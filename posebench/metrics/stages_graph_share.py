"""Share of BODY_25's stage loops that ran as a replayed CUDA graph (the
program's counters ``net.stages.graph`` over ``graph`` + ``net.stages.eager``,
counted in ``models/stage_graph.StageGraphs`` from the process's start:
set-up, the untraced window and the traced run), in the traced run of the
BODY_25 stream cell. A shape's first forward runs op by op."""

from posebench import spans


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "stream_body25":
        return None
    c = spans.counters()
    done = c.get("net.stages.graph", 0) + c.get("net.stages.eager", 0)
    if not done:
        return None
    return 100.0 * c.get("net.stages.graph", 0) / done
