"""Milliseconds the training loop waited in each ``next()`` of its feed
(``TprBatches``), from the benchmark's span around it, over the steps of
the traced sub-window."""


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "train":
        return None
    steps = run.trace.counts.get("steps", 0)
    if not steps:
        return None
    return 1e3 * run.trace.counts["feed_wait_s"] / steps
