"""Share of the peak tables built in score order (the program's counters
``decode.tables.sorted`` over ``sorted`` + ``scan``, counted in
``decode/peaks.peak_tables`` from the process's start: set-up, the untraced
window and the traced run), in the traced run of a stream cell. A batch
whose every row holds at most ``max_peaks`` peaks takes the scan order."""

from posebench import spans


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "stream":
        return None
    c = spans.counters()
    done = c.get("decode.tables.sorted", 0) + c.get("decode.tables.scan", 0)
    if not done:
        return None
    return 100.0 * c.get("decode.tables.sorted", 0) / done
