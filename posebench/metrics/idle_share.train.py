"""Share of the traced training sub-window in which no kernel or copy ran
on the device."""


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "train":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
