"""Device milliseconds of the conv/GEMM kernel class (``posebench.classes``)
per image of the traced sub-window, in the closed-loop inference cells."""


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "stream":
        return None
    images = run.trace.counts.get("images", 0)
    seconds = run.trace.by_class.get("conv/GEMM", 0.0)
    if not images or not seconds:
        return None
    return 1e3 * seconds / images
