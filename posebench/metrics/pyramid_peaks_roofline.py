"""The scale-space peak scores (``ops/pyramid_peaks.py``: its main,
census and pass kernels) against their bound: every scale's low-res part
maps read once and the full-resolution masked scores written once at
the memory bandwidth (``posebench.flops.pyramid_peaks_bound_s``), over
the summed device time of the three kernels. One launch of the main
kernel is one batch."""

from posebench import flops

MAIN, ALL = "pyramid_peaks_kernel", "pyramid_"


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "stream":
        return None
    launches, seconds = run.trace.launches(MAIN), run.trace.seconds(ALL)
    if not launches or not seconds:
        return None
    tr, m = run.cell["traffic"], run.config["model"]
    sizes = flops.scale_sizes(tr["height"], tr["width"], run.config["inference"]["scale_search"],
                              m["boxsize"], m["stride"])
    bound = flops.pyramid_peaks_bound_s(tr["batch"], sizes, tr["height"], tr["width"],
                                        m["stride"])
    return 100.0 * bound * launches / seconds
