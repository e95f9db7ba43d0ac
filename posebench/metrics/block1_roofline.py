"""Block 1's kernel (``ops/block1.py``, ``csrc/block1.cu``) against its
bound: the larger of conv1_1 + conv1_2's FLOPs at the bf16 peak and its
input read once plus its pooled output written once at the memory
bandwidth (``posebench.flops.block1_bound_s``), at the cell's padded
pyramid sizes, over the summed device time of its launches. One launch
is one scale of one batch."""

from posebench import flops

KERNEL = "block1_kernel"


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "stream":
        return None
    launches, seconds = run.trace.launches(KERNEL), run.trace.seconds(KERNEL)
    if not launches or not seconds:
        return None
    tr, m = run.cell["traffic"], run.config["model"]
    sizes = flops.scale_sizes(tr["height"], tr["width"], run.config["inference"]["scale_search"],
                              m["boxsize"], m["stride"])
    per_batch = sum(flops.block1_bound_s(tr["batch"], ph, pw) for _, _, ph, pw in sizes)
    return 100.0 * per_batch * launches / len(sizes) / seconds
