"""The BODY_25 conv epilogue (``ops/dense_epilogue.py``,
``csrc/dense_epilogue.cu``) against its bound: every epilogue of a forward
reading its bf16 input once and writing its bf16 output once at the memory
bandwidth (``posebench.flops_body25.dense_epilogue_bound_s``), at the
cell's padded pyramid sizes, over the summed device time of the launches
whose kernel name holds ``dense_epilogue``. A forward launches one per
epilogue: 99 a scale of a batch."""

from posebench import flops, flops_body25

KERNEL = "dense_epilogue"


def read(run):
    if run.trace is None or run.cell["traffic"]["kind"] != "stream_body25":
        return None
    launches, seconds = run.trace.launches(KERNEL), run.trace.seconds(KERNEL)
    if not launches or not seconds:
        return None
    tr, m = run.cell["traffic"], run.config["model"]
    sizes = flops.scale_sizes(tr["height"], tr["width"], run.config["inference"]["scale_search"],
                              m["boxsize"], m["stride"])
    per_batch = len(sizes) * len(flops_body25.epilogue_channels())
    bound = flops_body25.dense_epilogue_bound_s(tr["batch"], sizes)
    return 100.0 * bound * launches / per_batch / seconds
