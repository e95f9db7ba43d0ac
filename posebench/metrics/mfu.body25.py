"""BODY_25's model FLOPs of each image at the cell's padded pyramid sizes
(``posebench.flops_body25.pyramid_flops``) times the untraced window's
images/s, over the bf16 peak."""

from posebench import flops, flops_body25


def read(run):
    if run.cell["traffic"]["kind"] != "stream_body25" or "images_per_s" not in run.e2e:
        return None
    tr, m = run.cell["traffic"], run.config["model"]
    per_image = flops_body25.pyramid_flops(tr["height"], tr["width"],
                                           run.config["inference"]["scale_search"],
                                           m["boxsize"], m["stride"])
    return 100.0 * per_image * run.e2e["images_per_s"] / flops.PEAK_BF16_FLOPS
