"""Model FLOPs of each image at the cell's padded pyramid sizes
(``posebench.flops.pyramid_flops``) times the untraced window's images/s,
over the bf16 peak."""

from posebench import flops


def read(run):
    if run.cell["traffic"]["kind"] != "stream" or "images_per_s" not in run.e2e:
        return None
    tr, m = run.cell["traffic"], run.config["model"]
    per_image = flops.pyramid_flops(tr["height"], tr["width"],
                                    run.config["inference"]["scale_search"], m["boxsize"],
                                    m["stride"], m["num_stages"])
    return 100.0 * per_image * run.e2e["images_per_s"] / flops.PEAK_BF16_FLOPS
