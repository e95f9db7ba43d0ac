"""FLOPs a finetuning step needs per sample (``posebench.flops.train_flops``:
the frozen VGG's forward once, the trained layers' forward and backward
three times) times the untraced window's samples/s, over the bf16 peak."""

from posebench import flops


def read(run):
    if run.cell["traffic"]["kind"] != "train" or "train_samples_per_s" not in run.e2e:
        return None
    m, t = run.config["model"], run.config["train"]
    per_sample = flops.train_flops(run.cell["traffic"]["size"], m["num_stages"],
                                   frozen_vgg=t["vgg_lr_mult"] == 0.0)
    return 100.0 * per_sample * run.e2e["train_samples_per_s"] / flops.PEAK_BF16_FLOPS
