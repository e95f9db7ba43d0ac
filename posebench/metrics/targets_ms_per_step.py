"""Host milliseconds of the step's augmentation and labels (the program's
span ``train.targets``, ``_targets`` in ``training/train``) per training
step (``train.step``), in the traced run of a train cell."""

from posebench import spans


def read(run):
    return spans.read(run, "train", "train.targets", "train.step")
