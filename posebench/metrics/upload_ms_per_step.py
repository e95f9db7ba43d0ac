"""Host milliseconds of the step's upload of its raw batch (the program's
span ``train.upload``, ``_to_device`` in ``training/train``) per training
step (``train.step``), in the traced run of a train cell."""

from posebench import spans


def read(run):
    return spans.read(run, "train", "train.upload", "train.step")
