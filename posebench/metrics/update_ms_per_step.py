"""Host milliseconds of the MultiSGD update (the program's span
``train.update``, ``tx.update`` in ``training/train._descend``) per
training step (``train.step``), in the traced run of a train cell."""

from posebench import spans


def read(run):
    return spans.read(run, "train", "train.update", "train.step")
