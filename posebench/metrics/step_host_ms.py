"""Host milliseconds of one training step (the program's span
``train.step`` around ``step_fn`` in ``training/loop.train``; the feed's
``next()`` is outside it), in the traced run of a train cell."""

from posebench import spans


def read(run):
    return spans.read(run, "train", "train.step", "train.step")
