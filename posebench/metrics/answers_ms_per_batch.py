"""Host milliseconds of ``PoseEstimator._finish`` (the program's span
``infer.finish``: the tables' copy to the host and ``to_people`` of every
image) per batch, in the traced run of a stream cell."""

from posebench import spans


def read(run):
    return spans.read(run, "stream", "infer.finish", "infer.finish")
