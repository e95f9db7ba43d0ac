"""Host milliseconds of ``PoseEstimator.process_batch_async`` (the program's
span ``infer.enqueue``: upload, network, peak scores and tables enqueued)
less its wait in the overflow switch (``decode.overflow_switch``), per
batch, in the traced run of a stream cell."""

from posebench import spans


def read(run):
    return spans.read(run, "stream", "infer.enqueue", "infer.enqueue",
                      less="decode.overflow_switch")
