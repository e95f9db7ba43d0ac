"""Host milliseconds of the network's stage loop per batch (the program's
span ``net.stages``, the dispatch of the dense blocks, per span
``infer.enqueue``) in the traced run of the BODY_25 stream cell."""

from posebench import spans


def read(run):
    return spans.read(run, "stream_body25", "net.stages", "infer.enqueue")
