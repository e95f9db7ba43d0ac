"""Host milliseconds a batch waits in the decode's peak-overflow switch
(``bool(overflow)`` in ``decode/peaks.peak_tables``, the program's span
``decode.overflow_switch``: the device finishes the network and the peak
scores before the host can choose the tables' order), per batch enqueued
(``infer.enqueue``), in the traced run of a stream cell."""

from posebench import spans


def read(run):
    return spans.read(run, "stream", "decode.overflow_switch", "infer.enqueue")
