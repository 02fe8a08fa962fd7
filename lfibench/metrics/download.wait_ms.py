"""download.wait_ms: per call of the API, the host time of the program's
``lfi.download.wait`` span (the caller waiting for the views and maps to
reach host memory), in ms (``spans.per_call_ms``)."""

from lfibench import spans


def read(rec):
    return spans.per_call_ms(rec.trace, "lfi.download.wait")
