"""api.params_ms: per call of the API, the host time of the program's
``lfi.params`` span (the render's host arrays in NumPy: weights, offsets,
focus views and tables), in ms (``spans.per_call_ms``)."""

from lfibench import spans


def read(rec):
    return spans.per_call_ms(rec.trace, "lfi.params")
