"""api.upload_ms: per call of the API, the host time of the program's
``lfi.upload`` span (the fp16 check of the weights and the small uploads of
the render's arrays), in ms (``spans.per_call_ms``)."""

from lfibench import spans


def read(rec):
    return spans.per_call_ms(rec.trace, "lfi.upload")
