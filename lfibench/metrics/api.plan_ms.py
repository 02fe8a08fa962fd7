"""api.plan_ms: per call of the API, the host time of the program's
``lfi.plan`` span (the capacity plan, which reads the device's free memory
through ``cudaMemGetInfo``), in ms (``spans.per_call_ms``)."""

from lfibench import spans


def read(rec):
    return spans.per_call_ms(rec.trace, "lfi.plan")
