"""api.self_ms: per call of the API, the self time of the program's
``lfi.interpolate`` span: its duration less what its child ``lfi.*`` spans
cover (the Python between the program's layers), in ms
(``spans.self_ms``)."""

from lfibench import spans


def read(rec):
    return spans.self_ms(rec.trace)
