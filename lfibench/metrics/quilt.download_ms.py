"""quilt.download_ms: per ``render_quilt`` call, the host time of the
program's ``lfi.quilt.download`` span (the quilt canvas's copy to a host
array, until the caller holds it), in ms (``quilt.per_call_ms``)."""

from lfibench import quilt


def read(rec):
    return quilt.per_call_ms(rec.trace, "lfi.quilt.download")
