"""upload.gb_per_s: bytes of the host-to-device copies in the trace over
their device time, in GB/s (1e9 bytes)."""


def read(rec):
    if rec.trace is None:
        return None
    nbytes, seconds = rec.trace.copies("HtoD")
    return nbytes / seconds / 1e9 if nbytes and seconds else None
