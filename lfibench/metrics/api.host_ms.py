"""api.host_ms: per call of the API, the host time from the start of the
benchmark's ``lfibench.call`` span to the first CUDA launch, copy or set
inside it (the trace's CUDA runtime events), averaged over the calls
traced, in ms: the host work before the card gets any of the call."""


def read(rec):
    t = rec.trace
    if t is None:
        return None
    waits = []
    for span in t.spans("lfibench.call"):
        start = float(span["ts"])
        first = t.first_device_call(start, start + float(span["dur"]))
        if first is not None:
            waits.append((first - start) / 1e3)
    return sum(waits) / len(waits) if waits else None
