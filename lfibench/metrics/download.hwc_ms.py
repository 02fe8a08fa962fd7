"""download.hwc_ms: per frame, the device time of the kernels launched
inside the program's ``lfi.download.start`` span (the [N, C, H, W] ->
[N, H, W, C] copy of the views before their download), tied launch to
kernel by the trace's ``correlation`` argument, in ms
(``spans.device_ms_per_frame``)."""

from lfibench import spans


def read(rec):
    return spans.device_ms_per_frame(rec.trace, "lfi.download.start")
