"""quilt.hwc_ms: per frame, the device time of the kernels launched inside
the program's ``lfi.quilt.hwc`` span (the quilt canvas's [C, H, W] ->
[H, W, C] copy before its download), tied launch to kernel by the trace's
``correlation`` argument, in ms (``spans.device_ms_per_frame``)."""

from lfibench import spans


def read(rec):
    return spans.device_ms_per_frame(rec.trace, "lfi.quilt.hwc")
