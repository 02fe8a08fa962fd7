"""estimate.flags_ms: per frame, the device time of the kernels launched
inside the program's ``lfi.estimate.flags`` span (the exact rule's clean
flags in torch ops, which ``focus_estimate_roofline`` leaves out), tied
launch to kernel by the trace's ``correlation`` argument, in ms
(``spans.device_ms_per_frame``)."""

from lfibench import spans


def read(rec):
    return spans.device_ms_per_frame(rec.trace, "lfi.estimate.flags")
