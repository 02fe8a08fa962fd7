"""stream.drain_ms: per frame, the host time of the program's
``lfi.stream.drain`` spans (the render loop waiting for the oldest frame's
views and maps to reach host memory: long when the download sets the
pace), over the frames completed in the traced sub-window, in ms
(``streaming.per_frame_ms``)."""

from lfibench import streaming


def read(rec):
    return streaming.per_frame_ms(rec.trace, "lfi.stream.drain")
