"""stream.take_ms: per frame, the host time of the program's
``lfi.stream.take`` spans (the render loop waiting for the next frame in
pinned memory, then enqueueing its planar copy: long when the decode
thread sets the pace), over the frames completed in the traced sub-window,
in ms (``streaming.per_frame_ms``)."""

from lfibench import streaming


def read(rec):
    return streaming.per_frame_ms(rec.trace, "lfi.stream.take")
