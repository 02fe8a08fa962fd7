"""stream.feed_ms: per frame, the host time of the program's
``lfi.stream.feed`` spans (the stream's decode thread copying one pageable
host frame into its pinned buffer: the host's memory bandwidth), over the
frames completed in the traced sub-window, in ms
(``streaming.per_frame_ms``)."""

from lfibench import streaming


def read(rec):
    return streaming.per_frame_ms(rec.trace, "lfi.stream.feed")
