"""device.idle_unnamed_pct: the share of the traced sub-window in which the
device is idle and the calling thread is in none of the child spans of the
program's ``lfi.interpolate``: the idle time that the program's spans leave
unexplained, in %. The device's events are put on the host's clock first
(``spans.clock_lead``); see ``spans.idle_unnamed_pct``."""

from lfibench import spans


def read(rec):
    return spans.idle_unnamed_pct(rec.trace)
