"""device.idle_pct: the share of the traced sub-window in which neither a
kernel nor a copy nor a set runs on the card, in %."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or not t.busy:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
