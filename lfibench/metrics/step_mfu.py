"""step_mfu: the whole frame's share of the card's peak: the least time of
the kernel work of the frames completed in the traced sub-window (the
estimate and the blend all in focus, the blend at fixed focus:
``roofline.frame_bound_s``) over the sub-window's length, in %. It bounds
each kernel's roofline share from the frame's side, so it still reads when a
kernel leaves the path."""

from lfibench import roofline


def read(rec):
    t = rec.trace
    if t is None or not t.frames or t.window_s <= 0 or not t.busy:
        return None
    allfocus = bool(rec.mix.get("allfocus"))
    return 100 * t.frames * roofline.frame_bound_s(rec.config, allfocus) / t.window_s
