"""allfocus_blend_roofline: the least time of one all-in-focus blend of
the cell's grid and views (``roofline.allfocus_blend_bound_s``), over the
device time per frame of ``allfocus_blend_kernel`` in the trace, in %."""

from lfibench import roofline


def read(rec):
    t = rec.trace
    if t is None or not t.frames or not t.kernel_s("allfocus_blend_kernel"):
        return None
    c = rec.config
    bound = roofline.allfocus_blend_bound_s(c["cols"] * c["rows"], c["views"], 3,
                                            c["height"], c["width"])
    return 100 * bound / (t.kernel_s("allfocus_blend_kernel") / t.frames)
