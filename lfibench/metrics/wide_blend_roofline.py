"""wide_blend_roofline: the least time of one blend of the cell's grid and
views, over the device time per frame of the kernel that blends in the
cell's mix, in %: at fixed focus ``roofline.blend_bound_s`` over
``shift_blend_kernel``'s time, all in focus
``roofline.allfocus_blend_bound_s`` over ``allfocus_blend_kernel``'s. The
cells of grids too large to stage at once, whose blends run in passes.

The same quantity as ``shift_blend_roofline`` and
``allfocus_blend_roofline`` in the other cells, under a name of its own:
it goes once those two list the 17x17 cells."""

from lfibench import roofline


def read(rec):
    t = rec.trace
    allfocus = bool(rec.mix.get("allfocus"))
    kernel = "allfocus_blend_kernel" if allfocus else "shift_blend_kernel"
    if t is None or not t.frames or not t.kernel_s(kernel):
        return None
    c = rec.config
    bound_s = roofline.allfocus_blend_bound_s if allfocus else roofline.blend_bound_s
    bound = bound_s(c["cols"] * c["rows"], c["views"], 3, c["height"], c["width"])
    return 100 * bound / (t.kernel_s(kernel) / t.frames)
