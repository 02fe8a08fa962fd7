"""focus_estimate_roofline: the least time of one exact estimate at the
cell's K, S, H, W and radius (``roofline.estimate_bound_s``), over the
device time per frame of the estimate's kernels in the trace (the RGBx
pack, the map pass and the argmin pass), in %."""

from lfibench import roofline

KERNELS = ("rgbx_pack_kernel", "cheby_map_kernel", "focus_argmin_kernel")


def read(rec):
    t = rec.trace
    if t is None or not t.frames or not t.kernel_s(*KERNELS):
        return None
    c = rec.config
    bound = roofline.estimate_bound_s(
        c["focus_map_views"], c["focus_steps"], c["height"], c["width"],
        roofline.block_radius(c["width"], c["height"], c["pixel_size_factor"]))
    return 100 * bound / (t.kernel_s(*KERNELS) / t.frames)
