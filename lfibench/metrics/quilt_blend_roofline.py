"""quilt_blend_roofline: the least time of one fused quilt blend of the
cell's grid into its quilt of native tiles (``quilt.blend_bound_s``: the
bytes, or the fp16 tensor-core rate), over the device time per frame of
the ``shift_blend_kernel`` launched inside the program's ``lfi.blend``
span (the quilt instantiation of the blend kernel), in %."""

from lfibench import quilt


def read(rec):
    ms = quilt.kernel_ms_per_frame(rec.trace, "lfi.blend", "shift_blend_kernel")
    if ms is None:
        return None
    c, q = rec.config, rec.config["quilt"]
    bound = quilt.blend_bound_s(c["cols"] * c["rows"], q["cols"], q["rows"], 3,
                                c["height"], c["width"])
    return 100 * bound / (ms / 1e3)
