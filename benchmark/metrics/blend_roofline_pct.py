"""The blending kernel's (csrc/blend.cu, `blend_kernel`) share of its
roofline in %: the least time its bytes need at the peak HBM rate
(stats.blend_bytes: four f32 input maps read once, one f32 output written
once) over its mean time per launch in the traced stretch.  None when the
stretch launched it not at all (e.g. a radius that takes the wide path)."""

from benchmark import stats

KERNEL = "blend_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    seconds = launches = 0
    for name, (s, n) in tr["kernels"].items():
        if KERNEL in name and "wide" not in name:
            seconds += s
            launches += n
    if not launches:
        return None
    h, w = ctx["frame_shape"]
    return stats.roofline_pct(stats.blend_bytes(h, w), 0.0,
                              seconds / launches, ctx["peaks"])
