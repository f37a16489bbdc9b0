"""Device busy time per fused frame over the traced stretch: the union of
kernel, copy and fill intervals from torch.profiler's CUDA activity, over
the frames fused in the stretch (ops/preprocess.py, ops/fusion.py)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["frames"]:
        return None
    return 1000.0 * tr["busy_s"] / tr["frames"]
