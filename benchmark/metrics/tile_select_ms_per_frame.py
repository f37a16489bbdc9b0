"""Device time of the tile selection per fused frame: the time of the
kernels whose name contains `tile_select` (csrc/tiling.cu,
`tile_select_kernel`, one launch a tiled frame) in the traced stretch,
over the frames fused in it.  None when the stretch launched no such
kernel (a program without it, or a frame route without tiling)."""

KERNEL = "tile_select"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["frames"]:
        return None
    seconds = launches = 0
    for name, (s, n) in tr["kernels"].items():
        if KERNEL in name:
            seconds += s
            launches += n
    if not launches:
        return None
    return 1000.0 * seconds / tr["frames"]
