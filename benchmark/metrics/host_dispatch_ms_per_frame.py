"""Host time in the pipeline's dispatch per fused frame: the benchmark's
spans around each process_frame call of the window plus its final drain,
over the frames fused (pipeline.py, chunk.py)."""


def read(ctx):
    win = ctx["window"]
    if not win.fused:
        return None
    return 1000.0 * (sum(win.dispatch_s) + win.drain_s) / len(win.fused)
