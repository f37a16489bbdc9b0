"""Host time of a meshing snapshot (pipeline.py::snapshot_for_meshing, a
blocking copy): the mean of the benchmark's spans around each call in
the window.  None in a window without snapshots."""


def read(ctx):
    s = ctx["window"].snapshot_s
    if not s:
        return None
    return 1000.0 * sum(s) / len(s)
