"""Per-layer metric readers, one file each, named as the metric in
BENCHMARK.json.  Each defines read(ctx) -> float or None; None (nothing
to read in this run) leaves the metric out of the result line.

ctx keys: "window" (cell.Window of the measured window), "trace" (the
traced stretch's devtrace summary, or None), "frame_shape" (H, W),
"peaks" (peaks.json), and of the traced stretch: "n_eff" (the rows each
frame fused in it ran over, from the pipeline's bucket picks), "surfels"
(the live count at its start and end, read outside the profiled
stretch); "settings" (the configuration's settings, as the program takes
them)."""
