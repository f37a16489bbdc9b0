"""The regularisation kernel's (csrc/regularization.cu,
`regularize_kernel`, phase 8's symmetric form) share of its roofline in
%: the least time its bytes need at the peak HBM rate over its time in
the traced stretch.  Its bytes follow the rows it steps
(stats.regularize_bytes, 192 B a row): the n_eff rows of each frame
fused in the stretch (ctx "n_eff"), times the iterations a frame
(ctx "settings").

For the count-sized cells only: on the tiled route a launch steps the
frame's working set of whole tiles, not its n_eff rows, and ctx does not
carry the working set.  None when the stretch fused no frame or launched
the kernel not at all (the exact form, symmetric_regularization false)."""

from benchmark import stats

KERNEL = "regularize_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["n_eff"]:
        return None
    seconds = sum(s for name, (s, _) in tr["kernels"].items()
                  if KERNEL in name)
    if not seconds:
        return None
    iterations = ctx["settings"][
        "regularization_iterations_per_integration_iteration"]
    return stats.roofline_pct(
        stats.regularize_bytes(sum(ctx["n_eff"]), iterations), 0.0,
        seconds, ctx["peaks"])
