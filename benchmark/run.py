"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's NVIDIA GPUs.
The cell, its configuration, its traffic mix and its per-layer metrics
are found by name (BENCHMARK.json, configs/, traffic/, metrics/); see
cell.py for what a run does.  With --trace 0 the result carries the
cell's end-to-end metrics, with --trace 1 its per-layer ones, read from
a profiled stretch after the window.  Diagnostics go to standard error
and to earlier lines of standard output; the last lines of standard
error are the numbers compared, each beside its limit.

Exits non-zero without a result, before any frame is rendered, when
the configuration states a setting the plain reference can neither read
nor leave aside (reference/step.py::refuse_unchecked; the message names
it); when no card (or fewer than the cell asks for) is present; and when
a module of JAX or of the JAX package is loaded once the run is over.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "surfelmeshing_tpu")


def _prepare_environment() -> None:
    """Import from the checkout (not from this directory, whose module
    names must not shadow the standard library's) and keep every build
    and kernel cache at a fixed path inside it."""
    here = str(BENCH)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def base_name(name: str) -> str:
    """A metric's quantity: its name up to the first dot.  `peak_mib.x`
    is `peak_mib` reported under a name (and bound) of its own for the
    cells it lists."""
    return name.split(".")[0]


def load_reader(name: str):
    """The read function of metrics/<name>.py, or else of the reader of
    the metric's quantity, metrics/<base_name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{base_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare_environment()

    import torch

    from benchmark import cell as cellmod
    from benchmark import stats
    from benchmark.reference import step as rstep

    bench = cellmod.manifest()
    entry, config, _ = cellmod.find_cell(args.workload, bench)
    try:
        rstep.refuse_unchecked(config["settings"])
    except ValueError as e:
        print(f"benchmark: cell {args.workload}: {e}", file=sys.stderr)
        return 5
    chips = entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    run = cellmod.Run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    out = run.execute()
    win, trace = out["window"], out["trace"]

    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                value = out["e2e"][base_name(m["name"])]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = {"window": win, "trace": trace,
               "frame_shape": (config["camera"]["height"],
                               config["camera"]["width"]),
               "peaks": stats.peaks(),
               "n_eff": trace["n_eff"], "surfels": trace["surfels"],
               "settings": cellmod.program_settings(config)}
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                value = load_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": all(v <= lim for v, lim in out["checks"].values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
        run.note(f"traced stretch: {trace['frames']} frames, "
                 f"{trace['window_s']:.6f} s; card and power limit: "
                 f"{power_limit()}")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["checks"].items()}

    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 4
    for line in run.lines:
        print(f"benchmark: {line}", file=sys.stderr)
    print(json.dumps({"info": run.lines}))
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
