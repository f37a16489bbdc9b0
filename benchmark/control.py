"""The control of the check that decides `correct`, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Runs the cell as benchmark/run.py does (set-up, a window of `seconds`),
but puts the plain reference in the program's place for the frames that
are compared, with its map stored in bfloat16 (reference/step.py), and
prints, one JSON line a seed, every number compared beside its limit.
The control has to come out not correct.  The benchmark's own runs never
run it; it is not a cell.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import _prepare_environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _prepare_environment()

    import torch

    from benchmark import cell as cellmod

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        run = cellmod.Run(args.workload, seed, args.seconds, False,
                          time.perf_counter(), control=True)
        out = run.execute()
        checks = out["checks"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": True,
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}), flush=True)
        del run, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
