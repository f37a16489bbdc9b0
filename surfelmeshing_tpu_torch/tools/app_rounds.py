"""Times the port's application from one or more checkouts in alternating
rounds: the same synthetic TUM-format dataset and flags, run as `python -m
surfelmeshing_tpu_torch.app.main` from each checkout, each run in a
process of its own.  With two checkouts A and B and two rounds the order
is A, B, B, A, so a drift of the host or the card falls on both.

Prints one JSON line a run (checkout, round, wall seconds, and the means
of the app's timing report in host ms a frame: preprocessing and
integration, as the app reports them at its end), then one summary line
with each checkout's means over its runs.  The flags after `--` are
passed to the app after the dataset arguments' defaults; the app runs on
its default device (cuda) unless they say otherwise.

Usage:
  python -m surfelmeshing_tpu_torch.tools.app_rounds [--frames 40]
      [--width 640 --height 480] [--rounds 2] ROOT [ROOT ...]
      [-- APP FLAGS]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from ..io.synthetic import write_tum_dataset

_REPORT = re.compile(r"^\s+(\w+): total \S+\s+count (\d+)\s+mean (\S+)", re.M)


def run_app(root: str, dataset: str, flags: list) -> dict:
    """One app run from checkout `root`: wall seconds and the timing
    report's [count, mean ms] per tag."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "surfelmeshing_tpu_torch.app.main",
             *flags, dataset, "groundtruth.txt"],
            cwd=out, env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"app from {root} exited with "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    tags = {m.group(1): [int(m.group(2)), 1e3 * float(m.group(3))]
            for m in _REPORT.finditer(proc.stderr + proc.stdout)}
    return dict(wall_s=wall, tags=tags)


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    app_flags = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    flags = ["--restrict_fps_to", "0", "--exit_after_processing", *app_flags]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        dataset = os.path.join(tmp, "dataset")
        write_tum_dataset(dataset, args.frames, args.width, args.height)
        for r in range(args.rounds):
            order = args.roots if r % 2 == 0 else args.roots[::-1]
            for root in order:
                run = dict(root=root, round=r, **run_app(root, dataset, flags))
                print(json.dumps(run), flush=True)
                runs.append(run)
    summary = {}
    for root in args.roots:
        mine = [run for run in runs if run["root"] == root]
        summary[root] = {"wall_s": sum(r["wall_s"] for r in mine) / len(mine)}
        for tag in ("preprocessing", "integration"):
            ms = [r["tags"][tag][1] for r in mine if tag in r["tags"]]
            summary[root][f"{tag}_ms"] = sum(ms) / len(ms) if ms else None
    print(json.dumps({"summary": summary}), flush=True)
    return runs


if __name__ == "__main__":
    main()
