"""Nothing the benchmark runs loads JAX or the JAX package: after every
module of the harness, its readers and its reference is imported, no
loaded module's top-level name (compared whole) is one of them.  Also:
without a card the benchmark prints no result and exits non-zero."""

import ast
import json
import subprocess
import sys

from benchmark import cell as C

FORBIDDEN = ("jax", "jaxlib", "flax", "surfelmeshing_tpu")

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.run as run
from benchmark import cell, devtrace, stats
from benchmark.reference import blend, fusion, preprocess, se3, step
from benchmark.traffic import generator
import surfelmeshing_tpu_torch.pipeline, surfelmeshing_tpu_torch.chunk
import surfelmeshing_tpu_torch.meshing
for m in json.load(open({manifest!r}))["per_layer"]:
    run.load_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_after_importing_everything_the_benchmark_runs():
    code = PROBE.format(root=str(C.ROOT),
                        manifest=str(C.ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "surfelmeshing_tpu_torch" in top and "torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    """Every import of the reference is of the standard library, numpy,
    torch or the reference itself."""
    allowed = {"__future__", "dataclasses", "functools", "math", "struct",
               "time", "typing", "numpy", "torch"}
    for path in (C.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)


def test_without_a_card_no_result_and_a_nonzero_exit():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, str(C.BENCH / "run.py"), "--workload",
         "tum640_20m_defaults.explore.live", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(C.ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
