"""Build the port's native sources into shared libraries.

Each csrc/<name>.cu is compiled with nvcc for sm_90a at first use into
build/kernels/ at the repository root and loaded with ctypes by its
wrapper module; the native meshing engine (native/*.cc) is compiled the
same way with g++ into build/native/ (meshing/engine.py).  The file name
carries a hash of the sources and the build flags, so a stale library is
never loaded, and the library is renamed into place atomically, so
concurrent builds (test workers, chip_smoke's parallel builds) agree.
Nothing here runs at import time: the CPU tests import every module on
machines without nvcc.

`builds` counts the libraries this process compiled (cache misses).  The
bench tools read it around their timed regions, as the JAX benches count
XLA compiles: a build there invalidates the measurement.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
# No --use_fast_math: the kernels' divisions must be IEEE divisions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
builds = 0


def cached_build(name: str, compiler: str, flags: Sequence[str],
                 sources: Sequence[Path], headers: Sequence[Path] = (),
                 build_dir: Path = BUILD_DIR) -> Path:
    """Compile `sources` with `compiler flags -o <lib>` unless a library
    built from the same sources, headers and flags is already in
    `build_dir`; returns the library's path."""
    global builds
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in (*sources, *headers):
        digest.update(Path(p).read_bytes())
    path = build_dir / f"{name}_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        subprocess.run([compiler, *flags, "-o", tmp, *map(str, sources)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)      # atomic: concurrent builds agree
        builds += 1
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"{compiler} failed building "
                           f"{', '.join(map(str, sources))}:\n"
                           f"{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def build(name: str) -> Path:
    """Compile csrc/<name>.cu with nvcc (cached as above; every csrc/*.cuh
    header is part of the key)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return cached_build(name, nvcc, NVCC_FLAGS, [CSRC / f"{name}.cu"],
                        headers=sorted(CSRC.glob("*.cuh")))
