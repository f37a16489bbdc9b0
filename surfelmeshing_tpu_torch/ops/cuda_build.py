"""Build the port's CUDA sources into plain-C shared libraries.

Each csrc/<name>.cu is compiled with nvcc for sm_90a at first use into
build/kernels/ at the repository root and loaded with ctypes by its
wrapper module.  The file name carries a hash of the source and the build
flags, so a stale library is never loaded.  Nothing here runs at import
time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No --use_fast_math: the kernels' divisions must be IEEE divisions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library built from the same source
    and flags is already there; returns the library's path."""
    source_path = CSRC / f"{name}.cu"
    source = source_path.read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source_path)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)      # atomic: concurrent builds agree
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed building {source_path}:\n"
                           f"{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
