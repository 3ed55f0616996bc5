"""Build the package's CUDA kernels at first use, from ``csrc/`` alone.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` inside the
package (a directory that ``.gitignore`` lists), then loaded with ``ctypes``.
The hash covers the source and the flags, so an edited source rebuilds.
``--use_fast_math`` is deliberately absent: the factorization kernel's
contract (a non-positive pivot yields a non-finite factor) relies on IEEE
rsqrt/multiply semantics.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """Where a kernel library is, and what building it took (``seconds`` is
    0 and ``log`` empty when it was already built)."""

    path: str
    seconds: float
    log: str


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless the library for this exact source
    and flag set exists already."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return BuildInfo(path=path, seconds=0.0, log="")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return BuildInfo(path=path, seconds=seconds, log=proc.stdout + proc.stderr)


_LIBS: dict = {}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed.
    A process loads each library once."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build(name).path)
    return _LIBS[name]
