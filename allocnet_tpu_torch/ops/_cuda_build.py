"""The build that the port's CUDA kernels share: `nvcc` compiles one
source under `csrc/` into a shared library with a plain C interface, at
first use, and the kernel's module loads it with ctypes.

The library's file name carries a hash of the source and the flags, so an
edit of either builds anew; the build writes a temporary file and renames
it into place, so processes that build at once agree.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"      # where PATH has no nvcc


def nvcc(source: Path) -> str:
    path = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to "
                           f"build csrc/{source.name}")
    return path


def library_name(stem: str, source: Path, flags: list) -> str:
    """`{stem}_{hash of the source and the flags}.so`."""
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()
    return f"{stem}_{key[:16]}.so"


def build(stem: str, source: Path, flags: list, build_dir: Path) -> dict:
    """Compile `source` into `build_dir` unless its library is there.
    Returns {'path', 'seconds', 'ptxas'}: build wall time (0 if it was
    already built) and the `-Xptxas -v` report (registers, shared memory,
    spills).  Raises RuntimeError when nvcc is missing or fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / library_name(stem, source, flags)
    log = lib.with_suffix(".log")
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0,
                "ptxas": log.read_text() if log.exists() else ""}
    t0 = time.perf_counter()
    compiler = nvcc(source)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        res = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{source.name} "
                               f"({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, lib)          # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    report = res.stdout + res.stderr
    log.write_text(report)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "ptxas": report}
