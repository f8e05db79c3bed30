"""ctypes binding of the C++ host runtime (runtime/allocnet_native.cpp):
the dilated collision grid, RRT and Informed RRT*, path simplification and
the batched window crop of the corridor front end.

The port's own binding of the JAX package's planner/native.py.  The
library is built at first use with

    g++ -O3 -fPIC -std=c++17 -shared runtime/allocnet_native.cpp

into allocnet_tpu_torch/_build/ (keyed by a hash of the source), never into
runtime/.  There is no fallback here: a failed build or load raises, and a
caller that wants the Python RRT asks for it (planner.build_map(native=
False)).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "runtime" / "allocnet_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def library_name() -> str:
    """File name of the built runtime, keyed by a hash of the source and
    the flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return f"allocnet_native_{key[:16]}.so"


def set_build_dir(path) -> None:
    """Build into (and load from) `path` from now on."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    build.cache_clear()
    _load.cache_clear()


@functools.cache
def build() -> str:
    """Compile the runtime into BUILD_DIR unless that library exists;
    returns its path.  Raises RuntimeError when g++ is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / library_name()
    if lib.exists():
        return str(lib)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native runtime cannot be "
                           "built (build_map(native=False) takes the "
                           "Python RRT)")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)          # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(lib)


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    d = ctypes.POINTER(ctypes.c_double)
    i, f64, vp = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    lib.grid_create.restype = vp
    lib.grid_create.argtypes = [d, i, d, d, f64, f64]
    lib.grid_destroy.restype = None
    lib.grid_destroy.argtypes = [vp]
    lib.grid_query.restype = i
    lib.grid_query.argtypes = [vp, d]
    lib.rrt_plan.restype = i
    lib.rrt_plan.argtypes = [vp, d, d, f64, i, f64, ctypes.c_ulonglong, d, i]
    lib.rrt_star_plan.restype = i
    lib.rrt_star_plan.argtypes = [vp, d, d, f64, i, f64, ctypes.c_ulonglong,
                                  f64, d, i]
    lib.simplify_path.restype = i
    lib.simplify_path.argtypes = [vp, d, i, d, i]
    lib.cloud_crop_windows.restype = i
    lib.cloud_crop_windows.argtypes = [d, i, d, d, i, f64, d, d, i]
    return lib


def available() -> bool:
    """Whether the runtime builds (g++) and loads here.  It only reports:
    callers that need the runtime call it and get the build's error."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def crop_windows(points: np.ndarray, lo_bs: np.ndarray, hi_bs: np.ndarray,
                 n_max: int, cell: float = 1.0):
    """Batched corridor-window crop through the C++ CSR grid index.
    Returns (pts (W, n_max, 3) padded with 1e9, mask (W, n_max)): the
    points strictly inside each window, in cloud order, the first n_max."""
    lib = _load()
    pts = _f64(points).reshape(-1, 3)
    lo = _f64(lo_bs).reshape(-1, 3)
    hi = _f64(hi_bs).reshape(-1, 3)
    W = len(lo)
    out = np.empty((W, n_max, 3), dtype=np.float64)
    mask = np.empty((W, n_max), dtype=np.float64)
    lib.cloud_crop_windows(_dp(pts), len(pts), _dp(lo), _dp(hi), W, cell,
                           _dp(out), _dp(mask), n_max)
    return out, mask


class NativeGrid:
    """Dilated occupancy grid with O(1) collision queries."""

    def __init__(self, points: np.ndarray, lo, hi, scale: float = 0.25,
                 safe_dis: float = 0.5):
        self._handle = None
        self._lib = _load()
        pts = _f64(points).reshape(-1, 3)
        self._lo, self._hi = _f64(lo), _f64(hi)
        self._handle = self._lib.grid_create(_dp(pts), len(pts),
                                             _dp(self._lo), _dp(self._hi),
                                             scale, safe_dis)
        if not self._handle:
            raise RuntimeError("grid_create returned no grid")

    def close(self):
        if self._handle:
            self._lib.grid_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def blocked(self, p) -> bool:
        return bool(self._lib.grid_query(self._handle, _dp(_f64(p))))

    def _path(self, n: int, out: np.ndarray):
        return None if n <= 0 else out[:n].copy()

    def rrt(self, start, goal, step: float = 1.0, max_iter: int = 5000,
            goal_bias: float = 0.1, seed: int = 0,
            max_pts: int = 4096) -> np.ndarray | None:
        out = np.zeros((max_pts, 3), dtype=np.float64)
        n = self._lib.rrt_plan(self._handle, _dp(_f64(start)),
                               _dp(_f64(goal)), step, max_iter, goal_bias,
                               seed, _dp(out), max_pts)
        return self._path(n, out)

    def rrt_star(self, start, goal, step: float = 1.0, max_iter: int = 5000,
                 goal_bias: float = 0.1, seed: int = 0,
                 time_budget_s: float = 0.0,
                 max_pts: int = 4096) -> np.ndarray | None:
        """Informed RRT* (sfc_gen.hpp:45-114) within max_iter iterations
        (and time_budget_s seconds when positive)."""
        out = np.zeros((max_pts, 3), dtype=np.float64)
        n = self._lib.rrt_star_plan(self._handle, _dp(_f64(start)),
                                    _dp(_f64(goal)), step, max_iter,
                                    goal_bias, seed, time_budget_s,
                                    _dp(out), max_pts)
        return self._path(n, out)

    def simplify(self, path: np.ndarray, max_pts: int = 4096) -> np.ndarray:
        path = _f64(path)
        out = np.zeros((max_pts, 3), dtype=np.float64)
        n = self._lib.simplify_path(self._handle, _dp(path), len(path),
                                    _dp(out), max_pts)
        return path if n <= 0 else out[:n].copy()
