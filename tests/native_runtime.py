"""Waits for the JAX package's native runtime before a test uses it.

`allocnet_tpu.planner.native._load` builds `runtime/liballocnet_native.so`
at first use (`make -C runtime`), and `runtime/Makefile` links straight
into that path.  Under pytest-xdist several workers reach the first use
together: one finds the file while another's linker is still writing it,
`ctypes.CDLL` fails, `_load` returns None (it caches only success) and
`build_map` gives a map without the native grid.  `ensure_loaded` takes an
exclusive lock (one lock file per runtime directory, in the temp
directory), builds a missing library as the Makefile does into a temp file
renamed into place, and otherwise retries the load until the library is
whole."""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNTIME = os.path.join(ROOT, "runtime")
LIB = "liballocnet_native.so"
WAIT_S = 120.0            # the JAX package's `make` timeout
RETRY_S = 0.2


def makefile_command(runtime_dir: str, out: str) -> list:
    """runtime/Makefile's rule, `$(CXX) $(CXXFLAGS) -shared -o $@ $<`, with
    its defaults for CXX and CXXFLAGS (`?=`: the environment wins)."""
    cxx = os.environ.get("CXX", "g++")
    flags = os.environ.get("CXXFLAGS", "-O3 -Wall -fPIC -std=c++17").split()
    return [cxx, *flags, "-shared", "-o", out,
            os.path.join(runtime_dir, "allocnet_native.cpp")]


def _cdll(path: str):
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _jax_load():
    from allocnet_tpu.planner import native
    return native._load()


def ensure_loaded(runtime_dir: str = RUNTIME, load=None,
                  wait_s: float = WAIT_S) -> bool:
    """True once the runtime in `runtime_dir` loads (`load()` is not None;
    by default the JAX package's `native._load`, or `ctypes.CDLL` of the
    library for another directory).  False only when the library is
    missing and the Makefile's compiler is not installed.  Raises when
    the build fails or the library does not load within `wait_s`."""
    lib = os.path.join(runtime_dir, LIB)
    if load is None:
        load = (_jax_load if os.path.realpath(runtime_dir)
                == os.path.realpath(RUNTIME) else lambda: _cdll(lib))
    key = hashlib.sha256(os.path.realpath(runtime_dir).encode()).hexdigest()
    lock = os.path.join(tempfile.gettempdir(),
                        f"allocnet_native_{key[:16]}.lock")
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib):
                if shutil.which(makefile_command(runtime_dir, lib)[0]) is None:
                    return False
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=runtime_dir)
                os.close(fd)
                try:
                    subprocess.run(makefile_command(runtime_dir, tmp),
                                   check=True, capture_output=True,
                                   timeout=wait_s)
                    os.replace(tmp, lib)      # atomic: no reader sees a part
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            # a `make` outside the lock may still be writing the library
            deadline = time.monotonic() + wait_s
            while load() is None:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{lib} did not load in {wait_s} s")
                time.sleep(RETRY_S)
            return True
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
