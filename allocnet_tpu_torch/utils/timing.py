"""Phase timing and profiling.

Port of `allocnet_tpu/utils/timing.py`: the reference's phase taxonomy
(per-plan phases "path+corridor" learning_planner.hpp:301-303, "inference"
:191-194, "qp+fill" :235-237, and the model-load microbenchmark :115-135)
as a context-manager API with JSONL output.  The device trace is a
`torch.profiler` trace (Chrome JSON) where the JAX package writes a
`jax.profiler` one, and the microbenchmark times a card with CUDA events.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates host wall-clock per named phase; records like the
    reference's per-phase chrono spans.  A phase that launches work on a
    card ends when the host returns, not when the card finishes: sync
    inside the phase to time the device."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def dump(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(self.summary()) + "\n")


@contextlib.contextmanager
def device_trace(logdir: str):
    """`torch.profiler` trace of the enclosed region (host, and the card's
    kernels where there is one), written to logdir/trace.json as a Chrome
    trace.  Yields the profiler (its `key_averages()` sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def microbenchmark(fn, *args, warmup: int = 2, reps: int = 3) -> float:
    """Model-load style microbenchmark (learning_planner.hpp:91-135: two
    warm-ups then a timed pass).  Returns mean seconds over reps: by CUDA
    events when a tensor argument lies on a card, else by the host clock
    after waiting for the result."""
    dev = next((a.device for a in args if torch.is_tensor(a) and a.is_cuda),
               None)
    for _ in range(warmup):
        fn(*args)
    if dev is not None:
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    # host clock; a function that launches on a card from host inputs is
    # waited for after each call
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        sync()
    return (time.perf_counter() - t0) / reps
