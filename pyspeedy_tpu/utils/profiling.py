"""Profiling helpers: jax.profiler traces and simple phase timers.

The reference offers only a gprof build target (speedy.f90/Makefile:5,32);
here profiling is first-class: wrap any run in `trace()` to get a TensorBoard
/ Perfetto trace of the XLA execution, or use `PhaseTimer` for coarse
wall-clock accounting of init/step/export phases.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict

import jax

__all__ = ["trace", "PhaseTimer", "gpu_name_and_power_limit"]


def gpu_name_and_power_limit() -> str:
    """The GPUs' names and power limits as nvidia-smi reports them (one line
    per card). A card set below its maximum power runs slower under load,
    so every timing is reported beside this."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


@contextlib.contextmanager
def trace(log_dir: str = "trace"):
    """Capture a jax.profiler trace of the enclosed block into log_dir
    (relative to the working directory by default)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulate wall-clock per named phase; blocks on device results."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:30s} {self.totals[name]:10.3f}s "
                         f"x{self.counts[name]}")
        return "\n".join(lines)
