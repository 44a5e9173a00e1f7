"""Large batched ensembles on one accelerator — the internal fast path.

The reference caps out at OpenMP threads over a few dozen members
(speedy_driver.f90:58-79). Here 1024 members advance as vmapped scans on
the member axis, chunked along it (parallel/ensemble.MEMBER_CHUNK).
This script uses the internal
runner API directly — for the reference-style object API at small member
counts, see ensemble_forecast.py (SpeedyEns batches the same way under the
hood).
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from pyspeedy_tpu.models import model as M
from pyspeedy_tpu.params import T30L8
from pyspeedy_tpu.testing import make_demo_model
from pyspeedy_tpu.parallel.ensemble import (broadcast_state,
                                            make_run_steps_batched,
                                            pick_member_chunk)

n_members = 1024
n_days = 5

precision = "f64" if jax.default_backend() == "cpu" else "f32"
params = dataclasses.replace(T30L8, precision=precision, fft_mode="matmul")
consts, state, cal = make_demo_model(params)
n_day = params.nsteps

# One executable serves every chunk; the shortwave phase is static
# (current_step=2 after the bootstrap). donate=False: the chunk states
# share the loop-invariant arrays (masks, climatologies), which donation
# would invalidate for the next chunk.
chunk = pick_member_chunk(n_members)
run = make_run_steps_batched(consts, phase=2, donate=False)

# Perturbed initial conditions: fold a distinct key into each member's
# spectral temperature (surface level, small rotation-safe noise).
rng = np.random.default_rng(0)
chunks = []
for c in range(n_members // chunk):
    b = broadcast_state(state, chunk)
    t0, t1 = b["t"]
    pert = rng.normal(0.0, 1e-3, t0.shape).astype(np.asarray(t0).dtype)
    b["t"] = (t0 + pert, t1)
    chunks.append(b)

ctx, cal = M.build_step_ctx(cal, 2, n_day)
chunks = [run(b, ctx) for b in chunks]
jax.block_until_ready(chunks)  # compile + first day

t0 = time.time()
stepno = 2 + n_day
for d in range(n_days - 1):
    ctx, cal = M.build_step_ctx(cal, stepno, n_day)
    chunks = [run(b, ctx) for b in chunks]
    stepno += n_day
jax.block_until_ready(chunks)
wall = time.time() - t0
msps = n_members * (n_days - 1) * n_day / wall
print(f"{n_members} members x {n_days - 1} days: {msps:.0f} member-steps/s")

# Every member's final-step diagnostics are current (the runner returns
# them member-batched): ensemble-mean convective precipitation and the
# spread of the surface-level spectral mean temperature.
precnv = np.concatenate([np.asarray(b["precnv"]) for b in chunks])
tmean = np.concatenate(
    [np.asarray(b["t"][0])[:, 0, -1, 0, 0] / np.sqrt(2.0) for b in chunks])
errors = np.concatenate(
    [np.atleast_1d(np.asarray(b["error_flag"])) for b in chunks])
print(f"ensemble-mean precnv: {precnv.mean():.3f} mm/day; "
      f"surface-T spread: {tmean.std():.3f} K; "
      f"failed members: {int(errors.sum())}")
