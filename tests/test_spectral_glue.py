"""The batched-runner chaining contract."""

import dataclasses

import numpy as np

from pyspeedy_tpu.models import model as M
from pyspeedy_tpu.params import T30L8
from pyspeedy_tpu.testing import make_demo_model
from pyspeedy_tpu.parallel.ensemble import (broadcast_state,
                                            make_run_steps_batched)


def test_batched_runner_output_chains_back():
    """A batched run's output must feed back into the SAME executable —
    for physics-on (ephemerals stripped outside jit) and physics-off
    (ephemerals pass through untouched; round-3 review found the final
    vmapped group broadcasting stale copies and breaking the chain)."""
    params = dataclasses.replace(T30L8, fft_mode="matmul")
    base, state, cal = make_demo_model(params)
    for physics_on in (True, False):
        consts = dataclasses.replace(base, physics_on=physics_on)
        run = make_run_steps_batched(consts, phase=2, donate=False)
        b = broadcast_state(state, 2)
        cal2 = dataclasses.replace(cal)
        ctx, cal2 = M.build_step_ctx(cal2, 2, 3)
        out = run(b, ctx)
        ctx2, cal2 = M.build_step_ctx(cal2, 5, 3)
        out2 = run(out, ctx2)  # must not change the jit signature
        assert np.isfinite(np.asarray(out2["t"][0])).all(), physics_on
