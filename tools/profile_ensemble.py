"""Profile the batched-ensemble step on the accelerator and print top HLOs.

Usage: python tools/profile_ensemble.py [n_members] [n_days] [trace_dir]

Times a multi-day batched run, then traces one more run and aggregates
per-op device time via pyspeedy_tpu.utils.xplane. The trace is written to
trace_dir (default: output/trace_m<n_members>).
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pyspeedy_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pyspeedy_tpu.models import model as M
from pyspeedy_tpu.params import T30L8
from pyspeedy_tpu.testing import make_demo_model
from pyspeedy_tpu.parallel.ensemble import broadcast_state, make_run_steps_batched
from pyspeedy_tpu.utils.xplane import top_ops_report


def main():
    n_members = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_days = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    backend = jax.default_backend()
    precision = "f64" if backend == "cpu" else "f32"
    params = dataclasses.replace(T30L8, precision=precision, fft_mode="matmul")
    print(f"profile: backend={backend} members={n_members} days={n_days}",
          file=sys.stderr, flush=True)

    consts, state, cal = make_demo_model(params)
    bstate = broadcast_state(state, n_members)
    run = make_run_steps_batched(consts, donate=False, phase=2)

    n_day = params.nsteps
    ctx, cal = M.build_step_ctx(cal, 2, n_day * n_days)
    t0 = time.time()
    out = run(bstate, ctx)
    jax.block_until_ready(out)
    print(f"compile+first run: {time.time()-t0:.1f}s", file=sys.stderr,
          flush=True)

    # Timed, untraced
    t0 = time.time()
    out = run(bstate, ctx)
    jax.block_until_ready(out)
    wall = time.time() - t0
    msps = n_members * n_day * n_days / wall
    print(json.dumps({"members": n_members, "days": n_days, "wall_s": wall,
                      "member_steps_per_s": msps}), flush=True)

    trace_dir = (sys.argv[3] if len(sys.argv) > 3
                 else os.path.join("output", f"trace_m{n_members}"))
    jax.profiler.start_trace(trace_dir)
    out = run(bstate, ctx)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    print(f"trace written to {trace_dir}", file=sys.stderr, flush=True)
    print(top_ops_report(trace_dir, n=45), flush=True)


if __name__ == "__main__":
    main()
