"""Weak-scaling harness: ensemble grid-points/s at 1 -> N devices.

Runs the batched ensemble with a fixed number of members per device and
measures member-steps/s on 1 device and on all devices (ensemble-axis data
parallelism, plus optional latitude-band "space" sharding). On a CPU host it
uses virtual devices; run with:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python bench_scaling.py

Prints one JSON line with the weak-scaling efficiency.

NB: virtual CPU devices share the same physical cores, so CPU-host
"efficiency" only validates the mechanics (sharding compiles and runs);
the number is meaningful on real multi-card or multi-host machines.
"""

import dataclasses
import json
import sys
import time

import jax

from pyspeedy_tpu.utils.compile_cache import enable_compile_cache

MEMBERS_PER_DEVICE = 8
N_STEPS = 36


def measure(consts, state, cal, n_devices):
    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.parallel.ensemble import (broadcast_state,
                                                make_run_steps_batched,
                                                shard_ensemble)
    from pyspeedy_tpu.parallel.mesh import make_mesh

    devices = jax.devices()[:n_devices]
    mesh = make_mesh(n_ensemble=n_devices, n_space=1, devices=devices)
    n_members = MEMBERS_PER_DEVICE * n_devices

    batched = shard_ensemble(mesh, broadcast_state(state, n_members))
    run = make_run_steps_batched(consts, mesh=mesh, donate=False)

    ctx, cal2 = M.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS)
    out = run(batched, ctx)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    reps = 3
    for r in range(reps):
        ctx, cal2 = M.build_step_ctx(cal2, 2 + (r + 1) * N_STEPS, N_STEPS)
        out = run(out, ctx)
    jax.block_until_ready(out)
    wall = time.perf_counter() - t0
    return n_members * reps * N_STEPS / wall  # member-steps/s


def main():
    from pyspeedy_tpu.params import T30L8
    from pyspeedy_tpu.testing import make_demo_model

    enable_compile_cache()
    backend = jax.default_backend()
    precision = "f64" if backend == "cpu" else "f32"
    params = dataclasses.replace(T30L8, precision=precision,
                                 fft_mode="matmul")
    n_dev = len(jax.devices())
    print(f"scaling bench: backend={backend} devices={n_dev}",
          file=sys.stderr)

    consts, state, cal = make_demo_model(params)

    r1 = measure(consts, state, cal, 1)
    print(f"1 device: {r1:.0f} member-steps/s", file=sys.stderr)
    rn = r1
    if n_dev > 1:
        rn = measure(consts, state, cal, n_dev)
        print(f"{n_dev} devices: {rn:.0f} member-steps/s", file=sys.stderr)

    eff = rn / (r1 * n_dev) if n_dev > 1 else 1.0
    print(json.dumps({
        "metric": f"ensemble_weak_scaling_efficiency_{n_dev}dev",
        "value": round(eff, 3),
        "unit": "fraction",
        "vs_baseline": round(eff / 0.8, 3),  # target >= 0.8 (BASELINE.md)
    }))


if __name__ == "__main__":
    main()
