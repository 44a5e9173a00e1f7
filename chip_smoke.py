"""GPU smoke gate: SPEEDY's forecast and ensemble paths on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-cards  # only the four-card sharded ensemble

One-card phases, through the public API (`Speedy`, `SpeedyEns`) wherever
one exists:

  f64_parity    Speedy T30L8 f64 with set_bc()/run() for 1 and 3 days,
                against the golden fixtures (tests/fixtures) at rtol 1e-6.
  f32_single    Speedy f32 for 1 day on the GPU and on the host CPU in the
                same process: day-1 spectral T drift below 5e-2.
  f32_ensemble  SpeedyEns(64) f32 for 1 day on the batched path:
                finite, members bitwise equal, within 1e-3 of f32_single.
  sppt          SpeedyEns(16) f32 with SPPT for 1 day: finite, members
                differ.
  t47, t63      5 days of T47L8 / T63L8 f32 from synthetic boundary
                conditions (no bundled data at those grids): finite with the
                diagnostics check clean.

`--four-cards` runs the batched runner over a 4x1 and a 2x2
("ensemble" x "space") mesh of four cards (256 T30L8 f32 members, 1 day as
twelve chained 3-step calls) and compares each with the unsharded batched
run on one card at 2e-4 rel, after 6 steps and after the day. On four
H100s the worst is 1.6e-6 after 6 steps and 8.7e-5 after the day (2x2
mesh). On four virtual CPU devices the day-1 gap is 4.1e-4 in f32 (1.3e-14
in f64): the CPU's f32 rounding differs more with the per-card batch, so
a CPU rehearsal of this phase fails the day-1 bound.

Each phase prints one line: result, worst error beside its tolerance,
precision, compile seconds and run seconds. Then the card's name and power
limit (nvidia-smi), and last one JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
N being the number of cards the phases ran on (1, or 4 with --four-cards).
A failed or raising phase makes the exit code non-zero. Without a GPU the
script prints {"ok": false, ...} and exits 1; it never falls back to the
CPU. XLA runs with the flags the environment gives it (by default, with its
GPU autotuning on, as a user's run compiles).
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from datetime import datetime

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
FIXTURES = os.path.join(REPO, "tests", "fixtures")

import jax  # noqa: E402

# f64 phases need x64; f32 phases run under it too (f32 params keep f32
# state, the calendar scalars are cast inside the step).
jax.config.update("jax_enable_x64", True)

START = datetime(1982, 1, 1)
F64_RTOL = 1e-6           # the CPU suite's own fixture gate
F32_DRIFT_TOL = 5e-2      # day-1 spectral T, GPU f32 vs CPU f32
# Batched 64-member run vs the single-member run, both f32 on the GPU: the
# same step, fused and batched differently, so rounding differs and grows
# over 36 steps. Measured on an H100: 3.2e-5 and 6.6e-5 (XLA autotuning on
# and off), the size of the GPU-vs-CPU day-1 drift (7.6e-5); a batching fault
# would be orders of magnitude larger.
ENS_VS_SINGLE_TOL = 1e-3
SHARD_TOL = 2e-4          # sharded vs unsharded batched run, f32
N_MEMBERS_SHARDED = 256

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_seconds = [0.0]


def _on_event(event, duration_secs, **_):
    if event in _COMPILE_EVENTS:
        _compile_seconds[0] += duration_secs


def _f32(params):
    # fft_mode pinned so the CPU comparison runs the same formulation.
    return dataclasses.replace(params, precision="f32", fft_mode="matmul")


def _fresh_caches():
    """Consts and jitted steps are cached per configuration and hold arrays
    placed on the device they were built on: rebuild per device."""
    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.speedy import Speedy

    M._CONSTS_CACHE.clear()
    M._RUN_FN_CACHE.clear()
    M._DEVICE_INIT_CACHE.clear()
    Speedy._GLOBAL_JIT_CACHE.clear()


def _rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))


def _rtol_needed(got, ref):
    """Smallest rtol at which assert_allclose(got, ref, rtol, atol=0) holds."""
    x = np.asarray(got, dtype=np.float64)
    y = np.asarray(ref, dtype=np.float64)
    diff = np.abs(x - y)
    if np.any((y == 0) & (diff > 0)):
        return float("inf")
    nz = y != 0
    return float((diff[nz] / np.abs(y[nz])).max()) if nz.any() else 0.0


def _forecast(params, end):
    from pyspeedy_tpu import Speedy

    model = Speedy(start_date=START, end_date=end, params=params)
    model.set_bc()
    model.run()
    return model


class _DailySnapshots:
    """Callback: the exported dataset at the end of every simulated day
    (one 36-step scan shape serves the whole run, so it compiles once)."""

    interval = 36

    def __init__(self):
        self.by_day = {}

    def __call__(self, model):
        self.by_day[(model.current_date - START).days] = model.to_dataframe()


def phase_f64_parity():
    from pyspeedy_tpu import Speedy
    from pyspeedy_tpu.utils.dataset import open_dataset

    model = Speedy(start_date=START, end_date=datetime(1982, 1, 4))
    model.set_bc()
    snaps = _DailySnapshots()
    model.run(callbacks=[snaps])
    worst = {}
    for day in (1, 3):
        ref = open_dataset(os.path.join(
            FIXTURES, f"1982-01-{1 + day:02d}_0000.nc"))
        for v in ("u", "v", "t", "q", "phi", "ps"):
            worst[f"day{day}_{v}"] = _rtol_needed(snaps.by_day[day][v].data,
                                                  ref[v].data)
    w = max(worst.values())
    detail = "worst per field: " + " ".join(
        f"{k}={v:.2e}" for k, v in worst.items())
    return w <= F64_RTOL, w, F64_RTOL, "f64", detail


_single_t = {}


def phase_f32_single():
    from pyspeedy_tpu.params import T30L8

    params = _f32(T30L8)
    end = datetime(1982, 1, 2)
    t = {}
    for name, device in (("cpu", jax.devices("cpu")[0]),
                         ("gpu", jax.devices()[0])):
        _fresh_caches()
        with jax.default_device(device):
            t[name] = _forecast(params, end)["t"]
    _single_t["gpu"] = t["gpu"]
    finite = bool(np.isfinite(t["gpu"]).all())
    drift = _rel(t["gpu"], t["cpu"])
    return (finite and drift < F32_DRIFT_TOL, drift, F32_DRIFT_TOL, "f32",
            f"finite={finite}")


def _ensemble(n, params):
    from pyspeedy_tpu import SpeedyEns

    ens = SpeedyEns(n, start_date=START, end_date=datetime(1982, 1, 2),
                    params=params)
    for member in ens:
        member.set_bc()
    ens.run()  # raises on any member's diagnostics error flag
    return np.stack([m["t"] for m in ens])


def phase_f32_ensemble():
    from pyspeedy_tpu.params import T30L8

    ts = _ensemble(64, _f32(T30L8))
    finite = bool(np.isfinite(ts).all())
    identical = bool((ts == ts[0]).all())
    vs_single = _rel(ts[0], _single_t["gpu"])
    ok = finite and identical and vs_single < ENS_VS_SINGLE_TOL
    return (ok, vs_single, ENS_VS_SINGLE_TOL, "f32",
            f"finite={finite} members_identical={identical}")


def phase_sppt():
    from pyspeedy_tpu.params import T30L8

    ts = _ensemble(16, dataclasses.replace(_f32(T30L8), sppt_on=True))
    finite = bool(np.isfinite(ts).all())
    spread = _rel(ts[1:], np.broadcast_to(ts[0], ts[1:].shape))
    differ = all(bool((ts[i] != ts[0]).any()) for i in range(1, len(ts)))
    return (finite and differ, spread, 0.0, "f32",
            f"finite={finite} members_differ={differ} "
            "(worst = member spread in T, must exceed tol)")


def _preset_run(params, n_days):
    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.testing import make_demo_model

    consts, state, cal = make_demo_model(params)
    run = M.make_run_steps(consts, phase=2)
    n = n_days * params.nsteps
    n -= n % 3
    ctx, _ = M.build_step_ctx(cal, 2, n)
    out = run(state, ctx)
    t = np.asarray(out["t"][0])
    finite = bool(np.isfinite(t).all())
    flag = bool(np.asarray(out["error_flag"]))
    return finite and not flag, f"finite={finite} error_flag={flag}"


def _preset_phase(name):
    def phase():
        import pyspeedy_tpu.params as P

        ok, detail = _preset_run(_f32(getattr(P, name)), 5)
        return ok, 0.0, 0.0, "f32", f"5 days, {detail}"
    return phase


def _four_card_setup():
    """(consts, member state, ctxs): one day as twelve chained 3-step calls.
    A 3-step chunk keeps the start phase (2), so each layout compiles one
    executable, and it is the smallest such graph: three unrolled steps."""
    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.params import T30L8
    from pyspeedy_tpu.testing import make_demo_model

    consts, state, cal = make_demo_model(_f32(T30L8))
    ctxs = []
    for i in range(12):
        ctx, cal = M.build_step_ctx(cal, 2 + 3 * i, 3)
        ctxs.append(ctx)
    return consts, state, ctxs


def _day(run, state, ctxs):
    """Prognostic fields after the second chunk (6 steps) and the day."""
    snaps = []
    for ctx in ctxs:
        state = run(state, ctx)
        snaps.append({k: [np.asarray(a) for a in state[k]]
                      for k in ("vor", "div", "t", "ps")})
    return snaps[1], snaps[-1]


def _unsharded_day(consts, state, ctxs):
    from pyspeedy_tpu.parallel.ensemble import (broadcast_state,
                                                make_run_steps_batched)

    return _day(make_run_steps_batched(consts, phase=2),
                broadcast_state(state, N_MEMBERS_SHARDED), ctxs)


def phase_four_cards():
    from pyspeedy_tpu.parallel.ensemble import (broadcast_state,
                                                make_run_steps_batched,
                                                shard_ensemble)
    from pyspeedy_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devices)}")
    t0 = time.perf_counter()

    def progress(what):
        print(f"  four_cards: {what} done at {time.perf_counter() - t0:.0f} s "
              f"(compile so far {_compile_seconds[0]:.0f} s)", flush=True)

    consts, state, ctxs = _four_card_setup()
    progress("set-up")
    ref = _unsharded_day(consts, state, ctxs)
    progress("unsharded one-card day")
    errs = {}
    finite = True
    for n_ens, n_space in ((4, 1), (2, 2)):
        mesh = make_mesh(n_ensemble=n_ens, n_space=n_space,
                         devices=devices[:4])
        out = _day(make_run_steps_batched(consts, mesh=mesh, phase=2),
                   shard_ensemble(mesh, broadcast_state(
                       state, N_MEMBERS_SHARDED)), ctxs)
        progress(f"{n_ens}x{n_space} mesh day")
        for when, o, r in zip(("6_steps", "1_day"), out, ref):
            err = 0.0
            for name, levels in o.items():
                for b, a in zip(levels, r[name]):
                    finite = finite and bool(np.isfinite(b).all())
                    err = max(err, _rel(b, a))
            errs[f"{n_ens}x{n_space}_{when}"] = err
    worst = max(errs.values())
    detail = f"{N_MEMBERS_SHARDED} members; " + " ".join(
        f"{k}: {v:.2e}" for k, v in errs.items())
    return finite and worst < SHARD_TOL, worst, SHARD_TOL, "f32", detail


ONE_CARD_PHASES = (
    ("f64_parity", phase_f64_parity),
    ("f32_single", phase_f32_single),
    ("f32_ensemble", phase_f32_ensemble),
    ("sppt", phase_sppt),
    ("t47", _preset_phase("T47L8")),
    ("t63", _preset_phase("T63L8")),
)


def run_phase(name, fn):
    c0 = _compile_seconds[0]
    t0 = time.perf_counter()
    try:
        ok, worst, tol, precision, detail = fn()
    except Exception:  # the phase fails; the script still reports the rest
        traceback.print_exc()
        ok, worst, tol, precision, detail = False, float("nan"), \
            float("nan"), "-", "raised (traceback on stderr)"
    wall = time.perf_counter() - t0
    compile_s = _compile_seconds[0] - c0
    print(f"phase {name}: {'PASS' if ok else 'FAIL'} worst={worst:.3e} "
          f"tol={tol:.1e} precision={precision} compile_s={compile_s:.1f} "
          f"run_s={wall - compile_s:.1f} {detail}", flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded ensemble phase")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(json.dumps({"ok": False,
                          "reason": f"no GPU: JAX backend is "
                                    f"{jax.default_backend()!r}"}))
        return 1

    from pyspeedy_tpu.utils.compile_cache import enable_compile_cache
    from pyspeedy_tpu.utils.profiling import gpu_name_and_power_limit

    enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_event)

    phases = ((("four_cards", phase_four_cards),) if args.four_cards
              else ONE_CARD_PHASES)
    results = [run_phase(name, fn) for name, fn in phases]
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    if not all(results):
        print(json.dumps({"ok": False, "failed": [
            name for (name, _), ok in zip(phases, results) if not ok]}))
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four_cards else 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
