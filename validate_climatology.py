"""Full-physics 1-year climatology validation (BASELINE config #3).

Runs 13 months (first discarded as spinup), accumulates monthly means of key
fields, and checks them against broad climatological ranges. Prints a JSON
report.

    python validate_climatology.py [--months N] [--f32] [--preset T30|T47|T63]

T30 runs from the bundled ERA-interim boundary conditions through the public
Speedy API. The beyond-reference presets (T47L8/T63L8 — the reference is
compile-time locked to T30, params.f90:18-29) run from the synthetic BCs
(testing.synthetic_host_bc) through the model-level API: the bundled BC file
is on the 96x48 grid only. Their damping/dt retunes (params.py) were
calibrated by short runs; this is the multi-month stability + climate gate.

On CPU (f64) a T30 year takes ~10 minutes; on the GPU it is not measured.
"""

import argparse
import json
import sys
from datetime import datetime

import numpy as np


def run_t30(params, months):
    from pyspeedy_tpu import Speedy

    start = datetime(1981, 12, 1)
    model = Speedy(start_date=start, end_date=datetime(1983, 6, 1),
                   params=params)
    model.set_bc()

    tsfc, prec, toa = [], [], []
    for m in range(months):
        model._advance(30 * params.nsteps)
        model._raise_if_failed()
        model.spectral2grid()
        if m == 0:
            continue  # spinup
        w = np.cos(np.deg2rad(model["lat"]))[None, :, None]
        wsum = w.sum() * params.ix
        t_sfc = model["t_grid"][:, :, -1].T[None]  # (1, lat, lon)
        tsfc.append(float((t_sfc * w).sum() / wsum))
        p = (model["precnv"] + model["precls"]).T[None]
        prec.append(float((p * w).sum() / wsum) * 86.4)  # mm/day
        net = (model["tsr"] - model["olr"]).T[None]
        toa.append(float((net * w).sum() / wsum))
    return tsfc, prec, toa


def run_synthetic(params, months):
    """Model-level monthly loop from synthetic BCs (T47/T63 path)."""
    import dataclasses

    import jax

    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.models import prognostics as prog
    from pyspeedy_tpu.testing import make_demo_model

    consts, state, cal = make_demo_model(params)
    run = M.make_run_steps(consts, phase=2)
    s2g = jax.jit(lambda st: prog.spectral2grid(consts, st))

    n_month = 30 * params.nsteps
    assert n_month % 3 == 0
    stepno = 2
    geom_lat = np.asarray(consts.geom.radang, dtype=np.float64)
    w = np.cos(geom_lat)[:, None]
    wsum = w.sum() * params.ix

    tsfc, prec, toa = [], [], []
    for m in range(months):
        ctx, cal = M.build_step_ctx(cal, stepno, n_month)
        state = run(state, ctx)
        stepno += n_month
        if bool(np.asarray(state["error_flag"])):
            raise RuntimeError(f"diagnostics tripped in month {m}")
        if m == 0:
            continue
        st = s2g(state)
        t_sfc = np.asarray(st["t_grid"][-1])          # (il, ix)
        tsfc.append(float((t_sfc * w).sum() / wsum))
        p = np.asarray(state["precnv"]) + np.asarray(state["precls"])
        prec.append(float((p * w).sum() / wsum) * 86.4)
        net = np.asarray(state["tsr"]) - np.asarray(state["olr"])
        toa.append(float((net * w).sum() / wsum))
    return tsfc, prec, toa


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--months", type=int, default=13)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--preset", default="T30",
                    choices=("T30", "T47", "T63"))
    args = ap.parse_args()

    import jax

    from pyspeedy_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.default_backend() == "cpu" and not args.f32:
        jax.config.update("jax_enable_x64", True)

    import dataclasses

    from pyspeedy_tpu.params import T30L8, T47L8, T63L8

    params = {"T30": T30L8, "T47": T47L8, "T63": T63L8}[args.preset]
    if args.f32 or jax.default_backend() != "cpu":
        params = dataclasses.replace(params, precision="f32",
                                     fft_mode="matmul")

    if args.preset == "T30":
        tsfc, prec, toa = run_t30(params, args.months)
    else:
        tsfc, prec, toa = run_synthetic(params, args.months)

    report = {
        "preset": args.preset,
        "months_used": len(tsfc),
        "tsfc_mean_K": round(float(np.mean(tsfc)), 2),
        "tsfc_range_K": [round(min(tsfc), 2), round(max(tsfc), 2)],
        "precip_mean_mm_day": round(float(np.mean(prec)), 3),
        "toa_net_W_m2": round(float(np.mean(toa)), 2),
    }
    checks = {
        "tsfc_plausible": 270.0 < report["tsfc_mean_K"] < 295.0,
        "precip_plausible": 1.0 < report["precip_mean_mm_day"] < 6.0,
        "toa_balance": abs(report["toa_net_W_m2"]) < 40.0,
    }
    report["checks"] = checks
    report["ok"] = all(checks.values())
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
