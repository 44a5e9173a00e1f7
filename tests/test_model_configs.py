"""Model-configuration tests: dynamics-only runs (BASELINE config #2), SPPT
stochastic physics (config #4), float32 stability, and long-horizon
stability from synthetic boundary conditions."""

import dataclasses
from datetime import datetime

import numpy as np
import pytest

import jax

from pyspeedy_tpu.models import model as M
from pyspeedy_tpu.params import T30L8
from pyspeedy_tpu.testing import make_demo_model, synthetic_host_bc
from pyspeedy_tpu.utils.calendar import ModelCalendar


def run_days(params, days, **flags):
    consts, geom_np = M.build_consts(params, **flags)
    host_bc = synthetic_host_bc(params, geom_np)
    host_bc["_geom_np"] = geom_np
    state = M.allocate_state(params, n_months=1)
    cal = ModelCalendar.from_datetime(datetime(1982, 1, 1),
                                      nsteps=params.nsteps)
    state = M.initialize(consts, state, host_bc, cal)
    run = M.make_run_steps(consts)
    ctx, cal = M.build_step_ctx(cal, 2, days * params.nsteps)
    state = run(state, ctx)
    return consts, state


def test_dynamics_only_240_steps():
    """Physics-off T30L8 run: 240 steps stable from the rest state
    (BASELINE milestone A / config #2)."""
    params = T30L8
    consts, state = run_days(params, 7, physics_on=False)  # 252 steps
    assert not bool(state["error_flag"])
    vor = np.asarray(state["vor"])
    assert np.isfinite(vor).all()
    # Without physics there is no diabatic forcing: flow stays weak
    t_mean = float(state["t"][0][0, -1, 0, 0]) / np.sqrt(2.0)  # re plane
    assert 200.0 < t_mean < 320.0


def test_dynamics_only_240_step_self_fixture():
    """Pinned physics-off trajectory (tests/fixtures/dynamics_only_240.npz,
    f64, synthetic BCs): isolates dynamical-core regressions from the
    SST-anomaly floor in the reference-fixture comparisons. rtol 1e-8 leaves
    room only for benign compiler reassociation."""
    import os
    from datetime import datetime
    from pyspeedy_tpu.utils.calendar import ModelCalendar

    params = T30L8
    consts, geom_np = M.build_consts(params, physics_on=False)
    host_bc = synthetic_host_bc(params, geom_np)
    host_bc["_geom_np"] = geom_np
    state = M.allocate_state(params, n_months=1)
    cal = ModelCalendar.from_datetime(datetime(1982, 1, 1),
                                      nsteps=params.nsteps)
    state = M.initialize(consts, state, host_bc, cal)
    run = M.make_run_steps(consts)
    ctx, _ = M.build_step_ctx(cal, 2, 240)
    out = run(state, ctx)

    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                               "dynamics_only_240.npz"))
    got = {"vor": out["vor"][0], "div": out["div"][0], "t": out["t"][0],
           "ps": out["ps"][0], "q": out["tr"][0][:, 0]}
    for name, arr in got.items():
        a = np.asarray(arr)
        a = a[0] + 1j * a[1]  # real pair -> the fixture's complex layout
        b = fix[name]
        scale = np.abs(b).max()
        assert np.abs(a - b).max() / scale < 1e-8, name


def test_sppt_ensemble_spread():
    """SPPT on: two members with different RNG keys diverge; the pattern is
    bounded by the clipping (sppt.f90:106) and the AR(1) state persists."""
    params = dataclasses.replace(T30L8, sppt_on=True)
    consts, state, cal = make_demo_model(params)
    assert "sppt_spec" in state

    run = M.make_run_steps(consts)
    import copy
    state_b = dict(state)
    state_b["sppt_key"] = jax.random.key(12345)

    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 12)
    out_a = run(dict(state), ctx)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 12)
    out_b = run(state_b, ctx)

    da = np.abs(np.asarray(out_a["t"]) - np.asarray(out_b["t"])).max()
    assert da > 1e-10, "SPPT members with different keys must diverge"
    # AR(1) state persisted and is nonzero
    assert np.abs(np.asarray(out_a["sppt_spec"])).max() > 0
    assert not bool(out_a["error_flag"])


def test_f32_week_stable():
    params = dataclasses.replace(T30L8, precision="f32", fft_mode="matmul")
    consts, state = run_days(params, 7)
    assert not bool(state["error_flag"])
    assert np.isfinite(np.asarray(state["t_grid"] if "t_grid" in state
                                  else state["t"])).all()


def test_synthetic_month_stable():
    consts, state = run_days(T30L8, 30)
    assert not bool(state["error_flag"])
    ke_proxy = np.abs(np.asarray(state["vor"])).max()
    assert np.isfinite(ke_proxy)


def test_static_fields_invariant():
    """Guard for models.model.DYNAMIC_FIELDS: a day of stepping (including a
    forcing day-boundary) must leave every non-dynamic field bitwise
    unchanged, otherwise the scan-carry/ensemble-batch split would drop
    updates."""
    consts, state, cal = make_demo_model(T30L8)
    before = {k: np.asarray(v).copy() for k, v in state.items()}
    run = M.make_run_steps(consts)
    ctx, _ = M.build_step_ctx(cal, 2, 40)  # crosses step 36 (daily forcing)
    out = run(state, ctx)
    for k, v in out.items():
        if k in M.DYNAMIC_FIELDS or k == "sppt_key":
            continue
        np.testing.assert_array_equal(np.asarray(v), before[k],
                                      err_msg=f"static field {k} changed")


def test_rest_state_is_fixed_point_without_orography():
    """With flat orography, physics off, and exact (orthogonal) transform
    nodes, the reference rest state has no gradients: every dynamical
    tendency vanishes and the state must stay numerically at rest — a sharp
    whole-core correctness check.

    (In reference-node mode the transform non-orthogonality leaks ~1e-5
    zonal structure into ps, which then legitimately evolves; exact_nodes
    removes that seed.)"""
    import numpy as np
    import jax.numpy as jnp
    from pyspeedy_tpu.testing import synthetic_host_bc

    params = dataclasses.replace(T30L8, exact_nodes=True)
    consts, geom_np = M.build_consts(params, physics_on=False)
    host_bc = synthetic_host_bc(params, geom_np)
    host_bc["orog"] = np.zeros_like(host_bc["orog"])
    host_bc["_geom_np"] = geom_np
    state = M.allocate_state(params, n_months=1)
    cal = ModelCalendar.from_datetime(datetime(1982, 1, 1))
    state = M.initialize(consts, state, host_bc, cal)

    t_ref = np.asarray(state["t"][0]).copy()
    run = M.make_run_steps(consts)
    ctx, _ = M.build_step_ctx(cal, 2, 72)
    out = run(state, ctx)

    # vorticity/divergence stay at rest; T/ps hold the reference profile
    assert np.abs(np.asarray(out["vor"])).max() < 1e-12
    assert np.abs(np.asarray(out["div"])).max() < 1e-12
    drift = np.abs(np.asarray(out["t"][0]) - t_ref).max()
    assert drift < 1e-8, f"temperature drifted by {drift}"


def test_runtime_flag_increase_co2():
    """increase_co2 is a runtime state scalar (model_state_def.py:305-311):
    the daily forcing applies the CO2 absorptivity trend (forcing.f90:67-74)
    which feeds the longwave transmissivities and changes OLR."""
    consts, state, cal = make_demo_model(T30L8)
    run = M.make_run_steps(consts)

    st_co2 = dict(state)
    st_co2["increase_co2"] = np.asarray(True)
    # 40 steps from step 2 crosses the daily forcing boundary at step 36.
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 40)
    out_base = run(dict(state), ctx)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 40)
    out_co2 = run(st_co2, ctx)

    # 6.0 * exp(0.005 * (1982.x - 1950)) ~ 7.05
    assert float(out_co2["air_absortivity_co2"]) > 6.5
    assert float(out_base["air_absortivity_co2"]) == pytest.approx(6.0)
    d_olr = np.abs(np.asarray(out_co2["olr"])
                   - np.asarray(out_base["olr"])).max()
    assert d_olr > 0.05, "increase_co2 must change outgoing longwave"


def test_runtime_flag_land_coupling():
    """land_coupling_flag=False pins land temperature to the interpolated
    climatology and freezes the slab model (land_model.f90:179-187)."""
    consts, state, cal = make_demo_model(T30L8)
    run = M.make_run_steps(consts)

    st_off = dict(state)
    st_off["land_coupling_flag"] = np.asarray(False)
    stl_lm_before = np.asarray(state["stl_lm"]).copy()
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 40)
    out_on = run(dict(state), ctx)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 40)
    out_off = run(st_off, ctx)

    np.testing.assert_allclose(np.asarray(out_off["land_temp"]),
                               np.asarray(out_off["stlcl_obs"]),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out_off["stl_lm"]),
                                  stl_lm_before)
    d = np.abs(np.asarray(out_on["land_temp"])
               - np.asarray(out_on["stlcl_obs"])).max()
    assert d > 0.01, "coupled land temperature must deviate from climatology"


def test_runtime_flag_sst_anomaly_coupling():
    """sst_anomaly_coupling_flag gates the observed SST anomaly into
    sstan_am/sst_am (sea_model.f90:218-222, 278-282)."""
    consts, state, cal = make_demo_model(T30L8)
    run = M.make_run_steps(consts)

    state = dict(state)
    state["sst_anom"] = 2.0 * np.ones_like(np.asarray(state["sst_anom"]))
    st_off = dict(state)
    st_off["sst_anomaly_coupling_flag"] = np.asarray(False)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 4)
    out_on = run(dict(state), ctx)
    ctx, _ = M.build_step_ctx(dataclasses.replace(cal), 2, 4)
    out_off = run(st_off, ctx)

    assert np.abs(np.asarray(out_off["sstan_am"])).max() == 0.0
    assert np.abs(np.asarray(out_on["sstan_am"])).max() > 1.0


@pytest.mark.parametrize("preset", ["T30L5", "T30L7", "T47L8", "T63L8"])
def test_other_resolutions_run(preset):
    """Beyond the reference's fixed T30L8: other vertical/horizontal
    resolutions run stably from synthetic BCs (full physics). The presets
    scale dt and the diffusion times with truncation (params.py); T47/T63
    stability over 5 days on the GPU is gated by chip_smoke.py."""
    import pyspeedy_tpu.params as P

    params = getattr(P, preset)
    consts, state = run_days(params, 2)
    assert not bool(state["error_flag"])
    assert np.isfinite(np.asarray(state["t"])).all()


def test_grid_phi_matches_spectral_path():
    """consts.grid_phi reconstructs the physics-path geopotential by
    grid-space hydrostatic integration (models/geopotential.py
    get_geopotential_grid) — a re-association of two commuting linear
    operators, so trajectories must agree to rounding."""
    import dataclasses

    import jax
    import numpy as np

    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.ops import spectral as S
    from pyspeedy_tpu.models.geopotential import (get_geopotential,
                                                  get_geopotential_grid)
    from pyspeedy_tpu.params import T30L8
    from pyspeedy_tpu.testing import make_demo_model

    params = dataclasses.replace(T30L8, fft_mode="matmul")
    consts, state, cal = make_demo_model(params)
    assert "phisg" in state

    # Direct operator identity: spec2grid(phi) == grid-space recursion.
    phi = get_geopotential(consts.gp, state["t"][0], state["phis"])
    phig_ref = S.spec2grid_p(consts.sp, phi, 1)
    tg = S.spec2grid_p(consts.sp, state["t"][0], 1)
    phig = get_geopotential_grid(consts.gp, consts.sp, tg, state["t"][0],
                                 state["phisg"])
    np.testing.assert_allclose(np.asarray(phig), np.asarray(phig_ref),
                               rtol=0, atol=1e-9 * np.abs(phig_ref).max())

    # Trajectory agreement over a few steps (chaotic growth from the ulp
    # re-association stays tiny at this horizon in f64).
    ctx, _ = M.build_step_ctx(cal, 2, 6)
    run_off = M.make_run_steps(consts, phase=2)
    out_off = run_off(dict(state), ctx)
    consts_on = dataclasses.replace(consts, grid_phi=True)
    run_on = M.make_run_steps(consts_on, phase=2)
    out_on = run_on(dict(state), ctx)
    for name in ("vor", "div", "t", "ps"):
        for lev in range(2):
            a = np.asarray(out_off[name][lev])
            b = np.asarray(out_on[name][lev])
            scale = np.abs(a).max() or 1.0
            assert np.abs(a - b).max() / scale < 1e-10, (name, lev)
    assert not bool(out_on["error_flag"])


def test_bf16_tendencies_bounded_divergence():
    """consts.bf16_tendencies rounds each per-step tendency to bfloat16
    (~2^-9 relative on increments): short-horizon trajectories must stay
    finite, diagnostics-clean, and within increment-rounding distance of
    the f32 path — and must actually DIVERGE from it (a zero delta means
    the flag is dead code: make_run_steps strips the flag, so this drives
    make_run_steps_batched, which keeps consts flags)."""
    import dataclasses

    import numpy as np

    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.parallel.ensemble import (broadcast_state,
                                                make_run_steps_batched)
    from pyspeedy_tpu.params import T30L8
    from pyspeedy_tpu.testing import make_demo_model

    params = dataclasses.replace(T30L8, precision="f32", fft_mode="matmul")
    consts, state, cal = make_demo_model(params)
    ctx, _ = M.build_step_ctx(cal, 2, 6)
    bstate = broadcast_state(state, 1)
    out_a = make_run_steps_batched(consts, phase=2)(dict(bstate), ctx)
    c_b = dataclasses.replace(consts, bf16_tendencies=True)
    out_b = make_run_steps_batched(c_b, phase=2)(dict(bstate), ctx)
    assert not bool(np.asarray(out_b["error_flag"]).any())
    max_rel = 0.0
    for name, bound in (("t", 1e-3), ("ps", 1e-3), ("vor", 5e-2),
                        ("div", 5e-2)):
        a = np.asarray(out_a[name][0][0])
        b = np.asarray(out_b[name][0][0])
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max() or 1.0
        rel = np.abs(a - b).max() / scale
        assert rel < bound, (name, rel)
        max_rel = max(max_rel, rel)
    # The bf16 path must be exercised: identical trajectories mean the
    # rounding never happened.
    assert max_rel > 1e-8, "bf16_tendencies had no effect (dead flag?)"
