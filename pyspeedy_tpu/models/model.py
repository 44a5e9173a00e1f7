"""Model assembly: constants container, state allocation, the full
initialization sequence, and the jitted multi-step integrator.

Reference call-stack parity: initialization.f90:13-91 for `initialize`,
speedy.f90:20-74 (do_single_step) for the per-step sequence inside
`run_steps`. The N-step loop is a single lax.scan with per-step calendar
scalars precomputed on the host, so an arbitrary number of steps runs as one
XLA computation with no host round-trips.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from ..coupling.forcing import set_forcing
from ..coupling.coupler import couple_sea_land, initialize_coupler
from ..coupling.land import land_model_init
from ..coupling.sea import sea_model_init
from ..ops import spectral as S
from ..ops.geometry import Geometry, build_geometry
from ..params import ModelParams
from ..physics.driver import get_physical_tendencies
from ..physics.longwave_radiation import radset
from ..physics.surface_fluxes import set_orog_land_sfc_drag
from ..physics import sppt as sppt_mod
from ..registry import MODEL_STATE_VARS, internal_shape, is_tlev
from ..utils.calendar import ModelCalendar
from .diagnostics import check_diagnostics
from .geopotential import build_geopot
from .implicit import build_hordif, build_implicit
from .prognostics import initialize_from_rest_state
from .timestep import step

__all__ = ["Consts", "build_consts", "allocate_state", "initialize",
           "build_step_ctx", "make_run_steps", "SpeedyError"]


class SpeedyError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Consts:
    """Static tables and flags closed over by the jitted step functions."""

    params: ModelParams
    sp: Any                 # SpectralTransform
    geom: Geometry          # jnp arrays in the model dtype
    hd: Any                 # HorDiffusion
    gp: Any                 # GeopotTables
    implicit: Any           # ImplicitTables for the current dt
    fband: Any              # (301, 4)
    sppt: Any = None        # SpptTables (host constants) when params.sppt_on
    # NB: increase_co2 / land_coupling_flag / sst_anomaly_coupling_flag are
    # NOT consts: they are runtime-settable state scalars (traced values),
    # matching the reference registry (model_state_def.py:305-311, 377-383,
    # 412-418). See allocate_state for their defaults.
    sea_coupling_flag: int = 0  # compile-time in the reference (sea_model.f90:14-20)
    physics_on: bool = True
    # Reconstruct the physics-path geopotential by grid-space hydrostatic
    # integration of the already-transformed temperature instead of
    # inverse-transforming the phi stack (exact commutation of two linear
    # operators; saves kx field-levels of synthesis per step). Differs from
    # the reference-ordered spectral path only in summation order (ulp).
    # Off by default; no measurement on the GPU has shown it pays yet.
    grid_phi: bool = False
    # Emit the TENDENCY-class grid outputs (dynamics tendencies, flux-form
    # products, KE, physics tendency adds) in bfloat16, so the
    # direct-transform matrix products read 2-byte operands (f32
    # accumulation; spectral results stay f32). Rounds each per-step
    # increment at ~2^-9 relative; prognostic state and synthesis stay full
    # precision. Off by default; no measurement on the GPU has shown it pays
    # yet, and it needs a climate A/B before it may be turned on.
    bf16_tendencies: bool = False
    # Concatenate all per-step transforms into single mega-batched calls:
    # fewer, larger matrix products for single-member runs. The batched
    # ensemble runner turns it off (the concatenations materialize large
    # (members, ~90, il, ix) intermediates).
    fuse_transforms: bool = True

    def with_implicit(self, im) -> "Consts":
        return dataclasses.replace(self, implicit=im)


def _geom_jnp(params: ModelParams, geom_np: Geometry) -> Geometry:
    # Kept as *numpy* arrays: geometry scalars feed Python-level control flow
    # (e.g. sigma-level tests) inside traced functions, where a jnp constant
    # would become a tracer. XLA constant-folds them identically.
    dt = np.float64 if params.precision == "f64" else np.float32
    return Geometry(*(np.asarray(a, dtype=dt) for a in geom_np))


_CONSTS_CACHE: dict = {}
_RUN_FN_CACHE: dict = {}


def build_consts_cached(params: ModelParams, **flags):
    """Memoized build_consts: table construction and, more importantly, the
    jit caches keyed on the consts object are shared across model instances
    with identical configuration (the reference reuses module instances the
    same way)."""
    key = (params, tuple(sorted(flags.items())))
    if key not in _CONSTS_CACHE:
        _CONSTS_CACHE[key] = build_consts(params, **flags)
    return _CONSTS_CACHE[key]


def make_run_steps_cached(consts: Consts, phase: int | None = None):
    # The cache key is id(consts): the entry stores consts itself so the GC
    # can never recycle that id for a different Consts (a stale hit would
    # silently run the step with the wrong tables/resolution).
    key = (id(consts), phase)
    if key not in _RUN_FN_CACHE:
        _RUN_FN_CACHE[key] = (consts, make_run_steps(consts, phase))
    return _RUN_FN_CACHE[key][1]


def build_consts(params: ModelParams, **flags) -> tuple[Consts, Geometry]:
    """Build all static tables. Returns (consts, numpy geometry)."""
    geom_np = build_geometry(params)
    if params.fft_mode not in ("auto", "matmul", "fft"):
        raise ValueError(
            f"fft_mode must be 'auto', 'matmul' or 'fft', got "
            f"{params.fft_mode!r}")
    # fft_mode="auto": the dense DFT matrix product (with the dense
    # block-diagonal Legendre product) on accelerators, jnp.fft on the CPU.
    # Measured on an H100 (700 W), one grid->spectral->grid pair over 64
    # f32 field levels, device time: 70 us (matrix product) vs 26 us (cuFFT)
    # at 1 member, 5.13 vs 2.63 ms at 256 members, so cuFFT leads at both
    # sizes. (The matrix product's lower wall time for one isolated call at
    # 1 member, 87 vs 133-148 us, is per-call dispatch, which a scanned step
    # does not pay; and the 256-member pair compares the dense Legendre with
    # the m-batched one as well as the DFT with cuFFT.) The rule stays only
    # until an in-step comparison decides (ROADMAP speed item 3): the matrix
    # product is the form the "space" mesh axis shards, and the f32 gates
    # on the card ran with it.
    use_matmul = (params.fft_mode == "matmul"
                  or (params.fft_mode == "auto"
                      and jax.default_backend() != "cpu"))
    sp = S.build_spectral(params, geom_np, use_matmul_fft=use_matmul)
    hd = build_hordif(params, geom_np)
    gp = build_geopot(params, geom_np)
    im = build_implicit(params, geom_np, hd, 2.0 * params.delt)
    dt = np.float64 if params.precision == "f64" else np.float32
    fband = jnp.asarray(radset().astype(dt))
    sppt_tables = (sppt_mod.build_sppt_tables(params, np.asarray(sp.el2))
                   if params.sppt_on else None)
    consts = Consts(params=params, sp=sp, geom=_geom_jnp(params, geom_np),
                    hd=hd, gp=gp, implicit=im, fband=fband, sppt=sppt_tables,
                    **flags)
    return consts, geom_np


def allocate_state(params: ModelParams, n_months: int = 1) -> dict:
    """Zero-filled model state (the analog of ModelState_allocate,
    model_state.f90:358) in internal layouts, plus runtime extras.

    Arrays are created host-side (numpy): per-array device zeros would mean
    one small XLA compile per field; the first jitted call transfers the
    whole pytree at once."""
    rdt = np.float64 if params.precision == "f64" else np.float32
    state = {}
    for spec in MODEL_STATE_VARS:
        if spec.name == "current_step":
            continue  # host-side counter
        shape = internal_shape(params, spec, n_months=n_months)
        # Complex-kind (spectral) variables are stored as REAL pairs with a
        # leading c axis of size 2 (ops/spectral.py): no complex dtype in any
        # traced graph.
        dtype = {"c": rdt, "r": rdt, "i": np.int32, "l": bool}[spec.kind]
        cpre = (2,) if spec.kind == "c" else ()
        if is_tlev(spec):
            # Leapfrog time levels live as a tuple of per-level arrays (see
            # registry.internal_perm): t_levs is the leading internal axis.
            state[spec.name] = tuple(
                np.zeros(cpre + shape[1:], dtype=dtype)
                for _ in range(shape[0]))
        else:
            state[spec.name] = np.zeros(cpre + shape, dtype=dtype)
    # Defaults (model_state.f90 "Initialize default values")
    state["air_absortivity_co2"] = np.asarray(6.0, dtype=rdt)
    state["ablco2_ref"] = np.asarray(6.0, dtype=rdt)
    state["error_flag"] = np.asarray(False)
    # Runtime-settable flags (reference defaults, model_state_def.py:305-311,
    # 377-383, 412-418); consumed as traced values inside the step.
    state["increase_co2"] = np.asarray(False)
    state["land_coupling_flag"] = np.asarray(True)
    state["sst_anomaly_coupling_flag"] = np.asarray(True)
    if params.sppt_on:
        state.update(sppt_mod.init_sppt_state(params, jax.random.key(0)))
    return state


def _physics_fn(consts):
    return get_physical_tendencies if consts.physics_on else None


# Fields the per-step update writes. Everything else is loop-invariant during
# a run: boundary conditions, masks, climatologies, coordinates. Keeping them
# out of the scan carry (and out of the per-member ensemble batch) removes
# most of the per-step HBM traffic. tests/test_model_configs.py guards this
# set by checking the step leaves non-dynamic fields bitwise unchanged.
DYNAMIC_FIELDS = frozenset({
    # prognostics + diagnostics (timestep)
    "vor", "div", "t", "ps", "tr", "phi",
    # physics diagnostics
    "precnv", "precls", "cbmf", "tsr", "ssrd", "ssr", "slrd", "slr", "olr",
    "slru", "ustr", "vstr", "shf", "evap", "hfluxn", "tt_rsw", "rad_tau2",
    "rad_flux", "rad_st4a", "rad_strat_corr", "qcloud_equiv",
    # daily forcing
    "flux_solar_in", "flux_ozone_lower", "flux_ozone_upper",
    "zenit_correction", "stratospheric_correction", "snowc", "alb_land",
    "alb_sea", "alb_surface", "tcorh", "qcorh", "air_absortivity_co2",
    # coupled land/sea state
    "stlcl_obs", "snowdcl_obs", "soilwcl_obs", "land_temp", "snow_depth",
    "soil_avail_water", "stl_lm", "sstcl_ob", "sicecl_ob", "ticecl_ob",
    "sstan_ob", "sstan_am", "sst_am", "sice_am", "tice_am", "sst_om",
    "sice_om", "tice_om", "ssti_om",
    # runtime flags / stochastic physics. NB sppt_key is carried but NEVER
    # rewritten (counter-based noise keying, physics/sppt.py): XLA's
    # while-loop simplifier hoists the unchanged carry, so it costs nothing
    # per iteration (a per-step key rewrite would not be).
    "error_flag", "compute_shortwave",
    "sppt_spec", "sppt_key",
})


# Subset of DYNAMIC_FIELDS that every step recomputes from scratch BEFORE any
# consumer reads them: the physics driver writes precip/flux/radiation work
# arrays (physics.f90 ordering), and the land/sea coupler consumes hfluxn/shf/
# evap of the SAME step (speedy.f90:56-72). Nothing reads the previous step's
# value, so carrying them across scan iterations is pure HBM traffic — the
# batched ensemble runner drops them from the carry and returns the FINAL
# step's values member-batched (its last step group runs outside the scan),
# so registry reads after a batched run ARE current, matching the
# reference's parallel_step. The nstrad shortwave cache
# (tt_rsw/rad_tau2/rad_strat_corr/tsr/ssrd/ssr/qcloud_equiv) is NOT here: the
# cached branch reads the previous shortwave step's values.
EPHEMERAL_FIELDS = frozenset({
    "rad_flux", "rad_st4a", "slrd", "slr", "olr", "precnv", "precls",
    "cbmf", "ustr", "vstr", "shf", "evap", "slru", "hfluxn",
})


def split_state(state: dict, carry_fields=DYNAMIC_FIELDS):
    """(dynamic, static) partition of the state dict."""
    dyn = {k: v for k, v in state.items() if k in carry_fields}
    static = {k: v for k, v in state.items() if k not in carry_fields}
    return dyn, static


_DEVICE_INIT_CACHE: dict = {}


def _make_device_init(consts: Consts, geom_np: Geometry):
    """Jitted device-side initialization, cached per consts so repeated model
    constructions (tests, ensembles) reuse one compilation. Calendar scalars
    are traced arguments, so any start date hits the same executable."""
    # Keyed by id(consts); the entry pins consts so the id cannot be recycled
    # (see make_run_steps_cached).
    consts_outer = consts
    key = id(consts)
    if key in _DEVICE_INIT_CACHE:
        return _DEVICE_INIT_CACHE[key][1]

    # Initialization keeps full-precision tendencies (see make_run_steps).
    consts = dataclasses.replace(consts, bf16_tendencies=False)
    params = consts.params
    sp = consts.sp
    im_half = build_implicit(params, geom_np, consts.hd, 0.5 * params.delt)
    im_full = build_implicit(params, geom_np, consts.hd, params.delt)
    pf = _physics_fn(consts)

    # Split into three jits: compile time grows superlinearly with graph
    # size, and the two bootstrap steps are each about the size of a
    # regular step.
    @jax.jit
    def _init_fields(st, cs):
        st = dict(st)
        phi0 = pc.GRAV * st["orog"]
        st["phi0"] = phi0
        st["phis0"] = S.grid_filter(sp, phi0)
        st["forog"] = set_orog_land_sfc_drag(st["phis0"])
        st["fband"] = consts.fband

        # Prognostics from the rest state (prognostics.f90:22-120)
        st = initialize_from_rest_state(consts, st)
        bad0 = check_diagnostics(consts, st, 0)

        # Coupler day-0 exchange (coupler.f90:12-32)
        st = initialize_coupler(consts, st, cs["imont1"], cs["tmonth"],
                                cs["month_idx"])

        # Forcing, imode=0 (forcing.f90:43-48 + daily part)
        st["ablco2_ref"] = st["air_absortivity_co2"]
        st = set_forcing(consts, st, cs["year_frac"], cs["tyear"])
        st["error_flag"] = st["error_flag"] | bad0
        return st, bad0

    # First-step bootstrap: dt/2, dt (time_stepping.f90:13-27). The
    # reference's compute_shortwave flag defaults to .true.
    # (model_state.f90:780), so both bootstrap steps run shortwave.
    # stepno feeds the counter-based SPPT noise keying (physics/sppt.py);
    # the regular run starts at current_step=2.
    @jax.jit
    def _boot_half(st):
        return step(consts.with_implicit(im_half), st, 1, 1,
                    0.5 * params.delt, pf,
                    {"compute_shortwave": True, "stepno": 0})

    @jax.jit
    def _boot_full(st):
        return step(consts.with_implicit(im_full), st, 1, 2,
                    params.delt, pf,
                    {"compute_shortwave": True, "stepno": 1})

    def _device_init(st, cs):
        st, bad0 = _init_fields(st, cs)
        st = _boot_half(st)
        st = _boot_full(st)
        return st, bad0

    _DEVICE_INIT_CACHE[key] = (consts_outer, _device_init)
    return _device_init


def initialize(consts: Consts, state: dict, host_bc: dict,
               cal: ModelCalendar) -> dict:
    """Full initialization sequence (initialization.f90:13-91):
    boundaries -> rest-state prognostics -> coupler init -> forcing ->
    first_step bootstrap. host_bc holds the numpy BC fields in internal
    (month/lat/lon-leading) layouts."""
    params = consts.params
    sp = consts.sp
    geom_np = host_bc["_geom_np"]
    rdt = np.float64 if params.precision == "f64" else np.float32

    # Boundary fields (boundaries.f90:22-37) + host-side land/sea model
    # initialization (numpy; needs only the raw BC arrays).
    state = dict(state)
    for name in ("orog", "fmask_orig", "alb0", "veg_high", "veg_low",
                 "soil_wc_l1", "soil_wc_l2", "soil_wc_l3"):
        state[name] = host_bc[name].astype(rdt)

    land = land_model_init(params, {k: host_bc[k] for k in (
        "fmask_orig", "stl12", "snowd12", "veg_high", "veg_low",
        "soil_wc_l1", "soil_wc_l2", "alb0")})
    for k, v in land.items():
        state[k] = v.astype(rdt)

    sea = sea_model_init(params, {k: host_bc[k] for k in (
        "fmask_orig", "sst12", "sea_ice_frac12", "sst_anom")},
        geom_np.radang)
    for k, v in sea.items():
        state[k] = v.astype(rdt)

    # Everything else runs on device as ONE jitted computation (eager
    # op-by-op execution would mean hundreds of tiny compiles).
    device_init = _make_device_init(consts, geom_np)
    cal_scalars = {
        "imont1": jnp.asarray(cal.imont1, dtype=jnp.int32),
        "tmonth": jnp.asarray(cal.tmonth, dtype=params.dtype),
        "month_idx": jnp.asarray(cal.month_idx, dtype=jnp.int32),
        "year_frac": jnp.asarray(cal.year + cal.tyear, dtype=params.dtype),
        "tyear": jnp.asarray(cal.tyear, dtype=params.dtype),
    }
    # Stationary-variance SPPT initialization (sppt.f90:92) before the
    # bootstrap steps advance the AR(1) state — eliminates the first-step
    # flag from the scan carry entirely (see physics/sppt.py).
    if params.sppt_on:
        state["sppt_spec"] = sppt_mod.stationary_draw(consts,
                                                      state["sppt_key"])

    state, bad0 = device_init(state, cal_scalars)
    if bool(bad0):
        raise SpeedyError("Initial state failed the diagnostics check")

    # Coordinates (initialization.f90:85-87)
    state["lev"] = jnp.asarray(geom_np.fsg.astype(rdt))
    state["lon"] = jnp.asarray((360.0 / params.ix
                                * np.arange(params.ix)).astype(rdt))
    state["lat"] = jnp.asarray(
        (geom_np.radang * 90.0 / np.arcsin(1.0)).astype(rdt))
    return state


def build_step_ctx(cal: ModelCalendar, current_step: int, n_steps: int):
    """Precompute per-step calendar scalars for an n-step scan.

    Returns (ctx dict of stacked arrays, calendar after n steps). For step i:
    do_forcing/tyear/year_frac describe the pre-step date; imont1/tmonth/
    month_idx the post-advance date used by the coupler (speedy.f90:47-72).
    """
    do_forcing = np.zeros(n_steps, dtype=bool)
    compute_sw = np.zeros(n_steps, dtype=bool)
    tyear = np.zeros(n_steps)
    year_frac = np.zeros(n_steps)
    imont1 = np.zeros(n_steps, dtype=np.int32)
    tmonth = np.zeros(n_steps)
    month_idx = np.zeros(n_steps, dtype=np.int32)

    params_nsteps = cal.nsteps
    for i in range(n_steps):
        stepno = current_step + i
        do_forcing[i] = stepno % params_nsteps == 0
        compute_sw[i] = stepno % 3 == 0
        tyear[i] = cal.tyear
        year_frac[i] = cal.year + cal.tyear
        cal.advance()
        imont1[i] = cal.imont1
        tmonth[i] = cal.tmonth
        month_idx[i] = cal.month_idx

    ctx = {
        "do_forcing": jnp.asarray(do_forcing),
        "compute_shortwave": jnp.asarray(compute_sw),
        "tyear": jnp.asarray(tyear),
        "year_frac": jnp.asarray(year_frac),
        "imont1": jnp.asarray(imont1),
        "tmonth": jnp.asarray(tmonth),
        "month_idx": jnp.asarray(month_idx),
        # Absolute step index: keys the counter-based SPPT noise
        # (physics/sppt.py) — restart- and window-boundary-invariant.
        "stepno": jnp.asarray(
            np.arange(current_step, current_step + n_steps,
                      dtype=np.int32)),
    }
    return ctx, cal


def make_single_step(consts: Consts, static_sw=None):
    """The full per-step update (the body of do_single_step,
    speedy.f90:20-74) as a pure state -> state function; ctx_i carries the
    step's calendar scalars.

    static_sw: None for a traced compute_shortwave (lax.cond inside the
    physics driver), or a Python bool to specialize the step on its phase in
    the deterministic nstrad=3 cadence (no cond, no conditional copies of the
    radiation caches)."""
    params = consts.params
    pf = _physics_fn(consts)

    def single_step(state, ctx_i):
        # Calendar scalars arrive at the ambient float width; cast to the
        # model dtype so cond branches agree in mixed-precision runs.
        ctx_i = dict(ctx_i)
        for k in ("tyear", "year_frac", "tmonth"):
            ctx_i[k] = ctx_i[k].astype(params.dtype)

        # Daily forcing (speedy.f90:47-50)
        def with_forcing(st):
            return set_forcing(consts, st, ctx_i["year_frac"], ctx_i["tyear"])

        state = jax.lax.cond(ctx_i["do_forcing"], with_forcing,
                             lambda st: dict(st), state)

        sw = ctx_i["compute_shortwave"] if static_sw is None else static_sw
        state["compute_shortwave"] = jnp.asarray(sw)
        pctx = {"compute_shortwave": sw}
        if "stepno" in ctx_i:
            pctx["stepno"] = ctx_i["stepno"]
        if "sppt_pattern" in ctx_i:
            # Group-precomputed SPPT pattern (see physics/driver.py).
            pctx["sppt_pattern"] = ctx_i["sppt_pattern"]
        state = step(consts, state, 2, 2, 2.0 * params.delt, pf, pctx)

        bad = check_diagnostics(consts, state, 1)
        state["error_flag"] = state["error_flag"] | bad

        # Coupler exchange at the advanced date (speedy.f90:69-72)
        state = couple_sea_land(consts, state, ctx_i["imont1"],
                                ctx_i["tmonth"], ctx_i["month_idx"])
        return state

    return single_step


def make_run_steps(consts: Consts, phase: int | None = None,
                   unroll: int = 1):
    """Build the jitted n-step integrator (shapes specialize on n).

    Only the DYNAMIC_FIELDS travel through the scan carry; the invariant
    fields ride as loop constants.

    phase: current_step % 3 at the first step of the scan. When given, the
    scan runs over triples of steps with the shortwave flag specialized
    statically per position (requires n_steps % 3 == 0); when None, every
    step carries a traced flag through lax.cond.

    The single-member integrator always keeps full-precision tendencies:
    bf16_tendencies is an option of the batched runner
    (parallel/ensemble.py), which keeps the consts flags."""
    consts = dataclasses.replace(consts, bf16_tendencies=False)
    if phase is None:
        single_step = make_single_step(consts)

        @jax.jit
        def run_steps(state, ctx):
            dyn, static = split_state(state)

            def body(d, ctx_i):
                out = single_step({**static, **d}, ctx_i)
                return {k: out[k] for k in d}, None

            dyn, _ = jax.lax.scan(body, dyn, ctx, unroll=unroll)
            return {**static, **dyn}

        return run_steps

    # Shortwave runs when stepno % 3 == 0 (speedy.f90:53); position j of each
    # triple is stepno = first + 3*i + j, so the pattern is phase-periodic.
    steps3 = [make_single_step(consts, static_sw=((phase + j) % 3 == 0))
              for j in range(3)]
    sppt_grouped = consts.params.sppt_on and consts.physics_on

    @jax.jit
    def run_steps3(state, ctx):
        dyn, static = split_state(state)
        ctx3 = jax.tree.map(lambda a: a.reshape((-1, 3) + a.shape[1:]), ctx)

        def body(d, ctx_t):
            st = {**static, **d}
            if sppt_grouped:
                # One fused RNG draw + one batched inverse transform per
                # triple (the per-step form is launch-bound; see sppt.py).
                pats, st = sppt_mod.gen_sppt_n(consts, st, 3,
                                               ctx_t["stepno"][0])
            for j, fn in enumerate(steps3):
                ctx_j = {k: v[j] for k, v in ctx_t.items()}
                if sppt_grouped:
                    ctx_j["sppt_pattern"] = pats[j]
                st = fn(st, ctx_j)
            return {k: st[k] for k in d}, None

        dyn, _ = jax.lax.scan(body, dyn, ctx3, unroll=unroll)
        return {**static, **dyn}

    return run_steps3
