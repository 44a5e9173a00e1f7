"""Column-physics driver (reference: speedy.f90/physics.f90).

Sequencing matches physics.f90:14-256: convection -> large-scale condensation
-> shortwave (every nstrad steps, with absorbed fluxes and LW transmissivities
cached in the state) -> longwave down -> surface fluxes -> longwave up ->
vertical diffusion -> surface-flux tendencies -> SPPT.

Structure: `grid_physics` is the whole grid-space physics chain as a pure
function of explicit arrays (no state dict), column-local by construction.
`get_physical_tendencies` is the state-dict glue around it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from ..ops import spectral as S
from . import convection as conv
from . import large_scale_condensation as lsc
from . import longwave_radiation as lw
from . import shortwave_radiation as sw
from . import surface_fluxes as sflx
from . import vertical_diffusion as vdif
from .humidity import spec_hum_to_rel_hum
from .sppt import gen_sppt

__all__ = ["get_physical_tendencies", "grid_physics", "BC_FIELDS",
           "CACHE_FIELDS", "DIAG_FIELDS"]

# 2D boundary/forcing fields consumed by the grid physics (read-only here).
BC_FIELDS = (
    "fmask_land", "phis0", "forog", "sst_am", "alb_land", "alb_sea",
    "alb_surface", "snowc", "land_temp", "soil_avail_water",
    "zenit_correction", "flux_solar_in", "flux_ozone_upper",
    "flux_ozone_lower", "stratospheric_correction", "ssti_om",
)

# The nstrad shortwave cache: read on every step, rewritten on SW steps.
CACHE_FIELDS = ("tt_rsw", "rad_tau2", "rad_strat_corr", "tsr", "ssrd",
                "ssr", "qcloud_equiv")

# Per-step diagnostics written back into the state.
DIAG_FIELDS = ("cbmf", "precnv", "precls", "slrd", "slr", "olr",
               "ustr", "vstr", "shf", "evap", "slru", "hfluxn",
               "rad_flux", "rad_st4a")


def grid_physics(consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc, cache,
                 ablco2, sppt_pattern=None):
    """The full grid-space physics chain (physics.f90:107-232) on explicit
    arrays. Returns (utend, vtend, ttend, qtend, diag, new_cache) where the
    tendencies are the PHYSICS-ONLY contributions (added to the dynamics
    tendencies by the caller) and diag/new_cache are tuples ordered as
    DIAG_FIELDS / CACHE_FIELDS.

    sw_flag: Python bool (statically specialized step) or traced bool
    (lax.cond). All operations are column-local: elementwise over (il, ix)
    with reductions only along the level/band axes.
    """
    geom = consts.geom
    params = consts.params
    kx = params.kx
    (fmask_land, phis0, forog, sst_am, alb_land, alb_sea, alb_surface,
     snowc, land_temp, soil_avail_water, zenit_correction, flux_solar_in,
     flux_ozone_upper, flux_ozone_lower, stratospheric_correction,
     ssti_om) = bc
    if cache:
        tt_rsw_c, rad_tau2_c, rad_sc_c, tsr_c, ssrd_c, ssr_c, qcloud_c = cache
    else:
        # Statically shortwave-specialized steps recompute the whole cache
        # (SW-aligned scans carry none): the cached branch is dead code.
        assert sw_flag is True, "empty cache requires a static SW step"
        tt_rsw_c = rad_tau2_c = rad_sc_c = tsr_c = ssrd_c = ssr_c = \
            qcloud_c = None

    # --- thermodynamics (physics.f90:107-116) ---
    psg = jnp.exp(pslg)
    rps = 1.0 / psg
    qg = jnp.maximum(qg, 0.0)
    se = pc.CP * tg + phig
    rh, qsat = spec_hum_to_rel_hum(tg, psg, geom.fsg[:, None, None], qg)

    # --- deep convection (physics.f90:123-132) ---
    iptop, cbmf, precnv, dfse, dfqa = conv.get_convection_tendencies(
        geom, psg, se, qg, qsat)
    # Flux -> tendency scaling for levels 2..kx (physics.f90:127-130);
    # level 1 carries no convective flux, so a masked multiply is exact.
    lvl_mask = np.ones((kx, 1, 1))
    lvl_mask[0] = 0.0
    lvl_mask = jnp.asarray(lvl_mask, dtype=dfse.dtype)
    scale_t = rps * geom.grdscp[:, None, None]
    scale_q = rps * geom.grdsig[:, None, None]
    tt_cnv = dfse * (scale_t * lvl_mask)
    qt_cnv = dfqa * (scale_q * lvl_mask)
    icnv = kx - iptop

    # --- large-scale condensation (physics.f90:135-139) ---
    iptop, precls, tt_lsc, qt_lsc = lsc.get_large_scale_condensation_tendencies(
        geom, psg, qg, qsat, iptop)

    ttend = tt_cnv + tt_lsc
    qtend = qt_cnv + qt_lsc

    # --- shortwave (every nstrad steps; physics.f90:151-169) ---
    sw_state = {
        "zenit_correction": zenit_correction,
        "flux_solar_in": flux_solar_in,
        "flux_ozone_upper": flux_ozone_upper,
        "flux_ozone_lower": flux_ozone_lower,
        "alb_surface": alb_surface,
        "stratospheric_correction": stratospheric_correction,
        "air_absortivity_co2": ablco2,
    }

    def sw_branch(_):
        gse = (se[kx - 2] - se[kx - 1]) / (phig[kx - 2] - phig[kx - 1])
        icltop, cloudc, clstr, qcloud = sw.clouds(
            qg, rh, precnv, precls, iptop, gse, fmask_land)
        st = dict(sw_state)
        st["qcloud_equiv"] = qcloud
        tsr, ssrd, ssr, tt_flux, rad_tau2, rad_sc = sw.get_shortwave_rad_fluxes(
            geom, st, psg, qg, icltop, cloudc, clstr)
        tt_rsw = tt_flux * scale_t
        return tt_rsw, rad_tau2, rad_sc, tsr, ssrd, ssr, qcloud

    def cached_branch(_):
        return (tt_rsw_c, rad_tau2_c, rad_sc_c, tsr_c, ssrd_c, ssr_c,
                qcloud_c)

    # Statically-specialized steps (the nstrad=3 cadence is deterministic)
    # skip the cond entirely: the radiation caches flow straight through.
    if isinstance(sw_flag, bool):
        tt_rsw, rad_tau2, rad_sc, tsr, ssrd, ssr, qcloud = (
            sw_branch(None) if sw_flag else cached_branch(None))
    else:
        tt_rsw, rad_tau2, rad_sc, tsr, ssrd, ssr, qcloud = jax.lax.cond(
            sw_flag, sw_branch, cached_branch, None)

    # --- longwave downward (physics.f90:172-174) ---
    fband = consts.fband
    slrd, tt_rlw, rad_flux, rad_st4a = lw.get_downward_longwave_rad_fluxes(
        geom, fband, rad_tau2, tg)

    # --- surface fluxes (physics.f90:177-198) ---
    fl = sflx.get_surface_fluxes(
        geom, psg, ug, vg, tg, qg, rh, phig,
        phis0, fmask_land, forog, sst_am,
        ssrd, slrd, alb_land, alb_sea, snowc,
        land_temp, soil_avail_water, lfluxland=True)
    if consts.sea_coupling_flag > 0:
        # second, sea-only call with the ocean-model SST (physics.f90:186-195)
        fl = sflx.get_surface_fluxes(
            geom, psg, ug, vg, tg, qg, rh, phig,
            phis0, fmask_land, forog, ssti_om,
            ssrd, slrd, alb_land, alb_sea, snowc,
            land_temp, soil_avail_water, lfluxland=False, prev=fl["_carry"])
    hfluxn3 = jnp.concatenate(
        [fl["hfluxn"], jnp.zeros_like(fl["hfluxn"][:1])])

    # --- longwave upward (physics.f90:202-211) ---
    fsfc, ftop, tt_rlw = lw.get_upward_longwave_rad_fluxes(
        geom, fband, rad_tau2, rad_st4a, rad_sc, tg, fl["tsfc"], slrd,
        fl["slru"][2], tt_rlw, rad_flux)
    tt_rlw = tt_rlw * scale_t

    ttend = ttend + tt_rsw + tt_rlw

    # --- vertical diffusion + shallow convection (physics.f90:218-220) ---
    utend, vtend, tt_pbl, qt_pbl = vdif.get_vertical_diffusion_tend(
        geom, se, rh, qg, qsat, phig, icnv)

    # surface-flux tendencies into the lowest layer (physics.f90:223-226),
    # fused one-hot adds instead of scattered updates
    bot = np.zeros((kx, 1, 1))
    bot[kx - 1] = 1.0
    bot = jnp.asarray(bot, dtype=ttend.dtype)
    gsig = rps * geom.grdsig[kx - 1]
    gscp = rps * geom.grdscp[kx - 1]
    utend = utend + bot * (fl["ustr"][2] * gsig)
    vtend = vtend + bot * (fl["vstr"][2] * gsig)
    ttend = ttend + tt_pbl + bot * (fl["shf"][2] * gscp)
    qtend = qtend + qt_pbl + bot * (fl["evap"][2] * gsig)

    diag = (cbmf, precnv, precls, slrd, fsfc, ftop,
            fl["ustr"], fl["vstr"], fl["shf"], fl["evap"], fl["slru"],
            hfluxn3, rad_flux, rad_st4a)
    new_cache = (tt_rsw, rad_tau2, rad_sc, tsr, ssrd, ssr, qcloud)
    if sppt_pattern is not None:
        # SPPT multiplies the PHYSICS-ONLY tendency by 1 + pattern
        # (physics.f90:234-248: f*(tend - tend_dyn) + tend_dyn, and the
        # outputs here ARE tend - tend_dyn). Applied in-body so it fuses
        # with the chain and precedes the bf16 cast. mu = 1: no vertical
        # tapering (sppt.f90:20).
        f = 1.0 + sppt_pattern
        utend = f * utend
        vtend = f * vtend
        ttend = f * ttend
        qtend = f * qtend
    if consts.bf16_tendencies:
        # Tendency-class outputs only (see Consts.bf16_tendencies);
        # diagnostics and the radiation cache stay full precision.
        utend, vtend, ttend, qtend = (
            x.astype(jnp.bfloat16) for x in (utend, vtend, ttend, qtend))
    return utend, vtend, ttend, qtend, diag, new_cache


def get_physical_tendencies(consts, state, ctx, utend, vtend, ttend, trtend):
    """Add physics tendencies at time level 0 (physics.f90:14-256).

    ctx["compute_shortwave"] selects the cached-vs-fresh shortwave branch
    (a Python bool in phase-specialized scans). Returns
    (utend, vtend, ttend, trtend, state)."""
    sp = consts.sp
    params = consts.params

    # --- prognostics to grid at time level 0 (physics.f90:89-101) ---
    from ..models.tendencies import _multi_spec2grid

    ucos, vcos = S.vort2vel_p(sp, state["vor"][0], state["div"][0])
    sw_flag = ctx["compute_shortwave"]
    if consts.grid_phi:
        # phig by grid-space hydrostatic integration of tg (exact
        # commutation; saves the kx-level phi synthesis stack).
        from ..models.geopotential import get_geopotential_grid

        ug, vg, tg, qg, pslg1 = _multi_spec2grid(
            sp,
            [ucos, vcos, state["t"][0], state["tr"][0][:, 0],
             state["ps"][0][:, None]],
            consts.fuse_transforms)
        phig = get_geopotential_grid(consts.gp, sp, tg, state["t"][0],
                                     state["phisg"])
    else:
        ug, vg, tg, qg, phig, pslg1 = _multi_spec2grid(
            sp,
            [ucos, vcos, state["t"][0], state["tr"][0][:, 0], state["phi"],
             state["ps"][0][:, None]],
            consts.fuse_transforms)
    rcos = sp.cosgr[:, None]
    ug = ug * rcos
    vg = vg * rcos
    pslg = pslg1[0]

    bc = tuple(state[name] for name in BC_FIELDS)
    # Statically-SW steps never read the cache: pass none (the SW-aligned
    # batched scan does not carry the CACHE_FIELDS at all).
    if sw_flag is True:
        cache = ()
    else:
        cache = tuple(state[name] for name in CACHE_FIELDS)

    # SPPT pattern for this step (physics.f90:234-248): generated up front —
    # it depends only on the AR(1) state — and applied to the physics-only
    # tendencies inside grid_physics. Scan
    # bodies that group several steps precompute the group's patterns in one
    # batched gen_sppt_n call (launch-bound at small ensembles) and inject
    # them via ctx["sppt_pattern"]; the driver then skips generation.
    sppt_pattern = None
    if params.sppt_on:
        sppt_pattern = ctx.get("sppt_pattern") if ctx else None
        if sppt_pattern is None:
            sppt_pattern, state = gen_sppt(consts, state, ctx["stepno"])

    ut, vt, tt, qt, diag, new_cache = grid_physics(
        consts, sw_flag, ug, vg, tg, qg, phig, pslg, bc, cache,
        state["air_absortivity_co2"], sppt_pattern=sppt_pattern)

    state = dict(state)
    state.update(zip(DIAG_FIELDS, diag))
    state.update(zip(CACHE_FIELDS, new_cache))

    utend = utend + ut
    vtend = vtend + vt
    ttend = ttend + tt
    qtend = trtend[0] + qt

    trtend = jnp.concatenate([qtend[None], trtend[1:]])
    return utend, vtend, ttend, trtend, state
