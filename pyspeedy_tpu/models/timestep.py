"""Leapfrog time stepping with Robert-Williams filtering and horizontal
diffusion (reference: speedy.f90/time_stepping.f90)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from ..ops import spectral as S
from .tendencies import get_tendencies

__all__ = ["step", "hordif", "leapfrog_pair", "sdrag_mask"]


def hordif(field, fdt, dmp, dmp1):
    """fdt_out = (fdt - dmp*field) * dmp1 (horizontal_diffusion.f90:131-152).
    dmp/dmp1 are (mx, nx); field/fdt have trailing (mx, nx). Shared by this
    module's legacy path and the spectral-glue kernel function."""
    return (fdt - dmp * field) * dmp1


def leapfrog_pair(params, trfilt, j1: int, dt, eps, f0, f1, fdt,
                  do_truncate: bool):
    """Leapfrog + Robert-Williams filter update of one prognostic pair
    (time_stepping.f90:164-188). j1 is 1-based as in the reference: (1,1)
    forward, (1,2) initial leapfrog, (2,2) filtered. Returns (new0, new1)."""
    if do_truncate:
        fdt = fdt * trfilt
    fj = f0 if j1 == 1 else f1
    fnew = f0 + dt * fdt
    g1 = fj + params.wil * eps * (f0 - 2.0 * fj + fnew)
    # The reference computes the second-level filter displacement with the
    # already-updated first level (sequential aliasing in step_field_2d).
    g2 = fnew - (1.0 - params.wil) * eps * (g1 - 2.0 * fj + fnew)
    return (g1, g2)


def sdrag_mask(kx: int, mx: int, dtype):
    """One-hot (kx, mx, 1) mask selecting the top-level zonal-mean mode for
    the stratospheric drag (time_stepping.f90:92-100), applied as a fused
    masked subtract instead of a scattered update."""
    m00 = np.zeros((kx, mx, 1))
    m00[0, 0, 0] = 1.0
    return jnp.asarray(m00, dtype=dtype)


def _step_field(params, sp, j1: int, dt, eps, f, fdt):
    """leapfrog_pair on a (lev0, lev1) tuple field (time levels are pytree
    tuple elements, not a stacked axis — level selection is free at trace
    time); truncation applies on the quadratic grids (ix == 4iy)."""
    return leapfrog_pair(params, sp.trfilt, j1, dt, eps, f[0], f[1], fdt,
                         params.ix == params.iy * 4)


def step(consts, state, j1: int, j2: int, dt: float, physics_fn=None, ctx=None):
    """One (half/full/leapfrog) step (time_stepping.f90:38-147).

    j1/j2 are the reference's 1-based time-level selectors; dt the step
    length. consts.implicit must hold the tables for this dt.

    For the default semi-implicit configuration (alph >= 0.5) the whole
    spectral side — flux combination, linear tendencies, implicit
    correction, diffusion, leapfrog — runs through
    spectral_glue.apply_spectral_update (reference-ordered XLA). The
    explicit gravity-wave branch below (alph < 0.5, dead at the
    reference default) keeps the original op-by-op formulation.
    """
    params = consts.params
    sp = consts.sp
    im = consts.implicit
    hd = consts.hd

    if params.alph >= 0.5:
        from .spectral_glue import apply_spectral_update
        from .tendencies import grid_tendency_specs

        specs, psdt, state = grid_tendency_specs(
            consts, state, j2 - 1, physics_fn, ctx)
        return apply_spectral_update(consts, state, specs, psdt, j1, dt)

    vordt, divdt, tdt, psdt, trdt, state = get_tendencies(
        consts, state, j2 - 1, physics_fn, ctx)

    # --- horizontal diffusion (time_stepping.f90:78-122) ---
    vor0 = state["vor"][0]
    div0 = state["div"][0]
    vordt = hordif(vor0, vordt, hd.dmp, im.dmp1)
    divdt = hordif(div0, divdt, hd.dmpd, im.dmp1d)

    # tcorh is a (2, mx, nx) real pair; insert the level axis for the
    # (kx, 1, 1) vertical-profile broadcast.
    tcor = state["t"][0] + state["tcorh"][:, None] * hd.tcorv[:, None, None]
    tdt = hordif(tcor, tdt, hd.dmp, im.dmp1)

    # Stratospheric drag on the zonal-mean top-level flow
    # (time_stepping.f90:92-100), applied as a fused masked subtract.
    sdrag = 1.0 / (pc.TDRS * 3600.0)
    m00 = sdrag_mask(vordt.shape[-3], vordt.shape[-2], vordt.dtype)
    vordt = vordt - (sdrag * m00) * vor0
    divdt = divdt - (sdrag * m00) * div0

    vordt = hordif(vor0, vordt, hd.dmps, im.dmp1s)
    divdt = hordif(div0, divdt, hd.dmps, im.dmp1s)
    tdt = hordif(tcor, tdt, hd.dmps, im.dmp1s)

    # tr is a (2, ntr, kx, mx, nx) real pair; tracer index is axis 1.
    qcor = (state["tr"][0][:, 0]
            + state["qcorh"][:, None] * hd.qcorv[:, None, None])
    trdt = jnp.stack(
        [hordif(qcor, trdt[:, 0], hd.dmpd, im.dmp1d)]
        + [hordif(state["tr"][0][:, itr], trdt[:, itr], hd.dmp, im.dmp1)
           for itr in range(1, params.ntr)], axis=1)

    # --- leapfrog with Robert-Williams filter (time_stepping.f90:124-144) ---
    eps = 0.0 if j1 == 1 else params.rob

    state = dict(state)
    state["ps"] = _step_field(params, sp, j1, dt, eps, state["ps"], psdt)
    state["vor"] = _step_field(params, sp, j1, dt, eps, state["vor"], vordt)
    state["div"] = _step_field(params, sp, j1, dt, eps, state["div"], divdt)
    state["t"] = _step_field(params, sp, j1, dt, eps, state["t"], tdt)
    # tr levels are (ntr, kx, mx, nx); the filter update is elementwise so
    # the whole tracer batch steps in one call.
    state["tr"] = _step_field(params, sp, j1, dt, eps, state["tr"], trdt)
    return state
