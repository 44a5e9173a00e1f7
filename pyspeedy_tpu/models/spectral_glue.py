"""The spectral side of a leapfrog step as ONE function.

Everything between the direct transforms and the new prognostic state —
spectral flux combination (tendencies.f90:244-268), linear reference-profile
tendencies (:283-352), the semi-implicit correction (implicit.f90:234-289),
horizontal diffusion + stratospheric drag (time_stepping.f90:78-122) and the
Robert-Williams leapfrog (:124-188) — is pointwise/shift/level-contraction
algebra on tiny (2, kx, mx, nx) real-pair arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from .implicit import implicit_terms
from .tendencies import combine_specs, spectral_linear_tendencies
from .timestep import hordif, leapfrog_pair, sdrag_mask

__all__ = ["apply_spectral_update"]


def spectral_update(consts, j1: int, dt: float, eps: float, specs, psdt,
                    vor0, vor1, div0, div1, t0, t1, ps0, ps1,
                    trf0, trf1, phi, tcorh, qcorh):
    """specs: direct-transform outputs (list); state pairs at both time
    levels with tracers FLAT (2, ntr*kx, mx, nx). Returns the ten new state
    arrays (ps, vor, div, t, trf) x (lev1, lev2)."""
    params = consts.params
    sp = consts.sp
    im = consts.implicit
    hd = consts.hd
    ntr, kx = params.ntr, params.kx

    vordt, divdt, tdt, trdt = combine_specs(consts, specs, ntr, kx)

    # --- linear spectral tendencies + implicit (tendencies.f90:24-37) ---
    divdt, tdt, psdt = spectral_linear_tendencies(
        consts, div0, ps0, phi, divdt, tdt, psdt)
    divdt, tdt, psdt = implicit_terms(im, divdt, tdt, psdt)

    # --- horizontal diffusion (time_stepping.f90:78-122) ---
    tcorv_c = np.asarray(hd.tcorv)[:, None, None]
    qcorv_c = np.asarray(hd.qcorv)[:, None, None]

    vordt = hordif(vor0, vordt, hd.dmp, im.dmp1)
    divdt = hordif(div0, divdt, hd.dmpd, im.dmp1d)
    tcor = t0 + tcorh[:, None] * tcorv_c
    tdt = hordif(tcor, tdt, hd.dmp, im.dmp1)

    sdrag = 1.0 / (pc.TDRS * 3600.0)
    m00 = sdrag_mask(kx, vordt.shape[-2], vordt.dtype)
    vordt = vordt - (sdrag * m00) * vor0
    divdt = divdt - (sdrag * m00) * div0

    vordt = hordif(vor0, vordt, hd.dmps, im.dmp1s)
    divdt = hordif(div0, divdt, hd.dmps, im.dmp1s)
    tdt = hordif(tcor, tdt, hd.dmps, im.dmp1s)

    # Tracers (flat level axis): tracer 0 (humidity) gets the orographic
    # correction, the rest plain del^8 diffusion.
    qcor = trf0[:, :kx] + qcorh[:, None] * qcorv_c
    tr_parts = [hordif(qcor, trdt[:, :kx], hd.dmpd, im.dmp1d)]
    for itr in range(1, ntr):
        sl = slice(itr * kx, (itr + 1) * kx)
        tr_parts.append(hordif(trf0[:, sl], trdt[:, sl], hd.dmp, im.dmp1))
    trdt = jnp.concatenate(tr_parts, axis=1) if ntr > 1 else tr_parts[0]

    # --- leapfrog + Robert-Williams filter (time_stepping.f90:124-144) ---
    do_trunc = params.ix == params.iy * 4
    trfilt = sp.trfilt
    lf = lambda f0_, f1_, fdt_: leapfrog_pair(params, trfilt, j1, dt, eps,
                                              f0_, f1_, fdt_, do_trunc)
    ps0n, ps1n = lf(ps0, ps1, psdt)
    vor0n, vor1n = lf(vor0, vor1, vordt)
    div0n, div1n = lf(div0, div1, divdt)
    t0n, t1n = lf(t0, t1, tdt)
    trf0n, trf1n = lf(trf0, trf1, trdt)
    return (ps0n, ps1n, vor0n, vor1n, div0n, div1n, t0n, t1n, trf0n, trf1n)


def apply_spectral_update(consts, state, specs, psdt, j1: int, dt: float):
    """Run spectral_update over the state dict (the reference-ordered
    formulation; golden fixtures pin this path)."""
    params = consts.params
    eps = 0.0 if j1 == 1 else params.rob
    ntr, kx = params.ntr, params.kx

    tr0, tr1 = state["tr"]
    flat = lambda a: a.reshape((2, ntr * kx) + a.shape[-2:])
    arrays = (psdt,
              state["vor"][0], state["vor"][1],
              state["div"][0], state["div"][1],
              state["t"][0], state["t"][1],
              state["ps"][0], state["ps"][1],
              flat(tr0), flat(tr1),
              state["phi"], state["tcorh"], state["qcorh"])

    outs = spectral_update(consts, j1, dt, eps, list(specs), *arrays)

    (ps0, ps1, vor0, vor1, div0, div1, t0, t1, trf0, trf1) = outs
    unflat = lambda a: a.reshape((2, ntr, kx) + a.shape[-2:])
    state = dict(state)
    state["ps"] = (ps0, ps1)
    state["vor"] = (vor0, vor1)
    state["div"] = (div0, div1)
    state["t"] = (t0, t1)
    state["tr"] = (unflat(trf0), unflat(trf1))
    return state
