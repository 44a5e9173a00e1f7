"""Four-band longwave radiation (reference:
speedy.f90/longwave_radiation.f90).

Structure: the four spectral bands form a leading array axis
(instead of the reference's unrolled band loops), so each level of the
sequential up/down sweeps is a handful of fused elementwise ops on
(4, il, ix) arrays. The integer-temperature band-fraction lookup
fband(nint(T), band) is evaluated in closed form (the table is a
memoization of quadratics), keeping the whole scheme elementwise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import constants as pc

__all__ = ["radset", "get_downward_longwave_rad_fluxes",
           "get_upward_longwave_rad_fluxes", "NBAND"]

NBAND = 4


def radset() -> np.ndarray:
    """Energy fraction emitted in each LW band as f(T) (radset,
    longwave_radiation.f90:208-232). Returns (301, 4) table for T=100..400K."""
    eps1 = 1.0 - pc.EPSLW
    fband = np.zeros((301, 4))
    t = np.arange(200, 321)
    i = t - 100
    fband[i, 1] = (0.148 - 3.0e-6 * (t - 247) ** 2) * eps1
    fband[i, 2] = (0.356 - 5.2e-6 * (t - 282) ** 2) * eps1
    fband[i, 3] = (0.314 + 1.0e-5 * (t - 315) ** 2) * eps1
    fband[i, 0] = eps1 - (fband[i, 1] + fband[i, 2] + fband[i, 3])
    fband[: 100] = fband[100]
    fband[221:] = fband[220]
    return fband


def _fband_at(fband, ta):
    """Band fractions at nint(T), clipped to the table range.

    The (301,4) table is a memoization of closed-form quadratics
    (longwave_radiation.f90:208-232) with constant extrapolation outside
    T=200..320K — equivalent to evaluating the quadratics at
    clip(nint(T), 200, 320). The direct evaluation is a handful of
    elementwise FLOPs that XLA fuses into the neighbouring emission
    arithmetic, where a table gather at grid size would be a separate
    kernel."""
    eps1 = 1.0 - pc.EPSLW
    t = jnp.clip(jnp.floor(ta + 0.5), 200.0, 320.0)
    b1 = (0.148 - 3.0e-6 * (t - 247.0) ** 2) * eps1
    b2 = (0.356 - 5.2e-6 * (t - 282.0) ** 2) * eps1
    b3 = (0.314 + 1.0e-5 * (t - 315.0) ** 2) * eps1
    b0 = eps1 - (b1 + b2 + b3)
    return (b0, b1, b2, b3)


def _fband_all(ta):
    """Band fractions for all four bands as one stacked (4, *ta.shape)
    expression (same quadratics as _fband_at; band 0 is eps1 minus the
    others, itself a quadratic)."""
    return jnp.stack(_fband_at(None, ta))


# Bands 2-3 carry no stratospheric (k=0) flux (longwave_radiation.f90
# computes the k=1 layer only for jb=1,2).
_STRAT_BAND_MASK = np.array([1.0, 1.0, 0.0, 0.0])[:, None, None]


def get_downward_longwave_rad_fluxes(geom, fband, rad_tau2, ta):
    """Downward LW sweep (longwave_radiation.f90:16-121).

    Returns (fsfcd, dfabs, rad_flux, rad_st4a); rad_flux/rad_st4a feed the
    upward sweep of the same step. The band loop of the reference is a
    vectorized leading axis: flux is (4, il, ix) and each level update is
    one fused expression over it.
    """
    kx = ta.shape[0]
    nl1 = kx - 1
    wvi = geom.wvi

    # Blackbody emission: boundary temperatures, stratospheric means,
    # tropospheric gradients (lw:42-70).
    tb = [ta[k] + wvi[k, 1] * (ta[k + 1] - ta[k]) for k in range(nl1)]

    st4a_2 = [None] * kx
    st4a_2[0] = 0.75 * ta[0] + 0.25 * tb[0]
    st4a_2[1] = 0.50 * ta[1] + 0.25 * (tb[0] + tb[1])
    anis = 1.0
    for k0 in range(2, nl1):
        st4a_2[k0] = 0.5 * anis * jnp.maximum(tb[k0] - tb[k0 - 1], 0.0)
    st4a_2[kx - 1] = anis * jnp.maximum(ta[kx - 1] - tb[nl1 - 1], 0.0)

    st4a_1 = [None] * kx
    for k0 in range(2):
        st4a_1[k0] = pc.SBC * st4a_2[k0] ** 4
        st4a_2[k0] = jnp.zeros_like(ta[0])
    for k0 in range(2, kx):
        st3a = pc.SBC * ta[k0] ** 3
        st4a_1[k0] = st3a * ta[k0]
        st4a_2[k0] = 4.0 * st3a * st4a_2[k0]

    bmask = jnp.asarray(_STRAT_BAND_MASK, dtype=ta.dtype)

    # 3.1 stratosphere, bands 1-2 at k=1. Band fractions are evaluated
    # per level inside the sweep so they fuse into the emission arithmetic
    # instead of materializing a (4, kx, il, ix) array.
    emis = (1.0 - rad_tau2[:, 0]) * bmask
    flux = emis * (_fband_all(ta[0]) * (st4a_1[0] + emis * st4a_2[0]))
    dfabs = [None] * kx
    dfabs[0] = -jnp.sum(flux, axis=0)

    # 3.2 troposphere
    for k0 in range(1, kx):
        emis = 1.0 - rad_tau2[:, k0]
        brad = _fband_all(ta[k0]) * (st4a_1[k0] + emis * st4a_2[k0])
        newflux = rad_tau2[:, k0] * flux + emis * brad
        dfabs[k0] = jnp.sum(flux - newflux, axis=0)
        flux = newflux

    fsfcd = pc.EMISFC * jnp.sum(flux, axis=0)

    # 3.4 "black" band correction incl. surface reflection
    corlw = pc.EPSLW * pc.EMISFC * st4a_1[kx - 1]
    dfabs[kx - 1] = dfabs[kx - 1] - corlw
    fsfcd = fsfcd + corlw

    rad_st4a = jnp.stack([jnp.stack(st4a_1), jnp.stack(st4a_2)])
    return fsfcd, jnp.stack(dfabs), flux, rad_st4a


def get_upward_longwave_rad_fluxes(geom, fband, rad_tau2, rad_st4a,
                                   rad_strat_corr, ta, ts, fsfcd, fsfcu,
                                   dfabs_in, rad_flux_down):
    """Full upward sweep (longwave_radiation.f90:124-205), band-vectorized
    like the downward sweep."""
    kx = ta.shape[0]
    dhs = geom.dhs
    st4a_1 = rad_st4a[0]
    st4a_2 = rad_st4a[1]

    refsfc = 1.0 - pc.EMISFC
    fsfc = fsfcu - fsfcd

    flux = _fband_all(ts) * fsfcu + refsfc * rad_flux_down  # (4, il, ix)

    dfabs = [dfabs_in[k0] for k0 in range(kx)]
    # "black" band correction
    dfabs[kx - 1] = dfabs[kx - 1] + pc.EPSLW * fsfcu

    for k0 in range(kx - 1, 0, -1):
        emis = 1.0 - rad_tau2[:, k0]
        brad = _fband_all(ta[k0]) * (st4a_1[k0] - emis * st4a_2[k0])
        newflux = rad_tau2[:, k0] * flux + emis * brad
        dfabs[k0] = dfabs[k0] + jnp.sum(flux - newflux, axis=0)
        flux = newflux

    # stratosphere, bands 1-2 at k=1
    bmask = jnp.asarray(_STRAT_BAND_MASK, dtype=ta.dtype)
    emis = (1.0 - rad_tau2[:, 0]) * bmask
    brad = _fband_all(ta[0]) * (st4a_1[0] - emis * st4a_2[0])
    newflux = bmask * (rad_tau2[:, 0] * flux + emis * brad) \
        + (1.0 - bmask) * flux
    dfabs[0] = dfabs[0] + jnp.sum(flux - newflux, axis=0)
    flux = newflux

    # "black" band + polar-night cooling corrections
    corlw1 = dhs[0] * rad_strat_corr[1] * st4a_1[0] + rad_strat_corr[0]
    corlw2 = dhs[1] * rad_strat_corr[1] * st4a_1[1]
    dfabs[0] = dfabs[0] - corlw1
    dfabs[1] = dfabs[1] - corlw2

    ftop = corlw1 + corlw2 + jnp.sum(flux, axis=0)
    return fsfc, ftop, jnp.stack(dfabs)
