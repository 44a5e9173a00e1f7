"""Hydrostatic geopotential in spectral space (reference:
speedy.f90/geopotential.f90)."""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from ..ops import spectral as S
from ..ops.geometry import Geometry
from ..params import ModelParams

__all__ = ["GeopotTables", "build_geopot", "get_geopotential",
           "get_geopotential_grid"]


class GeopotTables(NamedTuple):
    xgeop1: jnp.ndarray  # (kx,)
    xgeop2: jnp.ndarray  # (kx,) (entry 0 unused)
    corf: jnp.ndarray    # (kx,) zonal-mean lapse-rate correction factors


def build_geopot(params: ModelParams, geom: Geometry) -> GeopotTables:
    """Hydrostatic constants (geopotential.f90:16-31) and the tropospheric
    zonal-mean correction factors (geopotential.f90:73-76)."""
    kx = params.kx
    hsg, fsg = geom.hsg, geom.fsg
    xgeop1 = np.zeros(kx)
    xgeop2 = np.zeros(kx)
    for k in range(kx):
        xgeop1[k] = pc.RGAS * np.log(hsg[k + 1] / fsg[k])
        if k != kx - 1:
            xgeop2[k + 1] = pc.RGAS * np.log(fsg[k + 1] / hsg[k + 1])

    corf = np.zeros(kx)
    for k in range(1, kx - 1):
        corf[k] = xgeop1[k] * 0.5 * np.log(hsg[k + 1] / fsg[k]) \
            / np.log(fsg[k + 1] / fsg[k - 1])

    dt = np.float64 if params.precision == "f64" else np.float32
    a = lambda x: jnp.asarray(np.asarray(x, dtype=dt))
    return GeopotTables(xgeop1=a(xgeop1), xgeop2=a(xgeop2), corf=a(corf))


def get_geopotential(gp: GeopotTables, t: jnp.ndarray, phis: jnp.ndarray) -> jnp.ndarray:
    """Bottom-up hydrostatic integration in spectral space
    (geopotential.f90:49-77).

    t: (..., kx, mx, nx) spectral temperature; phis: (..., mx, nx).
    Returns phi: (..., kx, mx, nx).
    """
    kx = t.shape[-3]
    mx = t.shape[-2]
    levels = [None] * kx
    levels[kx - 1] = phis + gp.xgeop1[kx - 1] * t[..., kx - 1, :, :]
    for k in range(kx - 2, -1, -1):
        levels[k] = (levels[k + 1] + gp.xgeop2[k + 1] * t[..., k + 1, :, :]
                     + gp.xgeop1[k] * t[..., k, :, :])
    phi = jnp.stack(levels, axis=-3)

    # Zonal-mean (m=0) lapse-rate correction in the free troposphere,
    # applied as a fused masked add (corf is zero at k=0 and k=kx-1, and the
    # m>0 columns are masked out).
    tpad = jnp.concatenate([jnp.zeros_like(t[..., :1, :, :]), t,
                            jnp.zeros_like(t[..., :1, :, :])], axis=-3)
    dtk = tpad[..., 2:, :, :] - tpad[..., :-2, :, :]
    m0mask = np.zeros((1, mx, 1))
    m0mask[0, 0, 0] = 1.0
    corr = gp.corf[:, None, None] * m0mask * dtk
    return phi + corr.astype(phi.dtype)


def get_geopotential_grid(gp: GeopotTables, sp, tg: jnp.ndarray,
                          t_pair: jnp.ndarray,
                          phisg: jnp.ndarray) -> jnp.ndarray:
    """Grid-space hydrostatic integration: phig == spec2grid(phi) without
    transforming the phi stack.

    The spectral recursion (geopotential.f90:49-77) is level-wise linear, so
    it commutes with the (linear) inverse transform: integrating the ALREADY
    TRANSFORMED temperature tg against the same coefficients reproduces
    spec2grid(get_geopotential(...)) to rounding — saving kx field-levels of
    inverse transform per physics call. The
    zonal-mean (m=0) lapse-rate correction is synthesized directly from the
    m=0 spectral column of t (one (nx -> il) matvec; the m=0 inverse DFT is
    the identity on the real plane, fourier.f90:72-76).

    tg: (..., kx, il, ix) grid temperature (= spec2grid of t_pair);
    t_pair: (2, ..., kx, mx, nx) the spectral pair tg came from;
    phisg: (il, ix) grid surface geopotential (spec2grid of state["phis"],
    loop-invariant, precomputed at initialization).
    """
    kx = tg.shape[-3]
    levels = [None] * kx
    levels[kx - 1] = phisg + gp.xgeop1[kx - 1] * tg[..., kx - 1, :, :]
    for k in range(kx - 2, -1, -1):
        levels[k] = (levels[k + 1] + gp.xgeop2[k + 1] * tg[..., k + 1, :, :]
                     + gp.xgeop1[k] * tg[..., k, :, :])
    phig = jnp.stack(levels, axis=-3)

    # m=0 correction, zonally uniform: corr(k, j) = corf[k] *
    # sum_n (t[k+1] - t[k-1])_re[m=0, n] * cpol_inv_full[j, 0, n].
    t0 = t_pair[0][..., :, 0, :]                      # (..., kx, nx) real m=0
    zero = jnp.zeros_like(t0[..., :1, :])
    tpad = jnp.concatenate([zero, t0, zero], axis=-2)
    dtk = tpad[..., 2:, :] - tpad[..., :-2, :]
    leg0 = sp.cpol_inv_full[:, 0, :]                  # (il, nx)
    corr = S.einsum("...kn,jn->...kj", gp.corf[:, None] * dtk, leg0)
    return phig + corr[..., None].astype(phig.dtype)
