"""Semi-implicit gravity-wave solver and horizontal-diffusion coefficient
tables.

Behavioral contract from ``speedy.f90/implicit.f90`` and
``horizontal_diffusion.f90``. The per-total-wavenumber kx-by-kx LU solves
of the reference (implicit.f90:194-207, matrix_inversion.f90) are
precomputed at set_time_step with a batched ``np.linalg.inv`` and gathered
into a dense (mx, nx, kx, kx) operator, so the per-step correction is one
batched level contraction instead of 62 small solves. It runs as unrolled
multiply-adds (`_apply_level_matrix`), so no matrix product, and hence no
matrix-product precision, is involved.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from ..ops.geometry import Geometry
from ..params import ModelParams

__all__ = ["HorDiffusion", "build_hordif", "ImplicitTables", "build_implicit",
           "implicit_terms"]


class HorDiffusion(NamedTuple):
    """Explicit damping coefficients + orographic correction profiles
    (horizontal_diffusion.f90:77-107). The implicit factors dmp1* depend on dt
    and live in ImplicitTables."""

    dmp: jnp.ndarray    # (mx, nx) del^8 damping for T and vorticity
    dmpd: jnp.ndarray   # (mx, nx) del^8 damping for divergence
    dmps: jnp.ndarray   # (mx, nx) del^2 stratospheric damping
    tcorv: jnp.ndarray  # (kx,) vertical orographic T-correction profile
    qcorv: jnp.ndarray  # (kx,) vertical orographic q-correction profile


def build_hordif(params: ModelParams, geom: Geometry) -> HorDiffusion:
    mx, nx, kx, trunc = params.mx, params.nx, params.kx, params.trunc
    npowhd = 4

    hdiff = 1.0 / (params.thd * 3600.0)
    hdifd = 1.0 / (params.thdd * 3600.0)
    hdifs = 1.0 / (params.thds * 3600.0)
    rlap = 1.0 / float(trunc * (trunc + 1))

    m0 = np.arange(mx)[:, None]
    n0 = np.arange(nx)[None, :]
    twn = (m0 + n0).astype(np.float64)
    elap = twn * (twn + 1.0) * rlap
    elapn = elap**npowhd

    tcorv = np.zeros(kx)
    qcorv = np.zeros(kx)
    rgam = pc.RGAS * pc.GAMMA / (1000.0 * pc.GRAV)
    qexp = pc.HSCALE / pc.HSHUM
    tcorv[1:] = geom.fsg[1:] ** rgam
    qcorv[2:] = geom.fsg[2:] ** qexp

    dt = np.float64 if params.precision == "f64" else np.float32
    a = lambda x: jnp.asarray(np.asarray(x, dtype=dt))
    return HorDiffusion(dmp=a(hdiff * elapn), dmpd=a(hdifd * elapn),
                        dmps=a(hdifs * elap), tcorv=a(tcorv), qcorv=a(qcorv))


class ImplicitTables(NamedTuple):
    """dt-dependent tables for the implicit correction (implicit.f90:83-218).
    Rebuilt for each of the three dt values of the startup sequence."""

    dmp1: jnp.ndarray   # (mx, nx) implicit del^8 factor, T/vor
    dmp1d: jnp.ndarray  # (mx, nx) implicit del^8 factor, divergence
    dmp1s: jnp.ndarray  # (mx, nx) implicit del^2 factor, stratosphere
    tref: jnp.ndarray   # (kx,) reference temperature profile
    tref2: jnp.ndarray  # (kx,) akap * tref
    tref3: jnp.ndarray  # (kx,) fsgr * tref
    dhsx: jnp.ndarray   # (kx,) xi * dhs
    xc: jnp.ndarray     # (kx, kx) T-from-div coupling (already * xi)
    xd: jnp.ndarray     # (kx, kx) hydrostatic P-from-T operator
    elz: jnp.ndarray    # (mx, nx) l(l+1) * xi / a^2
    xj_mn: jnp.ndarray  # (mx, nx, kx, kx) gathered inverse matrices; zero rows
                        # at l=0 so the correction vanishes there.


def _tref_profile(geom: Geometry) -> np.ndarray:
    rgam = pc.RGAS * pc.GAMMA / (1000.0 * pc.GRAV)
    return 288.0 * np.maximum(0.2, geom.fsg) ** rgam


def build_implicit(params: ModelParams, geom: Geometry, hd: HorDiffusion,
                   dt: float) -> ImplicitTables:
    kx, mx, nx = params.kx, params.mx, params.nx
    dhs, fsg, hsg = geom.dhs, geom.fsg, geom.hsg

    tref = _tref_profile(geom)
    tref2 = pc.AKAP * tref
    tref3 = geom.fsgr * tref

    dmp1 = 1.0 / (1.0 + np.asarray(hd.dmp, dtype=np.float64) * dt)
    dmp1d = 1.0 / (1.0 + np.asarray(hd.dmpd, dtype=np.float64) * dt)
    dmp1s = 1.0 / (1.0 + np.asarray(hd.dmps, dtype=np.float64) * dt)

    xi = dt * params.alph
    xxi = xi / pc.REARTH**2
    dhsx = xi * dhs

    m0 = np.arange(mx)[:, None]
    n0 = np.arange(nx)[None, :]
    ell = (m0 + n0).astype(np.float64)
    elz = ell * (ell + 1.0) * xxi

    # Temperature-from-divergence vertical structure (implicit.f90:129-170)
    ya = -pc.AKAP * tref[:, None] * dhs[None, :]
    xa = np.zeros((kx, kx))
    for k in range(1, kx):
        xa[k, k - 1] = 0.5 * (pc.AKAP * tref[k] / fsg[k]
                              - (tref[k] - tref[k - 1]) / dhs[k])
    for k in range(kx - 1):
        xa[k, k] = 0.5 * (pc.AKAP * tref[k] / fsg[k]
                          - (tref[k + 1] - tref[k]) / dhs[k])

    dsum = np.cumsum(dhs)
    xb = np.zeros((kx, kx))
    for k in range(kx - 1):
        for k1 in range(kx):
            xb[k, k1] = dhs[k1] * dsum[k]
            if k1 <= k:
                xb[k, k1] -= dhs[k1]

    xc = ya + xa[:, : kx - 1] @ xb[: kx - 1, :]

    # Hydrostatic operator P(k) = xd(k,k') T(k') (implicit.f90:172-182)
    xd = np.zeros((kx, kx))
    for k in range(kx):
        for k1 in range(k + 1, kx):
            xd[k, k1] = pc.RGAS * np.log(hsg[k1 + 1] / hsg[k1])
        xd[k, k] = pc.RGAS * np.log(hsg[k + 1] / fsg[k])

    xe = xd @ xc

    # Per-total-wavenumber matrices and their inverses (implicit.f90:194-207).
    lmax = mx + nx + 1
    ll = np.arange(1, lmax + 1, dtype=np.float64)
    xxx = ll * (ll + 1.0) / pc.REARTH**2
    base = pc.RGAS * tref[:, None] * dhs[None, :] - xe  # (kx, kx)
    xf = np.eye(kx)[None] + (xi * xi * xxx)[:, None, None] * base[None]
    xj = np.linalg.inv(xf)  # (lmax, kx, kx)

    # Gather per-(m,n): l(m,n) = m0+n0; the correction is skipped at l=0
    # (implicit.f90:268-275) -> zero matrix there.
    lidx = (m0 + n0)  # value of l; table index l-1
    xj_mn = np.where((lidx > 0)[..., None, None],
                     xj[np.clip(lidx - 1, 0, lmax - 1)], 0.0)

    xc = xc * xi

    dtv = np.float64 if params.precision == "f64" else np.float32
    a = lambda x: jnp.asarray(np.asarray(x, dtype=dtv))
    return ImplicitTables(
        dmp1=a(dmp1), dmp1d=a(dmp1d), dmp1s=a(dmp1s),
        tref=a(tref), tref2=a(tref2), tref3=a(tref3), dhsx=a(dhsx),
        xc=a(xc), xd=a(xd), elz=a(elz), xj_mn=a(xj_mn),
    )


def _apply_level_matrix(A, y):
    """(k, l) matrix along the level axis of complex (..., l, m, n), as kx^2
    unrolled scalar multiply-adds that fuse into plain elementwise work
    (kx is 8, far below a useful matrix-product size). A may be (k, l) or
    position-dependent (k, l, m, n)."""
    kxo, kxi = A.shape[0], A.shape[1]
    return jnp.stack(
        [sum(A[k, l] * y[..., l, :, :] for l in range(kxi))
         for k in range(kxo)], axis=-3)


def implicit_terms(im: ImplicitTables, divdt: jnp.ndarray, tdt: jnp.ndarray,
                   psdt: jnp.ndarray):
    """Semi-implicit gravity-wave correction (implicit.f90:234-289).

    Arrays are (..., kx, mx, nx) for 3-D and (..., mx, nx) for psdt; the level
    axis is third-from-last so the kx-by-kx contractions batch over (m, n).
    Returns corrected (divdt, tdt, psdt).
    """
    xd = np.asarray(im.xd)
    xc = np.asarray(im.xc)
    xj_t = np.transpose(np.asarray(im.xj_mn), (2, 3, 0, 1))  # (k, l, m, n)
    tref_c = np.asarray(im.tref)[:, None, None]
    dhsx_c = np.asarray(im.dhsx)[:, None, None]

    # ye = xd . tdt + R tref psdt
    ye = _apply_level_matrix(xd, tdt) \
        + pc.RGAS * tref_c * psdt[..., None, :, :]
    yf = divdt + im.elz * ye
    # divdt <- xj(l) . yf   (per-(m,n) kx x kx matvec)
    divdt = _apply_level_matrix(xj_t, yf)
    psdt = psdt - jnp.sum(dhsx_c * divdt, axis=-3)
    tdt = tdt + _apply_level_matrix(xc, divdt)
    return divdt, tdt, psdt
