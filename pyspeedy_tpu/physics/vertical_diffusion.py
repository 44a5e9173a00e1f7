"""Vertical diffusion and shallow convection (reference:
speedy.f90/vertical_diffusion.f90): shallow convection between the lowest two
layers, slow moisture diffusion above the PBL, and super-adiabatic lapse-rate
damping."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import constants as pc

__all__ = ["get_vertical_diffusion_tend"]

TRSHC = 6.0    # shallow-convection relaxation time [h]
TRVDI = 24.0   # moisture-diffusion relaxation time [h]
TRVDS = 6.0    # super-adiabatic damping time [h]
REDSHC = 0.5   # shallow-convection reduction under deep convection
RHGRAD = 0.5   # max d(RH)/d(sigma)
SEGRAD = 0.1   # min d(DSE)/d(phi)


def get_vertical_diffusion_tend(geom, se, rh, qa, qsat, phi, icnv):
    """Returns (utenvd, vtenvd, ttenvd, qtenvd); u/v tendencies are zero in
    the reference scheme (vertical_diffusion.f90:30-146)."""
    kx = se.shape[0]
    nl1 = kx - 1
    fsg, dhs, sigh = geom.fsg, geom.dhs, geom.sigh

    cshc = dhs[kx - 1] / 3600.0
    cvdi = (sigh[nl1] - sigh[1]) / ((nl1 - 1) * 3600.0)
    fshcq = cshc / TRSHC
    fshcse = cshc / (TRSHC * pc.CP)
    fvdiq = cvdi / TRVDI
    fvdise = cvdi / (TRVDS * pc.CP)

    rsig = np.asarray(1.0 / dhs)
    # rsig1[k0] = 1/(1 - sigh(k)) 1-based, needed only for k=1..nl1
    rsig1 = np.asarray(1.0 / (1.0 - sigh[1:nl1 + 1]))
    col = lambda a: a[:, None, None]

    # 2. shallow convection (vdiff:81-109): the lowest two layers only
    drh0 = RHGRAD * (fsg[kx - 1] - fsg[nl1 - 1])
    fvdiq2 = fvdiq * sigh[nl1]
    dmse = se[kx - 1] - se[nl1 - 1] + pc.ALHC * (qa[kx - 1] - qsat[nl1 - 1])
    drh = rh[kx - 1] - rh[nl1 - 1]
    fcnv = jnp.where(icnv > 0, REDSHC, 1.0)

    unstable = dmse >= 0.0
    fluxse = jnp.where(unstable, fcnv * fshcse * dmse, 0.0)

    moist = unstable & (drh >= 0.0)
    dry_humid = (~unstable) & (drh > drh0)
    fluxq = jnp.where(moist, fcnv * fshcq * qsat[kx - 1] * drh,
                      jnp.where(dry_humid, fvdiq2 * qsat[nl1 - 1] * drh, 0.0))

    # one-hot level columns (fuse as multiplies; no per-level slicing)
    row_nl1 = np.zeros((kx, 1, 1))
    row_nl1[nl1 - 1] = 1.0
    row_bot = np.zeros((kx, 1, 1))
    row_bot[kx - 1] = 1.0
    dt = se.dtype
    tt = (row_nl1 * rsig[nl1 - 1] * fluxse[None]
          - row_bot * rsig[kx - 1] * fluxse[None]).astype(dt)
    qt = (row_nl1 * rsig[nl1 - 1] * fluxq[None]
          - row_bot * rsig[kx - 1] * fluxq[None]).astype(dt)

    # 3. moisture diffusion above the PBL (vdiff:111-128), level-parallel:
    # rows 1-based k = 3..kx-2 gated statically by sigh(k) > 0.5.
    gate = np.zeros(kx)
    for k in range(3, kx - 1):
        if sigh[k] > 0.5:
            gate[k - 1] = 1.0
    if gate.any():
        drhk = jnp.concatenate([rh[1:] - rh[:-1], jnp.zeros_like(rh[:1])])
        drh0k = np.concatenate([RHGRAD * (np.asarray(fsg)[1:]
                                          - np.asarray(fsg)[:-1]), [0.0]])
        fvdiq2k = fvdiq * np.asarray(sigh)[1:kx + 1]
        fq = jnp.where((drhk >= col(drh0k)) & (col(gate) > 0.0),
                       col(fvdiq2k) * qsat * drhk, 0.0)
        # qt[k0] += fq[k0]*rsig[k0]; qt[k0+1] -= fq[k0]*rsig[k0+1]
        dn = jnp.concatenate([jnp.zeros_like(fq[:1]), fq[:-1]])
        qt = qt + (fq - dn) * col(rsig)

    # 4. super-adiabatic lapse-rate damping (vdiff:130-145), level-parallel:
    # the all-levels-below redistribution is an exclusive prefix sum.
    se0 = se[1:] + SEGRAD * (phi[:-1] - phi[1:])           # rows k0 = 0..kx-2
    fse = jnp.where(se[:-1] < se0, fvdise * (se0 - se[:-1]), 0.0)
    tt = tt + jnp.concatenate(
        [fse * col(rsig[:kx - 1]), jnp.zeros_like(fse[:1])])
    g = fse * col(rsig1)                                   # rsig1[k0], k0<=kx-2
    # prefix sums via log-depth shift-adds (fuse with the elementwise work)
    csum = g
    shift = 1
    while shift < csum.shape[0]:
        csum = csum + jnp.concatenate(
            [jnp.zeros_like(csum[:shift]), csum[:-shift]], axis=0)
        shift *= 2
    tt = tt - jnp.concatenate([jnp.zeros_like(g[:1]), csum])

    zeros = jnp.zeros((kx,) + se.shape[1:], dtype=se.dtype)
    return zeros, zeros, tt, qt
