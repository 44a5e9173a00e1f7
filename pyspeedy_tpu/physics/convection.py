"""Simplified Tiedtke mass-flux convection (reference:
speedy.f90/convection.f90).

The reference's per-column downward loop with data-dependent cloud top
(convection.f90:110-143) has a key structural property: the "processed"
mask (k > itop) is a *suffix* mask along the level axis, so the sequential
flux accumulation vectorizes exactly as flipped (bottom-up) cumulative sums,
and the frozen-at-exit values (fmass/fus/fuq at the cloud top) are one-hot
selections at itop. The whole scheme is then level-parallel elementwise math
plus one small cumsum — no per-level slicing, no scan — and fuses into a
couple of XLA kernels over the (batch, il, ix) grid. Level indices in the
integer fields (itop) keep the reference's 1-based convention: itop = kx+1
means "no convection".
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import constants as pc

__all__ = ["get_convection_tendencies", "diagnose_convection"]

PSMIN = 0.8    # minimum normalized surface pressure for convection
TRCNV = 6.0    # relaxation time [h]
RHBL = 0.9     # boundary-layer RH threshold
RHIL = 0.7     # intermediate-layer RH threshold (secondary flux)
ENTMAX = 0.5   # maximum entrainment fraction
SMF = 0.8      # secondary/primary cloud-base mass-flux ratio


def _rev_cumsum(x):
    """Suffix sums along axis 0: out[k] = sum_{j >= k} x[j].

    Log-depth shift-adds instead of jnp.cumsum: three shifted adds fuse
    into the surrounding elementwise work."""
    n = x.shape[0]
    shift = 1
    while shift < n:
        x = x + jnp.concatenate(
            [x[shift:], jnp.zeros_like(x[:shift])], axis=0)
        shift *= 2
    return x


def diagnose_convection(geom, psa, se, qa, qsat):
    """Conditional-instability / RH-threshold diagnosis
    (convection.f90:170-253). Returns (itop [1-based int], qdif).

    The reference's descending "last hit wins" sweep selects the smallest
    hitting level, i.e. a masked min along k — computed level-parallel.
    """
    kx = se.shape[0]
    nl1 = kx - 1
    nlp = kx + 1
    wvi = geom.wvi

    # Saturation moist static energy (levels 2..kx 1-based; index 0 unused)
    mss = se + pc.ALHC * qsat

    rlhc = 1.0 / pc.ALHC
    mse0 = se[kx - 1] + pc.ALHC * qa[kx - 1]
    mse1 = jnp.minimum(mse0, se[nl1 - 1] + pc.ALHC * qa[nl1 - 1])
    mss0 = jnp.maximum(mse0, mss[kx - 1])

    # Sweep levels 1-based k = 3 .. kx-3 (convection.f90:228-244): half-level
    # saturation MSE, then the smallest k whose threshold is exceeded.
    k0s = np.arange(2, kx - 3)                      # 0-based rows of the sweep
    if k0s.size == 0:   # kx = 5: the sweep is empty, convection never deep
        big = float(kx)
        ktop1 = jnp.full_like(psa, big)
        ktop2 = jnp.full_like(psa, big)
        msthr = jnp.zeros_like(psa)
    else:
        # contiguous slices, not index gathers (fuses)
        lo, hi = 2, kx - 3
        w1 = np.asarray(wvi)[lo:hi, 1][:, None, None]
        mss2 = mss[lo:hi] + w1 * (mss[lo + 1:hi + 1] - mss[lo:hi])
        ks = jnp.asarray((k0s + 1)[:, None, None], dtype=psa.dtype)

        big = float(kx)
        hit1 = mss0[None] > mss2
        ktop1 = jnp.min(jnp.where(hit1, ks, big), axis=0)
        hit2 = mse1[None] > mss2
        ktop2 = jnp.min(jnp.where(hit2, ks, big), axis=0)
        # msthr = mss2 at the selected (smallest) hitting level
        sel2 = ks == ktop2[None]
        msthr = jnp.sum(jnp.where(sel2 & hit2, mss2, 0.0), axis=0)

    qthr0 = RHBL * qsat[kx - 1]
    qthr1 = RHBL * qsat[nl1 - 1]
    lqthr = (qa[kx - 1] > qthr0) & (qa[nl1 - 1] > qthr1)

    candidate = (psa > PSMIN) & (ktop1 < kx)
    deep = candidate & (ktop2 < kx)
    shallow = candidate & (ktop2 >= kx) & lqthr

    itop = jnp.where(deep | shallow, ktop1, nlp).astype(jnp.int32)
    qdif = jnp.where(
        deep,
        jnp.maximum(qa[kx - 1] - qthr0, (mse0 - msthr) * rlhc),
        jnp.where(shallow, qa[kx - 1] - qthr0, 0.0),
    )
    return itop, qdif


def get_convection_tendencies(geom, psa, se, qa, qsat):
    """Convective fluxes of dry static energy and moisture
    (convection.f90:27-158).

    Returns (itop, cbmf, precnv, dfse, dfqa); dfse/dfqa are the *fluxes* to
    be scaled by rps*grdscp/grdsig in the physics driver (physics.f90:127-130).
    """
    kx = se.shape[0]
    fsg, dhs, wvi = np.asarray(geom.fsg), geom.dhs, np.asarray(geom.wvi)
    fqmax = 5.0
    fm0 = pc.P0 * dhs[kx - 1] / (pc.GRAV * TRCNV * 3600.0)
    rdps = 2.0 / (1.0 - PSMIN)

    # Entrainment profile (convection.f90:62-70), 1-based k = 2..kx-1.
    entr = np.zeros((kx, 1, 1), dtype=fsg.dtype)
    entr_raw = np.maximum(0.0, fsg[1:kx - 1] - 0.5) ** 2
    entr[1:kx - 1, 0, 0] = ENTMAX * entr_raw / entr_raw.sum()

    itop, qdif = diagnose_convection(geom, psa, se, qa, qsat)
    active = itop <= kx

    # --- cloud-base (boundary) layer, k = kx (convection.f90:80-108) ---
    k0 = kx - 1
    qmax = jnp.maximum(1.01 * qa[k0], qsat[k0])
    sb_b = se[k0 - 1] + wvi[k0 - 1, 1] * (se[k0] - se[k0 - 1])
    qb_b = jnp.minimum(qa[k0 - 1] + wvi[k0 - 1, 1] * (qa[k0] - qa[k0 - 1]),
                       qa[k0])
    fpsa = psa * jnp.minimum(1.0, (psa - PSMIN) * rdps)
    fmass0 = fm0 * fpsa * jnp.minimum(fqmax, qdif / (qmax - qb_b))
    cbmf = jnp.where(active, fmass0, 0.0)

    fus_bb = jnp.where(active, cbmf * se[k0], 0.0)
    fuq_bb = jnp.where(active, cbmf * qmax, 0.0)
    fds_bb = jnp.where(active, cbmf * sb_b, 0.0)
    fdq_bb = jnp.where(active, cbmf * qb_b, 0.0)

    # --- intermediate layers, 1-based k = kx-1 .. 3 (convection.f90:110-143)
    # m[k0] = active & (k > itop): true on a contiguous suffix of levels, so
    # the sequential updates become bottom-up cumulative sums ("after" = the
    # value just after this level's update; "before" = the level below's
    # "after", with the boundary layer at the bottom).
    # host-side constant (numpy, folded by XLA)
    karr = np.arange(1, kx + 1, dtype=np.int32)[:, None, None]  # 1-based
    interm = (karr >= 3) & (karr <= kx - 1)
    m = active[None] & (karr > itop[None]) & interm

    enmass = jnp.where(m, entr * psa[None] * cbmf[None], 0.0)
    fmass_after = cbmf[None] + _rev_cumsum(enmass)
    fus_after_c = fus_bb[None] + _rev_cumsum(enmass * se)
    fuq_after_c = fuq_bb[None] + _rev_cumsum(enmass * qa)

    # Half-level downdraft values per level (sb[k0] uses se[k0-1], se[k0]).
    w1 = wvi[:, 1][:, None, None]
    sb = jnp.concatenate(
        [jnp.zeros_like(se[:1]),
         se[:-1] + w1[:-1] * (se[1:] - se[:-1])])
    qb = jnp.concatenate(
        [jnp.zeros_like(qa[:1]),
         qa[:-1] + w1[:-1] * (qa[1:] - qa[:-1])])

    fds_after = jnp.where(m, fmass_after * sb, 0.0)
    fdq_after = jnp.where(m, fmass_after * qb, 0.0)

    def before(after, bottom):
        """value seen at level k0 before its update = level k0+1's after;
        the LAST intermediate level (k0 = kx-2) sees the boundary-layer
        value, and row kx-1 (the boundary layer itself, never masked) is
        filled with `bottom` so one-hot selections at itop = kx-1 pick the
        loop-never-fired value."""
        return jnp.concatenate([after[1:kx - 1], bottom[None], bottom[None]])

    fus_bef = before(fus_after_c, fus_bb)
    fuq_bef = before(fuq_after_c, fuq_bb)
    fds_bef = before(fds_after, fds_bb)
    fdq_bef = before(fdq_after, fdq_bb)

    dfse = jnp.where(m, (fus_bef - fds_bef) + (fds_after - fus_after_c), 0.0)
    dfqa = jnp.where(m, (fuq_bef - fdq_bef) + (fdq_after - fuq_after_c), 0.0)

    # Secondary moisture flux (convection.f90:134-141)
    delq = RHIL * qsat - qa
    fsq = SMF * cbmf[None] * delq
    msec = m & (delq > 0.0)
    sec = jnp.where(msec, fsq, 0.0)
    dfqa = dfqa + sec

    # --- top layer: condensation and detrainment (convection.f90:145-155) ---
    # Final (frozen-at-exit) fluxes = the topmost "after" values.
    fmass_fin = fmass_after[0]
    fus_fin = fus_after_c[0]
    fuq_fin = fuq_after_c[0]
    # fds/fdq froze at their last update (level itop+1); seen from the top
    # layer's row (k0 = itop-1, i.e. karr == itop) that is its before-value.
    fds_fin = jnp.sum(jnp.where(karr == itop[None], fds_bef, 0.0), axis=0)
    fdq_fin = jnp.sum(jnp.where(karr == itop[None], fdq_bef, 0.0), axis=0)

    m_top = active[None] & (karr == itop[None]) & interm
    qsatb = jnp.concatenate(
        [qsat[:-1] + w1[:-1] * (qsat[1:] - qsat[:-1]),
         jnp.zeros_like(qsat[:1])])
    pr = jnp.maximum(fuq_fin[None] - fmass_fin[None] * qsatb, 0.0)
    precnv = jnp.sum(jnp.where(m_top, pr, 0.0), axis=0)
    dfse = dfse + jnp.where(
        m_top, (fus_fin - fds_fin)[None] + pc.ALHC * pr, 0.0)
    dfqa = dfqa + jnp.where(m_top, (fuq_fin - fdq_fin)[None] - pr, 0.0)

    # Boundary layer row (k = kx)
    bot = np.zeros((kx, 1, 1))
    bot[kx - 1] = 1.0
    bot = jnp.asarray(bot, dtype=psa.dtype)
    sec_total = jnp.sum(sec, axis=0)
    dfse = dfse + bot * (fds_bb - fus_bb)
    dfqa = dfqa + bot * ((fdq_bb - fuq_bb) - sec_total)

    return itop, cbmf, precnv, dfse, dfqa
