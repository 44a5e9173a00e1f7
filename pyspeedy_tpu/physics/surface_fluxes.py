"""Surface fluxes of momentum, energy and moisture with land skin-temperature
energy balance (reference: speedy.f90/surface_fluxes.f90).

Only the active configuration of the reference is implemented: fhum0 = 0
(near-surface humidity = lowest-level humidity), lscasym/lskineb = true.
The aux dimension convention matches the reference: index 0 = land,
1 = sea, 2 = land/sea-fraction weighted average.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import constants as pc
from .humidity import get_qsat

__all__ = ["get_surface_fluxes", "set_orog_land_sfc_drag"]

FWIND0 = 0.95
FTEMP0 = 1.0
FHUM0 = 0.0
CDL = 2.4e-3
CDS = 1.0e-3
CHL = 1.2e-3
CHS = 0.9e-3
VGUST = 5.0
CTDAY = 1.0e-2
DTHETA = 3.0
FSTAB = 0.67
HDRAG = 2000.0
CLAMBDA = 7.0
CLAMBSN = 7.0


def set_orog_land_sfc_drag(phi0):
    """Orographic land-drag factor (surface_fluxes.f90:324-334)."""
    rhdrag = 1.0 / (pc.GRAV * HDRAG)
    return 1.0 + rhdrag * (1.0 - jnp.exp(-jnp.maximum(phi0, 0.0) * rhdrag))


def _stability_factor(tsurf, t2):
    """Asymmetric stability correction (surface_fluxes.f90:169-184)."""
    rdth = FSTAB / DTHETA
    astab = 0.5
    dth = jnp.where(
        tsurf > t2,
        jnp.minimum(DTHETA, tsurf - t2),
        jnp.maximum(-DTHETA, astab * (tsurf - t2)),
    )
    return 1.0 + dth * rdth


def get_surface_fluxes(geom, psa, ua, va, ta, qa, rh, phi, phi0, fmask, forog,
                       tsea, ssrd, slrd, alb_land, alb_sea, snowc, land_temp,
                       soil_avail_water, lfluxland=True, prev=None):
    """Compute surface fluxes (surface_fluxes.f90:40-320).

    Returns a dict with ustr/vstr/shf/evap/slru (each (3, il, ix)), hfluxn
    ((2, il, ix) land/sea), tsfc, tskin, u0, v0, t0, plus the land-path
    intermediates needed by a second (sea-only) call via `prev`.
    """
    kx = ta.shape[0]
    nl1 = kx - 1
    sigl = geom.sigl
    wvi = geom.wvi
    esbc = pc.EMISFC * pc.SBC
    rcp = 1.0 / pc.CP
    # cos(lat) for the daily-cycle skin-temperature term
    coa = geom.coa[:, None]

    if lfluxland:
        # 1. near-surface extrapolation (surface_fluxes.f90:117-160)
        u0 = FWIND0 * ua[kx - 1]
        v0 = FWIND0 * va[kx - 1]

        dt1 = wvi[kx - 1, 1] * (ta[kx - 1] - ta[nl1 - 1])
        t1_land_ext = ta[kx - 1] + dt1
        t1_sea_ext = t1_land_ext - phi0 * dt1 / (pc.RGAS * 288.0 * sigl[kx - 1])
        unstable = ta[kx - 1] > ta[nl1 - 1]
        # FTEMP0 = 1: use the extrapolated profile where dT/dz < 0
        t1_land = jnp.where(unstable, t1_land_ext, ta[kx - 1])
        t1_sea = jnp.where(unstable, t1_sea_ext, ta[kx - 1])

        t2_sea = ta[kx - 1] + rcp * phi[kx - 1]
        t2_land = t2_sea - rcp * phi0

        t0 = t1_sea + fmask * (t1_land - t1_sea)

        # 1.3 density * wind speed incl. gustiness
        denvvs0 = (pc.P0 * psa / (pc.RGAS * t0)) * jnp.sqrt(
            u0**2 + v0**2 + VGUST**2)

        # 2.1 effective skin temperature with daily-cycle correction
        tskin = land_temp + CTDAY * jnp.sqrt(coa) * ssrd * (1.0 - alb_land) * psa

        # 2.2 stability corrections
        denvvs1 = denvvs0 * _stability_factor(tskin, t2_land)

        # 2.3 land wind stress
        cdldv = CDL * denvvs0 * forog
        ustr_l = -cdldv * ua[kx - 1]
        vstr_l = -cdldv * va[kx - 1]

        # 2.4 / 2.5 sensible heat + evaporation (fhum0 = 0 path)
        chlcp = CHL * pc.CP
        shf_l = chlcp * denvvs1 * (tskin - t1_land)
        q1_land = qa[kx - 1]
        qsat0_l = get_qsat(tskin, psa, 1.0)
        evap_l = CHL * denvvs1 * jnp.maximum(
            0.0, soil_avail_water * qsat0_l - q1_land)

        # 3. land energy balance -> skin temperature adjustment
        tsk3 = tskin**3
        dslr = 4.0 * esbc * tsk3
        slru_l = esbc * tsk3 * tskin
        hfluxn_l = ssrd * (1.0 - alb_land) + slrd - (
            slru_l + shf_l + pc.ALHC * evap_l)

        clamb = CLAMBDA + snowc * (CLAMBSN - CLAMBDA)
        hfluxn_l = hfluxn_l - clamb * (tskin - land_temp)
        qsat_dt = get_qsat(tskin + 1.0, psa, 1.0)
        dqsat = jnp.where(evap_l > 0.0,
                          soil_avail_water * (qsat_dt - qsat0_l), 0.0)

        dtskin = hfluxn_l / (clamb + dslr
                             + CHL * denvvs1 * (pc.CP + pc.ALHC * dqsat))
        tskin = tskin + dtskin
        shf_l = shf_l + chlcp * denvvs1 * dtskin
        evap_l = evap_l + CHL * denvvs1 * dqsat * dtskin
        slru_l = slru_l + dslr * dtskin
        hfluxn_l = clamb * (tskin - land_temp)

        # 4.1 sea stability correction
        denvvs2 = denvvs0 * _stability_factor(tsea, t2_sea)
        q1_sea = qa[kx - 1]

        # 4.2 sea wind stress
        cdsdv = CDS * denvvs2
        ustr_s = -cdsdv * ua[kx - 1]
        vstr_s = -cdsdv * va[kx - 1]
    else:
        # Second (anomaly-coupled) call recomputes only the sea fluxes with
        # the carried land-path intermediates (surface_fluxes.f90:116, 281).
        (t1_land, t1_sea, denvvs2, q1_sea, ustr_l, vstr_l, shf_l, evap_l,
         slru_l, hfluxn_l, tskin, u0, v0, t0) = prev

    # 4.3-4.5 sea fluxes
    shf_s = CHS * pc.CP * denvvs2 * (tsea - t1_sea)
    qsat_sea = get_qsat(tsea, psa, 1.0)
    evap_s = CHS * denvvs2 * (qsat_sea - q1_sea)
    slru_s = esbc * tsea**4
    # NB the reference adds (not subtracts) shf and evap here
    # (surface_fluxes.f90:297) — replicated verbatim.
    hfluxn_s = ssrd * (1.0 - alb_sea) + slrd - slru_s + shf_s + pc.ALHC * evap_s

    # weighted averages (surface_fluxes.f90:304-314)
    wavg = lambda sea, land: sea + fmask * (land - sea)
    out = {
        "ustr": jnp.stack([ustr_l, ustr_s, wavg(ustr_s, ustr_l)]),
        "vstr": jnp.stack([vstr_l, vstr_s, wavg(vstr_s, vstr_l)]),
        "shf": jnp.stack([shf_l, shf_s, wavg(shf_s, shf_l)]),
        "evap": jnp.stack([evap_l, evap_s, wavg(evap_s, evap_l)]),
        "slru": jnp.stack([slru_l, slru_s, wavg(slru_s, slru_l)]),
        "hfluxn": jnp.stack([hfluxn_l, hfluxn_s]),
        "tsfc": wavg(tsea, land_temp),
        "tskin": wavg(tsea, tskin),
        "t0": wavg(t1_sea, t1_land),
        "u0": u0, "v0": v0,
        "_carry": (t1_land, t1_sea, denvvs2, q1_sea, ustr_l, vstr_l, shf_l,
                   evap_l, slru_l, hfluxn_l, tskin, u0, v0, t0),
    }
    return out
