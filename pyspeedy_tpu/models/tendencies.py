"""Dynamical-core tendencies (reference: speedy.f90/tendencies.f90).

All grid-point algebra is batched over the level axis; the per-level Fortran
transform loops collapse into single batched transforms (matrix products or
FFT).

Array layouts: spectral fields are real PAIRS with a leading c axis (c=0 real
part, c=1 imaginary part; see ops/spectral.py): (2, kx, mx, nx) / (2, mx, nx).
Grid fields are (kx, il, ix) / (il, ix). The leapfrog time levels are tuples
of per-level arrays: vor = (lev0, lev1) each (2, kx, mx, nx); tr levels are
(2, ntr, kx, mx, nx).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from ..ops import spectral as S
from .geopotential import get_geopotential
from .implicit import ImplicitTables, implicit_terms

__all__ = ["get_tendencies"]


def _vertical_means(dhs, fields):
    """Sigma-mass-weighted vertical means of (kx, il, ix) fields.
    Broadcast-multiply + level sum (not einsum): fuses with the
    surrounding elementwise work."""
    w = np.asarray(dhs)[:, None, None]
    return [jnp.sum(w * f, axis=0) for f in fields]


def _multi_spec2grid(sp, fields, fused):
    """Inverse-transform a list of (2, k_i, mx, nx) spectral pairs into
    (k_i, il, ix) grids. fused=True runs them as one mega-batched call (fewer
    launches, bigger matmuls); fused=False keeps per-field calls (better for
    vmapped ensembles)."""
    if fused:
        sizes = [f.shape[1] for f in fields]
        out = S.spec2grid_p(sp, jnp.concatenate(fields, axis=1), 1)
        import numpy as _np
        return jnp.split(out, list(_np.cumsum(sizes)[:-1]), axis=0)
    return [S.spec2grid_p(sp, f, 1) for f in fields]


def _multi_grid2spec(sp, fields, fused):
    if fused:
        sizes = [f.shape[0] for f in fields]
        out = S.grid2spec_p(sp, jnp.concatenate(fields, axis=0))
        import numpy as _np
        return jnp.split(out, list(_np.cumsum(sizes)[:-1]), axis=1)
    return [S.grid2spec_p(sp, f) for f in fields]


def _half_level_flux(sigdt, df):
    """temp[k] = sigdt[k] * df[k] on interior half levels, zero at the
    boundaries: returns a (kx+1, il, ix) array."""
    zeros = jnp.zeros_like(sigdt[:1])
    return jnp.concatenate([zeros, sigdt[1:-1] * df, zeros], axis=0)


def _prefix_cumsum(x, axis: int = 0):
    """Prefix sums along `axis` via log-depth shift-adds, which fuse into
    the surrounding elementwise work. The golden fixtures pin this summation
    order for the grid-point sigma-dot recursion."""
    import jax

    n = x.shape[axis]
    shift = 1
    while shift < n:
        head = jnp.zeros_like(jax.lax.slice_in_dim(x, 0, shift, axis=axis))
        x = x + jnp.concatenate(
            [head, jax.lax.slice_in_dim(x, 0, n - shift, axis=axis)],
            axis=axis)
        shift *= 2
    return x


def grid_dynamics_core(consts, vorg, divg, tg, trg_flat, ug0, vg0, pxy,
                       rcos2d, coriol2d):
    """Grid-point dynamical algebra (tendencies.f90:132-224): everything
    between the inverse and direct transforms, column-local by construction
    (vertical means, sigma-dot recursions, advection/energy products).

    Returns (utend, vtend, ttend, trtend, psdt_g, flux_ut, flux_vt,
    flux_qu, flux_qv, ke): the dynamics-only tendencies (physics adds come
    after), the grid-space log-ps tendency, and the direct-transform input
    products.
    """
    geom = consts.geom
    im: ImplicitTables = consts.implicit
    dhs = np.asarray(geom.dhs)
    dhsr = np.asarray(geom.dhsr)[:, None, None]
    fsgr = np.asarray(geom.fsgr)[:, None, None]
    # Host-side column constants (3-D numpy), folded by XLA.
    tref = np.asarray(im.tref)
    tref3_c = np.asarray(im.tref3)[:, None, None]
    kx = dhs.shape[0]
    ntr = trg_flat.shape[0] // kx

    ug = ug0 * rcos2d
    vg = vg0 * rcos2d
    px = pxy[0] * rcos2d
    py = pxy[1] * rcos2d
    vorg = vorg + coriol2d

    umean, vmean, dmean = _vertical_means(dhs, (ug, vg, divg))

    # --- log-ps tendency, grid part (tendencies.f90:144-149) ---
    psdt_g = -umean * px - vmean * py

    # --- sigma-dot vertical velocity (tendencies.f90:152-166) ---
    # NB the reference's recursion runs through k=kx, so the bottom half
    # level carries the accumulated sum (~ -mean(puv)), it is NOT zero.
    puv = (ug - umean) * px + (vg - vmean) * py
    zero2 = jnp.zeros_like(puv[:1])
    sigdt = jnp.concatenate(
        [zero2, -_prefix_cumsum(dhs[:, None, None] * (puv + divg - dmean))],
        axis=0)
    sigm = jnp.concatenate(
        [zero2, -_prefix_cumsum(dhs[:, None, None] * puv)], axis=0)

    tgg = tg - tref[:, None, None]

    # --- wind tendencies (tendencies.f90:174-195) ---
    tmp = _half_level_flux(sigdt, ug[1:] - ug[:-1])
    utend = vg * vorg - tgg * pc.RGAS * px - (tmp[1:] + tmp[:-1]) * dhsr
    tmp = _half_level_flux(sigdt, vg[1:] - vg[:-1])
    vtend = -ug * vorg - tgg * pc.RGAS * py - (tmp[1:] + tmp[:-1]) * dhsr

    # --- temperature tendency (tendencies.f90:197-210) ---
    tmp = _half_level_flux(sigdt, tgg[1:] - tgg[:-1]) \
        + _half_level_flux(sigm, (tref[1:] - tref[:-1])[:, None, None]
                           * jnp.ones_like(sigm[1:-1]))
    ttend = (tgg * divg - (tmp[1:] + tmp[:-1]) * dhsr
             + fsgr * tgg * (sigdt[1:] + sigdt[:-1])
             + tref3_c * (sigm[1:] + sigm[:-1])
             + pc.AKAP * (tg * puv - tgg * dmean))

    # --- tracer tendencies (tendencies.f90:212-224) ---
    # The reference zeroes the vertical tracer flux at the top two interior
    # half levels (temp(:,:,2:3) = 0, tendencies.f90:218).
    trmask = np.ones((kx + 1, 1, 1))
    trmask[1:3] = 0.0
    trmask = jnp.asarray(trmask, dtype=vorg.dtype)

    def tracer_tend(q):
        tmp = _half_level_flux(sigdt, q[1:] - q[:-1]) * trmask
        return q * divg - (tmp[1:] + tmp[:-1]) * dhsr

    trg_list = [trg_flat[i * kx:(i + 1) * kx] for i in range(ntr)]
    trtend = jnp.concatenate([tracer_tend(q) for q in trg_list], axis=0)

    # --- direct-transform input products (tendencies.f90:238-268) ---
    flux_ut = -ug * tgg * rcos2d
    flux_vt = -vg * tgg * rcos2d
    flux_qu = jnp.concatenate([-ug * q * rcos2d for q in trg_list], axis=0)
    flux_qv = jnp.concatenate([-vg * q * rcos2d for q in trg_list], axis=0)
    ke = 0.5 * (ug**2 + vg**2)

    out = (utend, vtend, ttend, trtend, psdt_g, flux_ut, flux_vt,
           flux_qu, flux_qv, ke)
    if consts.bf16_tendencies:
        # Cast in-kernel (see Consts.bf16_tendencies): every output here is
        # tendency-class (per-step increments / flux-form products), so the
        # direct transforms downstream read 2-byte operands.
        out = tuple(x.astype(jnp.bfloat16) for x in out)
    return out


def get_grid_point_tendencies(consts, state, j2: int, physics_fn=None, ctx=None):
    """Nonlinear grid-point tendencies, converted to spectral
    (tendencies.f90:51-276). j2 is the 0-based time level for the dynamics;
    physics always runs at time level 0 (j1=1 in the reference).

    Returns (vordt, divdt, tdt, psdt, trdt, state) where state carries the
    updated geopotential and any physics diagnostics.
    """
    specs, psdt, state = grid_tendency_specs(consts, state, j2, physics_fn,
                                             ctx)
    ntr = consts.params.ntr
    kx = consts.params.kx
    vordt, divdt, tdt, trdt_flat = combine_specs(consts, specs, ntr, kx)
    trdt = trdt_flat.reshape(
        (2, ntr, kx) + trdt_flat.shape[-2:])
    return vordt, divdt, tdt, psdt, trdt, state


def grid_tendency_specs(consts, state, j2: int, physics_fn=None, ctx=None):
    """The transform-and-grid-kernel part of get_grid_point_tendencies:
    inverse transforms -> grid dynamics core -> physics ->
    direct transforms. Returns (specs, psdt, state) where specs is the list
    of direct-transform outputs (wind/flux pairs then ke, ttend, tracer
    tendencies) still awaiting the spectral-side combination
    (tendencies.f90:238-268 second half), and psdt is the spectral log-ps
    tendency (grid part, already mean-masked)."""
    sp = consts.sp
    geom = consts.geom
    im: ImplicitTables = consts.implicit
    dhs = geom.dhs
    dhsr = geom.dhsr[:, None, None]
    fsgr = geom.fsgr[:, None, None]
    tref = im.tref
    kx = dhs.shape[0]

    vor = state["vor"][j2]
    div = state["div"][j2]
    t = state["t"][j2]
    tr = state["tr"][j2]  # (2, ntr, kx, mx, nx)
    ps = state["ps"][j2]
    ntr = tr.shape[1]

    # --- prognostics to grid space (tendencies.f90:109-130) ---
    # The per-field math is identical in both fusion modes (the cos-lat
    # scaling of the reference's kcos=2 variant commutes with the linear
    # transform and is applied after).
    ucos, vcos = S.vort2vel_p(sp, vor, div)
    psdx, psdy = S.gradient_p(sp, ps)
    (vorg, divg, tg, trg_flat, ug, vg, pxy) = _multi_spec2grid(
        sp,
        [vor, div, t, tr.reshape((2, -1) + tr.shape[-2:]),
         ucos, vcos, jnp.stack([psdx, psdy], axis=1)],
        consts.fuse_transforms)

    rcos = sp.cosgr[:, None]
    # Mask that zeroes the (0,0) spectral mean — a fused multiply instead of
    # a scattered .at[0,0].set(0) (dynamic-update-slice is a hot launch cost)
    not00 = np.ones((vor.shape[-2], vor.shape[-1]))
    not00[0, 0] = 0.0
    not00 = jnp.asarray(not00, dtype=vorg.dtype)

    rcos2d = jnp.broadcast_to(jnp.asarray(rcos, dtype=vorg.dtype),
                              vorg.shape[-2:])
    coriol2d = jnp.broadcast_to(
        jnp.asarray(geom.coriol[:, None], dtype=vorg.dtype),
        vorg.shape[-2:])
    (utend, vtend, ttend, trtend_flat, psdt_g, flux_ut, flux_vt,
     flux_qu, flux_qv, ke) = grid_dynamics_core(
        consts, vorg, divg, tg, trg_flat, ug, vg, pxy, rcos2d, coriol2d)
    trtend = trtend_flat.reshape((ntr, kx) + vorg.shape[-2:])

    # --- log-ps tendency (tendencies.f90:144-149) ---
    psdt = S.grid2spec_p(sp, psdt_g) * not00

    # --- physics (tendencies.f90:229-232) ---
    state = dict(state)
    state["phi"] = get_geopotential(consts.gp, state["t"][0], state["phis"])
    if physics_fn is not None:
        utend, vtend, ttend, trtend, state = physics_fn(
            consts, state, ctx, utend, vtend, ttend, trtend)

    # --- back to spectral (tendencies.f90:238-268) ---
    # Direct transforms of every outgoing field: the wind/flux pairs (scaled
    # by 1/cos as in grid_vel2vort's kcos=2) plus the scalar tendencies.
    # On the bf16_tendencies path the operands arrive bf16 from the kernels;
    # keep the 1/cos scaling in their dtype so no promotion re-widens them.
    rcos = jnp.asarray(rcos, dtype=utend.dtype)
    inputs = [utend * rcos, vtend * rcos, flux_ut, flux_vt]
    for i in range(ntr):
        inputs += [flux_qu[i * kx:(i + 1) * kx], flux_qv[i * kx:(i + 1) * kx]]
    inputs += [ke, ttend]
    inputs += [trtend[i] for i in range(ntr)]
    specs = _multi_grid2spec(sp, inputs, consts.fuse_transforms)

    return specs, psdt, state


def combine_specs(consts, specs, ntr: int, kx: int):
    """Spectral combination of the direct-transform outputs
    (tendencies.f90:244-268): flux pairs -> vor/div/T/tracer tendencies,
    KE Laplacian. Pure pointwise/shift spectral algebra. Tracer tendencies
    come back FLAT: (2, ntr*kx, mx, nx)."""
    sp = consts.sp
    vordt, divdt = S.vel2vort_p(sp, specs[0], specs[1])
    _, tdt_flux = S.vel2vort_p(sp, specs[2], specs[3])
    tr_fluxes = [S.vel2vort_p(sp, specs[4 + 2 * i], specs[5 + 2 * i])[1]
                 for i in range(ntr)]
    base = 4 + 2 * ntr
    ke_spec = specs[base]
    tdt = tdt_flux + specs[base + 1]
    trdt_flat = jnp.concatenate(
        [tr_fluxes[i] + specs[base + 2 + i] for i in range(ntr)], axis=1)

    divdt = divdt - S.laplacian(sp, ke_spec)

    return vordt, divdt, tdt, trdt_flat


def spectral_linear_tendencies(consts, div, ps, phi, divdt, tdt, psdt):
    """Linear (reference-profile) spectral tendencies on explicit arrays
    (tendencies.f90:283-352). div/phi are (2, kx, mx, nx), ps (2, mx, nx).
    Sequential (reference-ordered) sums: golden fixtures pin this
    trajectory."""
    sp = consts.sp
    geom = consts.geom
    im: ImplicitTables = consts.implicit
    dhs_np = np.asarray(geom.dhs)
    dhsr_c = np.asarray(geom.dhsr)[:, None, None]
    tref_np = np.asarray(im.tref)
    tref2_c = np.asarray(im.tref2)[:, None, None]
    tref3_c = np.asarray(im.tref3)[:, None, None]

    dmeanc = S.einsum("k,ckmn->cmn", geom.dhs.astype(div.dtype), div)
    not00 = np.ones((psdt.shape[-2], psdt.shape[-1]))
    not00[0, 0] = 0.0
    psdt = (psdt - dmeanc) * jnp.asarray(not00, dtype=dmeanc.dtype)

    # sigma-dot on half levels (2, kx+1, mx, nx); note the reference
    # accumulates only through k=kx-1 so the bottom boundary stays zero.
    zero2 = jnp.zeros_like(div[:, :1])
    flux = dhs_np[:-1, None, None] * (div[:, :-1] - dmeanc[:, None])
    csum = jnp.cumsum(flux, axis=1)
    sigdtc = jnp.concatenate([zero2, -csum, zero2], axis=1)

    dumk = jnp.concatenate(
        [zero2, sigdtc[:, 1:-1] * (tref_np[1:] - tref_np[:-1])[:, None, None],
         zero2], axis=1)

    tdt = (tdt - (dumk[:, 1:] + dumk[:, :-1]) * dhsr_c
           + tref3_c * (sigdtc[:, 1:] + sigdtc[:, :-1])
           - tref2_c * dmeanc[:, None])

    divdt = divdt - S.laplacian(
        sp, phi + pc.RGAS * tref_np[:, None, None] * ps[:, None])

    return divdt, tdt, psdt


def get_spectral_tendencies(consts, state, divdt, tdt, psdt, j2: int):
    """State-dict wrapper of spectral_linear_tendencies: updates
    state["phi"] from time level j2 first (tendencies.f90:333-336)."""
    state = dict(state)
    state["phi"] = get_geopotential(consts.gp, state["t"][j2], state["phis"])
    divdt, tdt, psdt = spectral_linear_tendencies(
        consts, state["div"][j2], state["ps"][j2], state["phi"],
        divdt, tdt, psdt)
    return divdt, tdt, psdt, state


def get_tendencies(consts, state, j2: int, physics_fn=None, ctx=None):
    """Full tendency computation incl. the semi-implicit correction
    (tendencies.f90:11-39). j2 is 0-based."""
    vordt, divdt, tdt, psdt, trdt, state = get_grid_point_tendencies(
        consts, state, j2, physics_fn, ctx)

    if consts.params.alph < 0.5:
        divdt, tdt, psdt, state = get_spectral_tendencies(
            consts, state, divdt, tdt, psdt, j2)
    else:
        divdt, tdt, psdt, state = get_spectral_tendencies(
            consts, state, divdt, tdt, psdt, 0)
        divdt, tdt, psdt = implicit_terms(consts.implicit, divdt, tdt, psdt)

    return vordt, divdt, tdt, psdt, trdt, state
