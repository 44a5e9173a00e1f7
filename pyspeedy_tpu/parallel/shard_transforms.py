"""Explicitly-sharded spectral transforms via shard_map + collectives.

The jit path (parallel/mesh.py) lets XLA's SPMD partitioner insert the
grid<->spectral communication. This module is the explicit version of the
same pencil decomposition, written with `shard_map` and hand-placed
collectives — the pattern needed for manual comm/compute overlap on real
multi-host meshes:

* grid fields are sharded in contiguous latitude bands over the "space"
  axis; physics is column-local, so it runs on local bands with no halos;
* the direct transform computes each device's partial Legendre projection
  over its latitude rows and combines them with ONE `psum` over "space"
  (the all-to-all/transpose step of distributed spectral models);
* the inverse transform is communication-free: spectral coefficients are
  replicated and each device synthesizes only its own latitude rows.

The hemispheric fold is folded into the full-sphere operators
(ops/spectral.py: cpol_inv_full / cpol_dir_full), so a latitude band never
needs its mirror row from another device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ops import spectral as S

__all__ = ["grid2spec_sharded", "spec2grid_sharded"]


def _fourier_direct_local(sp, grid_local):
    ix = grid_local.shape[-1]
    if sp.use_matmul_fft:
        re = S.einsum("...i,im->...m", grid_local, sp.dft_fwd_re)
        im = S.einsum("...i,im->...m", grid_local, sp.dft_fwd_im)
        return re, im
    F = jnp.fft.rfft(grid_local, axis=-1)[..., : sp.mx] / ix
    return jnp.real(F), jnp.imag(F)


def _fourier_inverse_local(sp, f_re, f_im):
    ix = 2 * sp.il
    if sp.use_matmul_fft:
        return (S.einsum("...m,mi->...i", f_re, sp.dft_inv_re)
                + S.einsum("...m,mi->...i", f_im, sp.dft_inv_im))
    F = (f_re + 1j * f_im).at[..., 0].set(f_re[..., 0])
    pad = [(0, 0)] * (F.ndim - 1) + [(0, ix // 2 + 1 - sp.mx)]
    return jnp.fft.irfft(jnp.pad(F, pad), n=ix, axis=-1) * ix


def grid2spec_sharded(sp, mesh, grid):
    """Direct transform of a latitude-sharded grid batch.

    grid: (B, il, ix) sharded P(None, "space", None).
    Returns replicated spectral (B, mx, nx) complex.
    """
    cpdir = jnp.asarray(sp.cpol_dir_full)  # (il, mx, nx)
    nsp = mesh.shape["space"]
    il_loc = sp.il // nsp

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "space", None), P("space", None, None)),
        out_specs=P(),
    )
    def _direct(g_loc, cp_loc):
        # g_loc: (B, il/P, ix); cp_loc: (il/P, mx, nx)
        f_re, f_im = _fourier_direct_local(sp, g_loc)
        part_re = S.einsum("jmn,bjm->bmn", cp_loc, f_re)
        part_im = S.einsum("jmn,bjm->bmn", cp_loc, f_im)
        # The transpose/reduction across latitude bands: one psum on ICI.
        part_re = jax.lax.psum(part_re, "space")
        part_im = jax.lax.psum(part_im, "space")
        return part_re + 1j * part_im

    return _direct(grid, cpdir)


def spec2grid_sharded(sp, mesh, spec, kcos: int = 1):
    """Inverse transform to a latitude-sharded grid batch (no communication).

    spec: (B, mx, nx) complex, replicated. Returns (B, il, ix) sharded
    P(None, "space", None).
    """
    cpinv = jnp.asarray(sp.cpol_inv_full)  # (il, mx, nx)
    cosgr = jnp.asarray(sp.cosgr)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P("space", None, None), P("space")),
        out_specs=P(None, "space", None),
    )
    def _inverse(sp_in, cp_loc, cosgr_loc):
        f_re = S.einsum("jmn,bmn->bjm", cp_loc, jnp.real(sp_in))
        f_im = S.einsum("jmn,bmn->bjm", cp_loc, jnp.imag(sp_in))
        f_im = f_im.at[..., 0].set(0.0)
        g = _fourier_inverse_local(sp, f_re, f_im)
        if kcos != 1:
            g = g * cosgr_loc[:, None]
        return g

    return _inverse(spec, cpinv, cosgr)
