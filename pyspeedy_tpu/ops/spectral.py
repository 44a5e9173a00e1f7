"""Spectral transform engine: spherical-harmonic <-> grid transforms and
spectral-space operators, batched over arbitrary leading axes.

Behavioral contract from the reference transform stack
(``speedy.f90/legendre.f90``, ``fourier.f90``, ``spectral.f90``), re-designed
for batched matrix products:

* The per-(m,n) Fortran dot-product loops become batched einsums against a
  precomputed Legendre operator ``cpol`` of shape (iy, mx, nx): matrix
  products when batched over levels/fields/ensemble members.
* The FFTPACK real FFT along longitude becomes ``jnp.fft.rfft/irfft`` (the
  coefficient convention matches FFTPACK's (cos, -sin) packing), with an
  optional DFT-by-matmul path (shardable, and one more matrix product in
  the chain for small ix).
* All meridional couplings (gradient, vor/div <-> u,v) are n±1 shifts with
  precomputed coefficient tables — pure pointwise ops.

Conventions (mirroring the reference):
* grid fields: (..., il, ix), latitude index 0 = southernmost;
* spectral fields: (..., mx, nx) complex, m = zonal wavenumber index,
  l = m + n = total wavenumber; only l <= trunc+1 entries participate.
* A constant field c has spec[0, 0] = sqrt(2) * c.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as pc
from ..params import ModelParams
from .geometry import Geometry

__all__ = [
    "MATMUL_PRECISION", "SpectralTransform", "build_spectral",
    "grid2spec", "spec2grid", "gradient", "vel2vort", "vort2vel",
    "grid_vel2vort", "truncate", "grid_filter", "laplacian", "laplacian_inv",
    "pair", "unpair", "grid2spec_p", "spec2grid_p", "gradient_p",
    "vel2vort_p", "vort2vel_p", "grid_vel2vort_p",
]

# The Fortran reference truncates the near-exact-underflow polynomial values
# (legendre.f90:297-302).
_POLY_FLOOR = 1.0e-30

# Precision of every float32 matrix product on the transform paths: this
# module's transforms, the sharded transforms, the SPPT pattern synthesis,
# the geopotential's m=0 correction and the linear spectral tendencies all
# contract through einsum/matmul below. Without it XLA's GPU backend runs float32
# dots in TF32 (a 10-bit mantissa). float64 dots are exact either way.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def einsum(spec, *operands):
    return jnp.einsum(spec, *operands, precision=MATMUL_PRECISION)


def matmul(a, b, preferred_element_type=None):
    return jnp.matmul(a, b, precision=MATMUL_PRECISION,
                      preferred_element_type=preferred_element_type)


def gaussian_nodes_and_weights(iy: int) -> tuple[np.ndarray, np.ndarray]:
    """Newton-converged Gaussian quadrature nodes and weights on the iy
    per-hemisphere points, replicating legendre.f90:224-257 (including its
    10-digit pi literal). Returns (z, w) with z > 0 descending from the pole."""
    n = 2 * iy
    eps = np.finfo(np.float64).eps  # epsilon(1.0_p)
    zs = np.empty(iy)
    w = np.empty(iy)
    z1 = 2.0
    for i in range(1, iy + 1):
        z = np.cos(3.141592654 * (i - 0.25) / (n + 0.5))
        pp = 0.0
        while abs(z - z1) > eps:
            p1, p2 = 1.0, 0.0
            for jj in range(1, n + 1):
                p3 = p2
                p2 = p1
                p1 = ((2.0 * jj - 1.0) * z * p2 - (jj - 1.0) * p3) / jj
            pp = n * (z * p1 - p2) / (z**2 - 1.0)
            z1 = z
            z = z1 - p1 / pp
        zs[i - 1] = z
        w[i - 1] = 2.0 / ((1.0 - z**2) * pp**2)
    return zs, w


def gaussian_weights(iy: int) -> np.ndarray:
    return gaussian_nodes_and_weights(iy)[1]


def _epsi_tables(mx: int, nx: int) -> tuple[np.ndarray, np.ndarray]:
    """Recursion coefficients eps(l,m)=sqrt((l^2-m^2)/(4 l^2-1)) on the
    (mx+1, nx+1) index grid (legendre.f90:79-95)."""
    m0 = np.arange(mx + 1)[:, None].astype(np.float64)
    n0 = np.arange(nx + 1)[None, :].astype(np.float64)
    ell2 = (m0 + n0) ** 2
    emm2 = m0**2
    with np.errstate(invalid="ignore", divide="ignore"):
        epsi = np.sqrt((ell2 - emm2) / (4.0 * ell2 - 1.0))
    epsi[0, 0] = 0.0
    epsi[:, nx] = 0.0
    repsi = np.where(epsi > 0.0, 1.0 / np.where(epsi > 0.0, epsi, 1.0), 0.0)
    return epsi, repsi


def _legendre_polys_at(x: float, y: float, mx: int, nx: int,
                       epsi: np.ndarray, repsi: np.ndarray) -> np.ndarray:
    """Associated Legendre polynomials at one latitude via the reference's
    diagonal-then-meridional recurrence (legendre.f90:260-307)."""
    alp = np.zeros((mx + 1, nx))
    m = np.arange(1, mx + 1, dtype=np.float64)
    consq = np.sqrt(0.5 * (2.0 * m + 1.0) / m)

    alp[0, 0] = np.sqrt(0.5)
    for i in range(1, mx + 1):
        alp[i, 0] = consq[i - 1] * y * alp[i - 1, 0]
    alp[:, 1] = x * alp[:, 0] * repsi[:, 1]
    for n in range(2, nx):
        alp[:, n] = (x * alp[:, n - 1] - epsi[:, n - 1] * alp[:, n - 2]) * repsi[:, n]

    alp[np.abs(alp) <= _POLY_FLOOR] = 0.0
    return alp[:mx, :]


class SpectralTransform(NamedTuple):
    """Precomputed transform operators and spectral coefficient tables.

    A NamedTuple of jnp arrays: a pytree, so it can be closed over by jit
    (tables become compile-time constants) or passed as an argument.
    """

    # Legendre operators, nsh2-masked, split by meridional parity:
    cpol_even: jnp.ndarray   # (iy, mx, nx) zero where n odd
    cpol_odd: jnp.ndarray    # (iy, mx, nx) zero where n even
    wt: jnp.ndarray          # (iy,) Gaussian weights
    # Latitude scalings
    cosgr: jnp.ndarray       # (il,) 1/cos(lat)
    cosgr2: jnp.ndarray      # (il,) 1/cos^2(lat)
    # Spectral operator tables (mx, nx) unless noted
    el2: jnp.ndarray         # l(l+1)/a^2 Laplacian eigenvalues
    el4: jnp.ndarray
    elm2: jnp.ndarray        # 1/el2 (0 at l=0)
    trfilt: jnp.ndarray      # 1 where l <= trunc else 0
    gradx: jnp.ndarray       # (mx,) m/a
    gradym: jnp.ndarray
    gradyp: jnp.ndarray
    uvdx: jnp.ndarray
    uvdym: jnp.ndarray
    uvdyp: jnp.ndarray
    vddym: jnp.ndarray
    vddyp: jnp.ndarray
    # Zonal DFT as matmul (alternative to jnp.fft):
    dft_fwd_re: jnp.ndarray  # (ix, mx) cos(2 pi m i / ix) / ix
    dft_fwd_im: jnp.ndarray  # (ix, mx) -sin(2 pi m i / ix) / ix
    dft_inv_re: jnp.ndarray  # (mx, ix) (2-delta_m0) cos(2 pi m i / ix)
    dft_inv_im: jnp.ndarray  # (mx, ix) -(2-delta_m0) sin(2 pi m i / ix)
    # Full-sphere Legendre operators with the hemispheric parity fold (and,
    # for the direct one, the Gaussian weights) baked in - the default
    # (non-dense) einsum transform path contracts against these:
    cpol_inv_full: jnp.ndarray  # (il, mx, nx)
    cpol_dir_full: jnp.ndarray  # (il, mx, nx)
    # Real-pair DFT operators: c indexes (cos, sin) parts. The whole
    # matmul-FFT transform runs in real arithmetic (no complex einsum, so no
    # re/im plane extraction copies); note
    # dft_inv_ri[1, 0, :] == 0 (sin(0)), which is exactly the reference's
    # "discard the m=0 imaginary part" rule (fourier.f90:72-76) fused into
    # the operator.
    dft_fwd_ri: jnp.ndarray  # (2, ix, mx)
    dft_inv_ri: jnp.ndarray  # (2, mx, ix)
    # Dense block-diagonal Legendre operators: the (m-batched) per-wavenumber
    # contractions "jmn,...jm->...mn" make m a *batch* dimension of the dot,
    # which XLA lowers with batch-major layout constraints and relayout
    # copies of (members, kx, il, ix)-sized arrays. Flattening (j,m)->(m,n)
    # into ONE dense matrix (zeros off the m-diagonal) turns the whole
    # Legendre stage into a plain (..., il*mx) @ (il*mx, mx*nx) matmul:
    # minormost contraction, no batch dims, no transposes, at the price of
    # mx-fold redundant FLOPs (ROADMAP speed item 3 re-measures this).
    leg_dir_dense: jnp.ndarray  # (il*mx, mx*nx) or (1,1) placeholder
    leg_inv_dense: jnp.ndarray  # (mx*nx, il*mx) or (1,1) placeholder
    use_matmul_fft: bool = False  # static flag, not a pytree leaf in practice
    use_dense_legendre: bool = False  # static flag

    @property
    def iy(self):
        return self.cpol_even.shape[0]

    @property
    def mx(self):
        return self.cpol_even.shape[1]

    @property
    def nx(self):
        return self.cpol_even.shape[2]

    @property
    def il(self):
        return self.cosgr.shape[0]

    @property
    def rdtype(self):
        return self.wt.dtype

    @property
    def cdtype(self):
        return jnp.complex128 if self.rdtype == jnp.float64 else jnp.complex64

    def astype(self, dtype) -> "SpectralTransform":
        return SpectralTransform(
            *(jnp.asarray(a, dtype=dtype) if not isinstance(a, bool) else a
              for a in self))

    @property
    def ix(self):
        return self.dft_fwd_re.shape[0]


def build_spectral(params: ModelParams, geom: Geometry,
                   use_matmul_fft: bool = False) -> SpectralTransform:
    """Build all transform tables (numpy f64, cast to the configured dtype).

    use_matmul_fft selects a dense-DFT zonal transform (one (ix, 2mx) matmul
    per direction) instead of jnp.fft; it is also the shardable form."""
    mx, nx, iy, trunc = params.mx, params.nx, params.iy, params.trunc

    epsi, repsi = _epsi_tables(mx, nx)
    wt = gaussian_weights(iy)

    # cpol at the (f32-rounded) geometry nodes, masked to the transform
    # triangle nsh2 (legendre.f90:68-77): l <= trunc+1 when ix == 4*iy.
    cpol = np.zeros((iy, mx, nx))
    for j in range(iy):
        cpol[j] = _legendre_polys_at(geom.sia_half[j], geom.coa_half[j],
                                     mx, nx, epsi, repsi)

    m0 = np.arange(mx)[:, None]
    n0 = np.arange(nx)[None, :]
    ell = (m0 + n0).astype(np.float64)
    if params.ix == 4 * params.iy:
        nsh2_mask = (m0 + n0 <= trunc + 1).astype(np.float64)
    else:
        nsh2_mask = np.ones((mx, nx))
    cpol = cpol * nsh2_mask[None, :, :]

    parity_even = ((n0 % 2) == 0).astype(np.float64)  # n'-m' = n even
    cpol_even = cpol * parity_even[None, :, :]
    cpol_odd = cpol * (1.0 - parity_even)[None, :, :]

    # Operator tables (spectral.f90:72-112)
    el2 = ell * (ell + 1.0) / pc.REARTH**2
    el4 = el2**2
    elm2 = np.zeros_like(el2)
    elm2[el2 > 0] = 1.0 / el2[el2 > 0]
    trfilt = (ell <= trunc).astype(np.float64)

    gradx = np.arange(mx, dtype=np.float64) / pc.REARTH

    # eps(l, m) lookups: epsi0[m0, n0] has l = m0+n0; the tables use the
    # "next-l" entries epsi0[m0, n0] (for the n-1 coupling) and
    # epsi0[m0, n0+1] (for the n+1 coupling).
    eps_m = epsi[:mx, :nx]        # eps at (m0, n0):   l = m0+n0
    eps_p = epsi[:mx, 1:nx + 1]   # eps at (m0, n0+1): l = m0+n0+1

    with np.errstate(divide="ignore", invalid="ignore"):
        uvdx = np.where(
            n0 == 0,
            -pc.REARTH / (m0 + 1.0),
            -pc.REARTH * m0 / np.where(n0 == 0, 1.0, ell * (ell + 1.0)),
        )
        gradym = np.where(n0 == 0, 0.0, (ell - 1.0) * eps_m / pc.REARTH)
        uvdym = np.where(n0 == 0, 0.0, -pc.REARTH * eps_m / np.where(ell == 0, 1.0, ell))
        vddym = np.where(n0 == 0, 0.0, (ell + 1.0) * eps_m / pc.REARTH)
    gradyp = (ell + 2.0) * eps_p / pc.REARTH
    uvdyp = -pc.REARTH * eps_p / (ell + 1.0)
    vddyp = ell * eps_p / pc.REARTH

    # Zonal DFT matrices
    ix = params.ix
    theta = 2.0 * np.pi * np.outer(np.arange(ix), np.arange(mx)) / ix
    dft_fwd_re = np.cos(theta) / ix
    dft_fwd_im = -np.sin(theta) / ix
    dup = np.where(np.arange(mx) == 0, 1.0, 2.0)
    dft_inv_re = (dup[:, None] * np.cos(theta).T)
    dft_inv_im = (-dup[:, None] * np.sin(theta).T)

    # Full-sphere fold operators (south rows: even-odd; north rows: flipped
    # even+odd; direct variant with quadrature weights folded in)
    cpol_inv_full = np.concatenate(
        [cpol_even - cpol_odd, (cpol_even + cpol_odd)[::-1]], axis=0)
    wt3 = wt[:, None, None]
    cpol_dir_full = np.concatenate(
        [(cpol_even - cpol_odd) * wt3,
         ((cpol_even + cpol_odd) * wt3)[::-1]], axis=0)

    # Dense block-diagonal Legendre matrices (see SpectralTransform docstring).
    # Gated by size: the zero-padding costs mx-fold FLOPs/memory, a clear win
    # at T30 (6 MB, removes all relayout copies) but not at T63 (100+ MB).
    il = 2 * iy
    use_dense = use_matmul_fft and (il * mx * mx * nx) <= 4_000_000
    if use_dense:
        idx = np.arange(mx)
        Dd = np.zeros((il, mx, mx, nx))
        Dd[:, idx, idx, :] = cpol_dir_full
        leg_dir_dense = Dd.reshape(il * mx, mx * nx)
        Ed = np.zeros((mx, nx, il, mx))
        Ed[idx, :, :, idx] = cpol_inv_full.transpose(1, 2, 0)
        leg_inv_dense = Ed.reshape(mx * nx, il * mx)
    else:
        leg_dir_dense = np.zeros((1, 1))
        leg_inv_dense = np.zeros((1, 1))

    dt = np.float64 if params.precision == "f64" else np.float32
    a = lambda x: jnp.asarray(np.asarray(x, dtype=dt))
    return SpectralTransform(
        cpol_even=a(cpol_even), cpol_odd=a(cpol_odd), wt=a(wt),
        cosgr=a(geom.cosgr), cosgr2=a(geom.cosgr2),
        el2=a(el2), el4=a(el4), elm2=a(elm2), trfilt=a(trfilt),
        gradx=a(gradx), gradym=a(gradym), gradyp=a(gradyp),
        uvdx=a(uvdx), uvdym=a(uvdym), uvdyp=a(uvdyp),
        vddym=a(vddym), vddyp=a(vddyp),
        dft_fwd_re=a(dft_fwd_re), dft_fwd_im=a(dft_fwd_im),
        dft_inv_re=a(dft_inv_re), dft_inv_im=a(dft_inv_im),
        cpol_inv_full=a(cpol_inv_full), cpol_dir_full=a(cpol_dir_full),
        dft_fwd_ri=a(np.stack([dft_fwd_re, dft_fwd_im])),
        dft_inv_ri=a(np.stack([dft_inv_re, dft_inv_im])),
        leg_dir_dense=a(leg_dir_dense), leg_inv_dense=a(leg_inv_dense),
        use_matmul_fft=use_matmul_fft,
        use_dense_legendre=use_dense,
    )


# ---------------------------------------------------------------------------
# Fourier (longitude) stage
# ---------------------------------------------------------------------------

def _check_static_flags(sp: SpectralTransform) -> None:
    """The path-selection flags are consulted with Python `if` inside traced
    code: they MUST be Python bools at trace time. That holds when the
    transform is closed over (the Consts pattern everywhere in this package);
    passing a SpectralTransform as a jit *argument* would turn the flags into
    tracers — fail loudly instead of mis-tracing."""
    if not (isinstance(sp.use_matmul_fft, bool)
            and isinstance(sp.use_dense_legendre, bool)):
        raise TypeError(
            "SpectralTransform path flags became traced values; pass the "
            "transform by closure (e.g. via Consts), not as a jit argument.")


def _fourier_direct(sp: SpectralTransform, grid: jnp.ndarray) -> jnp.ndarray:
    """Grid -> zonal Fourier coefficients, 1/ix normalized (fourier.f90:96-123).

    numpy's rfft convention (C - iS packing) coincides with FFTPACK's rfftf.
    """
    ix = grid.shape[-1]
    if sp.use_matmul_fft:
        re = einsum("...i,im->...m", grid, sp.dft_fwd_re)
        im = einsum("...i,im->...m", grid, sp.dft_fwd_im)
        return (re + 1j * im).astype(sp.cdtype)
    F = jnp.fft.rfft(grid, axis=-1)[..., : sp.mx] / ix
    return F.astype(sp.cdtype)


def _fourier_inverse(sp: SpectralTransform, F: jnp.ndarray, kcos: int) -> jnp.ndarray:
    """Zonal Fourier coefficients -> grid (fourier.f90:63-93).

    kcos=1: raw field; otherwise the output is scaled by 1/cos(lat).
    The imaginary part of the m=0 coefficient is discarded, as in the
    reference packing.
    """
    ix = 2 * sp.il  # ix == 2*il for the supported grids (96 = 2*48)
    # Drop the m=0 imaginary part (fused, instead of a scattered set)
    mask0 = np.zeros((1, sp.mx))
    mask0[0, 0] = 1.0
    F = F - 1j * (F.imag * jnp.asarray(mask0, dtype=F.real.dtype))
    if sp.use_matmul_fft:
        g = (einsum("...m,mi->...i", F.real, sp.dft_inv_re)
             + einsum("...m,mi->...i", F.imag, sp.dft_inv_im))
        g = g.astype(sp.rdtype)
    else:
        pad = [(0, 0)] * (F.ndim - 1) + [(0, ix // 2 + 1 - sp.mx)]
        Fp = jnp.pad(F, pad)
        g = jnp.fft.irfft(Fp, n=ix, axis=-1) * ix
        g = g.astype(sp.rdtype)
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return g


# ---------------------------------------------------------------------------
# Legendre (latitude) stage
# ---------------------------------------------------------------------------

def _legendre_direct(sp: SpectralTransform, F: jnp.ndarray) -> jnp.ndarray:
    """Fourier (..., il, mx) -> spectral (..., mx, nx) (legendre.f90:175-221).

    The reference folds hemispheres into even/odd parity sums before the
    weighted projection; here the parity fold and Gaussian weights are baked
    into a full-sphere operator (cpol_dir_full) so the whole stage is ONE
    batched einsum. FLOPs are identical to the parity-split pair of einsums
    (the split operators are half zeros), but the slice/flip/concat copies
    of the explicit fold disappear.
    """
    return einsum("jmn,...jm->...mn", sp.cpol_dir_full, F)


def _legendre_inverse(sp: SpectralTransform, spec: jnp.ndarray) -> jnp.ndarray:
    """Spectral (..., mx, nx) -> Fourier (..., il, mx) synthesis
    (legendre.f90:130-169), as one full-sphere einsum (see _legendre_direct)."""
    return einsum("jmn,...mn->...jm", sp.cpol_inv_full, spec)


def _leg_dir_dense(sp: SpectralTransform, F: jnp.ndarray) -> jnp.ndarray:
    """Fourier (..., il, mx) -> spectral (..., mx, nx) as ONE flat matmul
    against the block-diagonal dense operator (see SpectralTransform).

    bfloat16 operands (Consts.bf16_tendencies path) contract against a
    bf16 copy of the table (constant-folded once) with f32 accumulation;
    the spectral result is always f32."""
    x = F.reshape(*F.shape[:-2], sp.il * sp.mx)
    if x.dtype == jnp.bfloat16:
        out = matmul(x, sp.leg_dir_dense.astype(jnp.bfloat16),
                  preferred_element_type=sp.rdtype)
    else:
        out = matmul(x, sp.leg_dir_dense)
    return out.reshape(*F.shape[:-2], sp.mx, sp.nx)


def _leg_inv_dense(sp: SpectralTransform, S: jnp.ndarray) -> jnp.ndarray:
    """Spectral (..., mx, nx) -> Fourier (..., il, mx) as ONE flat matmul."""
    x = S.reshape(*S.shape[:-2], sp.mx * sp.nx)
    return matmul(x, sp.leg_inv_dense).reshape(*S.shape[:-2], sp.il, sp.mx)


# ---------------------------------------------------------------------------
# Public transforms and operators
# ---------------------------------------------------------------------------

def grid2spec(sp: SpectralTransform, grid: jnp.ndarray) -> jnp.ndarray:
    """Grid (..., il, ix) -> spectral (..., mx, nx) (spectral.f90:263-273).

    On the matmul-FFT path the whole transform runs in real arithmetic:
    one DFT einsum producing the stacked (cos, sin) Fourier pair and one
    c-batched Legendre einsum, with the complex view assembled only at the
    boundary, so no per-plane extraction copies of the re/im components
    are created.
    """
    _check_static_flags(sp)
    if not sp.use_matmul_fft:
        return _legendre_direct(sp, _fourier_direct(sp, grid))
    if sp.use_dense_legendre:
        # Pure chain of (..., X) @ (X, Y) matmuls: contraction always on the
        # minormost axis, zero batch dims, so XLA inserts no relayout copies.
        s_re = _leg_dir_dense(sp, matmul(grid, sp.dft_fwd_re))
        s_im = _leg_dir_dense(sp, matmul(grid, sp.dft_fwd_im))
        return jax.lax.complex(s_re, s_im).astype(sp.cdtype)
    F2 = einsum("...ji,cim->c...jm", grid, sp.dft_fwd_ri)
    S2 = einsum("jmn,c...jm->c...mn", sp.cpol_dir_full, F2)
    return jax.lax.complex(S2[0], S2[1]).astype(sp.cdtype)


def spec2grid(sp: SpectralTransform, spec: jnp.ndarray, kcos: int = 1) -> jnp.ndarray:
    """Spectral (..., mx, nx) -> grid (..., il, ix) (spectral.f90:251-261).

    Matmul-FFT path: real-pair pipeline (see grid2spec); the reference's
    "discard m=0 imaginary part" rule is inherent in dft_inv_ri[1, 0] == 0.
    """
    _check_static_flags(sp)
    if not sp.use_matmul_fft:
        return _fourier_inverse(sp, _legendre_inverse(sp, spec), kcos)
    if sp.use_dense_legendre:
        # dft_inv_im row m=0 is identically zero (sin 0), which realizes the
        # reference's "discard the m=0 imaginary part" rule (fourier.f90:72-76)
        # without masking.
        g = (matmul(_leg_inv_dense(sp, spec.real), sp.dft_inv_re)
             + matmul(_leg_inv_dense(sp, spec.imag), sp.dft_inv_im))
        g = g.astype(sp.rdtype)
    else:
        S2 = jnp.stack([spec.real, spec.imag])
        F2 = einsum("jmn,c...mn->c...jm", sp.cpol_inv_full, S2)
        g = einsum("c...jm,cmi->...ji", F2, sp.dft_inv_ri).astype(sp.rdtype)
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return g


# ---------------------------------------------------------------------------
# Real-pair spectral representation
# ---------------------------------------------------------------------------
# The model state stores spectral fields as REAL arrays with a leading c axis
# of size 2 (c=0: real part, c=1: imaginary part): vor is (2, kx, mx, nx), ps
# is (2, mx, nx). Every spectral-space operator in the model is linear with
# real coefficients except multiplication by i*m (the zonal derivative), which
# is a plane swap with a sign — so the whole spectral side runs in real
# arithmetic: complex einsums and re/im extraction would lower to relayout
# copies, and no traced graph carries a complex dtype. All right-aligned
# (mx, nx)-table broadcasts work unchanged on pairs.


def pair(spec: jnp.ndarray) -> jnp.ndarray:
    """Complex (..., mx, nx) -> real pair (2, ..., mx, nx)."""
    return jnp.stack([jnp.real(spec), jnp.imag(spec)])


def unpair(p: jnp.ndarray) -> jnp.ndarray:
    """Real pair (2, ..., mx, nx) -> complex (..., mx, nx)."""
    return jax.lax.complex(p[0], p[1])


def _imul_p(coef, p: jnp.ndarray) -> jnp.ndarray:
    """(i * coef) * p for a real broadcastable coef: (re, im) -> (-c*im, c*re)."""
    return jnp.stack([-coef * p[1], coef * p[0]])


def grid2spec_p(sp: SpectralTransform, grid: jnp.ndarray) -> jnp.ndarray:
    """Grid (..., il, ix) -> spectral pair (2, ..., mx, nx).

    Same arithmetic as grid2spec (spectral.f90:263-273) without ever forming
    a complex array on the matmul path."""
    _check_static_flags(sp)
    if grid.dtype == jnp.bfloat16 and sp.use_matmul_fft \
            and sp.use_dense_legendre:
        # bf16 operand pipeline (tendency-class fields only — see
        # Consts.bf16_tendencies): bf16 x bf16 dots with f32
        # accumulation; the Fourier intermediate stays bf16 so both GEMMs
        # read 2-byte operands. Output spectral pair is f32.
        dr = sp.dft_fwd_re.astype(jnp.bfloat16)
        di = sp.dft_fwd_im.astype(jnp.bfloat16)
        fr = matmul(grid, dr, preferred_element_type=jnp.bfloat16)
        fi = matmul(grid, di, preferred_element_type=jnp.bfloat16)
        return jnp.stack([_leg_dir_dense(sp, fr), _leg_dir_dense(sp, fi)])
    if grid.dtype == jnp.bfloat16:
        grid = grid.astype(sp.rdtype)
    if not sp.use_matmul_fft:
        return pair(_legendre_direct(sp, _fourier_direct(sp, grid)))
    if sp.use_dense_legendre:
        return jnp.stack([_leg_dir_dense(sp, matmul(grid, sp.dft_fwd_re)),
                          _leg_dir_dense(sp, matmul(grid, sp.dft_fwd_im))])
    F2 = einsum("...ji,cim->c...jm", grid, sp.dft_fwd_ri)
    return einsum("jmn,c...jm->c...mn", sp.cpol_dir_full, F2)


def spec2grid_p(sp: SpectralTransform, p: jnp.ndarray, kcos: int = 1) -> jnp.ndarray:
    """Spectral pair (2, ..., mx, nx) -> grid (..., il, ix).

    The reference's "discard the m=0 imaginary part" rule (fourier.f90:72-76)
    is inherent in dft_inv_ri[1, 0, :] == 0."""
    _check_static_flags(sp)
    if not sp.use_matmul_fft:
        return _fourier_inverse(sp, _legendre_inverse(sp, unpair(p)), kcos)
    if sp.use_dense_legendre:
        g = (matmul(_leg_inv_dense(sp, p[0]), sp.dft_inv_re)
             + matmul(_leg_inv_dense(sp, p[1]), sp.dft_inv_im)).astype(sp.rdtype)
    else:
        F2 = einsum("jmn,c...mn->c...jm", sp.cpol_inv_full, p)
        g = einsum("c...jm,cmi->...ji", F2, sp.dft_inv_ri).astype(sp.rdtype)
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return g


def gradient_p(sp: SpectralTransform, psi: jnp.ndarray):
    """gradient() on a real pair (spectral.f90:275-296)."""
    psdx = _imul_p(sp.gradx[:, None], psi)
    psdy = -sp.gradym * _shift_dn(psi) + sp.gradyp * _shift_up(psi)
    return psdx, psdy


def vel2vort_p(sp: SpectralTransform, ucosm: jnp.ndarray, vcosm: jnp.ndarray):
    """vel2vort() on real pairs (spectral.f90:160-186)."""
    zp = _no_zonal_last_row(sp, _imul_p(sp.gradx[:, None], ucosm))
    zc = _no_zonal_last_row(sp, _imul_p(sp.gradx[:, None], vcosm))
    vorm = sp.vddym * _shift_dn(ucosm) - sp.vddyp * _shift_up(ucosm) + zc
    divm = -sp.vddym * _shift_dn(vcosm) + sp.vddyp * _shift_up(vcosm) + zp
    return vorm, divm


def vort2vel_p(sp: SpectralTransform, vorm: jnp.ndarray, divm: jnp.ndarray):
    """vort2vel() on real pairs (spectral.f90:190-214)."""
    zp = _no_zonal_last_row(sp, _imul_p(sp.uvdx, vorm))
    zc = _no_zonal_last_row(sp, _imul_p(sp.uvdx, divm))
    ucosm = sp.uvdym * _shift_dn(vorm) - sp.uvdyp * _shift_up(vorm) + zc
    vcosm = -sp.uvdym * _shift_dn(divm) + sp.uvdyp * _shift_up(divm) + zp
    return ucosm, vcosm


def grid_vel2vort_p(sp: SpectralTransform, ug: jnp.ndarray, vg: jnp.ndarray,
                    kcos: int = 2):
    """grid_vel2vort() returning real pairs (spectral.f90:218-248)."""
    scale = sp.cosgr if kcos == 2 else sp.cosgr2
    specu = grid2spec_p(sp, ug * scale[:, None])
    specv = grid2spec_p(sp, vg * scale[:, None])
    return vel2vort_p(sp, specu, specv)


def truncate(sp: SpectralTransform, spec: jnp.ndarray) -> jnp.ndarray:
    """Triangular truncation to l <= trunc (spectral.f90:134-138)."""
    return spec * sp.trfilt


def laplacian(sp: SpectralTransform, spec: jnp.ndarray) -> jnp.ndarray:
    return -spec * sp.el2


def laplacian_inv(sp: SpectralTransform, spec: jnp.ndarray) -> jnp.ndarray:
    return -spec * sp.elm2


def _shift_dn(x: jnp.ndarray) -> jnp.ndarray:
    """x[..., n] -> x[..., n-1] with zero inflow (n axis last)."""
    return jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)


def _shift_up(x: jnp.ndarray) -> jnp.ndarray:
    """x[..., n] -> x[..., n+1] with zero inflow."""
    return jnp.concatenate([x[..., 1:], jnp.zeros_like(x[..., :1])], axis=-1)


def _no_zonal_last_row(sp: SpectralTransform, z: jnp.ndarray) -> jnp.ndarray:
    """The reference omits the zonal-derivative term on the last n row
    (spectral.f90:174-177, 201-205). Applied as a fused mask multiply (a
    scattered .at[...,-1].set would cost a dynamic-update-slice launch)."""
    nx = z.shape[-1]
    mask = np.ones((1, nx))
    mask[0, -1] = 0.0
    return z * jnp.asarray(mask, dtype=z.real.dtype)


def gradient(sp: SpectralTransform, psi: jnp.ndarray):
    """Spectral zonal/meridional gradient (spectral.f90:275-296).
    Returns (psdx, psdy); the grid-space x-derivative requires a later
    1/cos(lat) scaling (kcos != 1 in spec2grid)."""
    psdx = 1j * sp.gradx[:, None] * psi
    psdy = -sp.gradym * _shift_dn(psi) + sp.gradyp * _shift_up(psi)
    return psdx, psdy


def vel2vort(sp: SpectralTransform, ucosm: jnp.ndarray, vcosm: jnp.ndarray):
    """Spectral (U, V)=(u,v)*cos(lat) -> (vor, div) (spectral.f90:160-186)."""
    zp = _no_zonal_last_row(sp, 1j * sp.gradx[:, None] * ucosm)
    zc = _no_zonal_last_row(sp, 1j * sp.gradx[:, None] * vcosm)
    vorm = sp.vddym * _shift_dn(ucosm) - sp.vddyp * _shift_up(ucosm) + zc
    divm = -sp.vddym * _shift_dn(vcosm) + sp.vddyp * _shift_up(vcosm) + zp
    return vorm, divm


def vort2vel(sp: SpectralTransform, vorm: jnp.ndarray, divm: jnp.ndarray):
    """Spectral (vor, div) -> (U, V)=(u,v)*cos(lat) (spectral.f90:190-214)."""
    zp = _no_zonal_last_row(sp, 1j * sp.uvdx * vorm)
    zc = _no_zonal_last_row(sp, 1j * sp.uvdx * divm)
    ucosm = sp.uvdym * _shift_dn(vorm) - sp.uvdyp * _shift_up(vorm) + zc
    vcosm = -sp.uvdym * _shift_dn(divm) + sp.uvdyp * _shift_up(divm) + zp
    return ucosm, vcosm


def grid_vel2vort(sp: SpectralTransform, ug: jnp.ndarray, vg: jnp.ndarray,
                  kcos: int = 2):
    """Grid (u, v) -> spectral (vor, div) (spectral.f90:218-248).
    kcos=2 scales the input by 1/cos(lat), otherwise by 1/cos^2(lat)."""
    scale = sp.cosgr if kcos == 2 else sp.cosgr2
    specu = grid2spec(sp, ug * scale[:, None])
    specv = grid2spec(sp, vg * scale[:, None])
    return vel2vort(sp, specu, specv)


def grid_filter(sp: SpectralTransform, fg: jnp.ndarray) -> jnp.ndarray:
    """Spectrally truncate a grid-point field (spectral.f90:299-317).
    Runs through the real-pair pipeline (identical arithmetic, no complex
    intermediates)."""
    return spec2grid_p(sp, truncate(sp, grid2spec_p(sp, fg)), 1)
