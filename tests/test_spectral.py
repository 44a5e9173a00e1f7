"""Unit tests for the spectral transform engine.

The reference has no transform-level tests; these validate mathematical
identities (quadrature exactness, harmonic eigenfunctions, roundtrips).

Identity tests run with ``exact_nodes=True`` (Newton-converged Gaussian
latitudes), where the transform pair is orthogonal to ~1e-12.  The default
reference-parity mode replicates pySPEEDY's node/weight inconsistency
(geometry.f90:110 vs legendre.f90:224-257) and is only ~5e-4 orthogonal; a
dedicated test pins that behavior.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pyspeedy_tpu.ops.geometry import build_geometry
from pyspeedy_tpu.ops import spectral as S
from pyspeedy_tpu.params import T30L8

EXACT = dataclasses.replace(T30L8, exact_nodes=True)

_cache = {}


def _build(params):
    key = params.exact_nodes
    if key not in _cache:
        geom = build_geometry(params)
        _cache[key] = (geom, S.build_spectral(params, geom))
    return _cache[key]


@pytest.fixture(scope="module")
def exact():
    geom, sp = _build(EXACT)
    return geom, sp


@pytest.fixture(scope="module")
def refmode():
    geom, sp = _build(T30L8)
    return geom, sp


def random_trunc_spec(sp, seed=0, batch=(), lmax=30):
    """Random spectral field supported on l <= lmax with real m=0 column."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal(batch + (sp.mx, sp.nx)) \
        + 1j * rng.standard_normal(batch + (sp.mx, sp.nx))
    spec[..., 0, :] = spec[..., 0, :].real
    m0 = np.arange(sp.mx)[:, None]
    n0 = np.arange(sp.nx)[None, :]
    spec = spec * (m0 + n0 <= lmax)
    return jnp.asarray(spec)


def test_weights_sum(exact):
    _, sp = exact
    assert np.isclose(float(jnp.sum(sp.wt)), 1.0, rtol=0, atol=1e-14)


def test_constant_field_mean_coding(exact):
    _, sp = exact
    g = jnp.full((48, 96), 3.0)
    spec = S.grid2spec(sp, g)
    # The spherical mean is stored as sqrt(2)*value at (0,0)
    # (cf. prognostics.f90:74-76).
    assert np.isclose(complex(spec[0, 0]).real, 3.0 * np.sqrt(2.0), atol=1e-12)
    others = np.asarray(spec).copy()
    others[0, 0] = 0
    assert np.max(np.abs(others)) < 1e-12


def test_reference_mode_node_weight_quirk(refmode):
    # Parity pin: with the reference's first-guess nodes the projection of a
    # constant leaks ~5e-4 into higher zonal-mean modes, exactly as pySPEEDY's
    # transform does. This is intentional behavior, not a bug here.
    _, sp = refmode
    g = jnp.full((48, 96), 1.0)
    spec = np.asarray(S.grid2spec(sp, g))
    leak = np.abs(spec[0, 2])
    assert 1e-5 < leak < 5e-3
    assert np.isclose(spec[0, 0].real, np.sqrt(2.0), atol=1e-3)


def test_roundtrip_spec_grid_spec(exact):
    _, sp = exact
    spec = random_trunc_spec(sp, seed=1)
    g = S.spec2grid(sp, spec, 1)
    spec2 = S.grid2spec(sp, g)
    np.testing.assert_allclose(np.asarray(spec2), np.asarray(spec),
                               rtol=0, atol=1e-12)


def test_roundtrip_batched(exact):
    _, sp = exact
    spec = random_trunc_spec(sp, seed=2, batch=(3, 8))
    g = S.spec2grid(sp, spec, 1)
    assert g.shape == (3, 8, 48, 96)
    spec2 = S.grid2spec(sp, g)
    np.testing.assert_allclose(np.asarray(spec2), np.asarray(spec),
                               rtol=0, atol=1e-12)


def test_grid_filter_idempotent(exact):
    _, sp = exact
    rng = np.random.default_rng(3)
    g = jnp.asarray(rng.standard_normal((48, 96)))
    f1 = S.grid_filter(sp, g)
    f2 = S.grid_filter(sp, f1)
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f1), atol=1e-12)


def test_zonal_gradient_of_harmonic(exact):
    geom, sp = exact
    # f = cos(m*lon) cos(lat)^m is a sectoral harmonic; the true zonal
    # derivative is (1/(a cos lat)) df/dlon = -(m/a) sin(m lon) cos^(m-1)(lat).
    m = 3
    lon = 2.0 * np.pi * np.arange(96) / 96.0
    coslat = geom.coa
    f = np.cos(m * lon)[None, :] * (coslat**m)[:, None]
    spec = S.grid2spec(sp, jnp.asarray(f))
    psdx, _ = S.gradient(sp, spec)
    dfdx = S.spec2grid(sp, psdx, 2)
    expected = -m * np.sin(m * lon)[None, :] * (coslat ** (m - 1))[:, None] / 6.371e6
    np.testing.assert_allclose(np.asarray(dfdx), expected, atol=1e-9)


def test_laplacian_eigenvalue(exact):
    _, sp = exact
    spec = jnp.zeros((31, 32), dtype=jnp.complex128).at[2, 3].set(1.0 + 0.5j)
    lap = S.laplacian(sp, spec)
    l = 2 + 3
    expected = -(l * (l + 1)) / 6.371e6**2 * (1.0 + 0.5j)
    assert np.isclose(complex(lap[2, 3]), expected)


def test_vort2vel_vel2vort_roundtrip(exact):
    # The model's own round trip (tendencies.f90:109-130):
    # (vor, div) --vort2vel--> (U, V) --spec2grid(kcos=2)--> grid (u, v)
    # --grid_vel2vort(kcos=2)--> (vor, div) recovers the original away from
    # the truncation boundary.
    _, sp = exact
    rng = np.random.default_rng(4)
    m0 = np.arange(sp.mx)[:, None]
    n0 = np.arange(sp.nx)[None, :]
    # scale ~ physical vorticity magnitudes; keep l well inside truncation
    mask = (m0 + n0 <= 20) & ((m0 + n0) > 0)
    vor = (rng.standard_normal((31, 32)) + 1j * rng.standard_normal((31, 32))) * mask * 1e-5
    div = (rng.standard_normal((31, 32)) + 1j * rng.standard_normal((31, 32))) * mask * 1e-5
    vor[0, :] = vor[0, :].real
    div[0, :] = div[0, :].real
    vor, div = jnp.asarray(vor), jnp.asarray(div)
    U, V = S.vort2vel(sp, vor, div)
    ug = S.spec2grid(sp, U, 2)
    vg = S.spec2grid(sp, V, 2)
    vor2, div2 = S.grid_vel2vort(sp, ug, vg, 2)
    # The roundtrip is exact inside the triangular truncation; the l=trunc+1
    # boundary row picks up aliasing that the model's truncate() removes
    # (time_stepping.f90:178-180).
    np.testing.assert_allclose(np.asarray(S.truncate(sp, vor2)), np.asarray(vor),
                               rtol=0, atol=1e-16)
    np.testing.assert_allclose(np.asarray(S.truncate(sp, div2)), np.asarray(div),
                               rtol=0, atol=1e-16)


def test_uv_from_pure_rotation(exact):
    geom, sp = exact
    # Solid-body rotation: u = U0 cos(lat) -> vor = 2 U0/a sin(lat), div = 0.
    U0 = 10.0
    u = U0 * geom.coa[:, None] * np.ones((48, 96))
    v = np.zeros((48, 96))
    vor, div = S.grid_vel2vort(sp, jnp.asarray(u), jnp.asarray(v), 2)
    vor_g = S.spec2grid(sp, vor, 1)
    expected_vor = 2.0 * U0 / 6.371e6 * geom.sia[:, None] * np.ones((48, 96))
    np.testing.assert_allclose(np.asarray(vor_g), expected_vor, atol=1e-12)
    assert np.max(np.abs(np.asarray(S.spec2grid(sp, div, 1)))) < 1e-12


def test_matmul_dft_equals_fft(exact):
    # The matmul-DFT path must agree with the FFT path to roundoff.
    geom = build_geometry(EXACT)
    sp_fft = S.build_spectral(EXACT, geom, use_matmul_fft=False)
    sp_mm = S.build_spectral(EXACT, geom, use_matmul_fft=True)
    rng = np.random.default_rng(7)
    g = jnp.asarray(rng.standard_normal((4, 48, 96)))
    s1 = S.grid2spec(sp_fft, g)
    s2 = S.grid2spec(sp_mm, g)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), atol=1e-13)
    g1 = S.spec2grid(sp_fft, s1, 2)
    g2 = S.spec2grid(sp_mm, s1, 2)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), atol=1e-12)
