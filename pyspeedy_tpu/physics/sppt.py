"""SPPT stochastic physics pattern (reference: speedy.f90/sppt.f90).

Deliberate divergences from the reference, which are documented bugs there
(SURVEY.md "known quirks"): the spectral AR(1) state persists across steps in
the model state (the reference loses it to a local variable, sppt.f90:48-51),
and the RNG is a keyed, reproducible jax.random stream per member instead of
a wall-clock-seeded global generator (sppt.f90:132-145).

Performance: at small ensembles the step is launch-bound, so the
per-step pattern generation is kept to a handful of fused HLOs — the
wavenumber amplitude sigma and the AR(1) coefficients are HOST numpy
constants (built once in build_sppt_tables, folded by XLA), and both
clipped-normal planes come from ONE jax.random.normal call. The
multiplicative application itself lives INSIDE physics/driver.grid_physics
(before the bf16 tendency cast), so it fuses with the physics chain.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as pc

__all__ = ["gen_sppt", "gen_sppt_n", "init_sppt_state", "stationary_draw",
           "build_sppt_tables", "SpptTables", "as_typed_key"]


def as_typed_key(k):
    """Typed PRNG key from either a typed key or raw uint32 key data.

    The state stores sppt_key as RAW KEY DATA: a typed (extended-dtype) key
    array riding the vmapped scan carry defeats the while-loop carry
    optimizations even when never rewritten. Raw uint32 data is a plain
    carry; wrapping back to a typed key inside the step is free."""
    import jax.dtypes

    k = jnp.asarray(k)
    if jax.dtypes.issubdtype(k.dtype, jax.dtypes.prng_key):
        return k
    return jax.random.wrap_key_data(k, impl="threefry2x32")

TIME_DECORR = 6.0       # decorrelation time [h]
LEN_DECORR = 500000.0   # correlation length [m]
STDDEV = 0.33           # grid-space standard deviation


class SpptTables(NamedTuple):
    """Host-side AR(1) constants (folded into the compiled step)."""

    sigma: np.ndarray   # (1, 1, mx, nx) wavenumber amplitude (sppt.f90:84-92)
    phi: float          # AR(1) coefficient exp(-dt/tau)
    stat: float         # stationary-variance factor (1-phi^2)^(-1/2)


def _phi_val(params) -> float:
    return float(np.exp(-(24.0 / params.nsteps) / TIME_DECORR))


def build_sppt_tables(params, el2_np: np.ndarray) -> SpptTables:
    """Wavenumber-dependent amplitude + AR(1) coefficients (sppt.f90:30-92)
    as numpy constants; el2_np is the host copy of the Laplacian-eigenvalue
    table (l(l+1)/a^2, shape (mx, nx))."""
    phi = _phi_val(params)
    n = np.arange(1, params.trunc + 1, dtype=np.float64)
    f0 = np.sum((2 * n + 1) * np.exp(
        -0.5 * (LEN_DECORR / pc.REARTH) ** 2 * n * (n + 1)))
    f0 = np.sqrt((STDDEV**2 * (1 - phi**2)) / (2 * f0))
    sigma = f0 * np.exp(-0.25 * LEN_DECORR**2 * np.asarray(el2_np, np.float64))
    rdt = np.float64 if params.precision == "f64" else np.float32
    return SpptTables(sigma=sigma[None, None].astype(rdt), phi=phi,
                      stat=float((1 - phi**2) ** (-0.5)))


def init_sppt_state(params, key):
    """Initial AR(1) state: a zero pattern plus the member's base RNG key
    (stored as raw key data — see as_typed_key). model.initialize replaces
    the zeros with a stationary-variance draw (sppt.f90:92) once the
    spectral tables exist — no first-step flag ever rides the scan carry.
    sppt_spec is a real pair (2, kx, mx, nx)."""
    return {
        "sppt_spec": jnp.zeros((2, params.kx, params.mx, params.nx),
                               dtype=params.dtype),
        "sppt_key": jax.random.key_data(as_typed_key(key)),
    }


def stationary_draw(consts, key):
    """Stationary-variance AR(1) state (sppt.f90:92): the correct
    initialization the reference's lost-state bug prevents it from ever
    using. Runs eagerly at model init (a handful of tiny cached ops)."""
    params = consts.params
    tables = consts.sppt
    shape = (2, params.kx, params.mx, params.nx)
    eta = jnp.clip(
        jax.random.normal(jax.random.fold_in(as_typed_key(key), 0x5bb7),
                          shape, dtype=params.dtype), -10.0, 10.0)
    return tables.stat * tables.sigma * eta


def gen_sppt_n(consts, state, n: int, stepno):
    """Advance the AR(1) spectral pattern n steps and return the n grid-space
    multiplicative fields, clipped to +-1 (sppt.f90:40-111).

    Performance contract: at small ensembles the batched step is
    launch-bound and extra per-iteration scan-carry fields are the dominant
    SPPT cost, not the RNG or the transform. So
    (a) the noise is COUNTER-BASED — fold_in(member_key, stepno) — which
    leaves sppt_key loop-invariant (never rewritten, and stored as RAW
    uint32 data so no extended-dtype array rides the carry — see
    as_typed_key), and (b) the n per-step patterns of one scan group come
    from ONE fused RNG draw and ONE batched inverse transform. Only
    sppt_spec truly rides the carry (the AR(1) recursion is sequential).
    Counter-based keying also makes the stream a function of (member key,
    group start step) rather than of call history: identically grouped runs
    reproduce exactly however they are dispatched.

    The AR(1) recursion is exact — spec_j = phi*spec_{j-1} + sigma*eta_j —
    so the statistics equal n sequential single-step updates."""
    from ..ops import spectral as S

    params = consts.params
    tables = consts.sppt
    shape = (n, 2, params.kx, params.mx, params.nx)

    k1 = jax.random.fold_in(as_typed_key(state["sppt_key"]), stepno)
    # Complex white noise as real pairs (re, im): same per-plane draws as
    # the complex formulation, one fused RNG call for all planes and steps.
    eta = jnp.clip(jax.random.normal(k1, shape, dtype=params.dtype),
                   -10.0, 10.0)
    se = tables.sigma * eta

    spec = state["sppt_spec"]
    specs = []
    for j in range(n):
        spec = tables.phi * spec + se[j]
        specs.append(spec)

    stacked = jnp.stack(specs, axis=1)  # (2, n, kx, mx, nx)
    patterns = jnp.clip(S.spec2grid_p(consts.sp, stacked, 1), -1.0, 1.0)

    state = dict(state)
    state["sppt_spec"] = spec
    return patterns, state  # (n, kx, il, ix)


def gen_sppt(consts, state, stepno):
    """Single-step gen_sppt_n (traced-flag step paths)."""
    patterns, state = gen_sppt_n(consts, state, 1, stepno)
    return patterns[0], state
