"""Model configuration parameters.

The equivalent of the reference's compile-time configuration
(``speedy.f90/params.f90:18-44``).  Unlike the reference, the resolution is a
runtime (but trace-static) dataclass so several resolutions can coexist in one
process; the spectral/grid sizes feed static shapes into every jitted function.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

__all__ = ["ModelParams", "T30L8"]


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """Static model configuration (hashable; safe to close over in jit)."""

    # Spectral truncation / grid (reference params.f90:18-29)
    trunc: int = 30          # triangular truncation total wavenumber
    ix: int = 96             # number of longitudes
    iy: int = 24             # latitudes per hemisphere
    kx: int = 8              # vertical sigma levels
    ntr: int = 1             # number of tracers (q is tracer 1)

    # Time stepping (params.f90:32-39)
    nsteps: int = 36         # steps per day
    rob: float = 0.05        # Robert filter coefficient
    wil: float = 0.53        # Williams filter parameter
    alph: float = 0.5        # semi-implicit centering parameter

    # Physics cadence (params.f90:42-44)
    iseasc: int = 1          # seasonal cycle on/off
    nstrad: int = 3          # shortwave radiation period (steps)
    sppt_on: bool = False    # stochastic physics

    # Horizontal-diffusion damping times [hours] (reference compile-time
    # constants, physical_constants.f90:40-43). Runtime-configurable here
    # because higher truncations need stronger damping: with the T30 values
    # a T63 f32 run accumulates small-scale vorticity and blows up after
    # ~1 month (measured round 3).
    thd: float = 2.4         # del^8, temperature and vorticity
    thdd: float = 2.4        # del^8, divergence
    thds: float = 12.0       # del^2, stratospheric

    # Numerics: "f64" for reference parity, "f32" for the fast path.
    precision: str = "f64"

    # Zonal transform implementation: "fft" (jnp.fft), "matmul" (dense DFT,
    # shardable), or "auto" (see models/model.py build_consts).
    fft_mode: str = "auto"

    # The reference evaluates Legendre polynomials at first-guess (and
    # f32-rounded) Gaussian nodes while the quadrature weights are
    # Newton-converged (geometry.f90:110 vs legendre.f90:224-257), making its
    # transforms non-orthogonal at the ~5e-4 level. False replicates that for
    # parity; True uses converged f64 nodes (orthogonal to ~1e-12).
    exact_nodes: bool = False

    def __post_init__(self):
        if 86400 % self.nsteps != 0:
            raise ValueError(
                f"nsteps={self.nsteps} must divide 86400 so the model "
                "calendar advances an exact whole-second step")

    @property
    def il(self) -> int:
        return 2 * self.iy

    @property
    def mx(self) -> int:
        return self.trunc + 1

    @property
    def nx(self) -> int:
        return self.trunc + 2

    @property
    def t_levs(self) -> int:
        return 2

    @property
    def aux_dim(self) -> int:
        return 3

    @property
    def delt(self) -> float:
        return 86400.0 / self.nsteps

    @property
    def dtype(self):
        return jnp.float64 if self.precision == "f64" else jnp.float32

    @property
    def cdtype(self):
        return jnp.complex128 if self.precision == "f64" else jnp.complex64


T30L8 = ModelParams()


# Additional resolution presets. The reference is compile-time fixed at
# T30L8 (with sigma tables for 5/7/8 levels); here resolution is a runtime
# configuration: higher truncations use the same transform machinery with
# larger operator tables. The time step scales inversely with truncation
# (advective CFL): T30's dt=2400 s is marginal at T47 and unstable at T63
# (measured: a T47 f32 run with nsteps=36 trips the diagnostics check
# within ~weeks of simulation); nsteps stays a multiple of 3 so the
# phase-specialized shortwave cadence applies.
T30L5 = ModelParams(kx=5)
T30L7 = ModelParams(kx=7)
T47L8 = ModelParams(trunc=47, ix=144, iy=36, nsteps=54)   # dt = 1600 s
T63L8 = ModelParams(trunc=63, ix=192, iy=48, nsteps=72,   # dt = 1200 s
                    thd=0.8, thdd=0.8, thds=6.0)
