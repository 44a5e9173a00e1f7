"""Device-mesh and sharding layout for scale-out.

The reference's entire distributed layer is an OpenMP loop over ensemble
members (speedy_driver.f90:58-79). The replacement here is an
("ensemble", "space") jax.sharding.Mesh:

* the member axis of the batched state is sharded over "ensemble"
  (pure data parallelism — members never communicate);
* grid-space fields are sharded over latitude on "space" (the pencil
  decomposition of a spectral model: physics is column-local, so the only
  "space" communication is the all-to-all XLA inserts inside the
  grid<->spectral transforms);
* spectral (m, n) fields are sharded over m on "space".

With these input/output shardings declared on the jitted step, XLA's SPMD
partitioner inserts the transpose collectives automatically. The cards
of a host are joined all to all, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "ensemble_state_sharding", "ensemble_ctx_sharding"]


def make_mesh(n_ensemble: int = None, n_space: int = 1, devices=None) -> Mesh:
    """Build an ("ensemble", "space") mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_ensemble is None:
        n_ensemble = n_dev // n_space
    if n_ensemble * n_space != n_dev:
        raise ValueError(
            f"mesh {n_ensemble}x{n_space} != device count {n_dev}")
    dev_array = np.asarray(devices).reshape(n_ensemble, n_space)
    return Mesh(dev_array, axis_names=("ensemble", "space"))


# Spectral state fields are real (2, ..., mx, nx) pairs (ops/spectral.py) —
# not detectable by dtype, so they are named here (registry kind "c" plus the
# runtime-created spectral extras).
def _spectral_names():
    from ..registry import MODEL_STATE_VARS

    return ({s.name for s in MODEL_STATE_VARS if s.kind == "c"}
            | {"sppt_spec", "tcorh", "qcorh"})


def _spec_for_array(name: str, arr, batched: bool, shard_space: bool,
                    n_space: int, spectral_names=frozenset()) -> P:
    """PartitionSpec for one state array; `batched` marks a leading member
    axis (dynamic fields). Static fields are replicated over "ensemble"."""
    ndim = arr.ndim
    lead = ("ensemble",) if batched else ()
    body_ndim = ndim - len(lead)
    if body_ndim <= 0:
        return P(*lead) if lead else P()

    def with_axis(axis):
        spec = [None] * body_ndim
        if shard_space and arr.shape[len(lead) + axis] % n_space == 0:
            spec[axis] = "space"
        return P(*lead, *spec)

    if name in spectral_names:
        # spectral pair (2, ..., mx, nx): shard total-wavenumber n (innermost,
        # even size) over "space"; the Legendre contraction then reduces over
        # a sharded axis and XLA inserts the transpose collective.
        return with_axis(body_ndim - 1)
    if body_ndim >= 2 and arr.shape[-1] >= 32 and arr.shape[-2] >= 32:
        # grid (..., il, ix): latitude-band sharding over "space"
        return with_axis(body_ndim - 2)
    return P(*lead, *([None] * body_ndim))


def ensemble_state_sharding(mesh: Mesh, state: dict, shard_space: bool = True,
                            eph_batched: bool = False):
    """NamedSharding pytree for a member-batched state dict (DYNAMIC_FIELDS
    carry a leading member axis; the rest are member-shared).

    eph_batched: the batched runner's OUTPUT carries the final step's
    EPHEMERAL diagnostics member-batched (parallel/ensemble.py); its INPUT
    does not carry them at all."""
    from ..models.model import DYNAMIC_FIELDS, EPHEMERAL_FIELDS

    n_space = mesh.shape["space"]
    spectral_names = _spectral_names()
    shardings = {}
    for name, arr in state.items():
        if name in ("sppt_key",):
            shardings[name] = NamedSharding(mesh, P("ensemble"))
            continue
        batched = name in DYNAMIC_FIELDS and (
            eph_batched or name not in EPHEMERAL_FIELDS)
        shardings[name] = jax.tree.map(
            lambda a: NamedSharding(
                mesh, _spec_for_array(name, a, batched, shard_space, n_space,
                                      spectral_names)),
            arr)
    return shardings


def ensemble_ctx_sharding(mesh: Mesh, ctx: dict):
    """Per-step calendar scalars are replicated."""
    return {k: NamedSharding(mesh, P()) for k in ctx}
