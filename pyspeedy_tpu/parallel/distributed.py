"""Multi-host execution: jax.distributed initialization, DCN-aware meshes,
and global ensemble construction.

The reference has no distributed layer at all (its ensemble runner is an
OpenMP loop, speedy_driver.f90:58-79). The scale-out design keeps the
member ("ensemble") axis over the slow interconnect (the network, across
hosts) — members never communicate, so it carries zero steady-state
traffic — and the latitude/wavenumber ("space") axis over the fast links
within a host, where the transform transpose collectives live.

Typical multi-host entry:

    from pyspeedy_tpu.parallel import distributed as D
    D.initialize_distributed()                  # env/args -> jax.distributed
    mesh = D.make_hybrid_mesh(n_space=4)        # ensemble x space, DCN-aware
    state = D.make_global_ensemble(state, n_members, mesh)
    run = make_run_steps_batched(consts, mesh=mesh)

`tools/launch_multihost.py` drives this path with N local CPU processes
(virtual devices) so the multi-process code is testable on one host.
"""

from __future__ import annotations

import os

import jax
import numpy as np

__all__ = ["initialize_distributed", "make_hybrid_mesh",
           "make_global_ensemble", "process_local_members"]

_INITIALIZED = False


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None) -> bool:
    """Initialize jax.distributed for multi-process execution (idempotent).

    Arguments default from the standard environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, also set
    by tools/launch_multihost.py). Returns True if distributed mode is
    active (more than one process), False for single-process runs.
    """
    global _INITIALIZED
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process: nothing to initialize

    if not _INITIALIZED:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
        _INITIALIZED = True
    return jax.process_count() > 1


def make_hybrid_mesh(n_space: int = 1, devices=None):
    """("ensemble", "space") Mesh that maps "space" onto the fastest
    (intra-host / ICI) axis and "ensemble" across hosts (DCN).

    For a single process this reduces to parallel.mesh.make_mesh. For
    multi-process runs it requires n_space to divide the per-process device
    count, so every transform collective stays inside one process/slice and
    DCN only ever separates ensemble shards.
    """
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    n_total = len(devices)
    if n_total % n_space != 0:
        raise ValueError(f"n_space={n_space} does not divide {n_total}")

    if jax.process_count() > 1:
        per_proc = len([d for d in devices
                        if d.process_index == jax.process_index()])
        if per_proc % n_space != 0:
            raise ValueError(
                f"n_space={n_space} must divide the per-process device "
                f"count {per_proc} so transform collectives stay off DCN")
        # Order devices so the space axis varies fastest within a process:
        # (process-major, local-minor) -> reshape (ensemble, space).
        devs = sorted(devices, key=lambda d: (d.process_index, d.id))
        dev_array = np.asarray(devs).reshape(n_total // n_space, n_space)
        return Mesh(dev_array, axis_names=("ensemble", "space"))

    from .mesh import make_mesh
    return make_mesh(n_ensemble=n_total // n_space, n_space=n_space,
                     devices=devices)


def process_local_members(n_members: int, mesh) -> range:
    """Member-id range owned by this process under ensemble sharding."""
    n_ens = mesh.shape["ensemble"]
    if n_members % n_ens != 0:
        raise ValueError(f"{n_members} members not divisible by "
                         f"ensemble={n_ens}")
    per_shard = n_members // n_ens
    # ensemble shards owned by this process (mesh rows are process-major)
    rows = [i for i in range(n_ens)
            if mesh.devices[i, 0].process_index == jax.process_index()]
    if not rows:
        return range(0)
    return range(rows[0] * per_shard, (rows[-1] + 1) * per_shard)


def make_global_ensemble(state: dict, n_members: int, mesh,
                         shard_space: bool = True) -> dict:
    """Member-batch `state` onto the (possibly multi-process) mesh.

    Every process computes the same host-side values (broadcast_state is
    deterministic), and jax.make_array_from_callback assembles the global
    arrays from each process's addressable shards — the standard
    multi-process construction (no cross-host transfer of full arrays).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .ensemble import broadcast_state
    from .mesh import ensemble_state_sharding

    # Per-member SPPT keys are constructed HOST-SIDE (every process computes
    # the same fold_in chain deterministically, mirroring Speedy.set_bc's
    # per-member seeding) as raw uint32 key data (physics/sppt.as_typed_key)
    # — which also passes through make_array_from_callback like any array.
    sppt_key = state.get("sppt_key")
    if sppt_key is not None:
        from ..physics.sppt import as_typed_key

        base = as_typed_key(sppt_key)
        member_keys = jax.vmap(
            lambda i: jax.random.fold_in(base, i))(
                np.arange(n_members, dtype=np.uint32))
        key_data = np.asarray(jax.random.key_data(member_keys))
        state = {k: v for k, v in state.items() if k != "sppt_key"}

    batched = broadcast_state(state, n_members)
    if sppt_key is not None:
        batched["sppt_key"] = key_data
    shardings = ensemble_state_sharding(mesh, batched, shard_space)

    def place(x, sh):
        arr = np.asarray(x)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    return {
        k: (tuple(place(leaf, s) for leaf, s in zip(v, shardings[k]))
            if isinstance(v, tuple) else place(v, shardings[k]))
        for k, v in batched.items()
    }
