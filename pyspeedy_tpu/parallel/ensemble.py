"""Batched ensemble execution — the replacement for the reference's OpenMP
`parallel_step` (speedy_driver.f90:58-79).

Members form a leading batch axis on every state array; one vmapped step
advances all members at once (the transforms become bigger batched matrix
products), and the member axis shards over the
"ensemble" mesh axis for multi-chip scale-out with zero cross-member
communication.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models import model as M
from .mesh import ensemble_state_sharding

__all__ = ["broadcast_state", "make_run_steps_batched", "shard_ensemble",
           "MEMBER_CHUNK", "pick_member_chunk", "pick_scan_unroll"]

# Member-axis chunk widths, shared by SpeedyEns and bench.py. They were
# tuned on an earlier accelerator and are not yet measured on the H100
# (ROADMAP speed item 7 re-sweeps them): a chunk bounds the per-scan working
# set, and at higher resolutions the per-member working set grows, so the
# chunk shrinks.
MEMBER_CHUNK = 128
MEMBER_CHUNK_HIRES = 8
_T30_GRID_POINTS = 96 * 48


def pick_member_chunk(n_members: int, params=None) -> int:
    """Chunk width for an n-member ensemble: the resolution's chunk when it
    divides the ensemble evenly, else the whole ensemble."""
    target = MEMBER_CHUNK
    if params is not None and params.ix * params.il > _T30_GRID_POINTS:
        target = MEMBER_CHUNK_HIRES
    if n_members > target and n_members % target == 0:
        return target
    return n_members


def pick_scan_unroll(chunk: int, params=None) -> int:
    """Scan unroll factor for a `chunk`-wide batched run: 2 below the T30
    MEMBER_CHUNK, where per-iteration overhead shows, else 1 (a step that
    saturates device memory only loses by unrolling). Like the chunk
    widths, a rule carried over unmeasured on the H100 (ROADMAP speed item
    7)."""
    hires = params is not None and params.ix * params.il > _T30_GRID_POINTS
    return 2 if (chunk < MEMBER_CHUNK and not hires) else 1


def broadcast_state(state: dict, n_members: int) -> dict:
    """Member-batch a single-member state: only the DYNAMIC_FIELDS get a
    leading member axis; loop-invariant fields (climatologies, masks,
    orography...) stay shared across members — they dominate the state's
    footprint and never change during a run."""
    def rep(name, x):
        if name == "sppt_key":
            # Distinct per-member streams, stored as raw key data (see
            # physics/sppt.as_typed_key).
            from ..physics.sppt import as_typed_key
            keys = jax.random.split(as_typed_key(x), n_members)
            return jax.random.key_data(keys)
        if name in M.DYNAMIC_FIELDS and name not in M.EPHEMERAL_FIELDS:
            return jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (n_members,) + a.shape), x)
        return x

    return {k: rep(k, v) for k, v in state.items()}


def make_run_steps_batched(consts, mesh=None, shard_space: bool = True,
                           donate: bool = False, phase: int | None = None,
                           fuse_transforms: bool = False, unroll: int = 1):
    """Jitted n-step integrator over a member-batched state (leading member
    axis on DYNAMIC_FIELDS only). When a mesh is given, the state is
    constrained to the ensemble/space sharding layout.

    phase: current_step % 3 at the scan start. With physics on, the scan
    runs SW-ALIGNED step triples (shortwave at position 0), so the
    radiation cache flows as within-body values and never crosses the scan
    carry (any n_steps). With physics off (or phase=None) the unaligned
    group scan is used (phase then requires n_steps % 3 == 0).

    donate: input-buffer donation invalidates the loop-invariant arrays
    SHARED between member-chunk states — off by default.

    unroll: lax.scan unroll factor for the step-group loop (the body is a
    3-step triple on the aligned path)."""
    import dataclasses

    # Per-field transforms batch well already under vmap; the fused
    # mega-concat variant materializes large intermediates (see Consts), so
    # it stays opt-in here.
    consts = dataclasses.replace(consts, fuse_transforms=fuse_transforms)

    # Carry only fields whose previous-step value is actually consumed;
    # EPHEMERAL_FIELDS are recomputed before use every step (see model.py).
    carry_fields = M.DYNAMIC_FIELDS - M.EPHEMERAL_FIELDS

    def split(state):
        dyn = {k: v for k, v in state.items() if k in carry_fields}
        static = {k: v for k, v in state.items() if k not in carry_fields}
        return dyn, static

    # SW-aligned execution (phase given, physics on): scan over triples that
    # START with the shortwave step, so the radiation cache (CACHE_FIELDS,
    # the largest carried block — rad_tau2 alone is 576 KB/member) flows as
    # within-body values and leaves the scan carry entirely. No bf16 cache
    # casts are needed on this path (nothing cache-like crosses the carry);
    # numerics are bitwise identical to the unaligned structure.
    sw_aligned = phase is not None and consts.physics_on
    sppt_grouped = consts.params.sppt_on and consts.physics_on
    if sw_aligned:
        from ..physics.driver import CACHE_FIELDS
        cache_names = frozenset(CACHE_FIELDS) & carry_fields
        step_sw = M.make_single_step(consts, static_sw=True)
        step_ns = M.make_single_step(consts, static_sw=False)
    if sppt_grouped:
        from ..physics.sppt import gen_sppt_n

    if phase is None:
        singles = [(M.make_single_step(consts), 1)]
    else:
        singles = [(M.make_single_step(
            consts, static_sw=((phase + j) % 3 == 0)), 3) for j in range(3)]
    group = singles[0][1]

    def run_aligned(state, ctx):
        n = jax.tree.leaves(ctx)[0].shape[0]
        q = min((3 - phase) % 3, n)          # no-SW steps before alignment
        m = n - q
        n_triples, r = divmod(m, 3)
        # tail (outside the scan): the last full triple plus the leftover —
        # its SW step recomputes the cache, returned member-batched together
        # with the final EPHEMERAL diagnostics.
        tail_n = m - 3 * max(n_triples - 1, 0)

        dyn, static = split(state)
        eph_names = M.EPHEMERAL_FIELDS

        def at(tree_ctx, i):
            return jax.tree.map(lambda a: a[i], tree_ctx)

        # -- prefix: consumes the incoming cache (still in the carry dict) --
        # When the whole run fits inside the prefix (m == 0: 1-2 no-SW
        # steps, reachable via 1-2-step SpeedyEns callback intervals), the
        # LAST prefix step must surface the EPHEMERAL diagnostics — they
        # were stripped from the input outside jit, so returning only the
        # carry would leave members with stale precnv/flux values.
        eph0 = {}
        for j in range(q):
            ctx_j = at(ctx, j)
            if j == q - 1 and m == 0:
                def one_pre(dd, c=ctx_j):
                    st = step_ns({**static, **dd}, c)
                    return ({k: st[k] for k in dd},
                            {k: st[k] for k in eph_names if k in st})

                dyn, eph0 = jax.vmap(one_pre)(dyn)
            else:
                def one_pre(dd, c=ctx_j):
                    st = step_ns({**static, **dd}, c)
                    return {k: st[k] for k in dd}

                dyn = jax.vmap(one_pre)(dyn)

        # -- aligned scan: cache stripped from the carry ------------------
        dyn_nc = {k: v for k, v in dyn.items() if k not in cache_names}
        if n_triples > 1:
            ctx_scan = jax.tree.map(
                lambda a: a[q:q + 3 * (n_triples - 1)].reshape(
                    (n_triples - 1, 3) + a.shape[1:]), ctx)

            def body(d, ctx_t):
                def one(dd):
                    st = {**static, **dd}
                    if sppt_grouped:
                        # One RNG draw + one batched pattern transform per
                        # triple (launch-bound at small ensembles; sppt.py).
                        pats, st = gen_sppt_n(consts, st, 3,
                                              ctx_t["stepno"][0])
                    for j, fn in enumerate((step_sw, step_ns, step_ns)):
                        c = at(ctx_t, j)
                        if sppt_grouped:
                            c = {**c, "sppt_pattern": pats[j]}
                        st = fn(st, c)
                    return {k: st[k] for k in dd}

                return jax.vmap(one)(d), None

            dyn_nc, _ = jax.lax.scan(body, dyn_nc, ctx_scan, unroll=unroll)

        # -- tail -----------------------------------------------------------
        if tail_n == 0:
            # No aligned step ran (m == 0): the incoming cache passes
            # through; the final prefix step's diagnostics come from eph0.
            return {**static, **dyn, **eph0}
        ctx_tail = jax.tree.map(lambda a: a[n - tail_n:], ctx)

        def one_tail(dd):
            st = {**static, **dd}
            if sppt_grouped:
                pats, st = gen_sppt_n(consts, st, tail_n,
                                      ctx_tail["stepno"][0])
            for j in range(tail_n):
                fn = step_sw if j % 3 == 0 else step_ns
                c = at(ctx_tail, j)
                if sppt_grouped:
                    c = {**c, "sppt_pattern": pats[j]}
                st = fn(st, c)
            return ({k: st[k] for k in dd},
                    {k: st[k] for k in cache_names},
                    {k: st[k] for k in eph_names if k in st})

        dyn_nc, cache_out, eph = jax.vmap(one_tail)(dyn_nc)
        return {**static, **dyn_nc, **cache_out, **eph}

    def run(state, ctx):
        if sw_aligned:
            return run_aligned(state, ctx)
        dyn, static = split(state)
        ctx_g = jax.tree.map(
            lambda a: a.reshape((-1, group) + a.shape[1:]), ctx)
        # The last step group runs OUTSIDE the scan so the final values of the
        # EPHEMERAL_FIELDS (per-step physics diagnostics: precnv, fluxes, ...)
        # come back member-batched without being carried through every scan
        # iteration. The reference's parallel_step leaves every member's
        # diagnostics current (physics.f90:123-226); this matches that at zero
        # per-step HBM cost.
        ctx_main = jax.tree.map(lambda a: a[:-1], ctx_g)
        ctx_last = jax.tree.map(lambda a: a[-1], ctx_g)

        def run_group(st, ctx_t):
            for j, (fn, _) in enumerate(singles):
                st = fn(st, {k: v[j] for k, v in ctx_t.items()})
            return st

        def body(d, ctx_t):
            def one(dd):
                st = run_group({**static, **dd}, ctx_t)
                return {k: st[k] for k in dd}

            return jax.vmap(one)(d), None

        dyn, _ = jax.lax.scan(body, dyn, ctx_main, unroll=unroll)

        # Ephemerals are collected member-batched from the final group only
        # on the physics-on path (where they are stripped from the input and
        # recomputed every step). With physics off they pass through static
        # untouched — returning them from the vmapped final group would
        # broadcast stale copies to member-batched shapes and break chaining.
        eph_names = M.EPHEMERAL_FIELDS if consts.physics_on else frozenset()

        def one_final(dd):
            st = run_group({**static, **dd}, ctx_last)
            return ({k: st[k] for k in dd},
                    {k: st[k] for k in eph_names if k in st})

        dyn, eph = jax.vmap(one_final)(dyn)
        return {**static, **dyn, **eph}

    if mesh is None:
        jrun = jax.jit(run, donate_argnums=(0,) if donate else ())
    else:
        def run_sharded(state, ctx):
            sh = ensemble_state_sharding(mesh, state, shard_space)
            state = jax.lax.with_sharding_constraint(state, sh)
            out = run(state, ctx)
            # The output gains member-batched EPHEMERAL diagnostics the
            # (stripped) input did not have: rebuild shardings on the output.
            # With physics off the ephemerals pass through UNbatched, so they
            # must keep replicated specs (eph_batched mirrors eph_names).
            sh_out = ensemble_state_sharding(mesh, out, shard_space,
                                             eph_batched=consts.physics_on)
            return jax.lax.with_sharding_constraint(out, sh_out)

        jrun = jax.jit(run_sharded, donate_argnums=(0,) if donate else ())

    # EPHEMERAL fields are never read before the (physics-on) step rewrites
    # them, and the output returns them member-batched — feeding that output
    # back in would change the jit signature (unbatched -> batched
    # ephemerals) and trigger a full recompile on the second call. Strip
    # them OUTSIDE the jit so chained day-by-day calls hit one executable.
    # (With physics off the coupler still reads hfluxn, so nothing is
    # stripped there.)
    stripped = M.EPHEMERAL_FIELDS if consts.physics_on else frozenset()

    def _strip(state):
        return {k: v for k, v in state.items() if k not in stripped}

    def run_chained(state, ctx):
        return jrun(_strip(state), ctx)

    run_chained.lower = lambda state, ctx: jrun.lower(_strip(state), ctx)
    return run_chained


def shard_ensemble(mesh, state: dict, shard_space: bool = True) -> dict:
    """Place a member-batched state onto the mesh."""
    sh = ensemble_state_sharding(mesh, state, shard_space)
    return jax.device_put(state, sh)
