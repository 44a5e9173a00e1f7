"""Multi-process launcher + worker for the distributed ensemble path.

Launcher mode (default): spawn N local worker processes, each a JAX process
with K virtual CPU devices, wire them to one coordination service, run a
short sharded ensemble integration, and check the result against the
single-process trajectory. This exercises the exact code a real multi-host
(DCN) deployment uses — jax.distributed.initialize, a process-spanning Mesh,
make_array_from_callback — without pod hardware.

    python tools/launch_multihost.py [n_processes] [devices_per_process]

Worker mode (internal): invoked by the launcher with JAX_COORDINATOR_ADDRESS
/ JAX_NUM_PROCESSES / JAX_PROCESS_ID set. On real hosts, run one worker per
host with those variables and call the same main_worker() path.

The launcher is CPU-only by design: its workers are separate processes, and
each would reserve most of a GPU's memory if it opened the card.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_STEPS = 6
MEMBERS_PER_ENSEMBLE_SHARD = 2


def main_worker():
    import numpy as np

    import jax

    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.parallel import distributed as D
    from pyspeedy_tpu.parallel.ensemble import make_run_steps_batched
    from pyspeedy_tpu.testing import make_demo_model
    from pyspeedy_tpu.params import T30L8
    import dataclasses

    D.initialize_distributed()
    params = dataclasses.replace(T30L8, fft_mode="matmul")

    n_space = int(os.environ.get("PYSPEEDY_N_SPACE", "1"))
    mesh = D.make_hybrid_mesh(n_space=n_space)
    n_members = MEMBERS_PER_ENSEMBLE_SHARD * mesh.shape["ensemble"]

    consts, state, cal = make_demo_model(params)
    gstate = D.make_global_ensemble(state, n_members, mesh)

    ctx, cal2 = M.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS)
    run = make_run_steps_batched(consts, mesh=mesh, donate=False, phase=2)
    out = run(gstate, ctx)
    jax.block_until_ready(out)

    # Each process checks its addressable shard against the single-member
    # trajectory (members are unperturbed clones of it). In multi-process
    # mode every jit output is a global array: read via addressable shards.
    def local_value(x):
        return np.asarray(x.addressable_shards[0].data)

    run1 = M.make_run_steps(consts)
    ctx1, _ = M.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS)
    ref = run1(dict(state), ctx1)
    ref_t0 = local_value(ref["t"][0])

    t0_global = out["t"][0]  # (n_members, kx, mx, nx) global array
    max_err = 0.0
    for shard in t0_global.addressable_shards:
        local = np.asarray(shard.data)
        ref_piece = ref_t0[shard.index[1:]]  # spatial slice of this shard
        for mloc in range(local.shape[0]):
            max_err = max(max_err,
                          float(np.abs(local[mloc] - ref_piece).max()))
    ok = bool(max_err < 1e-10) and not bool(
        local_value(out["error_flag"]).any())

    # SPPT across processes (round-5): per-member keys are folded host-side
    # by make_global_ensemble; with stochastic physics on, the two members
    # of this process's ensemble shard must DIVERGE from each other.
    params_sppt = dataclasses.replace(params, sppt_on=True)
    consts_sppt, state_sppt, cal_sppt = make_demo_model(params_sppt)
    gstate_sppt = D.make_global_ensemble(state_sppt, n_members, mesh)
    ctx_s, _ = M.build_step_ctx(dataclasses.replace(cal_sppt), 2, N_STEPS)
    run_sppt = make_run_steps_batched(consts_sppt, mesh=mesh, donate=False,
                                      phase=2)
    out_sppt = run_sppt(gstate_sppt, ctx_s)
    jax.block_until_ready(out_sppt)
    shard0 = np.asarray(out_sppt["t"][0].addressable_shards[0].data)
    sppt_member_spread = float(np.abs(shard0[0] - shard0[1]).max()) \
        if shard0.shape[0] >= 2 else -1.0
    sppt_ok = (sppt_member_spread > 1e-10 and not bool(
        local_value(out_sppt["error_flag"]).any()))
    ok = ok and sppt_ok

    print(json.dumps({
        "process": jax.process_index(),
        "processes": jax.process_count(),
        "devices": jax.device_count(),
        "mesh": dict(mesh.shape),
        "members": n_members,
        "max_abs_err_vs_single": max_err,
        "sppt_member_spread": sppt_member_spread,
        "sppt_ok": sppt_ok,
        "ok": ok,
    }), flush=True)
    if not ok:
        sys.exit(1)


def main_launcher(n_processes: int, devices_per_process: int):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    procs = []
    for pid in range(n_processes):
        env = dict(os.environ)
        env.update(
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES=str(n_processes),
            JAX_PROCESS_ID=str(pid),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(env.get("XLA_FLAGS", "") +
                       f" --xla_force_host_platform_device_count="
                       f"{devices_per_process}").strip(),
            PYSPEEDY_WORKER="1",
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))

    ok = True
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        line = next((ln for ln in out.splitlines()
                     if ln.startswith("{")), None)
        if p.returncode != 0 or line is None:
            ok = False
            print(f"worker failed (rc={p.returncode}):\n"
                  + "\n".join(err.splitlines()[-5:]), file=sys.stderr)
        else:
            print(line, flush=True)
    print(json.dumps({"multihost_dryrun_ok": ok,
                      "n_processes": n_processes,
                      "devices_per_process": devices_per_process}),
          flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    if os.environ.get("PYSPEEDY_WORKER"):
        # Workers pin the CPU platform before any backend init (see the
        # module docstring: one process per card).
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        main_worker()
    else:
        n_proc = int(sys.argv[1]) if len(sys.argv) > 1 else 2
        dev_per = int(sys.argv[2]) if len(sys.argv) > 2 else 2
        main_launcher(n_proc, dev_per)
