"""Benchmark harness: T30L8 throughput on the available accelerator.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

The headline metric is single-member SYPD (simulated years per wall-clock
day) for the full-physics T30L8 model, measured as the MEDIAN of several
independent timing windows. The JSON also carries the ensemble throughput
numbers (member-steps/s at 64/256/1024 members, the batched replacement for
the reference's OpenMP parallel_step) and names the device it ran on.

The reference publishes no benchmark numbers and no Fortran toolchain is
available in this image to measure it, so vs_baseline is reported against a
documented 100-SYPD single-core estimate for SPEEDY-class Fortran models at
T30 (see BASELINE.md).
"""

import dataclasses
import json
import statistics
import sys
import time

import jax

from pyspeedy_tpu.utils.compile_cache import enable_compile_cache
from pyspeedy_tpu.utils.profiling import gpu_name_and_power_limit

REFERENCE_SYPD_ESTIMATE = 100.0  # SPEEDY single-core SYPD anchor (BASELINE.md)


def _sypd(n_steps, wall_s, nsteps_per_day=36):
    sim_years = n_steps / nsteps_per_day / 365.0
    return sim_years * 86400.0 / wall_s


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_single(params, consts, M, make_demo_model, n_windows=5,
                 days_per_window=30):
    """Median-of-windows single-member SYPD. Each window is ONE dispatched
    scan of days_per_window simulated days, as the public run() scans whole
    callback intervals per dispatch."""
    _, state, cal = make_demo_model(params)
    run = M.make_run_steps(consts, phase=2)  # chunks start at step 2 (+36d)

    n_day = params.nsteps
    n_win = days_per_window * n_day
    ctx, cal = M.build_step_ctx(cal, 2, n_win)
    state = run(state, ctx)
    jax.block_until_ready(state)  # compile + warm-up

    rates = []
    stepno = 2 + n_win
    for w in range(n_windows):
        ctx, cal = M.build_step_ctx(cal, stepno, n_win)
        t0 = time.perf_counter()
        state = run(state, ctx)
        jax.block_until_ready(state)
        wall = time.perf_counter() - t0
        stepno += n_win
        rates.append(n_win / wall)
    assert not bool(state["error_flag"]), "model blew up during bench"

    med = statistics.median(rates)
    sypd = _sypd(med, 1.0, nsteps_per_day=params.nsteps)
    _log(f"bench: single-member {days_per_window}-day windows "
         f"{[round(r, 1) for r in rates]} "
         f"steps/s -> median {med:.1f} steps/s, {sypd:.1f} SYPD")

    # XLA's cost_analysis counts a while/scan BODY once (verified: identical
    # flops for 36- vs 72-step scans), and this executable's body is one
    # 3-step phase triple, so per-step cost = analysis / 3. "bytes accessed"
    # is LOGICAL operand traffic (>= physical device-memory traffic).
    gflops_s = logical_gbs = None
    try:
        ca = run.lower(state, ctx).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        body_steps = 3
        if ca and ca.get("flops"):
            gflops_s = float(ca["flops"]) / body_steps * med / 1e9
        if ca and ca.get("bytes accessed"):
            logical_gbs = (float(ca["bytes accessed"]) / body_steps
                           * med / 1e9)
        _log(f"bench: roofline {gflops_s and round(gflops_s, 1)} GFLOP/s, "
             f"{logical_gbs and round(logical_gbs, 1)} GB/s logical operand "
             "traffic")
    except Exception as e:  # noqa: BLE001 - accounting is best-effort
        _log(f"bench: cost analysis unavailable: {e}")
    return sypd, rates, gflops_s, logical_gbs


def bench_ensemble(params, consts, M, make_demo_model, n_members,
                   n_repeats=3, days_per_repeat=2):
    """Median member-steps/s for an n_members batched ensemble (chunked
    along the member axis like SpeedyEns), plus the logical GB/s from XLA
    cost analysis of the batched executable.

    Each timing window is ONE dispatched scan of days_per_repeat days per
    chunk, after two discarded warm-up windows."""
    from pyspeedy_tpu.parallel.ensemble import (broadcast_state,
                                                make_run_steps_batched,
                                                pick_member_chunk,
                                                pick_scan_unroll)
    n_day = params.nsteps
    _, state1, cal = make_demo_model(params)
    chunk = pick_member_chunk(n_members, params)
    chunks = [broadcast_state(state1, chunk)
              for _ in range(n_members // chunk)]
    run = make_run_steps_batched(consts, phase=2, donate=False,
                                 unroll=pick_scan_unroll(chunk, params))

    n_win = days_per_repeat * n_day
    stepno = 2

    def one_window(chunks, stepno, cal):
        ctx, cal = M.build_step_ctx(cal, stepno, n_win)
        return [run(b, ctx) for b in chunks], stepno + n_win, cal, ctx

    chunks, stepno, cal, ctx = one_window(chunks, stepno, cal)  # compile
    jax.block_until_ready(chunks)
    for _ in range(2):
        chunks, stepno, cal, ctx = one_window(chunks, stepno, cal)
        jax.block_until_ready(chunks)

    rates = []
    for r in range(n_repeats):
        t0 = time.perf_counter()
        chunks, stepno, cal, ctx = one_window(chunks, stepno, cal)
        jax.block_until_ready(chunks)
        wall = time.perf_counter() - t0
        rates.append(n_members * n_win / wall)

    msps = statistics.median(rates)
    hbm_gbs = gflops_s = dev_s_per_mstep = None
    try:
        # Post-hoc lower+compile hits the persistent compilation cache.
        # cost_analysis counts the scan body once; the aligned executable is
        # q prefix steps + scan(triples, body=3 steps counted once) +
        # tail_n steps outside the scan. bytes are LOGICAL operand traffic.
        ca = run.lower(chunks[0], ctx).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        q = min((3 - 2) % 3, n_win)
        m = n_win - q
        n_triples = m // 3
        tail_n = m - 3 * max(n_triples - 1, 0)
        counted = (q + (3 if n_triples > 1 else 0) + tail_n) * chunk
        if ca and ca.get("bytes accessed"):
            hbm_gbs = (float(ca["bytes accessed"]) / counted * msps / 1e9)
        if ca and ca.get("flops"):
            # Real model FLOPs executed at the measured rate (the flop count
            # is the work, not an operand-traffic proxy).
            gflops_s = float(ca["flops"]) / counted * msps / 1e9
    except Exception:
        pass

    # Device op time per member-step from a jax.profiler trace of one
    # window (in-flight op durations overlap, so this bounds, not equals,
    # wall time; the wall msps above is the throughput measurement).
    try:
        import tempfile

        from pyspeedy_tpu.utils.xplane import device_op_totals
        with tempfile.TemporaryDirectory() as td:
            jax.profiler.start_trace(td)
            chunks, stepno, cal, _ = one_window(chunks, stepno, cal)
            jax.block_until_ready(chunks)
            jax.profiler.stop_trace()
            dev_total = sum(device_op_totals(td).values())
        dev_s_per_mstep = dev_total / (n_members * n_win)
    except Exception as e:  # noqa: BLE001 - accounting is best-effort
        _log(f"bench: ensemble trace unavailable: {e}")

    _log(f"bench: ensemble {n_members} (chunks of {chunk}): "
         f"{[round(r) for r in rates]} member-steps/s -> median {msps:.0f}"
         + (f", {hbm_gbs:.0f} GB/s logical" if hbm_gbs else "")
         + (f", {gflops_s:.0f} GFLOP/s achieved" if gflops_s else "")
         + (f", {dev_s_per_mstep*1e6:.0f} us device/member-step"
            if dev_s_per_mstep else ""))
    return msps, hbm_gbs, gflops_s, dev_s_per_mstep


def _device_info():
    """Platform, device kind and count as JAX reports them, plus the card's
    name and power limit from nvidia-smi where there is one."""
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform == "gpu":
        info["nvidia_smi"] = gpu_name_and_power_limit()
    return info


def main():
    from pyspeedy_tpu.models import model as M
    from pyspeedy_tpu.params import T30L8
    from pyspeedy_tpu.testing import make_demo_model

    enable_compile_cache()
    device = _device_info()
    on_cpu = device["platform"] == "cpu"
    precision = "f64" if on_cpu else "f32"
    params = dataclasses.replace(T30L8, precision=precision,
                                 fft_mode="matmul")
    _log(f"bench: device={device} precision={precision}")

    consts, _ = M.build_consts_cached(params)

    sypd, windows, gflops_s, hbm_gbs = bench_single(
        params, consts, M, make_demo_model)

    out = {
        "metric": "SYPD_T30L8_full_physics_1member_median5",
        "value": round(sypd, 2),
        "unit": "simulated_years_per_wallclock_day",
        "vs_baseline": round(sypd / REFERENCE_SYPD_ESTIMATE, 2),
        # The reference publishes no numbers and no Fortran toolchain exists
        # here: vs_baseline divides by a DOCUMENTED ESTIMATE (BASELINE.md),
        # not a measurement. SYPD / member-steps/s are the honest series.
        "baseline_is_estimate": True,
        "window_sypd_min": round(_sypd(min(windows), 1.0), 1),
        "window_sypd_max": round(_sypd(max(windows), 1.0), 1),
        "device": device,
    }
    if gflops_s is not None:
        out["achieved_gflops_per_s"] = round(gflops_s, 1)
    if hbm_gbs is not None:
        # LOGICAL operand traffic per unit time (see bench_single).
        out["logical_gb_per_s"] = round(hbm_gbs, 1)

    # Ensemble throughput at the three reference batch sizes. 1024 members
    # on the CPU would thrash host memory; the CPU runs a small ensemble.
    sizes = (8,) if on_cpu else (64, 256, 1024)
    for n_members in sizes:
        try:
            msps, e_hbm, e_gfl, e_dev = bench_ensemble(
                params, consts, M, make_demo_model, n_members)
            out[f"ensemble_msps_{n_members}"] = round(msps)
            if e_hbm is not None:
                out[f"ensemble_logical_gbs_{n_members}"] = round(e_hbm, 1)
            if e_gfl is not None:
                out[f"ensemble_achieved_gflops_{n_members}"] = round(e_gfl, 1)
            if e_dev is not None:
                out[f"ensemble_device_us_per_mstep_{n_members}"] = round(
                    e_dev * 1e6, 1)
        except Exception as e:  # noqa: BLE001 - diagnostic metrics
            _log(f"bench: ensemble {n_members} failed: {e}")

    # SPPT ensemble (BASELINE config #4): stochastic physics priced against
    # the same-size deterministic ensemble. The keyed-RNG AR(1) SPPT is the
    # reference's only stochastic feature (sppt.f90:40-111).
    n_sppt = 4 if on_cpu else 16
    try:
        params_sppt = dataclasses.replace(params, sppt_on=True)
        consts_sppt, _ = M.build_consts_cached(params_sppt)
        # Small batches are launch-bound and window-to-window noisy: use
        # more, longer windows than the big-ensemble runs.
        msps_off, *_ = bench_ensemble(params, consts, M, make_demo_model,
                                      n_sppt, n_repeats=5, days_per_repeat=4)
        msps_sppt, *_ = bench_ensemble(params_sppt, consts_sppt, M,
                                       make_demo_model, n_sppt, n_repeats=5,
                                       days_per_repeat=4)
        out[f"ensemble_msps_{n_sppt}_sppt"] = round(msps_sppt)
        out["sppt_overhead_pct"] = round(100.0 * (msps_off / msps_sppt - 1),
                                         1)
        _log(f"bench: sppt {n_sppt}-member {msps_sppt:.0f} msps "
             f"({out['sppt_overhead_pct']}% overhead vs deterministic "
             f"{msps_off:.0f})")
    except Exception as e:  # noqa: BLE001 - diagnostic metrics
        _log(f"bench: sppt ensemble failed: {e}")

    # Beyond-reference resolution throughput (the reference is compile-time
    # T30-only, params.f90:18-29): T63L8 single member + 64-member batch.
    # Accelerator only: a T63 f64 CPU bench would dominate the wall clock.
    if not on_cpu:
        try:
            from pyspeedy_tpu.params import T63L8

            params63 = dataclasses.replace(T63L8, precision="f32",
                                           fft_mode="matmul")
            consts63, _ = M.build_consts_cached(params63)
            sypd63, _, _, _ = bench_single(params63, consts63, M,
                                           make_demo_model, n_windows=3,
                                           days_per_window=5)
            out["t63_sypd_1member"] = round(sypd63, 1)
        except Exception as e:  # noqa: BLE001
            _log(f"bench: T63 single failed: {e}")
        try:
            msps63, *_ = bench_ensemble(params63, consts63, M,
                                        make_demo_model, 64, n_repeats=2,
                                        days_per_repeat=1)
            out["t63_ensemble_msps_64"] = round(msps63)
        except Exception as e:  # noqa: BLE001
            _log(f"bench: T63 ensemble failed: {e}")
        try:
            from pyspeedy_tpu.params import T47L8

            params47 = dataclasses.replace(T47L8, precision="f32",
                                           fft_mode="matmul")
            consts47, _ = M.build_consts_cached(params47)
            msps47, *_ = bench_ensemble(params47, consts47, M,
                                        make_demo_model, 64, n_repeats=2,
                                        days_per_repeat=1)
            out["t47_ensemble_msps_64"] = round(msps47)
        except Exception as e:  # noqa: BLE001
            _log(f"bench: T47 ensemble failed: {e}")

    print(json.dumps(out))


if __name__ == "__main__":
    main()
