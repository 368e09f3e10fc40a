#!/usr/bin/env python
"""Throughput of the tracking step or the acquisition search on one GPU.

Default metric: 12-channel tracking throughput (capture samples/s) at the
reference front end (fs = 38.192 MHz int8, IF 9.548 MHz), 1 ms
integration — each sample feeds 12 channels x 6 correlators.
``BENCH_METRIC=acquisition`` measures the 32-PRN x 29-bin search instead
(correlation points/s).

``vs_baseline`` compares against the math-equivalent float64 NumPy oracle
(softgnss_tpu.oracle) timed in-process on the host CPU — the reference
publishes no numbers (SURVEY.md §6), so the baseline is self-measured.

Prints exactly one JSON line, which names the device it ran on (JAX
platform, ``device_kind``, device count, and the card's name and power
limit as nvidia-smi reports them).  Without a GPU it exits non-zero and
prints nothing on stdout: a CPU timing is never reported as a device
number.

    python bench.py
    BENCH_METRIC=acquisition python bench.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def require_gpu():
    """``jax.devices()`` when JAX's default backend is a GPU; otherwise
    exit with status 2 (there is no CPU fallback)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU found: JAX's default devices are "
              f"{devs[0].platform!r}", file=sys.stderr)
        raise SystemExit(2)
    return devs


def nvidia_smi_lines() -> list[str]:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def card_info() -> str:
    try:
        return "; ".join(nvidia_smi_lines())
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"


def device_fields(devs) -> dict:
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_info()}


def tracking_workload(config, seed: int = 42, n_ms: int = 8000):
    """A synthetic capture with one satellite per channel (PRN 1..C) and
    the matching pre-assigned channels: the tracking benchmark's input."""
    from softgnss_tpu.acquire.search import Channels
    from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal

    n_channels = config.number_of_channels
    spc = config.samples_per_code
    rng = np.random.default_rng(seed)
    prns = list(range(1, n_channels + 1))
    sats = [SatelliteSignal(prn=p,
                            doppler_hz=float(rng.uniform(-4000, 4000)),
                            delay_samples=float(rng.integers(0, spc)),
                            phase0=float(rng.uniform(0, 6.28)),
                            nav_bits=tuple(rng.choice([-1, 1], size=64)))
            for p in prns]
    signal = synthesize_signal(config, sats, n_ms + 3, noise_std=1.0, seed=9)
    channels = Channels(
        prn=np.asarray(prns, np.int64),
        acquired_freq=np.asarray([config.intermediate_freq + s.doppler_hz
                                  for s in sats]),
        code_phase=np.asarray([int(s.delay_samples) for s in sats], np.int64),
        status=["T"] * n_channels)
    return signal, channels


def marginal_step_time(config, signal, channels, n_ms: int,
                       reps: int = 5) -> dict:
    """Marginal cost of one tracked millisecond (all channels).

    Times the tracker at two scan lengths and takes
    (T_long - T_short) / (n_long - n_short), each T the median of ``reps``
    runs after a compiling warm-up run.  The difference cancels what every
    call pays once: dispatch, the pointer upload and the fetch of the
    result.  Each run reads back a value that depends on every step.
    """
    import jax
    import jax.numpy as jnp

    from softgnss_tpu.track.scan import (_track_device, host_pack_signal,
                                         initial_state)
    from softgnss_tpu.track.tables import build_tables

    if n_ms < 100:
        raise ValueError(f"n_ms must be >= 100 for marginal-cost timing, got {n_ms}")
    n_short = min(max(200, n_ms // 8), n_ms // 2)
    tables = build_tables(config, np.asarray(channels.prn),
                          np.asarray(channels.acquired_freq))
    state0 = initial_state(config, channels)
    args = (jnp.asarray(host_pack_signal(config, signal)),
            jax.tree.map(jnp.asarray, tables),
            jnp.asarray(channels.acquired_freq, jnp.float64),
            jnp.asarray(np.asarray([s == "T" for s in channels.status])))

    def run(length):
        final, ys, _ovf = _track_device(config, *args, length, state0, 0)
        return float(jnp.asarray(ys.i_p[-1]).sum()) + float(final.ptr.sum())

    times = {}
    for length in (n_short, n_ms):
        assert np.isfinite(run(length))                  # compile + warm
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(length)
            samples.append(time.perf_counter() - t0)
        times[length] = float(np.median(samples))
    step_s = (times[n_ms] - times[n_short]) / (n_ms - n_short)
    return {"step_s": step_s, "n_short": n_short, "n_long": n_ms,
            "t_short_s": times[n_short], "t_long_s": times[n_ms]}


def bench_tracking(devs) -> dict:
    import softgnss_tpu as sg
    from softgnss_tpu.oracle import oracle_track_channel

    n_channels = int(os.environ.get("BENCH_CHANNELS", "12"))
    n_ms = int(os.environ.get("BENCH_MS", "8000"))
    oracle_ms = int(os.environ.get("BENCH_ORACLE_MS", "40"))
    config = sg.default_config(number_of_channels=n_channels)
    spc = config.samples_per_code
    signal, channels = tracking_workload(config, n_ms=n_ms)
    t = marginal_step_time(config, signal, channels, n_ms)
    device_sps = spc / t["step_s"]

    # CPU oracle baseline (single channel, scaled to n_channels)
    t0 = time.perf_counter()
    oracle_track_channel(config, signal, int(channels.prn[0]),
                         float(channels.acquired_freq[0]),
                         int(channels.code_phase[0]), oracle_ms)
    t_oracle_1ch = time.perf_counter() - t0
    oracle_sps = (oracle_ms * spc) / (t_oracle_1ch * n_channels)
    return {
        "metric": f"tracking_samples_per_sec_{n_channels}ch_fs38.192MHz",
        "value": device_sps,
        "unit": "samples/s",
        "vs_baseline": device_sps / oracle_sps,
        "step_time_us": t["step_s"] * 1e6,
        "correlator": config.resolved_correlator,
        "device": device_fields(devs),
    }


def bench_acquisition(devs) -> dict:
    import jax
    import jax.numpy as jnp

    import softgnss_tpu as sg
    from softgnss_tpu.acquire.search import _acquire_device
    from softgnss_tpu.oracle import oracle_acquire_grid
    from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal

    config = sg.default_config()
    sig = synthesize_signal(
        config, [SatelliteSignal(prn=7, doppler_hz=2500.0,
                                 delay_samples=12345.0)],
        config.acquisition_ms + 1, noise_std=1.5, seed=3)
    need = config.acquisition_ms * config.samples_per_code
    sigs = [jnp.asarray(np.concatenate([sig[:need - 1], np.array([r], np.int8)]))
            for r in range(4)]
    jax.block_until_ready(_acquire_device(config, sigs[0]))    # compile
    t0 = time.perf_counter()
    for r in range(1, 4):
        jax.block_until_ready(_acquire_device(config, sigs[r]))
    dt = (time.perf_counter() - t0) / 3
    n_corr = 32 * config.num_doppler_bins * config.samples_per_code
    # oracle: measured in-process on one PRN, scaled to 32
    t0 = time.perf_counter()
    oracle_acquire_grid(config, np.asarray(sig), 7)
    t_oracle = (time.perf_counter() - t0) * 32
    return {
        "metric": "acquisition_corr_points_per_sec_32prn_fs38.192MHz",
        "value": n_corr / dt,
        "unit": "corr-points/s",
        "vs_baseline": t_oracle / dt,
        "search_time_ms": dt * 1e3,
        "device": device_fields(devs),
    }


def main() -> int:
    devs = require_gpu()
    from softgnss_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    if os.environ.get("BENCH_METRIC", "tracking") == "acquisition":
        out = bench_acquisition(devs)
    else:
        out = bench_tracking(devs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
