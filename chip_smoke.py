#!/usr/bin/env python
"""Smoke test of the receiver on one GPU, against the plain references.

    python chip_smoke.py                 # phases 0-5 on one card
    python chip_smoke.py --four-cards    # phase 6 only, on four cards

Phases, all in this one process (a JAX process reserves most of a card's
memory, so no second one is started):

0. device: JAX's default backend must be a GPU; prints its kind, the JAX
   version and the card's name and power limit.
1. correlator parity at the reference front end (38.192 MHz, 12 channels,
   96 ms, bench.py's tracking workload): the 'onehot' and 'gather'
   trackers against each other and against the float64 NumPy oracle.
2. acquisition parity: the 32-PRN x 29-bin search against the oracle grid.
3. main path: the reference's default deployment (37 s, 8 channels,
   golden scenario from a seed) through ``pipeline.run_receiver``, cold
   then warm; fix error against the injected truth, stage times, peak
   device memory.
4. entry point: ``softgnss_tpu.cli.main`` in-process on a short run.
5. the XLA tracking step: marginal per-ms time of 'onehot' and 'gather'
   at 12 channels (bench.py's two-length method).
6. ``--four-cards`` only: the 37 s workload on one card and on meshes over
   four (channel 1x4, time-exact 4x1, time 4x1, PRN-sharded acquisition).

Any failed check raises, so the process exits non-zero.  Only when every
phase passed does the last stdout line read
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

from bench import (marginal_step_time, nvidia_smi_lines, require_gpu,
                   tracking_workload)

#: phase 1: prompt I vs the float64 oracle, relative RMS (TF32 would put
#: ~5e-4 relative error on every baseband term)
ORACLE_RMS_TOL = 1e-4
#: phase 1: onehot vs gather on identical loop states, max |delta| / RMS
IMPL_MAXDEV_TOL = 1e-4
#: phase 2: acquisition peak metric vs the oracle, relative
ACQ_METRIC_TOL = 1e-3
#: phase 3/6: median 3D fix error vs the injected truth, m
FIX_TOL_M = 30.0
#: phase 6: mesh correlators vs one card, max |delta| / RMS
MESH_CORR_TOL = 1e-5
CORRELATORS = ("i_p", "i_e", "i_l", "q_e", "q_p", "q_l")


class PhaseFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 0 --

def phase_device(devs) -> None:
    log(f"[0] device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__}")
    log("[0] nvidia-smi name, power.limit:")
    for line in nvidia_smi_lines():
        print(line, flush=True)


# ---------------------------------------------------------------- phase 1 --

def track_dot_precisions(config, signal, channels, n_ms: int) -> set:
    """The precision of every dot_general in the traced tracking step."""
    import jax.numpy as jnp

    from softgnss_tpu.track.scan import _track_device, initial_state
    from softgnss_tpu.track.tables import build_tables

    tables = build_tables(config, np.asarray(channels.prn),
                          np.asarray(channels.acquired_freq))
    jaxpr = jax.make_jaxpr(
        lambda sig, tab, cb, act, st: _track_device(
            config, sig, tab, cb, act, n_ms, st, 0))(
        jnp.asarray(signal), jax.tree.map(jnp.asarray, tables),
        jnp.asarray(channels.acquired_freq),
        jnp.ones(len(channels), bool), initial_state(config, channels))

    found = set()

    def walk(jpr):
        for eqn in jpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.add(str(eqn.params["precision"]))
            for v in eqn.params.values():
                for x in (v if isinstance(v, (tuple, list)) else (v,)):
                    sub = getattr(x, "jaxpr", x)
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return found


def lockstep_correlators(config, signal, channels, n_ms: int):
    """Per-ms correlator sums of 'onehot' and 'gather' evaluated on the
    SAME loop state every millisecond (the loop driven by 'onehot').

    In two closed loops, f32 summation order nudges the f64 filters, the
    Q40 code step then differs by a unit now and then, and a sample lying
    within ~1e-7 chip of a half-chip boundary changes tap: a one-sample
    jump of a few units in one correlator.  At 38 samples per chip that
    happens about once per 100 channel-ms, so the sums are compared here
    on identical states, where only the summation order differs."""
    import jax.numpy as jnp

    from softgnss_tpu.track.scan import _channel_ms, initial_state
    from softgnss_tpu.track.tables import build_tables

    cfgs = [config.with_options(correlator_impl=i) for i in ("onehot", "gather")]
    tabs = [jax.tree.map(jnp.asarray, build_tables(
        c, np.asarray(channels.prn), np.asarray(channels.acquired_freq)))
        for c in cfgs]
    carr_basis = jnp.asarray(channels.acquired_freq, jnp.float64)
    active = jnp.ones(len(channels), bool)

    @jax.jit
    def run(sig, tabs, st0):
        def step(st, _):
            new, outs = zip(*(jax.vmap(
                lambda t, cb, a, s, c=c: _channel_ms(c, sig, t, cb, a, s))(
                    tab, carr_basis, active, st) for c, tab in zip(cfgs, tabs)))
            return new[0], outs
        return jax.lax.scan(step, st0, None, length=n_ms)[1]

    return run(jnp.asarray(signal), tabs, initial_state(config, channels))


def correlator_parity(config, n_ms: int = 96) -> dict:
    """Phase 1: 'onehot' and 'gather' on the default device against each
    other and against the float64 oracle.  Raises on a failed check."""
    from softgnss_tpu.oracle import oracle_track_channel
    from softgnss_tpu.track import track

    signal, channels = tracking_workload(config, n_ms=n_ms)
    res = {impl: track(config.with_options(correlator_impl=impl), signal,
                       channels, n_ms=n_ms)
           for impl in ("onehot", "gather")}
    out = {"precision": sorted(track_dot_precisions(config, signal, channels,
                                                    n_ms)),
           "channels": len(channels), "n_ms": n_ms}
    check(np.array_equal(res["onehot"].absolute_sample,
                         res["gather"].absolute_sample),
          "onehot and gather absolute_sample differ")
    oh, ga = lockstep_correlators(config, signal, channels, n_ms)
    out["onehot_vs_gather_maxdev"] = max(
        float(np.max(np.abs(np.asarray(getattr(oh, k)) - getattr(ga, k)))
              / np.sqrt(np.mean(np.asarray(getattr(ga, k), np.float64) ** 2)))
        for k in CORRELATORS)
    check(out["onehot_vs_gather_maxdev"] < IMPL_MAXDEV_TOL,
          f"onehot vs gather max|d|/rms {out['onehot_vs_gather_maxdev']:.3g}")
    for impl, r in res.items():
        rms, das = [], []
        for c in range(len(channels)):
            orc = oracle_track_channel(
                config, signal, int(channels.prn[c]),
                float(channels.acquired_freq[c]),
                int(channels.code_phase[c]), n_ms)
            a = np.asarray(orc["i_p"], np.float64)
            b = np.asarray(r.i_p[c], np.float64)
            rms.append(float(np.sqrt(np.mean((a - b) ** 2))
                             / np.sqrt(np.mean(a ** 2))))
            das.append(int(np.max(np.abs(np.asarray(r.absolute_sample[c])
                                         - orc["absolute_sample"]))))
        out[f"{impl}_oracle_ip_rms"] = max(rms)
        out[f"{impl}_oracle_max_dAS"] = max(das)
        check(max(rms) < ORACLE_RMS_TOL,
              f"{impl} prompt I vs oracle rel RMS {max(rms):.3g}")
        check(max(das) <= 1,
              f"{impl} absolute_sample differs from the oracle by {max(das)}")
    return out


# ---------------------------------------------------------------- phase 2 --

def acquisition_parity(config) -> dict:
    """Phase 2: the device search against the float64 oracle grid for the
    injected PRNs.  The coarse Doppler bin is read from a second search
    with a zero-width fine band, whose carrier estimate is then the coarse
    bin's own frequency.  Raises on a failed check."""
    from softgnss_tpu.acquire.search import acquire
    from softgnss_tpu.oracle import oracle_acquire_grid
    from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal

    spc = config.samples_per_code
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=s * spc)
            for p, d, s in ((3, 2300.0, 0.11), (12, -1150.0, 0.47),
                            (19, 3875.0, 0.72), (27, -4620.0, 0.93))]
    signal = synthesize_signal(config, sats, config.acquisition_ms + 1,
                               noise_std=1.5, seed=3)
    dev = acquire(config, signal)
    coarse = acquire(config.with_options(acq_fine_band_hz=0.0), signal)
    lo = config.doppler_bin_freqs[0]
    out = {"prns": [s.prn for s in sats], "metric_rel_dev": 0.0}
    for s in sats:
        i = s.prn - 1
        _grid, o_phase, o_bin, o_metric = oracle_acquire_grid(config, signal,
                                                              s.prn)
        d_bin = int(round((coarse.carr_freq[i] - lo)
                          / config.acq_doppler_step_hz))
        rel = abs(dev.peak_metric[i] - o_metric) / o_metric
        out["metric_rel_dev"] = max(out["metric_rel_dev"], float(rel))
        check(dev.acquired[i] and coarse.acquired[i],
              f"PRN {s.prn} not acquired")
        check(int(dev.code_phase[i]) == int(o_phase),
              f"PRN {s.prn} code phase {dev.code_phase[i]} vs oracle {o_phase}")
        check(d_bin == int(o_bin), f"PRN {s.prn} Doppler bin {d_bin} vs "
                                   f"oracle {o_bin}")
        check(rel < ACQ_METRIC_TOL, f"PRN {s.prn} metric rel dev {rel:.3g}")
    return out


# ---------------------------------------------------------------- phase 3 --

def fix_error(results, truth) -> float:
    sol = results.solutions
    xyz = np.stack([sol.x, sol.y, sol.z], axis=1)
    return float(np.nanmedian(np.linalg.norm(xyz - np.asarray(truth)[None],
                                             axis=1)))


def reference_capture(config):
    """The golden scenario and its capture, built the way the CLI's
    ``--synthetic`` mode builds them."""
    from softgnss_tpu.scenario import build_scenario, synthesize_scenario

    n_ms = config.ms_to_process + config.acquisition_ms + 2
    scenario = build_scenario(config)
    return scenario, synthesize_scenario(scenario, n_ms)


def main_path(config) -> dict:
    """Phase 3: the closed loop through run_receiver, cold then warm.
    Raises on a failed check."""
    from softgnss_tpu.nav.hostctx import host_device
    from softgnss_tpu.pipeline import run_receiver

    t0 = time.perf_counter()
    scenario, signal = reference_capture(config)
    out = {"synth_s": time.perf_counter() - t0,
           "capture_bytes": int(signal.nbytes)}
    samples = config.ms_to_process * config.samples_per_code
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        res = run_receiver(config, signal=signal)
        wall = time.perf_counter() - t0
        check(res.has_fix, f"{label} run: no fix")
        err = fix_error(res, scenario.receiver_ecef)
        check(err < FIX_TOL_M, f"{label} run: median 3D error {err:.2f} m")
        out[label] = {"wall_s": wall, "timings_s": dict(res.timings_s),
                      "median_3d_err_m": err,
                      "fixes": int(np.isfinite(res.solutions.x).sum()),
                      "epochs": int(res.solutions.n_epochs),
                      "samples_per_s": samples / wall}
    out["compile_s"] = out["cold"]["wall_s"] - out["warm"]["wall_s"]
    dev = jax.devices()[0]
    out["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    out["stage_device"] = {"acquire": str(dev), "track": str(dev),
                           "navigate": str(host_device())}
    return out


# ---------------------------------------------------------------- phase 4 --

def entry_point(argv) -> int:
    from softgnss_tpu import cli

    rc = cli.main(argv)
    check(rc == 0, f"cli.main returned {rc}")
    return rc


# ---------------------------------------------------------------- phase 5 --

def step_times(config, n_ms: int) -> dict:
    """Phase 5: marginal per-ms tracking step of both correlators."""
    signal, channels = tracking_workload(config, n_ms=n_ms)
    out = {}
    for impl in ("onehot", "gather"):
        t = marginal_step_time(
            config.with_options(correlator_impl=impl), signal, channels, n_ms)
        check(t["step_s"] > 0, f"{impl}: non-positive marginal step time")
        out[impl] = t
    return out


# ---------------------------------------------------------------- phase 6 --

def four_cards(config, devs) -> dict:
    """Phase 6: one card against meshes over four.  Every comparison is
    made and logged before the checks, so a failing run still reports
    all of them.  Raises on a failed check."""
    from softgnss_tpu.parallel import acquire_sharded, make_mesh
    from softgnss_tpu.pipeline import run_receiver

    check(len(devs) >= 4, f"--four-cards needs 4 devices, found {len(devs)}")
    scenario, signal = reference_capture(config)
    t0 = time.perf_counter()
    base = run_receiver(config, signal=signal, navigate=False)
    out = {"one_card_s": time.perf_counter() - t0}
    ch, tm = config.channel_axis, config.time_axis

    acq_need = config.acquisition_ms * config.samples_per_code
    t0 = time.perf_counter()
    acq = acquire_sharded(config, signal[:acq_need],
                          make_mesh({tm: 1, ch: 4}))
    out["acquire"] = {
        "wall_s": time.perf_counter() - t0,
        "peaks_equal": bool(
            np.array_equal(acq.code_phase, base.acquisition.code_phase)
            and np.array_equal(acq.acquired, base.acquisition.acquired)),
        "carr_freq_maxdiff_hz": float(np.max(np.abs(
            acq.carr_freq - base.acquisition.carr_freq)))}

    ref = base.tracking
    for shard, shape in (("channel", (1, 4)), ("time-exact", (4, 1)),
                         ("time", (4, 1))):
        t0 = time.perf_counter()
        res = run_receiver(config, signal=signal, channels=base.channels,
                           mesh=make_mesh({tm: shape[0], ch: shape[1]}),
                           shard=shard, navigate=(shard == "time"))
        rec = {"wall_s": time.perf_counter() - t0,
               "mesh": f"{shape[0]}x{shape[1]}"}
        tr = res.tracking
        for name in ("absolute_sample", "sample_frac"):
            rec[f"{name}_equal"] = bool(np.array_equal(getattr(tr, name),
                                                       getattr(ref, name)))
        rec["corr_maxdev"] = max(
            float(np.max(np.abs(getattr(tr, k) - getattr(ref, k)))
                  / np.sqrt(np.mean(np.asarray(getattr(ref, k),
                                               np.float64) ** 2)))
            for k in CORRELATORS)
        if shard == "time":
            rec["has_fix"] = bool(res.has_fix)
            rec["median_3d_err_m"] = (fix_error(res, scenario.receiver_ecef)
                                      if res.has_fix else None)
        out[shard] = rec
    log(f"[6] four cards: {json.dumps(out)}")

    check(out["acquire"]["peaks_equal"],
          "PRN-sharded acquisition peaks differ from one card")
    for shard in ("channel", "time-exact"):
        rec = out[shard]
        check(rec["absolute_sample_equal"] and rec["sample_frac_equal"],
              f"{shard}: integer observables differ from one card")
        check(rec["corr_maxdev"] < MESH_CORR_TOL,
              f"{shard}: correlators differ by {rec['corr_maxdev']:.3g}")
    err = out["time"]["median_3d_err_m"]
    check(err is not None and err < FIX_TOL_M,
          f"time-sharded run: median 3D error {err} m")
    return out


# ------------------------------------------------------------------ main --

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card mesh phase")
    args = parser.parse_args(argv)

    devs = require_gpu()
    import softgnss_tpu as sg
    from softgnss_tpu.compile_cache import enable_compile_cache

    log(f"[0] compile cache: {enable_compile_cache()}")
    phase_device(devs)
    reference = sg.default_config(number_of_channels=8, ms_to_process=37000)

    if args.four_cards:
        four_cards(reference, devs)
    else:
        r = correlator_parity(sg.default_config(number_of_channels=12))
        log(f"[1] correlator parity (precision {r['precision']}): "
            f"{json.dumps(r)}")
        r = acquisition_parity(sg.default_config())
        log(f"[2] acquisition parity: {json.dumps(r)}")
        r = main_path(reference)
        log(f"[3] main path: {json.dumps(r)}")
        entry_point(["--synthetic", "--fast", "--ms", "2000", "--no-nav",
                     "--set", "number_of_channels=4"])
        log("[4] cli.main returned 0")
        r = step_times(sg.default_config(number_of_channels=12), n_ms=2048)
        log(f"[5] tracking step: {json.dumps(r)}")
        log("[5] per-ms step: " + ", ".join(
            f"{k} {v['step_s'] * 1e6:.2f} us" for k, v in r.items()))

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
