"""Measure time-shard warm-up vs stitched-output divergence.

Correctness sweep behind config.time_shard_warmup_ms (no timing: it runs
on the CPU backend, with 8 virtual devices for the mesh).
Sequential run = truth.  For each warmup, track the same capture with 4
time shards and compare stitched observables.  Metrics target what
navigation consumes: nav-bit signs (i_p), sample counters (pseudoranges),
carrier frequency.  Usage: python scripts/warmup_sweep.py [cn0_dbhz]
"""
import os
import sys
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np, softgnss_tpu as sg
from softgnss_tpu.pipeline import run_receiver
from softgnss_tpu.scenario import build_scenario, synthesize_scenario
from softgnss_tpu.signals.synth import amplitude_for_cn0
from softgnss_tpu.parallel import receiver_mesh, track_time_sharded

N_MS = 12000
cn0 = float(sys.argv[1]) if len(sys.argv) > 1 else None
cfg = sg.fast_config(number_of_channels=5, ms_to_process=N_MS,
                     acq_noncoherent_ms=10)
amp = 1.0 if cn0 is None else amplitude_for_cn0(cfg, cn0, 1.5)
sc = build_scenario(cfg, n_sats=5, amplitude=amp)
sig = synthesize_scenario(sc, N_MS + cfg.acquisition_ms + 2)
base = run_receiver(cfg, signal=sig, n_ms=N_MS, navigate=False)
seq = base.tracking
mesh = receiver_mesh(cfg, n_time=4, n_channel=2)

print(f"C/N0 = {cn0 or '~59 (toy)'} dB-Hz")
print(f"{'warmup':>7} {'bit_err%':>9} {'max|dAS|':>9} {'med|dAS|':>9} "
      f"{'max|dF|Hz':>10} {'overhead%':>10}")
for warmup in (25, 50, 100, 150, 250, 400, 700, 1000):
    c2 = cfg.with_options(time_shard_warmup_ms=warmup)
    tr = track_time_sharded(c2, sig, base.channels, mesh, n_ms=N_MS)
    # skip the pull-in transient of the sequential run itself (first 500 ms)
    sl = np.s_[:, 500:]
    bit_err = np.mean(np.sign(tr.i_p[sl]) != np.sign(seq.i_p[sl]))
    das = np.abs(tr.absolute_sample[sl] - seq.absolute_sample[sl])
    df = np.abs(tr.carr_freq[sl] - seq.carr_freq[sl])
    overhead = 100.0 * 3 * warmup / N_MS
    print(f"{warmup:>7} {100*bit_err:>9.4f} {das.max():>9.2f} "
          f"{np.median(das):>9.3f} {df.max():>10.2f} {overhead:>10.1f}")
