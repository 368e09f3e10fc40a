#!/usr/bin/env python
"""Dump the optimized HLO of the 12-channel tracking step for fusion
inspection, on the default backend.

    python scripts/dump_hlo.py    # env B, U: block ms and unroll; OUT: file
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import softgnss_tpu as sg
from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track.scan import _track_device, initial_state
from softgnss_tpu.track.tables import build_tables

N_CH = 12

cfg = sg.default_config(number_of_channels=N_CH).with_options(
    track_block_ms=int(os.environ.get("B", "64")),
    track_unroll=int(os.environ.get("U", "1")))
spc = cfg.samples_per_code
rng = np.random.default_rng(42)
prns = list(range(1, N_CH + 1))
signal = np.zeros(300 * spc, np.int8)
channels = Channels(prn=np.asarray(prns, np.int64),
                    acquired_freq=np.asarray([cfg.intermediate_freq + 1000.0] * N_CH),
                    code_phase=np.asarray([100] * N_CH, np.int64),
                    status=["T"] * N_CH)
tables = build_tables(cfg, np.asarray(prns), np.asarray(channels.acquired_freq))
state0 = initial_state(cfg, channels)
args = (jnp.asarray(signal), jax.tree.map(jnp.asarray, tables),
        jnp.asarray(channels.acquired_freq, jnp.float64),
        jnp.asarray(np.ones(N_CH, bool)))

lowered = jax.jit(_track_device, static_argnums=(0, 5, 7)).lower(
    cfg, *args, 128, state0, 0)
comp = lowered.compile()
txt = comp.as_text()
out = os.environ.get("OUT", "track_hlo.txt")
with open(out, "w") as f:
    f.write(txt)
print(f"wrote {len(txt)} chars to {out}")
ca = comp.cost_analysis()
if ca:
    print({k: v for k, v in sorted(ca.items()) if "bytes" in k or "flops" in k})
