"""Static correlator tables for the gather-free tracking hot path.

The reference-style per-sample code lookup (tracking.py:166-190) is three
38k-element data-dependent gathers per channel per ms.  The tracker
instead contracts a *narrow one-hot* of the half-chip index against small
per-tile code tables — pure elementwise + batched-matmul ops that XLA
fuses.  On the H100 the plain gather (``correlator_impl='gather'``)
measured faster per tracked ms (PERF.md); the one-hot path stays the
default until a measured change switches it:

* Sub-chip index ``h = ceil(S * tq)`` encodes all three correlator taps
  at once, where S = subdivision(config) is the smallest integer with
  ``S * dll_correlator_spacing`` integral (S=2 for the standard 0.5-chip
  spacing): with integer h and d = spacing*S,
  ``ceil(tq + j/S) = (h + j + S - 1) // S`` exactly, so one index stream
  drives early (j=-d), prompt (j=0), late (j=+d) through three
  precomputed sub-chip code tables.
* Within a ``track_tile``-sample tile, h spans only ~``S*tile*chips_per
  _sample`` values, and its offset from a *nominal* per-tile base (chip
  rate from acquisition Doppler) is bounded by the DLL pull-in range; so
  ``h_local = h - h_base(tile)`` fits in a static window of width
  ``onehot_width`` and the contraction is against statically-gathered
  per-tile code slices.

The correlator outputs are numerically the same sums as the gather
formulation (f32 accumulation order differs; parity vs the float64
oracle stays under the 1e-3 RMS budget, tests/test_tracking.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from softgnss_tpu.config import ReceiverConfig
from softgnss_tpu.signals import ca


class CorrelatorTables(NamedTuple):
    """Per-channel static tables (leading axis = channels)."""

    #: (C, 1025) padded code chips (for the exact-gather fallback path)
    code_pads: np.ndarray
    #: (C, n_tiles, onehot_width, 3) E/P/L code values per tile-local half-chip
    codes_static: np.ndarray
    #: (C, n_tiles) nominal half-chip index at each tile start, minus margin
    h_base: np.ndarray


#: margin sub-chips above/below a tile's nominal span.  Bound: remainder
#: phase contributes < S*step (tiny), the ceil/floor offsets < 2, and
#: code-rate drift vs the table nominal < S*(5 Hz/fs)*window (~0.01*S) —
#: a +-2 offset with +S+4 width headroom covers all of it several times
#: over.
_H_OFFSET = 2


def subdivision(config: ReceiverConfig) -> int:
    """Chip subdivision S: smallest integer with S*spacing integral >= 1.

    S=2 for the standard 0.5-chip early/late spacing; S=4 for 0.25-chip
    narrow correlators, etc.  Raises for spacings with no small rational
    subdivision (use correlator_impl='gather' for those).
    """
    d = config.dll_correlator_spacing
    for s in range(2, 33):
        ds = d * s
        if abs(ds - round(ds)) < 1e-9 and round(ds) >= 1:
            return s
    raise ValueError(
        f"dll_correlator_spacing={d} has no subdivision <= 32; use "
        "correlator_impl='gather'")


def _frame_shift_subchips(config: ReceiverConfig) -> int:
    """Sub-chips the code phase at a fixed frame position can sit BELOW the
    o=0 nominal, in block mode: the ms start floats at sample offset
    o in [0, 2*track_frame_pre) inside its static frame, shifting every
    tile's chip phase down by up to o chips-per-sample."""
    s = subdivision(config)
    s_chips = config.code_freq_basis / config.sampling_freq
    return int(np.ceil(s * s_chips * 2 * config.track_frame_pre))


def tile_starts(config: ReceiverConfig) -> np.ndarray:
    """(n_tiles,) frame-sample index where each correlator tile begins.

    pack=1: tile t covers consecutive samples [tile*t, tile*(t+1)).
    pack=4 (int32-packed capture, byte-plane order): tile t = (b, t'') with
    b = t // (T/4) covers samples {4*(tile*t'' + i) + b : i in [0, tile)} —
    stride-4 samples of one byte plane, spanning 4*tile real samples from
    k0 = 4*tile*t'' + b.  Every tile keeps ``track_tile`` lanes; only the
    tile -> sample mapping changes.
    """
    pack = config.track_pack
    t_total = config.track_window // config.track_tile
    t_idx = np.arange(t_total)
    t_pp = t_total // pack
    return pack * config.track_tile * (t_idx % t_pp) + t_idx // t_pp


def onehot_width(config: ReceiverConfig) -> int:
    """Static width of the tile-local sub-chip window (covers one tile's
    real-sample span: track_tile*track_pack samples)."""
    s = subdivision(config)
    span = config.track_tile * config.track_pack
    per_tile = s * span * config.code_freq_basis / config.sampling_freq
    w = int(np.ceil(per_tile)) + s + 4 + _frame_shift_subchips(config)
    return (w + 7) // 8 * 8


def n_tiles(config: ReceiverConfig) -> int:
    return config.track_window // config.track_tile


def _sub_chip_tables(code_pad: np.ndarray, s: int, ds: int) -> np.ndarray:
    """(n_sub, 3) E/P/L code values indexed by sub-chip index h = ceil(S*tq).

    code_pad is the 1025-chip padded code (pad[i] = chip i-1); entries use
    the exact identity ceil(tq + j/S) = (h + j + S - 1)//S:
    E[h] = pad[(h - ds + s - 1)//s], P[h] = pad[(h + s - 1)//s],
    L[h] = pad[(h + ds + s - 1)//s], clamped at the table edges
    (out-of-range h only occurs on masked samples).
    """
    n_sub = s * 1023 + 4 * s + 8
    h = np.arange(n_sub)
    e = code_pad[np.clip((h - ds + s - 1) // s, 0, 1024)]
    p = code_pad[np.clip((h + s - 1) // s, 0, 1024)]
    late = code_pad[np.clip((h + ds + s - 1) // s, 0, 1024)]
    return np.stack([e, p, late], axis=1).astype(np.float32)


def build_tables(config: ReceiverConfig, prns: np.ndarray,
                 acquired_freq: np.ndarray | None = None) -> CorrelatorTables:
    """Build correlator tables for a channel set.

    ``prns``: (C,) 1-based PRNs (0 = idle channel -> zero tables);
    ``acquired_freq``: (C,) acquisition carrier frequencies, used for the
    Doppler-consistent nominal chip rate that centers each tile's window
    (None -> the nominal IF; the window margin covers any L1 Doppler).
    """
    c = len(prns)
    tile = config.track_tile
    t_count = n_tiles(config)
    w = onehot_width(config)
    s_div = subdivision(config)
    ds = int(round(config.dll_correlator_spacing * s_div))

    code_pads = np.zeros((c, 1025), np.float32)
    codes_static = np.zeros((c, t_count, w, 3), np.float32)
    h_base = np.zeros((c, t_count), np.int64)

    k0 = tile_starts(config)                               # (T,)
    shift = _frame_shift_subchips(config)
    for i in range(c):
        if prns[i] <= 0:
            continue
        pad = ca.padded_code(int(prns[i])).astype(np.float32)
        code_pads[i] = pad
        sub = _sub_chip_tables(pad, s_div, ds)             # (n_sub, 3)
        doppler = (0.0 if acquired_freq is None
                   else acquired_freq[i] - config.intermediate_freq)
        fc_eff = config.code_freq_basis * (1.0 + doppler / config.l1_freq)
        s_chips = fc_eff / config.sampling_freq            # chips per sample
        base = (np.floor(s_div * s_chips * k0).astype(np.int64)
                - _H_OFFSET - shift)
        h_base[i] = base
        idx = base[:, None] + np.arange(w)[None, :]        # (T, w)
        codes_static[i] = sub[np.clip(idx, 0, len(sub) - 1)]
    return CorrelatorTables(code_pads, codes_static, h_base)
