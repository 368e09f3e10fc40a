"""GPS C/A (Gold) PRN code generation — vectorized.

The C/A code for PRN *p* is ``-G1 * delay(G2, d_p)`` where G1/G2 are the two
maximal-length sequences of the 10-stage LFSRs with feedback taps (3,10) and
(2,3,6,8,9,10), and ``d_p`` is the per-PRN G2 delay
(reference: initialize.py:234-302).

Design: G1 and G2 are PRN-independent, so we run each LFSR **once**
as a ``lax.scan`` over 1023 steps, then produce all PRNs at once with a single
vectorized modular gather for the per-PRN circular delays — instead of the
reference's 32 independent Python LFSR loops (initialize.py:269-298).

Chips are +/-1 (sign convention identical to the reference: binary 1 -> +1).
The first 10 chips of every PRN match the octal values published in
IS-GPS-200 Table 3-Ia (verified in tests/test_ca_code.py).
"""

from __future__ import annotations

import functools

import numpy as np

from softgnss_tpu.config import ReceiverConfig

#: G2 delays per PRN (1-based PRN -> G2_DELAYS[prn-1]).  Entries 33..51 serve
#: non-GPS uses (e.g. ground transmitters); the reference carries the same
#: extended table (reference: initialize.py:251-255) but only PRNs 1..32 are
#: searched.
G2_DELAYS: tuple[int, ...] = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,
    145, 175, 52, 21, 237, 235, 886, 657, 634, 762, 355, 1012, 176, 603, 130, 359, 595, 68,
    386,
)

_CODE_LEN = 1023


def _lfsr_sequence(tap_indices: tuple[int, ...]) -> np.ndarray:
    """Run a 10-stage +/-1 LFSR for 1023 chips (host-side; static data).

    ``tap_indices`` are 0-based register positions whose product feeds back
    into stage 0; the output chip is stage 9.  Registers start at -1
    (all-ones in binary convention).
    """
    reg = -np.ones(10, np.int32)
    chips = np.empty(_CODE_LEN, np.int32)
    for i in range(_CODE_LEN):
        chips[i] = reg[9]
        # product of tapped stages == XOR in the +/-1 domain
        fb = np.prod(reg[list(tap_indices)])
        reg[1:] = reg[:-1]
        reg[0] = fb
    return chips


@functools.cache
def gold_codes(num_prn: int = 32) -> np.ndarray:
    """All C/A codes as a (num_prn, 1023) int8 array of +/-1 chips.

    Row ``i`` is PRN ``i+1``.  Cached; computed once per process, host-side —
    the codes are config-independent constants that get baked into jitted
    programs, so they must never be built under an ambient trace.
    """
    if num_prn > len(G2_DELAYS):
        raise ValueError(f"num_prn must be <= {len(G2_DELAYS)}")

    g1 = _lfsr_sequence((2, 9))
    g2 = _lfsr_sequence((1, 2, 5, 7, 8, 9))
    delays = np.asarray(G2_DELAYS[:num_prn], np.int32)
    # circular right-shift of g2 by d == gather at (i - d) mod 1023
    idx = (np.arange(_CODE_LEN, dtype=np.int32)[None, :] - delays[:, None]) % _CODE_LEN
    return (-g1[None, :] * g2[idx]).astype(np.int8)


def gold_code(prn: int) -> np.ndarray:
    """C/A code for a single PRN (1-based), (1023,) int8 of +/-1."""
    if not 1 <= prn <= len(G2_DELAYS):
        raise ValueError(f"PRN must be in 1..{len(G2_DELAYS)}, got {prn}")
    return gold_codes(max(32, prn))[prn - 1]


def padded_code(prn: int) -> np.ndarray:
    """Code padded with one wraparound chip on each side, (1025,) int8.

    Index layout: padded[0] = chip 1022, padded[i] = chip i-1 for i in
    1..1023, padded[1024] = chip 0 — so a ceil'd chip phase *c* in [0, 1024]
    indexes ``padded[c]`` = chip c-1, i.e. the chip active over phase
    (c-1, c] (reference: tracking.py:109-111,166-188).
    """
    code = gold_code(prn)
    return np.concatenate([code[-1:], code, code[:1]])


@functools.cache
def resample_indices(config: ReceiverConfig) -> np.ndarray:
    """Chip index for each sample of one code period, (samples_per_code,) int32.

    ``ceil(ts * (1..N) / tc) - 1`` with the final sample pinned to chip 1022
    (reference: initialize.py:223-226).  Static given the config, so it is
    computed host-side in float64 and baked into jitted programs as a
    constant gather index.
    """
    n = config.samples_per_code
    ts = 1.0 / config.sampling_freq
    tc = 1.0 / config.code_freq_basis
    idx = np.ceil(ts * np.arange(1, n + 1, dtype=np.float64) / tc).astype(np.int64) - 1
    idx[-1] = _CODE_LEN - 1
    return idx.astype(np.int32)


@functools.cache
def ca_table(config: ReceiverConfig, num_prn: int = 32) -> np.ndarray:
    """All C/A codes resampled to the sampling rate, (num_prn, samples_per_code) f32.

    One gather over the chip-index table — the vectorized replacement for
    the reference's per-PRN upsampling loop (reference: initialize.py:215-230).
    """
    return gold_codes(num_prn)[:, resample_indices(config)].astype(np.float32)
