"""Multi-channel DLL/PLL tracking as a ``lax.scan`` over milliseconds.

The reference tracks channels one-by-one in Python, reading the capture file
inside the per-millisecond hot loop (reference: tracking.py:59,132,154).  Here:

* the whole capture lives in device memory as int8; each channel consumes it
  with a per-ms ``dynamic_slice`` — no host I/O in the loop,
* channels are **vmapped** (and shardable over a mesh axis — see
  softgnss_tpu.parallel) instead of serialized,
* the per-ms loop is a single ``lax.scan`` whose carry is the loop-filter /
  NCO state pytree; one compiled step serves all 37k milliseconds,
* the data-dependent block size ("read ceil((1023-remCodePhase)/codePhaseStep)
  samples", reference: tracking.py:148-154) becomes a fixed-size window
  ``track_window`` with a masked tail — static shapes for XLA — while exact
  integer NCO bookkeeping (Q40 code phase, uint32 carrier turns, see
  softgnss_tpu.signals.nco) reproduces the variable block boundaries,
  including the ``absoluteSample`` sample counter that pseudoranges are
  derived from (reference: tracking.py:255, postNavigation.py:60-61).

Loop equations (identical math to reference: tracking.py:221-249):

    PLL:  err = atan(Q_P / I_P) / 2pi
          nco += (tau2/tau1)(err - err_prev) + err * PDI/tau1
          carrFreq = acquiredFreq + nco
    DLL:  err = (|E| - |L|) / (|E| + |L|),  |X| = sqrt(I_X^2 + Q_X^2)
          nco += (tau2/tau1)(err - err_prev) + err * PDI/tau1
          codeFreq = codeFreqBasis - nco
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.config import ReceiverConfig
from softgnss_tpu.signals.nco import (
    CODE_FRAC_BITS,
    CODE_ONE,
    carrier_step_u32,
    carrier_turns,
    ceil_chip_index,
    chips_to_q,
    code_step_q,
    sin_turns,
)
from softgnss_tpu.track.tables import (
    CorrelatorTables,
    build_tables,
    onehot_width,
    subdivision,
    tile_starts,
)


class TrackState(NamedTuple):
    """Per-channel tracking loop state (the scan carry). Leaves are (C,)."""

    ptr: jnp.ndarray          # i64: absolute sample index of next read
    carr_phase: jnp.ndarray   # i32: carrier NCO counts (uint32 semantics)
    code_rem_q: jnp.ndarray   # i64: remainder code phase, Q40 chips
    carr_freq: jnp.ndarray    # f64: current carrier frequency, Hz
    code_freq: jnp.ndarray    # f64: current code frequency, Hz
    carr_nco: jnp.ndarray     # f64: PLL filter accumulator
    carr_err: jnp.ndarray     # f64: previous PLL discriminator
    code_nco: jnp.ndarray     # f64: DLL filter accumulator
    code_err: jnp.ndarray     # f64: previous DLL discriminator
    ms: jnp.ndarray           # i64: milliseconds tracked so far
    #: i64: frame anchor (ptr - track_frame_pre at entry) of the ms-grid
    #: block this state sits in — lets a resumed run rebuild the SAME
    #: static frames as the uninterrupted run, keeping resume bit-exact
    #: in block mode (see _scan_ms)
    block_base: jnp.ndarray
    #: f32: partial coherent-integration correlator sums (all zero when
    #: config.pdi_ms == 1 — the loop filters then consume each code
    #: period's sums directly, the reference cadence)
    acc_i_e: jnp.ndarray
    acc_i_p: jnp.ndarray
    acc_i_l: jnp.ndarray
    acc_q_e: jnp.ndarray
    acc_q_p: jnp.ndarray
    acc_q_l: jnp.ndarray
    #: f32: previous update's prompt sums, the FLL discriminator memory
    #: (zero when config.fll_bandwidth_hz == 0 — pure-PLL reference mode)
    fll_ip: jnp.ndarray
    fll_qp: jnp.ndarray


#: the six coherent-accumulator leaves of TrackState, in corr-tuple order
_ACC_FIELDS = ("acc_i_e", "acc_i_p", "acc_i_l",
               "acc_q_e", "acc_q_p", "acc_q_l")
#: all float32 zero-initialized state leaves
_F32_FIELDS = _ACC_FIELDS + ("fll_ip", "fll_qp")


class MsOutputs(NamedTuple):
    """Per-ms logged observables (reference: tracking.py:253-275), plus
    ``sample_frac``: the sub-sample fraction of the code-period boundary.
    The reference's pseudoranges quantize at the integer fid.tell() sample
    counter (c/fs meters, tracking.py:255); the Q40 code NCO knows the
    boundary exactly — it crossed 1023 chips ``rem/step`` samples before
    ``absolute_sample`` — so ``absolute_sample - sample_frac`` is the
    boundary arrival to sub-millimeter code-phase resolution."""

    absolute_sample: jnp.ndarray  # i64
    sample_frac: jnp.ndarray      # f64 in [0, 1)
    code_freq: jnp.ndarray        # f64
    carr_freq: jnp.ndarray        # f64
    i_p: jnp.ndarray              # f32
    i_e: jnp.ndarray
    i_l: jnp.ndarray
    q_e: jnp.ndarray
    q_p: jnp.ndarray
    q_l: jnp.ndarray
    dll_discr: jnp.ndarray        # f64
    dll_discr_filt: jnp.ndarray
    pll_discr: jnp.ndarray
    pll_discr_filt: jnp.ndarray


@dataclass
class TrackResults:
    """Tracking output; array fields are (channels, ms)."""

    prn: np.ndarray
    status: list[str]
    absolute_sample: np.ndarray
    sample_frac: np.ndarray
    code_freq: np.ndarray
    carr_freq: np.ndarray
    i_p: np.ndarray
    i_e: np.ndarray
    i_l: np.ndarray
    q_e: np.ndarray
    q_p: np.ndarray
    q_l: np.ndarray
    dll_discr: np.ndarray
    dll_discr_filt: np.ndarray
    pll_discr: np.ndarray
    pll_discr_filt: np.ndarray
    #: loop state after the last tracked millisecond; pass as ``state=`` to
    #: :func:`track` to resume the capture exactly where this run stopped
    final_state: "TrackState | None" = None
    #: per-channel ms at which lock was lost (inf = held); filled by the
    #: pipeline from profiling.channel_lock_loss when config.lock_demotion —
    #: a channel with a finite entry carries status 'L' and navigation
    #: excludes it from every epoch at/after that millisecond
    lock_loss_ms: np.ndarray | None = None

    @property
    def n_ms(self) -> int:
        return self.i_p.shape[1]


def initial_state(config: ReceiverConfig, channels: Channels) -> TrackState:
    """Loop state at the first millisecond (reference: tracking.py:107-130)."""
    c = len(channels)
    active = np.asarray([s == "T" for s in channels.status])
    ptr = jnp.asarray(config.skip_samples + channels.code_phase, jnp.int64)
    return TrackState(
        ptr=ptr,
        carr_phase=jnp.zeros(c, jnp.int32),
        code_rem_q=jnp.zeros(c, jnp.int64),
        carr_freq=jnp.asarray(channels.acquired_freq, jnp.float64),
        code_freq=jnp.full(c, config.code_freq_basis, jnp.float64),
        carr_nco=jnp.zeros(c, jnp.float64),
        carr_err=jnp.zeros(c, jnp.float64),
        code_nco=jnp.zeros(c, jnp.float64),
        code_err=jnp.zeros(c, jnp.float64),
        ms=jnp.zeros(c, jnp.int64),
        block_base=ptr - config.track_frame_pre,
        **{f: jnp.zeros(c, jnp.float32) for f in _F32_FIELDS},
    )


def _correlate_gather(config: ReceiverConfig, tables, tq, i_bb, q_bb):
    """Reference-style correlators: per-sample code lookups
    (reference: tracking.py:164-190, 209-219).  Exact — the plain
    cross-check path (config.correlator_impl='gather')."""
    half_q = chips_to_q(config.dll_correlator_spacing)
    code_pad = tables.code_pads
    # padded-code index is the ceil'd chip phase itself: pad[i] = chip i-1,
    # so pad[ceil(t)] = chip ceil(t)-1, the reference's convention
    # (tracking.py:166-188).  Clip covers only the masked tail.
    idx_p = jnp.clip(ceil_chip_index(tq), 0, 1024)
    idx_e = jnp.clip(ceil_chip_index(tq - half_q), 0, 1024)
    idx_l = jnp.clip(ceil_chip_index(tq + half_q), 0, 1024)
    early, prompt, late = code_pad[idx_e], code_pad[idx_p], code_pad[idx_l]
    return (jnp.sum(early * i_bb), jnp.sum(prompt * i_bb), jnp.sum(late * i_bb),
            jnp.sum(early * q_bb), jnp.sum(prompt * q_bb), jnp.sum(late * q_bb))


def _correlate_onehot(config: ReceiverConfig, tables, rem_q, step_q, bb2):
    """Gather-free correlators: tile-local half-chip one-hot contraction.

    Same sums as the gather formulation (see softgnss_tpu.track.tables):
    the half-chip index h = ceil(S*tq) at frame sample k (code phase
    tq = rem_q + step_q*k in Q40 chips) selects E/P/L code values through
    static per-tile tables, so the per-ms compute is pure elementwise ops
    plus two small batched matmuls.

    ``bb2`` is the baseband as ONE (2, ...) array (I plane then Q plane —
    a single producer chain; separate i/q operands make XLA split the
    mix into two fusions that each redo the unpack/NCO/mask work), in the
    tile order of tables.tile_starts: consecutive samples when
    config.track_pack == 1, byte-plane order (plane axis major, frame
    sample pack*i + b at position (b, i)) when the capture is consumed
    through an int32 view.  Either way tile t covers samples
    k0[t] + pack*i, i in [0, track_tile), so every array keeps a full
    track_tile-lane minor dimension — no interleave is ever materialized.

    ``h`` is evaluated with EXACT 32-bit digit arithmetic (per-tile i64
    scalars + base-2^24 in-tile digits) instead of a direct int64 vector
    formulation, keeping the per-sample work in 32-bit lanes.  Whether the
    int64 form is cheaper on a GPU has not been measured; the digit form
    stays until it is.

    Both contractions run at ``Precision.HIGHEST``: a float32 dot may
    otherwise execute in TF32 on a GPU, whose ~3 significant digits put
    ~5e-4 relative error on every baseband term — far above the 1e-4
    oracle-parity budget.  (The one-hot operand is exact in any precision;
    the baseband operand is not.)
    """
    tile = config.track_tile
    pack = config.track_pack
    t_count = config.track_window // tile
    w = onehot_width(config)
    s_div = subdivision(config)
    if tile > 128:
        raise ValueError("track_tile > 128 overflows the i32 in-tile digits")

    mask24 = (1 << 24) - 1
    #: sub-chip bias keeping every tile-start phase positive: the frame
    #: o-shift makes rem_q as negative as ~ -2*track_frame_pre samples of
    #: code; verify the static bound so the digit identity stays exact
    bias = 1 << 10
    s_chips = config.code_freq_basis / config.sampling_freq
    assert s_div * s_chips * (2 * config.track_frame_pre + 64) < bias, (
        "track_frame_pre too large for the one-hot phase bias")
    s_q = step_q * s_div                                     # i64 scalar
    k0 = jnp.asarray(tile_starts(config), jnp.int64)         # (T,)
    # ceil(x/2^40) = (x + 2^40 - 1) >> 40; fold the +const into the base
    a_t = (rem_q * s_div + (CODE_ONE - 1) + (jnp.int64(bias) << CODE_FRAC_BITS)
           + s_q * k0)                                       # (T,) i64, > 0
    hi_t = (a_t >> CODE_FRAC_BITS).astype(jnp.int32)         # (T,)
    lo_t = a_t & (CODE_ONE - 1)                              # (T,) in [0, 2^40)
    lo_hi = (lo_t >> 24).astype(jnp.int32)                   # (T,) < 2^16
    lo_lo = (lo_t & mask24).astype(jnp.int32)                # (T,) < 2^24
    s_qp = s_q * pack                                        # step between tile lanes
    s_hi = (s_qp >> 24).astype(jnp.int32)
    s_lo = (s_qp & mask24).astype(jnp.int32)
    j = jnp.arange(tile, dtype=jnp.int32)                    # (tile,)
    # (lo_t + s_qp*j) >> 40 in digits: d0 < 2^24 + 2^24*127 < 2^31
    d0 = lo_lo[:, None] + s_lo * j[None, :]                  # (T, tile) i32
    h = (hi_t[:, None]
         + ((lo_hi[:, None] + s_hi * j[None, :] + (d0 >> 24)) >> 16))
    h_local = h - (tables.h_base.astype(jnp.int32) + bias)[:, None]
    # squeeze the per-sample index to int8 when the window allows: the
    # (T, tile) index is the one large per-ms intermediate XLA may
    # materialize in device memory, and s8 quarters that traffic.
    # Out-of-window values (masked samples) clamp to sentinels that match
    # no iota row.
    if w < 127:
        h_local = jnp.clip(h_local, -1, w).astype(jnp.int8)
        iota_w = jnp.arange(w, dtype=jnp.int8)
    else:
        iota_w = jnp.arange(w, dtype=jnp.int32)
    oh = (h_local[:, :, None] == iota_w[None, None, :]).astype(jnp.float32)

    bb = bb2.reshape(2, t_count, tile)                            # (2, T, tile)
    hi = jax.lax.Precision.HIGHEST
    u = jnp.einsum("tkw,ctk->twc", oh, bb, precision=hi,
                   preferred_element_type=jnp.float32)            # (T, w, 2)
    corr = jnp.einsum("twc,twx->xc", u, tables.codes_static, precision=hi,
                      preferred_element_type=jnp.float32)         # (3, 2)
    return (corr[0, 0], corr[1, 0], corr[2, 0],
            corr[0, 1], corr[1, 1], corr[2, 1])


def _frame_overflow(config: ReceiverConfig, active, o, blk):
    """>0 when a frame cannot represent its millisecond: the true span
    [o, o+blk) leaves the static window, or the frame offset exceeds the
    one-hot table coverage o <= 2*track_frame_pre (the static tables'
    sub-chip shift margin, tables._frame_shift_subchips) — beyond it,
    in-window samples' h_local falls outside the table window and would
    silently match no one-hot row, corrupting the correlators with no
    other symptom.  The coverage bound does not apply to the 'gather'
    correlator (exact per-sample clipped lookups, valid at any in-window
    offset)."""
    bad = jnp.maximum(-o, o + blk - config.track_window)
    if config.resolved_correlator != "gather":
        bad = jnp.maximum(bad, o - 2 * config.track_frame_pre)
    return jnp.where(active, jnp.maximum(bad, 0), jnp.int64(0))


def _frame_ms(config: ReceiverConfig, frame, base_ptr, tables, carr_basis,
              active, st: TrackState):
    """One millisecond of one channel against a pre-extracted sample frame.

    ``frame``: (track_window,) raw samples whose first element is absolute
    capture sample ``base_ptr``.  The millisecond's code period starts
    ``o = st.ptr - base_ptr`` samples into the frame (o = 0 on the per-ms
    path; in block mode o floats in [0, 2*track_frame_pre) as the true ms
    boundaries drift off the nominal samples_per_code grid).  The code /
    carrier NCO phases are anchored at ``st.ptr`` exactly as in the per-ms
    formulation — identical integer phase sequences at identical absolute
    samples — so block mode changes only f32 accumulation grouping.

    Returns (new_state, outputs, overflow); ``overflow`` > 0 means the true
    span [o, o+blk) left the frame and the result is invalid (the caller
    raises — grow config.track_frame_margin).
    """
    fs = config.sampling_freq
    blk_win = config.track_window
    code_len_q = config.code_length * CODE_ONE

    # --- block size from exact integer code NCO ---------------------------
    step_q = code_step_q(st.code_freq, fs)
    blk = (code_len_q - st.code_rem_q + step_q - 1) // step_q    # i64 scalar
    o = st.ptr - base_ptr                                        # i64 scalar
    ovf = _frame_overflow(config, active, o, blk)

    o32 = o.astype(jnp.int32)
    k32 = jnp.arange(blk_win, dtype=jnp.int32)
    mask = (k32 >= o32) & (k32 < o32 + blk.astype(jnp.int32))
    raw = jnp.where(mask, frame.astype(jnp.float32), 0.0)

    rem_eff = st.code_rem_q - step_q * o                  # Q40 chips at frame[0]

    # --- carrier mix via uint32 NCO (reference: tracking.py:192-207) -------
    w = carrier_step_u32(st.carr_freq, fs)
    turns = carrier_turns(st.carr_phase - w * o32, w, k32)
    bb2 = sin_turns(jnp.stack([turns, turns + 0.25])) * raw[None]  # (2, W)

    # --- six correlators (reference: tracking.py:209-219) ------------------
    if config.resolved_correlator == "onehot":
        if config.track_pack != 1:
            raise ValueError(
                "flat _frame_ms used with byte-plane tables "
                "(config.track_pack > 1); use _frame_ms_packed")
        i_e, i_p, i_l, q_e, q_p, q_l = _correlate_onehot(
            config, tables, rem_eff, step_q, bb2)
    elif config.resolved_correlator == "gather":
        tq = rem_eff + step_q * jnp.arange(blk_win, dtype=jnp.int64)
        i_e, i_p, i_l, q_e, q_p, q_l = _correlate_gather(
            config, tables, tq, bb2[0], bb2[1])
    else:
        raise ValueError(
            f"unknown correlator_impl {config.resolved_correlator!r}")

    new, outs = _filters_and_outputs(config, carr_basis, active, st, step_q, blk, w,
                                     (i_e, i_p, i_l, q_e, q_p, q_l))
    return new, outs, ovf


def _frame_ms_packed(config: ReceiverConfig, frame32, base_ptr, tables,
                     carr_basis, active, st: TrackState):
    """One millisecond of one channel against an int32-PACKED sample frame.

    ``frame32``: (track_window/4,) i32, four little-endian int8 samples per
    element, sample 4m+b in byte b of element m.  Samples are processed in
    byte-plane order (plane axis major) so no interleave is ever
    materialized; every sum is over the same sample set as
    :func:`_frame_ms`, so the state recurrence is identical up to f32
    accumulation grouping inside the one-hot contraction.
    """
    fs = config.sampling_freq
    blk_win = config.track_window
    code_len_q = config.code_length * CODE_ONE

    step_q = code_step_q(st.code_freq, fs)
    blk = (code_len_q - st.code_rem_q + step_q - 1) // step_q    # i64 scalar
    o = st.ptr - base_ptr                                        # i64 scalar
    ovf = _frame_overflow(config, active, o, blk)

    # byte planes: v[b, m] = sample pack*m+b, sign-extended (little-endian)
    pk = config.track_pack
    shr = 8 * (pk - 1)
    shl = jnp.array([8 * (pk - 1 - b) for b in range(pk)],
                    frame32.dtype)
    v = ((frame32[None, :] << shl[:, None]) >> shr).astype(jnp.float32)
    m32 = jnp.arange(blk_win // pk, dtype=jnp.int32)
    k32 = pk * m32[None, :] + jnp.arange(pk, dtype=jnp.int32)[:, None]
    o32 = o.astype(jnp.int32)
    mask = (k32 >= o32) & (k32 < o32 + blk.astype(jnp.int32))
    raw = jnp.where(mask, v, 0.0)

    rem_eff = st.code_rem_q - step_q * o

    w = carrier_step_u32(st.carr_freq, fs)
    turns = carrier_turns(st.carr_phase - w * o32, w, k32)
    bb2 = sin_turns(jnp.stack([turns, turns + 0.25])) * raw[None]  # (2,4,W/4)

    i_e, i_p, i_l, q_e, q_p, q_l = _correlate_onehot(
        config, tables, rem_eff, step_q, bb2)

    new, outs = _filters_and_outputs(config, carr_basis, active, st, step_q, blk, w,
                                     (i_e, i_p, i_l, q_e, q_p, q_l))
    return new, outs, ovf


def _packed_view(signal, pack: int):
    """int16/int32 little-endian view of an int8 capture, built from 1D
    strided slices + shifts.  A direct ``reshape(-1, pack)`` + bitcast is
    the natural spelling, but its (N/pack, pack)-shaped intermediate may be
    laid out with the pack-wide minor dim padded; the strided formulation
    stays 1D throughout.  It runs once per tracking call and is reused by
    every scan step."""
    n = signal.shape[0] // pack * pack
    dt = jnp.int16 if pack == 2 else jnp.int32
    word = signal[0:n:pack].astype(dt) & 0xFF
    for b in range(1, pack - 1):
        word = word | ((signal[b:n:pack].astype(dt) & 0xFF) << (8 * b))
    return word | (signal[pack - 1:n:pack].astype(dt) << (8 * (pack - 1)))


def _channel_ms(config: ReceiverConfig, signal, tables, carr_basis, active, st: TrackState):
    """One millisecond of one channel, slicing its window from the capture.
    All inputs per-channel scalars except ``signal`` (shared capture) and
    ``tables`` (per-channel static arrays)."""
    if config.track_pack > 1:
        # tables are in byte-plane tile order: consume the capture through
        # the packed view (word-aligned; the <=3-sample shift rides o)
        pk = config.track_pack
        sigp = _packed_view(signal, pk)
        start = st.ptr // pk
        frame = jax.lax.dynamic_slice(sigp, (start,),
                                      (config.track_window // pk,))
        new, outs, _ = _frame_ms_packed(config, frame, start * pk, tables,
                                        carr_basis, active, st)
        return new, outs
    frame = jax.lax.dynamic_slice(signal, (st.ptr,), (config.track_window,))
    new, outs, _ = _frame_ms(config, frame, st.ptr, tables, carr_basis, active, st)
    return new, outs


def _filters_and_outputs(config: ReceiverConfig, carr_basis, active, st,
                         step_q, blk, w, corr):
    """Loop-filter updates + logged outputs from the six correlator sums.

    Pure elementwise math on per-channel scalars (vmapped over channels).
    Equations per reference tracking.py:221-275.

    With ``config.pdi_ms`` K > 1 (coherent integration beyond the
    reference's fixed 1 ms) the six sums accumulate in the state carry and
    the discriminators/filters run only on every K-th code period, from
    the K-period totals; frequencies hold between updates.  K == 1
    compiles to exactly the reference-cadence program (no accumulator
    reads).
    """
    code_len_q = config.code_length * CODE_ONE
    tau1c, tau2c = config.pll_taus
    tau1d, tau2d = config.dll_taus
    pdi = config.pdi_s
    K = config.pdi_ms
    i_e, i_p, i_l, q_e, q_p, q_l = corr

    if K > 1:
        a_ie, a_ip, a_il, a_qe, a_qp, a_ql = (
            getattr(st, f) + c for f, c in zip(_ACC_FIELDS, corr))
        upd = (st.ms % K) == (K - 1)
    else:
        a_ie, a_ip, a_il, a_qe, a_qp, a_ql = corr
        upd = None

    # --- PLL (reference: tracking.py:221-235) -------------------------------
    i_p64, q_p64 = a_ip.astype(jnp.float64), a_qp.astype(jnp.float64)
    safe_ip = jnp.where(i_p64 != 0, i_p64, 1.0)
    carr_err = jnp.where(i_p64 != 0, jnp.arctan(q_p64 / safe_ip), 0.0) / (2.0 * jnp.pi)
    carr_nco = st.carr_nco + tau2c / tau1c * (carr_err - st.carr_err) + carr_err * (pdi / tau1c)
    if config.fll_bandwidth_hz > 0:
        # FLL assist (config docstring): cross/dot over consecutive prompt
        # sums; atan (not atan2) so nav-bit flips cancel.  First-order
        # loop: wn = 4*Bn
        ip_prev = st.fll_ip.astype(jnp.float64)
        qp_prev = st.fll_qp.astype(jnp.float64)
        cross = ip_prev * q_p64 - qp_prev * i_p64
        dot = ip_prev * i_p64 + qp_prev * q_p64
        safe_dot = jnp.where(dot != 0, dot, 1.0)
        ferr = jnp.where(dot != 0, jnp.arctan(cross / safe_dot),
                         0.0) / (2.0 * jnp.pi * pdi)
        carr_nco = carr_nco + (4.0 * config.fll_bandwidth_hz) * pdi * ferr
    carr_freq = carr_basis + carr_nco

    # --- DLL (reference: tracking.py:237-251) -------------------------------
    e_mag = jnp.sqrt(a_ie.astype(jnp.float64) ** 2 + a_qe.astype(jnp.float64) ** 2)
    l_mag = jnp.sqrt(a_il.astype(jnp.float64) ** 2 + a_ql.astype(jnp.float64) ** 2)
    denom = jnp.where(e_mag + l_mag > 0, e_mag + l_mag, 1.0)
    code_err = jnp.where(e_mag + l_mag > 0, (e_mag - l_mag) / denom, 0.0)
    code_nco = st.code_nco + tau2d / tau1d * (code_err - st.code_err) + code_err * (pdi / tau1d)
    code_freq = config.code_freq_basis - code_nco
    if config.carrier_aided_dll:
        # code rate rides the carrier Doppler scaled by f_code/f_L1; the
        # DLL corrects only the residual divergence (config docstring)
        code_freq = code_freq + (config.code_freq_basis / config.l1_freq) * (
            carr_freq - config.intermediate_freq)

    if K > 1:
        # hold filters/frequencies between the every-K-periods updates;
        # reset the accumulators at each update
        carr_err = jnp.where(upd, carr_err, st.carr_err)
        carr_nco = jnp.where(upd, carr_nco, st.carr_nco)
        carr_freq = jnp.where(upd, carr_freq, st.carr_freq)
        code_err = jnp.where(upd, code_err, st.code_err)
        code_nco = jnp.where(upd, code_nco, st.code_nco)
        code_freq = jnp.where(upd, code_freq, st.code_freq)
        z32 = jnp.float32(0.0)
        accs = {f: jnp.where(upd, z32, a)
                for f, a in zip(_ACC_FIELDS, (a_ie, a_ip, a_il, a_qe, a_qp, a_ql))}
        accs["fll_ip"] = jnp.where(upd, a_ip, st.fll_ip)
        accs["fll_qp"] = jnp.where(upd, a_qp, st.fll_qp)
    else:
        accs = {f: getattr(st, f) for f in _ACC_FIELDS}
        accs["fll_ip"] = a_ip
        accs["fll_qp"] = a_qp

    # --- state update (frozen when inactive) --------------------------------
    new = TrackState(
        ptr=st.ptr + blk,
        carr_phase=st.carr_phase + w * blk.astype(jnp.int32),
        code_rem_q=st.code_rem_q + step_q * blk - code_len_q,
        carr_freq=carr_freq,
        code_freq=code_freq,
        carr_nco=carr_nco,
        carr_err=carr_err,
        code_nco=code_nco,
        code_err=code_err,
        ms=st.ms + 1,
        block_base=st.block_base,
        **accs,
    )
    new = jax.tree.map(lambda n, o: jnp.where(active, n, o), new, st)

    z32 = jnp.float32(0.0)
    z64 = jnp.float64(0.0)
    frac = new.code_rem_q.astype(jnp.float64) / step_q.astype(jnp.float64)
    outs = MsOutputs(
        absolute_sample=jnp.where(active, new.ptr, jnp.int64(0)),
        sample_frac=jnp.where(active, frac, z64),
        code_freq=jnp.where(active, code_freq, z64),
        carr_freq=jnp.where(active, carr_freq, z64),
        i_p=jnp.where(active, i_p, z32),
        i_e=jnp.where(active, i_e, z32),
        i_l=jnp.where(active, i_l, z32),
        q_e=jnp.where(active, q_e, z32),
        q_p=jnp.where(active, q_p, z32),
        q_l=jnp.where(active, q_l, z32),
        dll_discr=jnp.where(active, code_err, z64),
        dll_discr_filt=jnp.where(active, code_nco, z64),
        pll_discr=jnp.where(active, carr_err, z64),
        pll_discr_filt=jnp.where(active, carr_nco, z64),
    )
    return new, outs


def _scan_ms(config: ReceiverConfig, signal, tables: CorrelatorTables,
             carr_basis, active, n_ms: int, state0: TrackState,
             start_ms: int = 0):
    """Scan ``n_ms`` milliseconds for all (vmapped) channels.

    With ``config.track_block_ms`` B > 1, per-channel capture windows are
    extracted one *block* at a time: a single batched dynamic_slice fetches
    (r+1) code periods per channel, which two reshapes re-frame into r
    static windows at samples_per_code spacing.  The inner per-ms scan then
    does no data-dependent slicing at all — the naive per-ms formulation
    spends more time in its vmapped dynamic_slice (an XLA gather with
    batched starts) than in the correlator math.  Each block re-anchors at
    the exact channel pointers, so frame drift never accumulates beyond one
    block (bounded by track_frame_pre; overflow is detected, not silent).

    Blocks are aligned to the ABSOLUTE ms grid ``start_ms + k*B`` with
    anchors carried in ``TrackState.block_base``, so the f32 accumulation
    grouping (frame tiling) depends only on the absolute millisecond, not
    on where a run started or stopped: a resumed run is bit-exact against
    the uninterrupted one (tests/test_resume_profiling.py), except within
    (B+1) code periods of the capture end where buffer clamping may regroup
    a frame.  Shared by the single-device tracker and the shard_map-sharded
    variants (softgnss_tpu.parallel.track).
    Returns (final_state, ys, overflow).
    """
    spc = config.samples_per_code
    win = config.track_window
    pre = config.track_frame_pre
    sig_len = signal.shape[0] * (config.track_pack
                                 if signal.dtype != jnp.int8 else 1)
    B = config.track_block_ms

    # The capture is consumed through an int16/int32 view when
    # config.track_pack > 1 (the correlator tables are built in the
    # matching byte-plane tile order — see tables.tile_starts): wider words
    # make the batched-start per-channel buffer slice move fewer, larger
    # elements.  The packed words are consumed DIRECTLY by the byte-plane
    # correlator (_frame_ms_packed), so no sample-order interleave is ever
    # materialized.  The <=3-sample word-alignment shift rides the frame
    # o-offset (a deterministic function of the anchor, so resume grouping
    # is unaffected).
    pack = config.track_pack
    if pack > 1:
        if signal.dtype == jnp.int8:
            # in-jit strided packing: track() pre-packs on the host
            # instead; this path serves the sharded callers that still
            # ship int8 shards
            sig_pack = _packed_view(signal, pack)
        elif signal.dtype == (jnp.int16 if pack == 2 else jnp.int32):
            # capture arrives pre-packed (a free little-endian host view)
            sig_pack = signal
        else:
            raise ValueError(
                f"track_pack={pack} needs an int8 or pre-packed "
                f"{'int16' if pack == 2 else 'int32'} capture, got "
                f"{signal.dtype}")
        step_fn_packed = jax.vmap(
            lambda frame, base, tab, cb, act, st: _frame_ms_packed(
                config, frame, base, tab, cb, act, st),
            in_axes=(0, 0, 0, 0, 0, 0))
    else:
        step_fn = jax.vmap(
            lambda frame, base, tab, cb, act, st: _frame_ms(
                config, frame, base, tab, cb, act, st),
            in_axes=(0, 0, 0, 0, 0, 0))

    def ms_step(carry, _):
        st, ovf = carry
        if pack > 1:
            start = st.ptr // pack
            frames = jax.vmap(lambda p: jax.lax.dynamic_slice(
                sig_pack, (p,), (win // pack,)))(start)
            new, outs, ov = step_fn_packed(frames, start * pack, tables,
                                           carr_basis, active, st)
        else:
            frames = jax.vmap(
                lambda p: jax.lax.dynamic_slice(signal, (p,), (win,)))(st.ptr)
            new, outs, ov = step_fn(frames, st.ptr, tables, carr_basis, active, st)
        return (new, jnp.maximum(ovf, ov.max())), outs

    # derive the zero from the state so it inherits any shard_map
    # "varying" axis tags (a literal 0 carry would type-mismatch the
    # channel-varying overflow inside sharded scans)
    zero = jnp.max(state0.ptr) * 0
    phase = start_ms % B if B > 1 else 0
    lead = min(B - phase, n_ms) if phase else 0
    n_full = (n_ms - lead) // B if B > 1 else 0
    r_tail = n_ms - lead - n_full * B if B > 1 else 0
    longest = max(lead, B if n_full else 0, r_tail)
    use_blocks = (B > 1 and n_ms > 0 and spc < win <= 2 * spc
                  and sig_len >= (longest + 1) * spc)
    if not use_blocks:
        (final, ovf), ys = jax.lax.scan(ms_step, (state0, zero), None, length=n_ms)
        return final, ys, ovf

    def scan_segment(carry, base, p0: int, r: int):
        """Run frames for grid-block milliseconds [p0, p0+r) anchored at
        per-channel ``base`` (the block's ms-0 frame anchor).

        The ONLY batched-start (gather-lowered) slice is the per-block
        buffer fetch; each ms then takes its frame from the buffer at a
        channel-SHARED offset j*spc — a plain dynamic_slice — with the
        per-channel sub-offset handled by the o-shift inside _frame_ms.
        """
        buf_len = (r + 1) * spc
        start = jnp.clip(base + p0 * spc, 0, sig_len // pack * pack - buf_len)
        if pack > 1:
            start = start // pack * pack
            buf = jax.vmap(lambda p: jax.lax.dynamic_slice(
                sig_pack, (p // pack,), (buf_len // pack,)))(start)
        else:
            buf = jax.vmap(
                lambda p: jax.lax.dynamic_slice(signal, (p,), (buf_len,)))(start)
        c_dim = buf.shape[0]

        def inner(carry2, j):
            st2, ovf2 = carry2
            fb = start + j * spc
            if pack > 1:
                frame = jax.lax.dynamic_slice(
                    buf, (0, j * (spc // pack)), (c_dim, win // pack))
                new, outs, ov = step_fn_packed(frame, fb, tables, carr_basis,
                                               active, st2)
            else:
                frame = jax.lax.dynamic_slice(buf, (0, j * spc), (c_dim, win))
                new, outs, ov = step_fn(frame, fb, tables, carr_basis, active, st2)
            return (new, jnp.maximum(ovf2, ov.max())), outs

        return jax.lax.scan(inner, carry, jnp.arange(r, dtype=jnp.int64),
                            unroll=min(config.track_unroll, r))

    carry = (state0, zero)
    parts = []
    if lead:   # finish the grid block a resumed run stopped inside
        carry, ys_l = scan_segment(carry, state0.block_base, phase, lead)
        parts.append(ys_l)
    if n_full:
        def block_step(carry2, _):
            st, ovf = carry2
            base = st.ptr - pre
            return scan_segment((st._replace(block_base=base), ovf), base, 0, B)

        carry, ys_b = jax.lax.scan(block_step, carry, None, length=n_full)
        parts.append(jax.tree.map(
            lambda a: a.reshape((n_full * B,) + a.shape[2:]), ys_b))
    if r_tail:
        st, ovf = carry
        base = st.ptr - pre
        carry, ys_t = scan_segment((st._replace(block_base=base), ovf), base,
                                   0, r_tail)
        parts.append(ys_t)
    final, ovf = carry
    ys = (parts[0] if len(parts) == 1
          else jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts))
    return final, ys, ovf


@partial(jax.jit, static_argnums=(0, 5, 7))
def _track_device(config: ReceiverConfig, signal, tables: CorrelatorTables,
                  carr_basis, active, n_ms: int, state0: TrackState,
                  start_ms: int = 0):
    """Scan over milliseconds with channels vmapped."""
    return _scan_ms(config, signal, tables, carr_basis, active, n_ms, state0,
                    start_ms)


def _check_overflow(ovf) -> None:
    """Raise if any block-mode frame failed to contain its ms span."""
    n = int(jax.device_get(ovf))
    if n > 0:
        raise RuntimeError(
            f"tracking frame overflowed its static window by {n} samples — "
            "code-phase drift within a block exceeded the frame slack; "
            "increase config.track_frame_margin or reduce track_block_ms")


def host_pack_signal(config: ReceiverConfig, signal):
    """Pre-pack an int8 capture into its int16/int32 little-endian view on
    the HOST (a free numpy reinterpretation) instead of in-jit from device
    int8, where it lowers to strided byte gathers.  _scan_ms accepts
    either form; non-int8 or pack-1 inputs pass through untouched."""
    pack = config.track_pack
    sig_np = np.asarray(signal)
    if pack > 1 and sig_np.dtype == np.int8:
        n = sig_np.shape[0] // pack * pack
        return np.ascontiguousarray(sig_np[:n]).view(
            np.int16 if pack == 2 else np.int32)
    return signal


def track(config: ReceiverConfig, signal: np.ndarray, channels: Channels,
          n_ms: int | None = None, state: TrackState | None = None) -> TrackResults:
    """Track all channels over ``n_ms`` milliseconds of the capture.

    ``signal`` is the full raw capture (int8), *including* any skipped
    prefix — channel pointers are absolute sample indices, exactly like the
    reference's ``fid.tell()`` bookkeeping (tracking.py:107,255).
    """
    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    # anchor the length check at the resume pointer, not the capture start
    start = (config.skip_samples if state is None
             else int(np.max(np.asarray(state.ptr))))
    needed = start + (n_ms + 2) * config.samples_per_code
    if signal.shape[0] < needed:
        raise ValueError(
            f"capture too short for tracking: need >= {needed} samples, got {signal.shape[0]}"
        )

    tables = build_tables(config, np.asarray(channels.prn),
                          np.asarray(channels.acquired_freq))
    active = np.asarray([s == "T" for s in channels.status])

    if state is None:
        state = initial_state(config, channels)
        start_ms = 0
    else:
        start_ms = int(np.max(np.asarray(state.ms)))

    sig_up = host_pack_signal(config, signal)

    # only start_ms % track_block_ms affects the trace (the block-grid
    # phase); pass the phase so resuming at different points reuses one
    # compiled executable instead of recompiling the whole scan
    B = config.track_block_ms
    final, ys, ovf = _track_device(
        config, jnp.asarray(sig_up), jax.tree.map(jnp.asarray, tables),
        jnp.asarray(channels.acquired_freq, jnp.float64), jnp.asarray(active),
        n_ms, state, start_ms % B if B > 1 else 0)
    ys = jax.device_get(ys)
    _check_overflow(ovf)

    return TrackResults(
        final_state=jax.tree.map(np.asarray, jax.device_get(final)),
        prn=np.asarray(channels.prn),
        status=list(channels.status),
        absolute_sample=np.asarray(ys.absolute_sample).T,
        sample_frac=np.asarray(ys.sample_frac).T,
        code_freq=np.asarray(ys.code_freq).T,
        carr_freq=np.asarray(ys.carr_freq).T,
        i_p=np.asarray(ys.i_p).T,
        i_e=np.asarray(ys.i_e).T,
        i_l=np.asarray(ys.i_l).T,
        q_e=np.asarray(ys.q_e).T,
        q_p=np.asarray(ys.q_p).T,
        q_l=np.asarray(ys.q_l).T,
        dll_discr=np.asarray(ys.dll_discr).T,
        dll_discr_filt=np.asarray(ys.dll_discr_filt).T,
        pll_discr=np.asarray(ys.pll_discr).T,
        pll_discr_filt=np.asarray(ys.pll_discr_filt).T,
    )
