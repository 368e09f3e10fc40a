"""Synthetic GPS L1 IF signal generator — the framework's test/bench backend.

The reference ships no test data (its golden inputs are unpublished textbook
recordings, reference: initialize.py:99, main.py:60), so correctness here is
established closed-loop: inject known PRNs / Doppler / delays / nav bits,
synthesize int8 IF samples, and verify that every receiver stage recovers the
injected truth (SURVEY.md §4).

Signal model (per satellite)::

    s[k] = A * CA_prn(floor(chips(k)) mod 1023) * D(floor(chips(k)/1023/20))
             * sin(2*pi*(IF + fd) * k/fs + phi0)
    chips(k) = fc_eff * (k - delay_samples) / fs          (static delay)
    chips(k) = fc * (t_rx0 + k/fs - tau(k) - t_bits0)     (dynamic delay)
    fc_eff   = code_freq_basis * (1 + fd / fL1)           # consistent code Doppler

so ``delay_samples mod samples_per_code`` is the acquisition code phase and
``IF + fd`` the acquisition carrier frequency.  The carrier is sine-phased:
with the reference's mixing convention (I = sin * x, reference:
tracking.py:205-207) a phase-locked PLL then yields nav bits on I_P.

Device execution: within each 1-ms block, code phase, carrier phase,
and delay are (piecewise-)linear, so every per-ms quantity reduces to a
host-precomputed (satellite, ms) parameter table — window-relative Q40
chip phase, uint32 carrier counts, the at-most-one nav-bit edge per ms —
and the device scan is pure elementwise math + one dynamic_slice of the
code + a constant-index tile gather + a narrow one-hot contraction (the
same gather-free pattern as the tracking correlator).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.config import ReceiverConfig
from softgnss_tpu.signals.ca import gold_codes
from softgnss_tpu.signals.nco import carrier_sin_cos

_BITS_PER_PERIOD = 20  # nav bit = 20 C/A code periods
_CHIPS_PER_BIT = 1023 * _BITS_PER_PERIOD
_Q = 40
_QONE = 1 << _Q
_TILE = 128


@dataclass(frozen=True)
class SatelliteSignal:
    """Injected truth for one satellite."""

    prn: int
    #: carrier Doppler relative to the IF, Hz
    doppler_hz: float = 0.0
    #: signal delay in samples; acquisition should report
    #: ``delay_samples mod samples_per_code`` as the code phase
    delay_samples: float = 0.0
    #: scalar amplitude, or a per-ms envelope (edge-held past its end) —
    #: e.g. ``(1.0,) * 2000 + (0.0,)`` kills the satellite at ms 2000,
    #: exercising the receiver's lock-loss demotion path
    amplitude: float | tuple[float, ...] = 1.0
    #: carrier phase at k=0, radians
    phase0: float = 0.0
    #: +/-1 nav bits, one per 20 ms; indexed by bit counter mod len.
    #: None -> constant +1 (no data modulation).
    nav_bits: tuple[int, ...] | None = None
    #: override the code chipping rate; None -> Doppler-consistent
    code_freq_hz: float | None = None

    def effective_code_freq(self, config: ReceiverConfig) -> float:
        if self.code_freq_hz is not None:
            return self.code_freq_hz
        return config.code_freq_basis * (1.0 + self.doppler_hz / config.l1_freq)


def amplitude_for_cn0(config: ReceiverConfig, cn0_dbhz: float,
                      noise_std: float) -> float:
    """Signal amplitude that yields the given carrier-to-noise density.

    The synthesized carrier has power A^2/2; white noise of std ``sigma``
    per sample at rate fs has density sigma^2/fs, so
    C/N0 = A^2 fs / (2 sigma^2).  Real L1 captures sit at ~35-50 dB-Hz;
    the framework's toy defaults (A=1, sigma=1.5) are ~59 dB-Hz.
    """
    return float(np.sqrt(2.0 * noise_std**2 * 10.0 ** (cn0_dbhz / 10.0)
                         / config.sampling_freq))


def _nav_bit_array(sat: SatelliteSignal) -> np.ndarray:
    if sat.nav_bits is None:
        return np.ones(1, np.float32)
    bits = np.asarray(sat.nav_bits, np.float32)
    if not np.all(np.abs(bits) == 1):
        raise ValueError("nav_bits must be +/-1")
    return bits


class _MsParams(NamedTuple):
    """Per-(satellite, ms) tables; leading axes (S, n_ms) on the host,
    transposed to (n_ms, S) for the device scan."""

    win_start: np.ndarray   # i32 code-window start chip, in [0, 1023)
    frac0_q: np.ndarray     # i64 Q40 window-relative chips at sample 0
    step_q: np.ndarray      # i64 Q40 chips/sample
    bit0: np.ndarray        # f32 nav bit before the edge
    bit1: np.ndarray        # f32 nav bit after the edge
    edge_q: np.ndarray      # i64 Q40 window-relative chips of the bit edge
    p0: np.ndarray          # i32 carrier NCO counts at sample 0
    pw: np.ndarray          # i32 carrier NCO counts/sample


def _window_geometry(config: ReceiverConfig):
    """Static tile geometry of the per-ms code window."""
    spms = config.samples_per_code
    t_count = -(-spms // _TILE)
    s_nom = config.code_freq_basis / config.sampling_freq      # chips/sample
    w = int(np.ceil(s_nom * _TILE)) + 8
    w = (w + 7) // 8 * 8
    win_chips = int(np.ceil(s_nom * t_count * _TILE)) + 8
    h_base = np.floor(s_nom * _TILE * np.arange(t_count)).astype(np.int64) - 2
    static_idx = np.clip(h_base[:, None] + np.arange(w)[None, :], 0, win_chips - 1)
    return t_count, w, win_chips, h_base.astype(np.int32), static_idx.astype(np.int32)


def _build_params(config: ReceiverConfig, n_ms: int, chips0: np.ndarray,
                  chip_slope: np.ndarray, cyc0: np.ndarray, cyc_slope: np.ndarray,
                  bit_tables: list[np.ndarray], wrap_bits: bool) -> _MsParams:
    """Host-side per-ms parameter tables (all float64/integer NumPy).

    chips0/cyc0: (S, n_ms) code chips / carrier cycles at each ms start;
    chip_slope/cyc_slope: (S, n_ms) per-sample slopes.
    """
    c0 = np.floor(chips0).astype(np.int64)
    frac0_q = np.rint((chips0 - c0) * _QONE).astype(np.int64)
    carry = frac0_q >= _QONE
    c0 += carry
    frac0_q = np.where(carry, 0, frac0_q)
    step_q = np.rint(chip_slope * _QONE).astype(np.int64)

    win_start = np.mod(c0, 1023).astype(np.int32)

    b_idx = c0 // _CHIPS_PER_BIT
    edge_chip = (b_idx + 1) * _CHIPS_PER_BIT
    # device-side chips_q is (chips_abs - c0) in Q40 (it already contains
    # frac0_q), so the edge threshold is simply (edge_chip - c0) in Q40
    edge_q = np.minimum(edge_chip - c0, 1 << 20) * _QONE

    s = chips0.shape[0]
    bit0 = np.empty(chips0.shape, np.float32)
    bit1 = np.empty(chips0.shape, np.float32)
    for i in range(s):
        table = bit_tables[i]
        if wrap_bits:
            bit0[i] = table[np.mod(b_idx[i], len(table))]
            bit1[i] = table[np.mod(b_idx[i] + 1, len(table))]
        else:
            bit0[i] = table[np.clip(b_idx[i], 0, len(table) - 1)]
            bit1[i] = table[np.clip(b_idx[i] + 1, 0, len(table) - 1)]

    p0 = np.rint((cyc0 - np.floor(cyc0)) * 2.0**32).astype(np.int64)
    pw = np.rint(np.mod(cyc_slope, 1.0) * 2.0**32).astype(np.int64)
    to_i32 = lambda x: (np.bitwise_and(x, 0xFFFFFFFF)
                        - (np.bitwise_and(x, 0xFFFFFFFF) >> 31 << 32)).astype(np.int32)
    return _MsParams(win_start, frac0_q, step_q, bit0, bit1, edge_q,
                     to_i32(p0), to_i32(pw))


@functools.partial(jax.jit, static_argnums=(0, 1, 5))
def _synth_device(config: ReceiverConfig, n_ms: int, params, codes3, amps,
                  noise_std: float, noise_key):
    """Scan over 1-ms blocks; satellites vmapped inside each block.

    params: _MsParams with (n_ms, S) leading axes; codes3: (S, 3*1023) f32
    tiled C/A codes; amps: (n_ms, S) f32 per-ms amplitudes (scanned with
    the parameter tables, so time-varying signal strength is free).
    """
    spms = config.samples_per_code
    t_count, w, win_chips, h_base, static_idx = _window_geometry(config)
    h_base_j = jnp.asarray(h_base)                              # (T,)
    static_idx_j = jnp.asarray(static_idx)                      # (T, w)
    iota_w = jnp.arange(w, dtype=jnp.int32)
    j_lane = jnp.arange(_TILE, dtype=jnp.int64)
    k32 = (jnp.arange(t_count, dtype=jnp.int32)[:, None] * _TILE
           + jnp.arange(_TILE, dtype=jnp.int32)[None, :])       # (T, 128)
    t_off = (jnp.arange(t_count, dtype=jnp.int64) * _TILE)      # (T,)

    def one_sat(p: _MsParams, code3, amp):
        win = jax.lax.dynamic_slice(code3, (p.win_start,), (win_chips,))
        tiles = win[static_idx_j]                               # (T, w) const idx
        pt = p.frac0_q + p.step_q * t_off                       # (T,) Q40
        h_int = (pt >> _Q).astype(jnp.int32)                    # (T,) chips
        frac24 = ((pt & (_QONE - 1)) >> 16)                     # (T,) i64 Q24
        step24 = p.step_q >> 16
        off = ((frac24[:, None] + step24 * j_lane[None, :]) >> 24).astype(jnp.int32)
        loc = jnp.clip(h_int[:, None] + off - h_base_j[:, None], 0, w - 1)
        oh = (loc[:, :, None] == iota_w[None, None, :]).astype(jnp.float32)
        code_val = jnp.einsum("tkw,tw->tk", oh, tiles,
                              preferred_element_type=jnp.float32)

        chips_q = pt[:, None] + p.step_q * j_lane[None, :]      # (T, 128) Q40
        bit_val = jnp.where(chips_q >= p.edge_q, p.bit1, p.bit0)

        sin_v, _ = carrier_sin_cos(p.p0, p.pw, k32)
        return amp * code_val * bit_val * sin_v                 # (T, 128)

    def ms_step(carry_key, xs):
        p_ms, amp_ms = xs
        per_sat = jax.vmap(one_sat, in_axes=(0, 0, 0))(p_ms, codes3, amp_ms)
        x = per_sat.sum(axis=0).reshape(-1)[:spms]
        key, sub = jax.random.split(carry_key)
        if noise_std > 0.0:
            x = x + noise_std * jax.random.normal(sub, (spms,), jnp.float32)
        q = jnp.clip(jnp.round(x), -128, 127).astype(jnp.int8)
        return key, q

    _, out = jax.lax.scan(ms_step, noise_key, (params, amps), length=n_ms)
    return out.reshape(-1)


def _run_synth(config: ReceiverConfig, prns, params: _MsParams, amps,
               n_ms: int, noise_std: float, seed: int) -> np.ndarray:
    codes = gold_codes()[np.asarray(prns) - 1].astype(np.float32)
    codes3 = np.concatenate([codes, codes, codes], axis=1)      # (S, 3069)
    # device layout: (n_ms, S) so the scan slices per-ms rows
    dev_params = _MsParams(*[jnp.asarray(np.ascontiguousarray(a.T)) for a in params])
    amps = np.asarray(amps, np.float32)
    if amps.ndim == 1:
        amps = np.broadcast_to(amps[:, None], (len(prns), n_ms))
    if amps.shape != (len(prns), int(n_ms)):
        raise ValueError(f"amplitudes must be (n_sats,) or (n_sats, n_ms), "
                         f"got {amps.shape}")
    out = _synth_device(config, int(n_ms), dev_params, jnp.asarray(codes3),
                        jnp.asarray(np.ascontiguousarray(amps.T)),
                        float(noise_std), jax.random.PRNGKey(seed))
    return np.asarray(jax.device_get(out))


def synthesize_signal(config: ReceiverConfig, sats: list[SatelliteSignal],
                      n_ms: int, noise_std: float = 0.0, seed: int = 0) -> np.ndarray:
    """Generate ``n_ms`` milliseconds of int8 IF samples for the given satellites."""
    if config.sampling_freq % 1000:
        raise ValueError("synthesizer requires sampling_freq divisible by 1000")
    if not sats:
        raise ValueError("need at least one satellite")

    fs = config.sampling_freq
    spms = config.samples_per_code
    m = np.arange(n_ms, dtype=np.float64)[None, :] * spms       # sample at ms start

    fc = np.asarray([s.effective_code_freq(config) for s in sats])[:, None]
    d = np.asarray([s.delay_samples for s in sats])[:, None]
    chips0 = fc * (m - d) / fs
    chip_slope = np.broadcast_to(fc / fs, chips0.shape)

    fcar = np.asarray([config.intermediate_freq + s.doppler_hz for s in sats])[:, None]
    phi0 = np.asarray([s.phase0 for s in sats])[:, None]
    cyc0 = fcar * m / fs + phi0 / (2.0 * np.pi)
    cyc_slope = np.broadcast_to(fcar / fs, cyc0.shape)

    params = _build_params(config, n_ms, chips0, chip_slope, cyc0, cyc_slope,
                           [_nav_bit_array(s) for s in sats], wrap_bits=True)
    amps = np.empty((len(sats), n_ms), np.float32)
    for i, s in enumerate(sats):
        a = np.atleast_1d(np.asarray(s.amplitude, np.float32))
        k = min(len(a), n_ms)
        amps[i, :k] = a[:k]
        amps[i, k:] = a[-1]                                     # edge hold
    return _run_synth(config, [s.prn for s in sats], params, amps,
                      n_ms, noise_std, seed)


def synthesize_iq(config: ReceiverConfig, sats: list[SatelliteSignal],
                  n_ms: int, noise_std: float = 0.0,
                  seed: int = 0) -> np.ndarray:
    """Generate a complex baseband I/Q capture — (N, 2) int8 [I, Q] pairs.

    ``config.intermediate_freq`` is the recorded complex center offset
    (0 for a zero-IF SDR front end); each satellite appears at
    ``intermediate_freq + doppler_hz`` in the complex spectrum.  The
    quadrature component is the same synthesis with the carrier phase
    retarded by pi/2 and independent noise, so
    ``I + jQ = A c(t) exp(j(2 pi f t + phase0 - pi/2))`` — digitally
    upconverting with :func:`softgnss_tpu.io.upconvert_iq` reproduces
    exactly the real capture :func:`synthesize_signal` would emit at
    ``intermediate_freq + fs/4``.  Test backend for the iq8/iq16 front
    ends (the reference has no complex support at all).
    """
    import dataclasses

    sats_q = [dataclasses.replace(s, phase0=s.phase0 - np.pi / 2.0)
              for s in sats]
    i = synthesize_signal(config, sats, n_ms, noise_std=noise_std, seed=seed)
    q = synthesize_signal(config, sats_q, n_ms, noise_std=noise_std,
                          seed=seed + 0x5EED)
    return np.stack([i, q], axis=1)


def synthesize_dynamic(config: ReceiverConfig, prns: list[int],
                       delays_s: np.ndarray, bit_streams: np.ndarray,
                       t_rx0_minus_bits0: float, n_ms: int,
                       amplitudes: np.ndarray | None = None,
                       phase0: np.ndarray | None = None,
                       noise_std: float = 0.0, seed: int = 0,
                       clock_ppm: float = 0.0) -> np.ndarray:
    """Geometry-consistent IF capture with per-ms time-varying delays.

    ``delays_s``: (S, >= n_ms+1) light times (s) at each ms boundary,
    linearly interpolated within the ms (curvature error over 1 ms is
    ~1e-7 samples for GPS dynamics — code and carrier phase stay
    continuous and geometry-consistent across the capture);
    ``bit_streams``: (S, n_bits) +/-1 transmitted nav bits, bit 0 starting
    at transmit time 0; ``t_rx0_minus_bits0``: receiver capture start minus
    bit-stream start, in GPS seconds.  ``amplitudes``: (S,) constants or
    (S, n_ms) per-ms envelopes (time-varying signal strength).  Used by the
    golden-scenario builder (softgnss_tpu.scenario) for closed-loop
    navigation tests.

    ``clock_ppm``: receiver-oscillator fractional frequency offset in
    parts per million (the reference assumes an exact front end,
    initialize.py:105-107 — every real capture has this).  The sampling
    clock runs at fs*(1+rho) and the downconversion LO, derived from the
    same oscillator, at (f_L1 - f_IF)*(1+rho): in capture-sample units
    every signal appears with an extra common carrier offset of
    ~ -f_L1*rho Hz, a code-clock scale of 1/(1+rho), and a pseudorange-
    counter drift of rho (the receiver's clock-bias slope, rho*c m/s).
    The caller's ``delays_s`` must be sampled at the TRUE boundary times
    t_rx0 + k*1e-3/(1+rho) (synthesize_scenario handles this).
    """
    if config.sampling_freq % 1000:
        raise ValueError("synthesizer requires sampling_freq divisible by 1000")
    s = len(prns)
    delays_s = np.asarray(delays_s, np.float64)
    if delays_s.shape[0] != s or delays_s.shape[1] < n_ms + 1:
        raise ValueError(f"delays_s must be (n_sats, >= n_ms+1), got {delays_s.shape}")
    bit_streams = np.asarray(bit_streams, np.float32)
    if not np.all(np.abs(bit_streams) == 1):
        raise ValueError("bit_streams must be +/-1")

    fs = config.sampling_freq
    spms = config.samples_per_code
    fc = config.code_freq_basis
    f_if = config.intermediate_freq
    f_l1 = config.l1_freq
    t0 = np.arange(n_ms, dtype=np.float64)[None, :] * (spms / fs)
    tau0 = delays_s[:, :n_ms]
    dtau = (delays_s[:, 1:n_ms + 1] - tau0) / spms              # s per sample

    # receiver-clock warp: receiver sample k sits at true time
    # k/(fs*(1+rho)); the LO error shifts the apparent IF by ~ -f_L1*rho
    rho = clock_ppm * 1e-6
    fc_x = fc / (1.0 + rho)
    f_if_x = (f_if - (f_l1 - f_if) * rho) / (1.0 + rho)

    chips0 = fc * (t_rx0_minus_bits0 - tau0) + fc_x * t0
    chip_slope = fc_x / fs - fc * dtau

    phi0 = (np.zeros(s) if phase0 is None else np.asarray(phase0))[:, None]
    cyc0 = f_if_x * t0 - f_l1 * tau0 + phi0 / (2.0 * np.pi)
    cyc_slope = f_if_x / fs - f_l1 * dtau

    params = _build_params(config, n_ms, chips0, chip_slope, cyc0, cyc_slope,
                           [b for b in bit_streams], wrap_bits=False)
    amps = (np.ones(s, np.float32) if amplitudes is None
            else np.asarray(amplitudes, np.float32))
    return _run_synth(config, prns, params, amps, n_ms, noise_std, seed)


def default_scenario(config: ReceiverConfig, num_sats: int = 4, noise_std: float = 2.0,
                     seed: int = 7) -> tuple[list[SatelliteSignal], np.ndarray]:
    """A reproducible multi-satellite scenario + its IF capture (for tests/bench)."""
    rng = np.random.default_rng(seed)
    spc = config.samples_per_code
    sats = []
    for i in range(num_sats):
        sats.append(SatelliteSignal(
            prn=int(rng.integers(1, 33)) if i else 5,
            doppler_hz=float(rng.uniform(-4000, 4000)),
            delay_samples=float(rng.uniform(0, spc)),
            amplitude=float(rng.uniform(0.8, 1.5)),
            phase0=float(rng.uniform(0, 2 * np.pi)),
            nav_bits=tuple(rng.choice([-1, 1], size=64)),
        ))
    # ensure distinct PRNs
    seen = set()
    uniq = []
    next_prn = 1
    for s in sats:
        prn = s.prn
        while prn in seen:
            prn = next_prn
            next_prn += 1
        seen.add(prn)
        uniq.append(dataclasses.replace(s, prn=prn))
    signal = synthesize_signal(config, uniq, config.ms_to_process + config.acquisition_ms + 2,
                               noise_std=noise_std, seed=seed)
    return uniq, signal
