"""Receiver configuration.

A frozen, hashable dataclass so a config can be passed as a *static* argument
to ``jax.jit`` — every derived quantity (samples per code, Doppler grids,
block sizes) is then a Python-level constant inside the traced program, which
keeps all shapes static for XLA.

Covers every knob of the reference settings object
(reference: initialize.py:80-185) plus accelerator-execution knobs
(chunking, window padding, mesh axis names).  Unlike the reference —
which is configured by editing source (reference: README.md:18-19) —
configs here are immutable values; use :func:`dataclasses.replace`
(re-exported as ``with_options``) to derive variants, and the CLI exposes
``--set key=value`` overrides.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


#: valid values of ReceiverConfig.correlator_impl
CORRELATOR_IMPLS = ("auto", "onehot", "gather")


@dataclass(frozen=True)
class ReceiverConfig:
    """All receiver knobs. Frozen + hashable => usable as a jit static arg."""

    # --- processing -------------------------------------------------------
    #: milliseconds of capture to process (reference: initialize.py:85)
    ms_to_process: int = 37000
    #: number of tracking channels (reference: initialize.py:88)
    number_of_channels: int = 8
    #: samples to skip at the start of the capture; the reference expresses
    #: this in bytes but only supports 1-byte samples
    #: (reference: initialize.py:94, tracking.py:107)
    skip_samples: int = 0

    # --- raw signal front-end ---------------------------------------------
    #: default capture file (reference: initialize.py:99)
    file_name: str = ""
    #: on-disk sample encoding; 'int8' matches the reference
    #: (reference: initialize.py:102); 'int16'/'uint8' and packed 'int4'/
    #: 'int2'/'int1' are handled by softgnss_tpu.io
    data_format: str = "int8"
    #: intermediate frequency after the RF front end, Hz
    #: (reference: initialize.py:105)
    intermediate_freq: float = 9_548_000.0
    #: sampling frequency, Hz (reference: initialize.py:107)
    sampling_freq: float = 38_192_000.0
    #: C/A chipping rate, Hz (reference: initialize.py:109)
    code_freq_basis: float = 1_023_000.0
    #: chips per C/A code period (reference: initialize.py:112)
    code_length: int = 1023

    # --- acquisition --------------------------------------------------------
    #: skip acquisition and reuse cached results (reference: initialize.py:117)
    skip_acquisition: bool = False
    #: PRNs to search, 1-based (reference: initialize.py:120)
    acq_satellite_list: tuple[int, ...] = tuple(range(1, 33))
    #: two-sided Doppler search band in kHz (reference: initialize.py:123)
    acq_search_band_khz: float = 14.0
    #: peak-to-second-peak detection threshold (reference: initialize.py:126)
    acq_threshold: float = 2.5
    #: Doppler bin spacing, Hz (hard-coded 500 in reference: acquisition.py:101)
    acq_doppler_step_hz: float = 500.0
    #: milliseconds of signal used by the fine-frequency search
    #: (hard-coded 10 in reference: acquisition.py:172-177)
    acq_fine_freq_ms: int = 10
    #: zoom-FFT fine search: boxcar decimation factor after the coarse mix
    acq_fine_decimation: int = 512
    #: zoom-FFT fine search: FFT length on the decimated signal
    acq_fine_fft: int = 8192
    #: zoom-FFT fine search: half-width of the searched band around the
    #: coarse bin, Hz (coarse bins are acq_doppler_step_hz apart)
    acq_fine_band_hz: float = 400.0
    #: milliseconds accumulated non-coherently in the code/Doppler search.
    #: 2 = the reference's scheme (best of two 1-ms correlations, its
    #: bit-transition hedge, acquisition.py:129-133; sensitivity floor
    #: ~47 dB-Hz at threshold 2.5).  K > 2 sums K per-ms correlation powers
    #: instead — beyond the reference, ~5 log10(K/2) dB lower floor (K=10
    #: reaches ~41 dB-Hz; measured curves in BASELINE.md); each extra
    #: millisecond adds one more pass over the batched FFT grid
    acq_noncoherent_ms: int = 2

    # --- tracking loops ----------------------------------------------------
    #: DLL damping ratio (reference: initialize.py:130)
    dll_damping_ratio: float = 0.7
    #: DLL noise bandwidth, Hz (reference: initialize.py:132)
    dll_noise_bandwidth: float = 2.0
    #: early/late correlator offset, chips (reference: initialize.py:134)
    dll_correlator_spacing: float = 0.5
    #: PLL damping ratio (reference: initialize.py:137)
    pll_damping_ratio: float = 0.7
    #: PLL noise bandwidth, Hz (reference: initialize.py:139)
    pll_noise_bandwidth: float = 25.0
    #: DLL loop gain (reference: tracking.py:45)
    dll_loop_gain: float = 1.0
    #: PLL loop gain (reference: tracking.py:52)
    pll_loop_gain: float = 0.25
    #: FLL-assisted PLL (beyond the reference's pure Costas PLL,
    #: tracking.py:221-235): noise bandwidth (Hz) of a first-order
    #: frequency-locked-loop assist on the carrier NCO, driven by the
    #: bit-insensitive cross/dot discriminator over consecutive prompt
    #: sums — pulls in residual acquisition frequency errors far beyond
    #: the PLL's own lock-in range (~tens of Hz at the default 25 Hz
    #: bandwidth; false-lock-prone beyond).  Unambiguous pull-in range is
    #: +-1/(4*pdi_s) Hz (+-250 Hz at 1 ms PDI, halving per PDI doubling).
    #: 0 = off (reference behavior)
    fll_bandwidth_hz: float = 0.0
    #: carrier-aided DLL (beyond the reference, which runs the code loop
    #: unaided, tracking.py:237-249): the code NCO rate follows the PLL's
    #: carrier Doppler scaled by f_code/f_L1 (1/1540), so the DLL only
    #: tracks the residual code-carrier divergence and its noise
    #: bandwidth can drop well below the unaided 2 Hz (e.g. 0.25-0.5 Hz)
    #: without dynamics lag — standard receiver practice that cuts code
    #: pseudorange noise by ~sqrt(BW ratio)
    carrier_aided_dll: bool = False
    #: predetection (coherent) integration time in code periods (ms).
    #: 1 = the reference's hard-coded PDI (tracking.py:42,49).  K > 1
    #: (beyond the reference) accumulates the six correlator sums over K
    #: consecutive code periods and updates the DLL/PLL at that cadence,
    #: lowering the tracking noise floor by ~10 log10(K) dB of coherent
    #: gain; per-ms observables (I_P nav-bit stream, absolute_sample
    #: pseudorange counters) keep their 1-ms cadence.  K should divide 20
    #: (the nav-bit period) and the capture should be near a bit edge at
    #: tracking start for the full gain — a data-bit flip inside a window
    #: partially cancels that window's sums
    pdi_ms: int = 1

    # --- navigation solution -------------------------------------------------
    #: period between PVT fixes, ms (reference: initialize.py:144)
    nav_sol_period_ms: int = 500
    #: elevation mask, degrees (reference: initialize.py:147)
    elevation_mask_deg: float = 10.0
    #: apply tropospheric correction (reference: initialize.py:150)
    use_trop_corr: bool = True
    #: apply the Klobuchar ionospheric correction when subframe 4 page 18
    #: coefficients are decoded from the nav message (beyond the
    #: reference, which ignores subframes 4-5 entirely — see nav.iono)
    use_iono_corr: bool = True
    #: carrier-smoothing (Hatch filter) window in epochs; 0 = off (the
    #: reference has no smoothing).  Code pseudoranges are blended with
    #: integrated carrier-phase deltas, cutting code noise by ~sqrt(N)
    carrier_smoothing_epochs: int = 0
    #: known true position (E, N, U) for plotting, or None
    #: (reference: initialize.py:156)
    true_position: tuple[float, float, float] | None = None
    #: RAIM fault detection & exclusion (beyond the reference, which
    #: discards its least-squares residuals, geoFunctions:704-719): each
    #: epoch's post-fit residual sum-of-squares is chi-square tested; on a
    #: fault, leave-one-out re-solves isolate and exclude the faulty
    #: satellite (>= 6 usable satellites), else the epoch is invalidated.
    #: See NavSolutions.raim_flag.
    raim: bool = True
    #: one-sigma pseudorange error (m) normalizing the RAIM test
    #: statistic.  None (default) auto-calibrates from the capture: a
    #: first residual pass takes a median-of-epochs robust scale, so the
    #: test adapts to the front end's actual code noise (a persistent
    #: fault spanning most of the capture inflates the estimate — supply
    #: the receiver's known UERE explicitly to catch those)
    raim_sigma_m: float | None = None
    #: floor (m) under the auto-calibrated RAIM sigma
    raim_sigma_floor_m: float = 3.0
    #: navigation solution filter: 'lsq' = independent per-epoch least
    #: squares (the reference's scheme, geoFunctions:636-739); 'ekf' = an
    #: 8-state position/velocity/clock extended Kalman filter across
    #: epochs (beyond the reference) — smooths code noise, solves through
    #: epochs with fewer than 4 usable satellites once initialized, and
    #: adds per-measurement innovation gating.  See nav.ekf; the
    #: per-epoch LS columns stay available as NavSolutions.lsq_*
    nav_filter: str = "lsq"
    #: EKF white-noise acceleration PSD per ECEF axis, m^2/s^3 (raise for
    #: high-dynamics platforms, lower for static receivers)
    ekf_accel_psd: float = 2.0
    #: EKF clock-drift random-walk PSD, m^2/s^3 (TCXO-class default)
    ekf_clock_psd: float = 1.0
    #: EKF clock-bias white-noise PSD, m^2/s
    ekf_clock_bias_psd: float = 0.1
    #: EKF pseudorange one-sigma, m; None = reuse the RAIM-calibrated
    #: sigma (raim_sigma_m / auto-calibration)
    ekf_range_sigma_m: float | None = None
    #: EKF range-rate (carrier Doppler) one-sigma, m/s
    ekf_doppler_sigma: float = 0.15
    #: EKF innovation gate, standard deviations (chi on each scalar update)
    ekf_gate_sigma: float = 6.0

    # --- lock monitoring (beyond the reference: tracking.py:253-275 logs
    # --- the observables but never reacts to lock loss) -----------------------
    #: demote channels that lose lock: navigation excludes a channel from
    #: every epoch after its C/N0 or phase-lock indicator collapses
    lock_demotion: bool = True
    #: lock-metric window, ms (Van Dierendonck C/N0 estimator span)
    lock_window_ms: int = 1000
    #: C/N0 floor, dB-Hz: windows below it count as unlocked
    lock_cn0_threshold_dbhz: float = 28.0
    #: phase-lock (NBD/NBP) floor: ~1 phase-locked, ~0 tracking noise
    lock_pll_threshold: float = 0.5

    # --- plotting ------------------------------------------------------------
    #: draw per-channel tracking dashboards (reference: initialize.py:165;
    #: note the reference's gate is inverted — initialize.py:521 plots when
    #: the flag is False. We use the flag with its stated meaning.)
    plot_tracking: bool = False

    # --- constants -----------------------------------------------------------
    #: speed of light, m/s (reference: initialize.py:171)
    speed_of_light: float = 299_792_458.0
    #: nominal signal travel time added to pseudoranges, ms
    #: (reference: initialize.py:173)
    start_offset_ms: float = 68.802
    #: GPS L1 carrier frequency, Hz (used by the signal simulator)
    l1_freq: float = 1_575_420_000.0

    # --- accelerator-execution knobs ------------------------------------------
    # The defaults below predate any GPU measurement; they are kept until a
    # sweep on the card re-tunes them.
    #: PRNs per acquisition chunk: the (chunk, doppler, samples) correlation
    #: tensor is materialized per chunk to bound device-memory footprint
    acq_prn_chunk: int = 8
    #: extra samples beyond samples_per_code in the fixed tracking window
    #: (covers code-NCO block-size wander of +/- a few samples); the window
    #: is then rounded up to a multiple of track_tile
    track_window_extra: int = 8
    #: sample-tile size of the gather-free one-hot correlator
    track_tile: int = 128
    #: milliseconds per tracking window-extraction block.  The per-channel
    #: capture windows for a whole block are extracted with ONE batched
    #: dynamic_slice and re-framed at static offsets, instead of one
    #: per-channel dynamic_slice (an XLA gather) every millisecond — the
    #: dominant per-step cost of the naive scan.  <= 1 disables blocking
    #: (the round-1 per-ms path)
    track_block_ms: int = 64
    #: total static slack (samples) around each block-mode frame, absorbing
    #: code-phase drift of the true ms boundaries away from the nominal
    #: samples_per_code grid within a block.  0 = auto-size from the worst
    #: case (DLL pull-in of ~1 chip + max code Doppler over the block)
    track_frame_margin: int = 0
    #: unroll factor of the per-ms tracking scan (amortizes per-iteration
    #: loop overhead; the recurrence itself stays sequential)
    track_unroll: int = 4
    #: correlator strategy: 'auto' (= 'onehot'), 'onehot' (gather-free
    #: tiled contraction, see softgnss_tpu.track.tables), or 'gather'
    #: (direct per-sample table lookup — the reference formulation, kept
    #: as the plain cross-check path)
    correlator_impl: str = "auto"
    #: mesh axis names for sharded runs
    time_axis: str = "time"
    channel_axis: str = "channel"
    #: warmup (re-lock) milliseconds discarded at each time-shard boundary
    #: when tracking is sharded over time blocks.  Default from the measured
    #: sweep (scripts/warmup_sweep.py, table in BASELINE.md): down to 25 ms
    #: the stitched nav bits are error-free and sample counters stay within
    #: the inherent +-1 quantization at both ~59 and 45 dB-Hz; 250 ms buys
    #: 4x margin and a <= ~10 Hz post-boundary carrier-frequency transient
    #: at ~5% redundant compute on the reference workload (8 shards, 37 s).
    #: The exact-carry anchor is shard='time-exact'.
    time_shard_warmup_ms: int = 250
    #: time-chunk size (ms) of the software-pipelined tracker
    #: (softgnss_tpu.parallel.stream): capture upload, device compute, and
    #: output readback overlap across chunks.  0 = monolithic (upload the
    #: whole capture, then track, then fetch).  Enable via
    #: ``run_receiver(..., stream=True)`` or ``track_streamed``; rounded
    #: down to a multiple of track_block_ms
    track_stream_chunk_ms: int = 4096

    # --- derived ----------------------------------------------------------------
    @property
    def samples_per_code(self) -> int:
        """Samples in one C/A code period (reference: initialize.py:184-185)."""
        return int(round(self.sampling_freq / (self.code_freq_basis / self.code_length)))

    @property
    def samples_per_chip(self) -> int:
        """Whole samples per chip (reference: acquisition.py:145)."""
        return int(round(self.sampling_freq / self.code_freq_basis))

    @property
    def num_doppler_bins(self) -> int:
        """Doppler bins across the search band (reference: acquisition.py:68,
        generalized: the reference hard-codes the 500 Hz step)."""
        band_hz = self.acq_search_band_khz * 1000.0
        return int(round(band_hz / self.acq_doppler_step_hz)) + 1

    @property
    def doppler_bin_freqs(self) -> tuple[float, ...]:
        """Absolute carrier frequencies searched (reference: acquisition.py:99-101)."""
        lo = self.intermediate_freq - self.acq_search_band_khz / 2.0 * 1000.0
        return tuple(lo + self.acq_doppler_step_hz * i for i in range(self.num_doppler_bins))

    @property
    def pdi_s(self) -> float:
        """Predetection integration time in seconds (feeds the loop-filter
        update gain, reference tracking.py:221-249)."""
        return self.pdi_ms * 1e-3

    @property
    def track_frame_pre(self) -> int:
        """Block-mode frame pre-margin: nominal sample offset of a true ms
        boundary inside its static frame (half the frame slack).  0 when
        window blocking is off (the per-ms path).

        Auto bound (track_frame_margin=0): the ms boundaries drift from the
        nominal ``j*samples_per_code`` grid by at most ~1 chip of DLL
        pull-in plus the code-Doppler rate (|doppler| < 6 kHz on L1 =>
        < 3.9e-6 of the code rate) integrated over the block, plus the
        +-1-sample code-period jitter; a few samples of slack on top."""
        if self.track_block_ms <= 1:
            return 0
        if self.track_frame_margin > 0:
            return self.track_frame_margin // 2
        drift = 6e-6 * self.track_block_ms * self.samples_per_code
        return self.samples_per_chip + int(math.ceil(drift)) + 8

    #: preferred samples-per-word packing of the tracking capture view
    #: (1, 2, or 4; see track_pack).  Wider words make the batched
    #: per-channel buffer slicing faster; narrower words shrink each
    #: correlator tile's real-sample span and with it the one-hot width
    track_pack_size: int = 2

    @property
    def track_pack(self) -> int:
        """Samples per capture word in the tracking hot path: >1 when the
        int8 capture is consumed through an int16/int32 view (fast batched
        slicing + byte-plane-ordered correlation, see track.scan)."""
        p = self.track_pack_size
        if (p in (2, 4)
                and self.resolved_correlator == "onehot"
                and self.track_block_ms > 1
                and self.samples_per_code % p == 0 and self.track_tile % p == 0):
            return p
        return 1

    @property
    def resolved_correlator(self) -> str:
        """The correlator implementation actually used by the tracker:
        'auto' is the one-hot contraction on every backend."""
        return "onehot" if self.correlator_impl == "auto" else self.correlator_impl

    @property
    def track_window(self) -> int:
        """Fixed per-ms sample window for tracking (static shape for XLA),
        rounded up to a whole number of track_tile-sample tiles (times the
        word packing, so the packed window splits into whole planes).  In
        block mode the window is widened by the frame slack
        (2*track_frame_pre) so a static frame contains the drifting true
        ms span."""
        w = self.samples_per_code + self.track_window_extra + 2 * self.track_frame_pre
        mult = self.track_tile * self.track_pack
        return (w + mult - 1) // mult * mult

    @property
    def acquisition_ms(self) -> int:
        """Milliseconds of signal consumed by acquisition (reference: initialize.py:481)."""
        return max(self.acq_fine_freq_ms, self.acq_noncoherent_ms) + 1

    def loop_coefficients(self, noise_bw: float, damping: float, gain: float) -> tuple[float, float]:
        """Second-order loop filter coefficients (tau1, tau2).

        Wn = bw*8*zeta/(4*zeta^2+1); tau1 = k/Wn^2; tau2 = 2*zeta/Wn
        (reference: initialize.py:306-328).
        """
        wn = noise_bw * 8.0 * damping / (4.0 * damping**2 + 1.0)
        return gain / (wn * wn), 2.0 * damping / wn

    @property
    def dll_taus(self) -> tuple[float, float]:
        return self.loop_coefficients(self.dll_noise_bandwidth, self.dll_damping_ratio, self.dll_loop_gain)

    @property
    def pll_taus(self) -> tuple[float, float]:
        return self.loop_coefficients(self.pll_noise_bandwidth, self.pll_damping_ratio, self.pll_loop_gain)

    def total_samples_needed(self) -> int:
        """Upper bound on capture samples consumed by a full run."""
        # acquisition reads acquisition_ms; tracking consumes ~1 code period
        # per ms plus the initial code-phase offset (< 1 code period).
        return self.skip_samples + (self.ms_to_process + 2) * self.samples_per_code

    def __post_init__(self):
        if self.correlator_impl not in CORRELATOR_IMPLS:
            raise ValueError(
                f"correlator_impl={self.correlator_impl!r}; valid values are "
                + ", ".join(repr(v) for v in CORRELATOR_IMPLS))

    def with_options(self, **kwargs) -> "ReceiverConfig":
        return dataclasses.replace(self, **kwargs)


def default_config(**kwargs) -> ReceiverConfig:
    """The reference's default workload: fs=38.192 MHz, IF=9.548 MHz, 8 ch."""
    return ReceiverConfig(**kwargs)


def fast_config(**kwargs) -> ReceiverConfig:
    """A small, fast configuration for tests: fs=4.096 MHz, IF=1 MHz.

    samples_per_code = 4096 — everything is ~10x cheaper than the reference
    workload while exercising identical code paths.  fs/chip-rate is
    deliberately *incommensurate* (4.0039 samples/chip) like real front ends,
    so chip boundaries do not land exactly on samples.
    """
    base = dict(
        sampling_freq=4_096_000.0,
        intermediate_freq=1_000_000.0,
        ms_to_process=1000,
        number_of_channels=4,
    )
    base.update(kwargs)
    return ReceiverConfig(**base)
