"""Cold-start acquisition: batched FFT code-phase/Doppler search.

Searches every PRN over a Doppler grid for code phase and carrier frequency
via FFT circular correlation, then refines carrier frequency with a zoom
FFT — the reference's search math (acquisition.py:27-204), batched for an
accelerator:

* the reference loops 32 PRNs x 29 Doppler bins in Python, doing ~3.7k
  single-row FFT/IFFT pairs (reference: acquisition.py:92-133); here the whole
  (PRN-chunk x doppler x code-phase) tensor goes through one batched
  FFT -> multiply -> IFFT -> |.|^2, chunked over PRNs only to bound
  device memory,
* peak/second-peak detection is a vectorized masked argmax over the grid
  (reference: acquisition.py:139-164 builds per-case index ranges; we use the
  equivalent circular-distance exclusion mask),
* the fine-frequency stage (reference: acquisition.py:166-193) runs for all
  PRNs under ``lax.map`` with masked selection — no data-dependent branching.

Documented divergences from the reference:
* the fine-frequency stage is a zoom FFT (coarse-bin mix -> boxcar
  decimation -> small FFT) instead of the reference's 8x-zero-padded
  multi-million-point FFT (acquisition.py:179-191): the giant FFT wastes
  >99% of its spectrum, and the reference's version additionally drops
  a +4-bin offset when mapping its argmax back to Hz (a
  constant ~fs/fftNumPts*4 Hz underestimate).  The zoom search has equal or
  finer resolution (fine_freq_resolution) and starts the PLL on frequency.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.config import ReceiverConfig
from softgnss_tpu.signals.ca import ca_table, gold_codes
from softgnss_tpu.signals.nco import carrier_sin_cos, carrier_step_u32


@dataclass
class AcquisitionResults:
    """Per-PRN acquisition outputs (row i is PRN i+1).

    Mirrors the reference's acqResults recarray (acquisition.py:201-203):
    ``carr_freq == 0`` marks a PRN as not acquired (acquisition.py:44-46).
    """

    carr_freq: np.ndarray   # (32,) f64, Hz; 0 if not acquired
    code_phase: np.ndarray  # (32,) i64, samples
    peak_metric: np.ndarray  # (32,) f64, first/second peak ratio

    @property
    def acquired(self) -> np.ndarray:
        return self.carr_freq > 0


@dataclass
class Channels:
    """Tracking channel assignments (reference preRun, acquisition.py:259-306)."""

    prn: np.ndarray            # (C,) i64; 0 = idle channel
    acquired_freq: np.ndarray  # (C,) f64
    code_phase: np.ndarray     # (C,) i64
    status: list[str]          # 'T' tracking / '-' idle

    def __len__(self):
        return len(self.prn)


def fine_freq_resolution(config: ReceiverConfig) -> float:
    """Frequency resolution (Hz) of the zoom-FFT fine-frequency search."""
    return (config.sampling_freq / config.acq_fine_decimation) / config.acq_fine_fft


def _corr_fft_len(config: ReceiverConfig) -> int:
    """FFT length for the code-phase correlation.

    For non-power-of-two samples_per_code the circular correlation is
    computed as a zero-padded power-of-two LINEAR correlation of length
    >= 2N, folded back circularly in :func:`_prn_block` — numerically the
    same grid the reference's direct N-point transform produces.  The fold
    was forced by an earlier backend; a GPU FFT accepts 38192 points, and
    the fold is kept until the card measures native against folded.
    """
    spc = config.samples_per_code
    if spc & (spc - 1) == 0:
        return spc
    return 1 << int(np.ceil(np.log2(2 * spc)))


def _baseband_ffts(config: ReceiverConfig, long_signal: jnp.ndarray):
    """Doppler-mixed FFTs of the K = ``acq_noncoherent_ms`` acquisition
    milliseconds, stacked (K, B, M), plus the DC-removed fine-frequency
    signal.  PRN-independent."""
    spc = config.samples_per_code
    fs = config.sampling_freq
    fft_n = _corr_fft_len(config)
    k_ms = config.acq_noncoherent_ms
    sig = long_signal.astype(jnp.float32)
    sig_ms = sig[: k_ms * spc].reshape(k_ms, spc)
    sig0dc = sig - jnp.mean(sig)

    # reference mixes with sin/cos separately (acquisition.py:103-117);
    # sin(th) + j*cos(th) = j*exp(-j*th), and the global j drops under |.|^2.
    # Phases come from the exact uint32 carrier NCO + polynomial sine:
    # f32 phase ramps lose precision by the end of a 1 ms block, and the
    # integer NCO keeps every bin's phase exact without f64
    # transcendentals.  The same phase-0 mixer serves every millisecond:
    # each is correlated independently and |.|^2 discards the inter-ms
    # carrier phase.
    freqs = jnp.asarray(config.doppler_bin_freqs, jnp.float64)      # (B,)
    steps = carrier_step_u32(freqs, fs)                              # (B,) i32
    k32 = jnp.arange(spc, dtype=jnp.int32)
    sin_v, cos_v = carrier_sin_cos(jnp.int32(0), steps[:, None], k32[None, :])
    mixer = (cos_v - 1j * sin_v).astype(jnp.complex64)               # e^{-j th}

    xs = jnp.fft.fft(mixer[None, :, :] * sig_ms[:, None, :], fft_n)  # (K, B, M)
    return xs, sig0dc


def _fine_chip_indices(config: ReceiverConfig) -> np.ndarray:
    """Static chip-index gather for the 10-ms code wipe-off.

    Sample n of the slice (which starts at the code-phase-aligned chip-0
    sample) carries chip floor(n*ts/tc).  The reference indexes from n+1
    (acquisition.py:172-177), mislabeling the last sample of every chip —
    ~3% wipe-off loss at its workload, ~25% at 4 samples/chip — another
    documented off-by-one not reproduced."""
    fine_n = config.acq_fine_freq_ms * config.samples_per_code
    ts = 1.0 / config.sampling_freq
    tc = 1.0 / config.code_freq_basis
    chip_idx = np.floor(ts * np.arange(fine_n, dtype=np.float64) / tc)
    return np.mod(chip_idx, 1023).astype(np.int32)


def _prn_block(config: ReceiverConfig, xs, sig0dc, code_fd, gold,
               bin_mask=None):
    """Full acquisition math for a block of PRNs.

    ``xs``: (K, B, M) Doppler-mixed per-ms signal FFTs; ``code_fd``:
    (p, N) conjugated code FFTs; ``gold``: (p, 1023) chips;
    ``bin_mask``: optional (p, B) bool — Doppler bins eligible for the
    peak search (warm-start hints; None = all).  Returns
    (fine_or_zero_carr_freq, code_phase, metric), each (p,).
    PRN-independent inputs (xs, sig0dc) are shared — this same block
    function serves the single-chip chunked path and the mesh-sharded path
    (softgnss_tpu.parallel.acquire).
    """
    spc = config.samples_per_code
    fs = config.sampling_freq
    p = code_fd.shape[0]
    fft_n = _corr_fft_len(config)

    def corr_sq(x):
        c = jnp.fft.ifft(x[None, :, :] * code_fd[:, None, :])        # (p, B, M)
        if fft_n != spc:
            # fold the zero-padded linear correlation back to circular:
            # c_circ[k] = c_lin[k] + c_lin[k - N], negative lags at M - N + k
            c = c[..., :spc] + c[..., fft_n - spc:]
        return jnp.abs(c) ** 2

    if config.acq_noncoherent_ms == 2:
        # reference scheme: per Doppler row, keep whichever millisecond has
        # the stronger peak (bit-transition hedge, acquisition.py:129-133)
        r1 = corr_sq(xs[0])
        r2 = corr_sq(xs[1])
        take1 = r1.max(-1, keepdims=True) > r2.max(-1, keepdims=True)
        results = jnp.where(take1, r1, r2)                           # (p, B, N)
    else:
        # non-coherent accumulation over K ms (beyond the reference):
        # square-law summing is insensitive to nav-bit signs, so no hedge
        # is needed, and the noise floor tightens ~sqrt(K).  The Python
        # loop unrolls under jit, bounding the live (p, B, M) intermediate
        # to one millisecond at a time.
        results = corr_sq(xs[0])
        for k in range(1, config.acq_noncoherent_ms):
            results = results + corr_sq(xs[k])

    # --- peak / second-peak metric (reference: acquisition.py:139-164) ------
    if bin_mask is not None:
        # hinted search: only bins inside each PRN's predicted-Doppler
        # window compete for the peak (and for the second-peak row)
        results = jnp.where(bin_mask[:, :, None], results, 0.0)
    flat = results.reshape(p, -1)
    peak_idx = jnp.argmax(flat, axis=1)
    bin_idx = peak_idx // spc
    code_phase = peak_idx % spc
    peak = jnp.take_along_axis(flat, peak_idx[:, None], 1)[:, 0]

    # exclude one chip around the peak in its Doppler row, circularly, with
    # the reference's exact asymmetric span [cp - spchip, cp + spchip - 1]
    # (acquisition.py:141-152: excludeRange covers spchip samples below the
    # peak but spchip-1 above it)
    spchip = config.samples_per_chip
    pos = jnp.arange(spc)
    delta = (pos[None, :] - code_phase[:, None]) % spc
    keep = (delta >= spchip) & (delta < spc - spchip)
    row = jnp.take_along_axis(results, bin_idx[:, None, None], 1)[:, 0, :]  # (p, N)
    second = jnp.max(jnp.where(keep, row, -jnp.inf), axis=1)
    metric = peak / second

    # --- fine carrier frequency over 10 ms: zoom FFT -----------------------
    # The reference takes an 8x-zero-padded multi-million-point FFT of the
    # code-wiped signal (acquisition.py:166-193), and almost all of that
    # spectrum is discarded.  Equivalent here: mix down by the COARSE bin
    # frequency (exact uint32-NCO carrier), boxcar-decimate, and take a
    # small FFT around DC;
    # fine = coarse + argmax within +/-acq_fine_band_hz.  Resolution is
    # fine_freq_resolution(config) (~9 Hz at the reference workload, at
    # least as fine as the reference's fs/fft_pts).
    fine_n = config.acq_fine_freq_ms * spc
    decim = config.acq_fine_decimation
    nfft = config.acq_fine_fft
    n_dec = -(-fine_n // decim)                                # ceil
    pad = n_dec * decim - fine_n
    chip_idx = jnp.asarray(_fine_chip_indices(config))
    fs_dec = fs / decim
    freqs_fft = np.fft.fftfreq(nfft, 1.0 / fs_dec)
    band_mask = jnp.asarray(np.abs(freqs_fft) <= config.acq_fine_band_hz)
    freqs_fft = jnp.asarray(freqs_fft)
    coarse = jnp.take(jnp.asarray(config.doppler_bin_freqs, jnp.float64), bin_idx)

    def fine_one(args):
        cp, code, f_coarse = args
        long_code = code[chip_idx]
        x = jax.lax.dynamic_slice(sig0dc, (cp,), (fine_n,)) * long_code
        w = carrier_step_u32(f_coarse, fs)
        sin_v, cos_v = carrier_sin_cos(jnp.int32(0), w,
                                       jnp.arange(fine_n, dtype=jnp.int32))
        # decimate I and Q as real arrays; go complex only on the short
        # decimated series
        dec_i = jnp.pad(x * cos_v, (0, pad)).reshape(n_dec, decim).sum(axis=1)
        dec_q = jnp.pad(x * sin_v, (0, pad)).reshape(n_dec, decim).sum(axis=1)
        dec = (dec_i - 1j * dec_q).astype(jnp.complex64)
        mag = jnp.abs(jnp.fft.fft(dec, nfft))
        k = jnp.argmax(jnp.where(band_mask, mag, -jnp.inf))
        return f_coarse + freqs_fft[k]

    fine_freq = jax.lax.map(fine_one, (code_phase, gold, coarse))

    carr_freq = jnp.where(metric > config.acq_threshold, fine_freq, 0.0)
    return carr_freq, code_phase.astype(jnp.int64), metric.astype(jnp.float64)


@partial(jax.jit, static_argnums=(0,))
def _acquire_device(config: ReceiverConfig, long_signal: jnp.ndarray,
                    bin_mask=None):
    prn_list = np.asarray(config.acq_satellite_list, np.int64)
    xs, sig0dc = _baseband_ffts(config, long_signal)

    fft_n = _corr_fft_len(config)
    codes = jnp.asarray(ca_table(config)[prn_list - 1])              # (P, N)
    code_fd = jnp.conj(jnp.fft.fft(codes.astype(jnp.complex64), fft_n))  # (P, M)
    gold = jnp.asarray(gold_codes()[prn_list - 1], jnp.float32)      # (P, 1023)

    # chunk over PRNs: the (chunk, B, M) grid bounds device-memory footprint
    chunk = min(config.acq_prn_chunk, len(prn_list))
    n_prn = len(prn_list)
    pad = (-n_prn) % chunk
    code_fd = jnp.pad(code_fd, ((0, pad), (0, 0))).reshape(-1, chunk, fft_n)
    gold = jnp.pad(gold, ((0, pad), (0, 0))).reshape(-1, chunk, 1023)

    if bin_mask is None:
        outs = jax.lax.map(
            lambda args: _prn_block(config, xs, sig0dc, args[0], args[1]),
            (code_fd, gold))
    else:
        n_bins = bin_mask.shape[1]
        mask_c = jnp.pad(bin_mask, ((0, pad), (0, 0)),
                         constant_values=True).reshape(-1, chunk, n_bins)
        outs = jax.lax.map(
            lambda args: _prn_block(config, xs, sig0dc, args[0], args[1],
                                    args[2]),
            (code_fd, gold, mask_c))
    carr_freq, code_phase, metric = (o.reshape(-1)[:n_prn] for o in outs)
    return carr_freq, code_phase, metric


def hint_bin_mask(config: ReceiverConfig, doppler_hints,
                  hint_halfwidth_hz: float) -> np.ndarray | None:
    """(P, B) bool Doppler-bin mask from per-PRN carrier-frequency hints,
    or None when every PRN searches the full band.  Shared by the
    single-device and the PRN-sharded acquisition paths."""
    if doppler_hints is None:
        return None
    hints = np.asarray(doppler_hints, np.float64)
    bins = np.asarray(config.doppler_bin_freqs)                  # (B,)
    sel = hints[np.asarray(config.acq_satellite_list) - 1]       # (P,)
    dist = np.abs(bins[None, :] - sel[:, None])
    inside = dist <= hint_halfwidth_hz
    # no hint, or a hint whose window misses the search band entirely
    # -> fall back to the full band for that PRN; an all-full mask is
    # dropped so the unhinted (already-compiled) device variant runs
    full = np.isnan(sel) | ~inside.any(axis=1)
    if full.all():
        return None
    return np.where(full[:, None], True, inside)


def acquire(config: ReceiverConfig, long_signal: np.ndarray,
            doppler_hints: np.ndarray | None = None,
            hint_halfwidth_hz: float = 500.0) -> AcquisitionResults:
    """Run acquisition on >= acquisition_ms milliseconds of raw IF samples.

    ``doppler_hints``: optional (32,) per-PRN predicted absolute carrier
    frequencies (IF + Doppler — nav.assist.predict_doppler from a prior
    ephemeris set), NaN = no hint.  Hinted PRNs search only Doppler bins
    within ``hint_halfwidth_hz`` of the prediction (warm start, beyond
    the reference): wrong-bin noise cannot steal the peak, and a strong
    cross-correlator outside the window cannot alias in.  Note the hint
    must absorb any front-end oscillator offset — a common bias shifts
    every PRN's measured Doppler equally.
    """
    need = config.acquisition_ms * config.samples_per_code
    if long_signal.shape[0] < need:
        raise ValueError(f"acquisition needs {need} samples, got {long_signal.shape[0]}")
    bin_mask = hint_bin_mask(config, doppler_hints, hint_halfwidth_hz)
    if bin_mask is not None:
        bin_mask = jnp.asarray(bin_mask)
    carr, phase, metric = _acquire_device(config, jnp.asarray(long_signal[:need]),
                                          bin_mask)
    out = tuple(np.asarray(jax.device_get(v)) for v in (carr, phase, metric))

    # scatter back into 32-wide arrays indexed by PRN
    n = 32
    carr_freq = np.zeros(n)
    code_phase = np.zeros(n, np.int64)
    peak_metric = np.zeros(n)
    for i, prn in enumerate(config.acq_satellite_list):
        carr_freq[prn - 1] = out[0][i]
        code_phase[prn - 1] = out[1][i]
        peak_metric[prn - 1] = out[2][i]
    return AcquisitionResults(carr_freq, code_phase, peak_metric)


def assign_channels(config: ReceiverConfig, acq: AcquisitionResults) -> Channels:
    """Allocate the strongest acquired PRNs to tracking channels.

    Sorts by peak metric descending and fills up to number_of_channels
    (reference: acquisition.py:276-305).
    """
    c = config.number_of_channels
    prn = np.zeros(c, np.int64)
    freq = np.zeros(c)
    phase = np.zeros(c, np.int64)
    status = ["-"] * c

    order = np.argsort(-acq.peak_metric, kind="stable")
    n_active = min(c, int(acq.acquired.sum()))
    for i in range(n_active):
        p = order[i]
        prn[i] = p + 1
        freq[i] = acq.carr_freq[p]
        phase[i] = acq.code_phase[p]
        status[i] = "T"
    return Channels(prn, freq, phase, status)


def format_channel_status(config: ReceiverConfig, channels: Channels) -> str:
    """ASCII channel table (reference: acquisition.py:308-336)."""
    bar = "*=========*=====*===============*===========*=============*========*"
    lines = [bar,
             "| Channel | PRN |   Frequency   |  Doppler  | Code Offset | Status |",
             bar]
    for i in range(len(channels)):
        if channels.status[i] != "-":
            lines.append("|      %2d | %3d |  %2.5e |   %5.0f   |    %6d   |     %1s  |" % (
                i, channels.prn[i], channels.acquired_freq[i],
                channels.acquired_freq[i] - config.intermediate_freq,
                channels.code_phase[i], channels.status[i]))
        else:
            lines.append("|      %2d | --- |  ------------ |   -----   |    ------   |   Off  |" % i)
    lines.append(bar)
    return "\n".join(lines)
