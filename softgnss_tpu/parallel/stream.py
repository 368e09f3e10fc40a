"""Software-pipelined (stage-overlapped) tracking over sequential time chunks.

The monolithic tracker runs upload -> compute -> readback as strict
barriers: the whole capture is uploaded to device memory before the scan
starts and every per-ms output series is fetched after it ends (the
reference's orchestrator, initialize.py:476-515, is the same strictly
staged shape, one channel at a time).  This module overlaps the three
stages across time CHUNKS of the capture, using JAX's asynchronous
dispatch — the pipeline-parallel (PP) row of the SURVEY §2 parallelism
table:

    host:     upload k+1   |  readback k-1 + assemble (NumPy)
    device:             compute chunk k

The loop-filter carry serializes the *compute* of consecutive chunks
(the same recurrence that makes time sharding approximate, see
parallel/track.py), so compute itself stays sequential — but chunk
k+1's capture slice rides the host->device DMA while chunk k computes,
and chunk k-1's outputs transfer back and convert to NumPy in the same
shadow.  The capture upload is 1.4 GB at the reference workload; how
much of it the overlap hides on a GPU host has not been measured.  With
a memory-mapped capture (what ``io.read_if_samples`` returns for int8
files) disk reads stream through the same window and the receiver never
holds the full capture in host RAM.

Chunk boundaries ride the resume machinery (TrackState carry +
absolute-ms block anchoring, scan._scan_ms): chunk starts are rounded
to multiples of ``track_block_ms``, so every chunk rebuilds the SAME
static frames as the uninterrupted run.  Integer observables
(absolute_sample, sample_frac — everything pseudoranges consume) are
bit-identical to the monolithic tracker; f64 loop-filter streams can
differ by ~1 ulp across the per-chunk-length compiles, exactly as for
track_time_exact (tests/test_stream.py pins both).

The per-chunk sample window is *deterministic* (a Doppler-rate bound
around the nominal ms grid, not the data-dependent pointers), so chunk
k+1 can be sliced and uploaded before chunk k has computed — no host
sync in the steady state.  A post-hoc check verifies every fetched
pointer stayed inside its chunk's window and raises otherwise.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.config import ReceiverConfig
from softgnss_tpu.track.scan import (
    MsOutputs,
    TrackResults,
    TrackState,
    _check_overflow,
    _track_device,
    initial_state,
)
from softgnss_tpu.track.tables import build_tables

#: relative code-rate envelope of the chunk window bound: true per-ms
#: pointer advance deviates from the nominal samples_per_code grid by the
#: code Doppler (< 4e-6 of the chip rate for |Doppler| < 6 kHz on L1)
#: plus DLL transients; 1e-4 (~100 Hz of code-rate error) is ~25x the
#: physical envelope
_DRIFT_REL = 1e-4


def _chunk_span(config: ReceiverConfig, m0: int, m1: int) -> tuple[int, int]:
    """Unclamped [base, end) capture-sample window guaranteed to contain
    every frame of tracked milliseconds [m0, m1): nominal grid +- the
    drift envelope, +- the initial code phase (< 1 period) and the static
    frame slack."""
    spc = config.samples_per_code
    guard = 2 * spc + config.track_window
    base = config.skip_samples + math.floor(m0 * spc * (1 - _DRIFT_REL)) - guard
    end = (config.skip_samples + math.ceil((m1 + 2) * spc * (1 + _DRIFT_REL))
           + guard)
    return base, end


def track_streamed(config: ReceiverConfig, signal: np.ndarray,
                   channels: Channels, n_ms: int | None = None,
                   chunk_ms: int | None = None,
                   state: TrackState | None = None,
                   mesh=None) -> TrackResults:
    """Track ``n_ms`` milliseconds in pipelined ``chunk_ms`` time chunks.

    Drop-in for :func:`softgnss_tpu.track.track` (same signature plus
    ``chunk_ms``); ``signal`` may be any int8 array-like including an
    ``np.memmap`` — each chunk is materialized host-side only when its
    upload is issued.

    ``mesh``: optional — per-chunk tracking runs CHANNEL-SHARDED over the
    mesh (softgnss_tpu.parallel.track_channels_sharded) while the chunked
    upload pipeline stays: multi-device runs no longer re-inherit the
    whole-capture upload barrier.  Integer observables are bit-identical
    to the unstreamed sharded tracker (tests/test_stream.py).
    """
    from softgnss_tpu.track.scan import track

    n_ms = int(config.ms_to_process if n_ms is None else n_ms)
    B = max(1, config.track_block_ms)
    if chunk_ms is None:
        chunk_ms = config.track_stream_chunk_ms
    if n_ms <= 0 or chunk_ms <= 0 or chunk_ms >= n_ms:
        # nothing to pipeline (0 = monolithic per the config docstring;
        # a single chunk would only add the window-margin re-slicing)
        if mesh is not None:
            from softgnss_tpu.parallel.track import track_channels_sharded

            return track_channels_sharded(config, np.asarray(signal),
                                          channels, mesh, n_ms=n_ms,
                                          state=state)
        return track(config, signal, channels, n_ms=n_ms, state=state)
    chunk_ms = max(B, int(chunk_ms) // B * B)        # chunk starts on the block grid
    spc = config.samples_per_code
    sig_len = signal.shape[0]
    start = (config.skip_samples if state is None
             else int(np.max(np.asarray(state.ptr))))
    needed = start + (n_ms + 2) * spc
    if sig_len < needed:
        raise ValueError(
            f"capture too short for tracking: need >= {needed} samples, "
            f"got {sig_len}")

    n_channels = len(channels)
    if mesh is not None:
        # pad the channel set to the mesh axis and graft any resumed state
        # exactly as track_channels_sharded does
        from softgnss_tpu.parallel.track import _pad_channels

        channels_run = _pad_channels(config, channels,
                                     mesh.shape[config.channel_axis])
    else:
        channels_run = channels
    tables = build_tables(config, np.asarray(channels_run.prn),
                          np.asarray(channels_run.acquired_freq))
    active = np.asarray([s == "T" for s in channels_run.status])
    if state is None:
        state = initial_state(config, channels_run)
        start_ms = 0
    else:
        start_ms = int(np.max(np.asarray(state.ms)))
        if mesh is not None and len(np.asarray(state.ptr)) != len(channels_run):
            pad_state = initial_state(config, channels_run)
            state = jax.tree.map(
                lambda pad_leaf, live: jnp.asarray(np.concatenate(
                    [np.asarray(live), np.asarray(pad_leaf)[n_channels:]])),
                pad_state, jax.tree.map(np.asarray, state))
    if start_ms % B:
        raise ValueError(
            f"track_streamed resumes only on the {B}-ms block grid, "
            f"got start_ms={start_ms}")

    # chunk k tracks ms [start_ms + k*chunk_ms, ...); uniform lengths keep
    # one compiled executable for all interior chunks
    bounds = list(range(0, n_ms, chunk_ms)) + [n_ms]
    spans = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]

    tables_dev = jax.tree.map(jnp.asarray, tables)
    carr_dev = jnp.asarray(channels_run.acquired_freq, jnp.float64)
    active_dev = jnp.asarray(active)

    # ONE window length for every chunk (the drift envelope widens the
    # needed span slightly with absolute time; per-chunk exact lengths
    # would give every chunk a distinct signal shape and its own compile).
    # The tail beyond a chunk's needed span is never consumed.
    L = min(sig_len,
            max(b - a for a, b in
                (_chunk_span(config, start_ms + m0, start_ms + m1)
                 for m0, m1 in spans)))

    from softgnss_tpu.track.scan import host_pack_signal

    def upload(k):
        m0, m1 = spans[k]
        base, _ = _chunk_span(config, start_ms + m0, start_ms + m1)
        # pack-aligned base: the chunk is shipped as its int16/int32 host
        # view (host_pack_signal) so in-jit packing never runs
        base = max(0, min(base, sig_len - L)) // 4 * 4
        end = base + L
        chunk = np.ascontiguousarray(signal[base:end])
        return base, end, jnp.asarray(host_pack_signal(config, chunk))

    st = state
    prev_base = 0                                    # current state's rebase
    inflight: list[tuple] = []                       # (span, base, end, ys, ovf)
    fetched: list[MsOutputs] = []

    def drain_one():
        (m0, m1), base, end, ys_d, ovf_d = inflight.pop(0)
        ys = MsOutputs(*[np.asarray(leaf) for leaf in jax.device_get(ys_d)])
        _check_overflow(np.max(jax.device_get(ovf_d)))
        ys = ys._replace(absolute_sample=np.where(
            ys.absolute_sample != 0, ys.absolute_sample + base, 0))
        # post-hoc window validation: every active pointer's frame stayed
        # inside [base, end) (the scan clamps out-of-window slices, which
        # would silently corrupt frames — catch it loudly instead)
        a = ys.absolute_sample[ys.absolute_sample != 0]
        if a.size:
            # frame/buffer envelope around the pointer stream: a block's
            # buffer spans [ptr_blockstart - pre, ptr_blockstart - pre +
            # (B+1)*spc) and ptr advances ~spc/ms, so the outermost
            # touched samples sit within ~2 periods of the pointers
            # a bound only binds where the chunk window is interior: at
            # the capture edges (base == 0 / end == sig_len) the scan's
            # buffer clamp is the monolithic tracker's own behavior
            lo = int(a.min()) - 2 * spc - config.track_frame_pre
            hi = int(a.max()) + 2 * spc
            if (lo < base and base > 0) or (hi > end and end < sig_len):
                raise RuntimeError(
                    "streamed-tracking chunk window violated: pointers "
                    f"[{a.min()}, {a.max()}] vs window [{base}, {end}) — "
                    "code-rate drift exceeded the _DRIFT_REL envelope")
        fetched.append(ys)

    next_up = upload(0)
    for k, (m0, m1) in enumerate(spans):
        base, end, sig_dev = next_up
        # rebase the carried state into this chunk's window (device-side
        # integer ops on async values — no host sync)
        delta = base - prev_base
        if delta:
            st = st._replace(ptr=st.ptr - delta,
                             block_base=st.block_base - delta)
        prev_base = base
        # chunk starts sit on the block grid, so only start_ms % B (== 0)
        # matters to the scan — pass the phase, not the raw value, to keep
        # ONE compiled executable across all interior chunks
        if mesh is not None:
            from softgnss_tpu.parallel.track import _track_channels_sharded

            final, ys_d, ovf_d = _track_channels_sharded(
                config, mesh, m1 - m0, (start_ms + m0) % B,
                sig_dev, tables_dev, carr_dev, active_dev, st)
        else:
            final, ys_d, ovf_d = _track_device(
                config, sig_dev, tables_dev, carr_dev, active_dev,
                m1 - m0, st, (start_ms + m0) % B)
        inflight.append(((m0, m1), base, end, ys_d, ovf_d))
        st = final
        if k + 1 < len(spans):
            next_up = upload(k + 1)                  # overlaps chunk k compute
        if len(inflight) > 1:
            drain_one()                              # chunk k-1, also overlapped
    while inflight:
        drain_one()

    from softgnss_tpu.parallel.track import _results_from_ys

    ys = jax.tree.map(lambda *xs: np.concatenate(xs), *fetched)
    final_state = jax.tree.map(np.asarray, jax.device_get(st))
    final_state = final_state._replace(
        ptr=final_state.ptr + prev_base,
        block_base=final_state.block_base + prev_base)
    res = _results_from_ys(channels_run, ys, n_channels)
    res.final_state = jax.tree.map(lambda x: x[:n_channels], final_state)
    return res
