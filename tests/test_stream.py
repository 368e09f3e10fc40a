"""Software-pipelined (stage-overlapped) tracking: parity vs monolithic.

The streamed tracker (softgnss_tpu.parallel.stream) must reproduce the
monolithic run: integer observables bit-exact (chunk boundaries ride the
block-anchored resume machinery), float streams to the ~1 ulp per-chunk-
compile budget established for track_time_exact.
"""

import numpy as np
import pytest

from softgnss_tpu import fast_config
from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.parallel import track_streamed
from softgnss_tpu.pipeline import run_receiver
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track import track

N_MS = 400


@pytest.fixture(scope="module")
def cfg():
    return fast_config(number_of_channels=3)


@pytest.fixture(scope="module")
def capture(cfg):
    nav_bits = tuple((-1) ** (i // 3) for i in range(40))
    sats = [
        SatelliteSignal(prn=4, doppler_hz=900.0, delay_samples=700.0,
                        phase0=0.3, nav_bits=nav_bits),
        SatelliteSignal(prn=17, doppler_hz=-2100.0, delay_samples=2500.0,
                        phase0=4.0, nav_bits=nav_bits),
    ]
    signal = synthesize_signal(cfg, sats, N_MS + 3, noise_std=1.0, seed=5)
    channels = Channels(
        prn=np.array([4, 17, 0], np.int64),
        acquired_freq=np.array([cfg.intermediate_freq + 900.0,
                                cfg.intermediate_freq - 2100.0, 0.0]),
        code_phase=np.array([700, 2500, 0], np.int64),
        status=["T", "T", "-"],
    )
    return sats, signal, channels


def _assert_matches(st, ref):
    np.testing.assert_array_equal(st.absolute_sample, ref.absolute_sample)
    # the f64 loop filters can differ by ~1 ulp across the per-chunk-length
    # compiles (same budget as track_time_exact); that perturbs the Q40
    # step quantization and with it sample_frac's low digits only
    np.testing.assert_allclose(st.sample_frac, ref.sample_frac, atol=1e-6)
    np.testing.assert_array_equal(np.sign(st.i_p), np.sign(ref.i_p))
    for name in ("code_freq", "carr_freq", "i_p", "q_p", "i_e", "q_e",
                 "i_l", "q_l", "dll_discr_filt", "pll_discr_filt"):
        np.testing.assert_allclose(getattr(st, name), getattr(ref, name),
                                   rtol=1e-5, atol=0.1, err_msg=name)
    np.testing.assert_array_equal(np.asarray(st.final_state.ptr),
                                  np.asarray(ref.final_state.ptr))
    # Q40 remainder phase absorbs the f64 step quantization: ~1 ulp of
    # code_freq -> ~1e-6 chips (2^20 Q40 counts) over a chunk
    drem = np.abs(np.asarray(st.final_state.code_rem_q)
                  - np.asarray(ref.final_state.code_rem_q))
    assert drem.max() < (1 << 21), drem


class TestStreamedTracking:
    def test_matches_monolithic(self, cfg, capture):
        _, signal, channels = capture
        ref = track(cfg, signal, channels, n_ms=N_MS)
        st = track_streamed(cfg, signal, channels, n_ms=N_MS, chunk_ms=128)
        _assert_matches(st, ref)

    def test_partial_tail_chunk_and_memmap(self, cfg, capture, tmp_path):
        """n_ms not a chunk multiple; capture consumed via np.memmap."""
        _, signal, channels = capture
        path = tmp_path / "cap.bin"
        np.asarray(signal, np.int8).tofile(path)
        mm = np.memmap(path, np.int8, "r")
        ref = track(cfg, signal, channels, n_ms=300)
        st = track_streamed(cfg, mm, channels, n_ms=300, chunk_ms=128)
        _assert_matches(st, ref)

    def test_single_chunk_covers_all(self, cfg, capture):
        _, signal, channels = capture
        ref = track(cfg, signal, channels, n_ms=150)
        st = track_streamed(cfg, signal, channels, n_ms=150, chunk_ms=4096)
        _assert_matches(st, ref)

    def test_too_short_capture_raises(self, cfg, capture):
        _, signal, channels = capture
        with pytest.raises(ValueError, match="capture too short"):
            track_streamed(cfg, signal[: 50 * cfg.samples_per_code], channels,
                           n_ms=N_MS, chunk_ms=128)


class TestStreamedPipeline:
    def test_run_receiver_stream(self, cfg, capture):
        _, signal, channels = capture
        ref = run_receiver(cfg, signal=signal, n_ms=N_MS, navigate=False)
        st = run_receiver(cfg, signal=signal, n_ms=N_MS, navigate=False,
                          stream=True)
        np.testing.assert_array_equal(st.tracking.absolute_sample,
                                      ref.tracking.absolute_sample)
        np.testing.assert_allclose(st.tracking.i_p, ref.tracking.i_p,
                                   rtol=1e-5, atol=0.01)

    def test_stream_excludes_time_sharding(self, cfg, capture):
        """stream composes with shard='channel' only: time sharding
        partitions the capture itself."""
        import jax
        from jax.sharding import Mesh

        _, signal, channels = capture
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    (cfg.time_axis, cfg.channel_axis))
        with pytest.raises(ValueError, match="shard='channel'"):
            run_receiver(cfg, signal=signal, n_ms=N_MS, navigate=False,
                         mesh=mesh, shard="time", stream=True)


class TestStreamedOnMesh:
    """stream x mesh composition: per-chunk
    uploads with channel-sharded tracking must match the unstreamed
    sharded tracker (and thus the monolithic one)."""

    def test_mesh_streamed_matches_sharded(self, cfg, capture):
        import jax

        from softgnss_tpu.parallel import make_mesh, track_channels_sharded

        assert jax.device_count() >= 4
        sats, signal, channels = capture
        mesh = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 4})
        ref = track_channels_sharded(cfg, signal, channels, mesh, n_ms=N_MS)
        st = track_streamed(cfg, signal, channels, n_ms=N_MS, chunk_ms=128,
                            mesh=mesh)
        _assert_matches(st, ref)

    def test_pipeline_stream_with_mesh(self, cfg, capture):
        import jax

        from softgnss_tpu.parallel import make_mesh

        sats, signal, channels = capture
        mesh = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 4})
        res = run_receiver(cfg, signal=signal, n_ms=N_MS, navigate=False,
                           mesh=mesh, shard="channel", stream=True)
        ref = run_receiver(cfg, signal=signal, n_ms=N_MS, navigate=False)
        np.testing.assert_array_equal(res.tracking.absolute_sample,
                                      ref.tracking.absolute_sample)
