"""Multi-device sharding tests on the 8-virtual-CPU-device mesh.

conftest.py sets xla_force_host_platform_device_count=8, the standard
stand-in for a multi-GPU host; the same code paths drive real meshes.
"""

import jax
import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.acquire import acquire, assign_channels
from softgnss_tpu.parallel import (
    acquire_sharded,
    make_mesh,
    receiver_mesh,
    track_channels_sharded,
    track_time_sharded,
)
from softgnss_tpu.parallel.track import propagate_state
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track import track

N_MS = 600


@pytest.fixture(scope="module")
def cfg():
    return sg.fast_config(number_of_channels=4, time_shard_warmup_ms=150)


@pytest.fixture(scope="module")
def capture(cfg):
    nav_bits = tuple(np.random.default_rng(1).choice([-1, 1], size=64))
    sats = [
        SatelliteSignal(prn=4, doppler_hz=1800.0, delay_samples=700.0,
                        phase0=0.5, nav_bits=nav_bits),
        SatelliteSignal(prn=11, doppler_hz=-1200.0, delay_samples=2222.0,
                        phase0=1.5, nav_bits=nav_bits),
        SatelliteSignal(prn=19, doppler_hz=3100.0, delay_samples=3555.0,
                        phase0=2.5, nav_bits=nav_bits),
    ]
    signal = synthesize_signal(cfg, sats, N_MS + 13, noise_std=1.0, seed=8)
    res = acquire(cfg, signal)
    channels = assign_channels(cfg, res)
    return sats, signal, channels


def test_device_count():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"


@pytest.mark.parametrize("shape", [(1, 4), (4, 1), (2, 4)])
def test_make_mesh_plain_device_order(cfg, shape):
    """The cards of one host are joined all to all: the mesh takes the
    devices in plain order, shaped (time, channel)."""
    mesh = make_mesh({cfg.time_axis: shape[0], cfg.channel_axis: shape[1]})
    assert mesh.axis_names == (cfg.time_axis, cfg.channel_axis)
    assert mesh.devices.shape == shape
    n = shape[0] * shape[1]
    assert list(mesh.devices.flat) == jax.devices()[:n]


class TestShardedAcquisition:
    def test_matches_unsharded(self, cfg, capture):
        sats, signal, _ = capture
        mesh = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 8})
        res_ref = acquire(cfg, signal)
        res_sh = acquire_sharded(cfg, signal, mesh)
        np.testing.assert_array_equal(res_sh.code_phase, res_ref.code_phase)
        np.testing.assert_allclose(res_sh.peak_metric, res_ref.peak_metric, rtol=1e-5)
        np.testing.assert_allclose(res_sh.carr_freq, res_ref.carr_freq, rtol=1e-9)

    def test_hinted_matches_unsharded(self, cfg, capture):
        """Doppler-hinted (assisted) acquisition on the mesh == off-mesh:
        the (PRN, bin) hint mask shards with the PRN axis."""
        sats, signal, _ = capture
        mesh = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 8})
        hints = np.full(32, np.nan)
        for s in sats:
            hints[s.prn - 1] = cfg.intermediate_freq + s.doppler_hz + 90.0
        res_ref = acquire(cfg, signal, doppler_hints=hints)
        res_sh = acquire_sharded(cfg, signal, mesh, doppler_hints=hints)
        np.testing.assert_array_equal(res_sh.code_phase, res_ref.code_phase)
        np.testing.assert_allclose(res_sh.peak_metric, res_ref.peak_metric,
                                   rtol=1e-5)
        np.testing.assert_allclose(res_sh.carr_freq, res_ref.carr_freq,
                                   rtol=1e-9)
        # the hint actually constrained the search: every injected PRN's
        # coarse peak sits inside the hint window
        for s in sats:
            assert abs(res_sh.carr_freq[s.prn - 1]
                       - hints[s.prn - 1]) < 600.0

    def test_uneven_prn_padding(self, cfg, capture):
        """PRN count not divisible by shard count still works."""
        sats, signal, _ = capture
        cfg5 = cfg.with_options(acq_satellite_list=tuple(range(1, 23)))  # 22 PRNs
        mesh = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 8})
        res_ref = acquire(cfg5, signal)
        res_sh = acquire_sharded(cfg5, signal, mesh)
        np.testing.assert_array_equal(res_sh.code_phase, res_ref.code_phase)
        np.testing.assert_allclose(res_sh.peak_metric, res_ref.peak_metric, rtol=1e-5)


class TestChannelShardedTracking:
    def test_matches_unsharded_exactly(self, cfg, capture):
        _, signal, channels = capture
        mesh = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 4})
        ref = track(cfg, signal, channels, n_ms=N_MS)
        sh = track_channels_sharded(cfg, signal, channels, mesh, n_ms=N_MS)
        # integer NCOs + per-channel-local reductions: bit-identical
        np.testing.assert_array_equal(sh.absolute_sample, ref.absolute_sample)
        np.testing.assert_array_equal(sh.i_p, ref.i_p)
        np.testing.assert_array_equal(sh.carr_freq, ref.carr_freq)
        assert sh.status == ref.status
        # final loop state survives sharding (mesh checkpoints stay resumable)
        assert sh.final_state is not None
        np.testing.assert_array_equal(np.asarray(sh.final_state.ptr),
                                      np.asarray(ref.final_state.ptr))

    def test_channel_padding(self, cfg, capture):
        """3 active channels over 8 shards (pad to 8)."""
        _, signal, channels = capture
        mesh = make_mesh({cfg.time_axis: 1, cfg.channel_axis: 8})
        ref = track(cfg, signal, channels, n_ms=200)
        sh = track_channels_sharded(cfg, signal, channels, mesh, n_ms=200)
        np.testing.assert_array_equal(sh.i_p, ref.i_p)
        assert sh.i_p.shape[0] == len(channels)


class TestTimeShardedTracking:
    def test_stitched_outputs_track_sequential(self, cfg, capture):
        _, signal, channels = capture
        mesh = receiver_mesh(cfg, n_time=2, n_channel=4)
        ref = track(cfg, signal, channels, n_ms=N_MS)
        sh = track_time_sharded(cfg, signal, channels, mesh, n_ms=N_MS)
        assert sh.i_p.shape == ref.i_p.shape

        active = [c for c in range(len(channels)) if channels.status[c] == "T"]
        assert sh.final_state is not None
        assert np.max(np.abs(np.asarray(sh.final_state.ptr)[active]
                             - np.asarray(ref.final_state.ptr)[active])) <= 1
        for c in active:
            # period numbering identical: sample counters within 1 sample
            assert np.max(np.abs(sh.absolute_sample[c] - ref.absolute_sample[c])) <= 1
            # nav-bit stream identical where both are locked
            agree = np.mean(np.sign(sh.i_p[c, 50:]) == np.sign(ref.i_p[c, 50:]))
            assert agree > 0.99, f"channel {c}: sign agreement {agree}"
            # carrier frequency trajectory re-locks to the same solution
            err = np.abs(sh.carr_freq[c, 50:] - ref.carr_freq[c, 50:])
            assert np.median(err) < 2.0
            # correlator power preserved (no lock loss at the boundary)
            p_sh = np.abs(sh.i_p[c, 50:]).mean()
            p_ref = np.abs(ref.i_p[c, 50:]).mean()
            assert p_sh > 0.9 * p_ref

    def test_four_way_time_split(self, cfg, capture):
        _, signal, channels = capture
        cfg4 = cfg.with_options(time_shard_warmup_ms=100)
        mesh = receiver_mesh(cfg4, n_time=4, n_channel=2)
        ref = track(cfg4, signal, channels, n_ms=N_MS)
        sh = track_time_sharded(cfg4, signal, channels, mesh, n_ms=N_MS)
        for c in range(3):
            assert np.max(np.abs(sh.absolute_sample[c] - ref.absolute_sample[c])) <= 1
            agree = np.mean(np.sign(sh.i_p[c, 50:]) == np.sign(ref.i_p[c, 50:]))
            assert agree > 0.985

    def test_rejects_indivisible(self, cfg, capture):
        _, signal, channels = capture
        mesh = receiver_mesh(cfg, n_time=2, n_channel=4)
        with pytest.raises(ValueError, match="divisible"):
            track_time_sharded(cfg, signal, channels, mesh, n_ms=333)


class TestTimeExactTracking:
    def test_exact_vs_sequential(self, cfg, capture):
        """The sequential-carry handoff mode (SURVEY §5.7) is the exact
        anchor: integer-NCO observables (everything pseudoranges consume)
        and nav-bit signs are bit-identical to the single-device tracker;
        f64 loop-filter streams agree to ~1 ulp (each block length is a
        separate XLA compilation with its own fusion choices)."""
        from softgnss_tpu.parallel import track_time_exact

        _, signal, channels = capture
        mesh = receiver_mesh(cfg, n_time=4, n_channel=2)
        ref = track(cfg, signal, channels, n_ms=N_MS)
        ex = track_time_exact(cfg, signal, channels, mesh, n_ms=N_MS)
        for name in ("absolute_sample", "sample_frac"):
            np.testing.assert_array_equal(getattr(ex, name), getattr(ref, name),
                                          err_msg=name)
        np.testing.assert_array_equal(np.sign(ex.i_p), np.sign(ref.i_p))
        for name in ("code_freq", "carr_freq", "i_p", "q_p", "i_e", "q_e",
                     "i_l", "q_l", "dll_discr_filt", "pll_discr_filt"):
            np.testing.assert_allclose(getattr(ex, name), getattr(ref, name),
                                       rtol=1e-5, atol=0.01, err_msg=name)
        np.testing.assert_array_equal(np.asarray(ex.final_state.ptr),
                                      np.asarray(ref.final_state.ptr))
        np.testing.assert_array_equal(np.asarray(ex.final_state.code_rem_q),
                                      np.asarray(ref.final_state.code_rem_q))

    def test_rejects_indivisible(self, cfg, capture):
        from softgnss_tpu.parallel import track_time_exact

        _, signal, channels = capture
        mesh = receiver_mesh(cfg, n_time=4, n_channel=2)
        with pytest.raises(ValueError, match="divisible"):
            track_time_exact(cfg, signal, channels, mesh, n_ms=333)


class TestShardedPipeline:
    def test_run_receiver_with_mesh(self, cfg, capture):
        """mesh= distributes acquisition (PRN axis) and tracking (channel
        or time axis) through the public pipeline."""
        from softgnss_tpu.pipeline import run_receiver

        _, signal, _ = capture
        mesh = receiver_mesh(cfg, n_time=2, n_channel=4)
        base = run_receiver(cfg, signal=signal, n_ms=300, navigate=False)
        ch_sh = run_receiver(cfg, signal=signal, n_ms=300, navigate=False,
                             mesh=mesh, shard="channel")
        np.testing.assert_array_equal(ch_sh.tracking.i_p, base.tracking.i_p)
        np.testing.assert_array_equal(ch_sh.acquisition.code_phase,
                                      base.acquisition.code_phase)
        t_sh = run_receiver(cfg, signal=signal, n_ms=300, navigate=False,
                            mesh=mesh, shard="time")
        assert t_sh.tracking.i_p.shape == base.tracking.i_p.shape
        ex_sh = run_receiver(cfg, signal=signal, n_ms=300, navigate=False,
                             mesh=mesh, shard="time-exact")
        np.testing.assert_array_equal(ex_sh.tracking.i_p, base.tracking.i_p)
        with pytest.raises(ValueError, match="shard"):
            run_receiver(cfg, signal=signal, n_ms=300, navigate=False,
                         mesh=mesh, shard="bogus")


class TestPropagatedState:
    def test_propagated_code_phase_near_truth(self, cfg, capture):
        """The analytic code-phase propagation lands within a chip of the
        sequentially tracked boundary."""
        _, signal, channels = capture
        ref = track(cfg, signal, channels, n_ms=N_MS)
        st = propagate_state(cfg, channels, 400)
        for c in range(len(channels)):
            if channels.status[c] != "T":
                continue
            # sequential boundary at ms 400 is absolute_sample[399]
            err_samples = abs(int(st.ptr[c]) - int(ref.absolute_sample[c, 399]))
            assert err_samples <= cfg.samples_per_chip, f"ch {c}: {err_samples}"
