"""Near-far robustness.

C/A cross-correlation floors at ~-21.6 dB, so a +20 dB interferer sits
within ~2 dB of a weak satellite's own peak: the reference's
threshold-2.5 best-of-two search (acquisition.py:139-164) can miss the
weak PRN or false-alarm on absent ones.  These tests stress that regime
and assert the defense layers individually:

* acquisition: non-coherent K=10 accumulation recovers the weak PRN at
  its true code phase under a +20 dB neighbor,
* a false-alarmed channel (tracking an absent PRN) is demoted by the
  lock monitor AND never reaches the fix (its noise bits fail
  parity/ephemeris gating), leaving the PVT solution clean,
* a channel frame-locked to a different TOW is dropped by the majority
  vote before pseudoranges are formed.

(The third layer, RAIM fault exclusion on a consistent-looking but
biased pseudorange, is exercised in tests/test_raim.py.)
"""

import dataclasses

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.acquire import acquire
from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.nav.solve import post_navigate
from softgnss_tpu.pipeline import run_receiver
from softgnss_tpu.scenario import build_scenario, synthesize_scenario
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal


class TestNearFarAcquisition:
    def test_weak_prn_acquired_under_14db_interferer(self):
        """+14 dB neighbor: K=10 non-coherent accumulation acquires the
        weak PRN cold, at the true code phase."""
        cfg = sg.fast_config(number_of_channels=4, acq_noncoherent_ms=10)
        sats = [
            SatelliteSignal(prn=7, doppler_hz=1500.0, delay_samples=900.0,
                            amplitude=5.0),             # +14 dB
            SatelliteSignal(prn=13, doppler_hz=-2200.0,
                            delay_samples=2600.0, amplitude=1.0),
        ]
        sig = synthesize_signal(cfg, sats, cfg.acquisition_ms + 1,
                                noise_std=1.0, seed=21)
        acq = acquire(cfg, sig)
        assert acq.acquired[7 - 1]
        assert acq.acquired[13 - 1], "weak PRN lost to the interferer"
        assert abs(int(acq.code_phase[13 - 1]) - 2600) <= 1
        assert abs(acq.carr_freq[13 - 1]
                   - (cfg.intermediate_freq - 2200.0)) < 20.0

    def test_weak_prn_at_20db_needs_hinted_threshold(self):
        """+20 dB neighbor: the interferer's cross-correlation floor
        (~-21.6 dB) sits ~2 dB under the weak peak, so the
        peak/second-peak RATIO cannot clear the cold threshold 2.5 — but
        the peak LOCATION stays true, and inside a +-1-bin hint window a
        reduced threshold is statistically sound (noise-only second peaks
        there ratio ~1.2): hint + threshold 1.5 recovers the weak PRN."""
        cfg = sg.fast_config(number_of_channels=4, acq_noncoherent_ms=10)
        sats = [
            SatelliteSignal(prn=7, doppler_hz=1500.0, delay_samples=900.0,
                            amplitude=10.0),            # +20 dB
            SatelliteSignal(prn=13, doppler_hz=-2200.0,
                            delay_samples=2600.0, amplitude=1.0),
        ]
        sig = synthesize_signal(cfg, sats, cfg.acquisition_ms + 1,
                                noise_std=1.0, seed=21)
        cold = acquire(cfg, sig)
        assert cold.acquired[7 - 1]
        assert not cold.acquired[13 - 1]        # the documented ratio wall
        assert abs(int(cold.code_phase[13 - 1]) - 2600) <= 1  # peak is true

        hints = np.full(32, np.nan)
        hints[13 - 1] = cfg.intermediate_freq - 2200.0
        assisted = acquire(cfg.with_options(acq_threshold=1.5), sig,
                           doppler_hints=hints)
        assert assisted.acquired[13 - 1]
        assert abs(int(assisted.code_phase[13 - 1]) - 2600) <= 1

    def test_no_false_alarms_with_k10(self):
        """The strong interferer's cross-correlations stay under the
        threshold on every absent PRN with K=10 (square-law averaging);
        K=2 (the reference scheme) is the false-alarm-prone one."""
        cfg = sg.fast_config(number_of_channels=4, acq_noncoherent_ms=10)
        sats = [SatelliteSignal(prn=7, doppler_hz=1500.0,
                                delay_samples=900.0, amplitude=10.0)]
        sig = synthesize_signal(cfg, sats, cfg.acquisition_ms + 1,
                                noise_std=1.0, seed=22)
        acq = acquire(cfg, sig)
        absent = np.ones(32, bool)
        absent[7 - 1] = False
        assert not acq.acquired[absent].any(), (
            f"false alarms on PRNs "
            f"{1 + np.flatnonzero(acq.acquired & absent)}")


@pytest.mark.slow
class TestFalseLockDefenses:
    def test_false_alarm_channel_demoted_and_fix_clean(self):
        """A channel assigned to an ABSENT PRN (as a near-far false alarm
        would) tracks noise: the lock monitor demotes it, the nav stage
        never uses it (noise bits fail parity/frame sync), and the fix
        matches the clean-run quality."""
        cfg = sg.fast_config(number_of_channels=6, ms_to_process=37000)
        sc = build_scenario(cfg, n_sats=5)
        sig = synthesize_scenario(sc, 37020)

        # receiver-chosen channels for the 5 real sats + 1 false alarm
        acq = acquire(cfg, sig[:cfg.acquisition_ms * cfg.samples_per_code])
        absent = next(p for p in range(1, 33) if p not in sc.prns)
        prn = np.concatenate([np.asarray(sc.prns),
                              np.asarray([absent])]).astype(np.int64)
        freq = np.concatenate([acq.carr_freq[np.asarray(sc.prns) - 1],
                               [cfg.intermediate_freq + 800.0]])
        phase = np.concatenate([acq.code_phase[np.asarray(sc.prns) - 1],
                                [1234]]).astype(np.int64)
        channels = Channels(prn=prn, acquired_freq=freq, code_phase=phase,
                            status=["T"] * 6)
        res = run_receiver(cfg, signal=sig, channels=channels)

        # layer 1: the lock monitor flags the noise channel (and only it)
        loss = np.asarray(res.tracking.lock_loss_ms)
        assert np.isfinite(loss[5]), "false-lock channel not demoted"
        assert not np.isfinite(loss[:5]).any()

        # the fix is uncorrupted
        assert res.has_fix
        sol = res.solutions
        xyz = np.stack([sol.x, sol.y, sol.z], 1)
        ok = np.isfinite(xyz).all(1)
        err = np.linalg.norm(xyz[ok] - np.asarray(sc.receiver_ecef), axis=1)
        assert np.median(err) < 30.0
        # layer 2: the nav stage excluded the channel entirely (no frame
        # sync on noise bits -> first_subframe 0, no pseudoranges)
        assert sol.first_subframe[5] == 0
        assert not np.isfinite(sol.raw_p[5]).any() or \
            (sol.prn[5] == 0).all()

    def test_tow_vote_drops_mislocked_channel(self, caplog):
        """A channel whose frame sync lands one subframe away (TOW off by
        6 s) is excluded by the majority vote (beyond the reference,
        which silently uses the last channel's TOW)."""
        cfg = sg.fast_config(number_of_channels=5, ms_to_process=37000)
        sc = build_scenario(cfg, n_sats=5)
        sig = synthesize_scenario(sc, 37020)
        res = run_receiver(cfg, signal=sig, navigate=False)
        tr = res.tracking

        # doctor channel 4: shift its bit stream a whole subframe early —
        # frame sync finds a valid preamble 6000 ms in, TOW reads 6 s off
        ip = np.asarray(tr.i_p).copy()
        ip[4, :-6000] = ip[4, 6000:]
        ip[4, -6000:] = ip[4, -12000:-6000]
        doctored = dataclasses.replace(tr, i_p=ip)
        import logging

        with caplog.at_level(logging.WARNING, logger="softgnss_tpu.nav.solve"):
            sol, _ = post_navigate(cfg, doctored)
        assert sol is not None
        assert any("TOW" in r.message and "disagrees" in r.message
                   for r in caplog.records)
        # solution comes from the 4 agreeing channels and stays clean
        xyz = np.stack([sol.x, sol.y, sol.z], 1)
        ok = np.isfinite(xyz).all(1)
        err = np.linalg.norm(xyz[ok] - np.asarray(sc.receiver_ecef), axis=1)
        assert np.median(err) < 50.0
