"""RAIM fault detection & exclusion (beyond the reference).

The reference's least-squares solver computes residuals and discards them
(geoFunctions/__init__.py:704-719); a biased pseudorange silently drags
the fix.  Here every epoch's post-fit residual SSE is chi-square tested
(sigma auto-calibrated from the capture), and on a fault leave-one-out
re-solves isolate and exclude the faulty satellite — or invalidate the
epoch when no single exclusion explains the residuals.

Observables-level (fabricated tracking output, like tests/test_postnav.py):
a 7-satellite geometry gives the n >= 6 redundancy exclusion needs.
"""

import dataclasses

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.nav.geodesy import geo2cart
from softgnss_tpu.nav.solve import post_navigate
from test_postnav import (TOW_COUNT, FakeTrack, build_track,
                                visible_constellation)

#: +600 m pseudorange bias — far above the few-mm observable noise of the
#: fabricated track, well below anything that would break preamble sync
BIAS_M = 600.0
FAULT_MS = 20000


@pytest.fixture(scope="module")
def raim_case():
    config = sg.fast_config(number_of_channels=7, ms_to_process=37000,
                            use_trop_corr=False)
    rx = np.asarray(geo2cart(np.array([47.0, 0, 0]),
                             np.array([8.5, 0, 0]), 500.0, 4))
    t_rx0 = TOW_COUNT * 6.0 - 0.35
    ephs = visible_constellation(rx, 7, TOW_COUNT * 6.0)
    track = build_track(config, rx, ephs, t_rx0)
    return config, rx, track


def _with_bias(track, channel_biases):
    bad = FakeTrack()
    bad.__dict__.update(track.__dict__)
    bad.absolute_sample = track.absolute_sample.copy()
    return bad


def _fault(config, track, ch, meters, from_ms=FAULT_MS):
    bad = _with_bias(track, None)
    bias_samples = meters / config.speed_of_light * config.sampling_freq
    bad.absolute_sample[ch, from_ms:] += bias_samples
    return bad


def _err3d(sol, rx):
    return np.sqrt((sol.x - rx[0]) ** 2 + (sol.y - rx[1]) ** 2
                   + (sol.z - rx[2]) ** 2)


class TestRaim:
    def test_clean_capture_no_false_alarms(self, raim_case):
        config, rx, track = raim_case
        sol, _ = post_navigate(config, track)
        assert sol is not None
        assert np.all(sol.raim_flag == 0)
        assert np.all(sol.raim_excluded_prn == 0)
        assert np.isfinite(sol.x).all()

    def test_single_fault_excluded(self, raim_case):
        """A mid-capture bias on one satellite is isolated and excluded;
        the fix never degrades."""
        config, rx, track = raim_case
        sol, _ = post_navigate(config, _fault(config, track, 0, BIAS_M))
        assert sol is not None
        err = _err3d(sol, rx)
        faulty = sol.raim_flag == 1
        # every epoch after the fault onset is flagged + excluded
        epoch_ms = sol.first_epoch_ms + sol._period_ms * np.arange(sol.n_epochs)
        assert np.array_equal(faulty, epoch_ms >= FAULT_MS)
        assert np.all(sol.raim_excluded_prn[faulty] == track.prn[0])
        assert np.all(sol.raim_excluded_prn[~faulty] == 0)
        # the excluded satellite's observables are withheld at those epochs
        assert np.all(np.isnan(sol.raw_p[0][faulty]))
        # fix quality unaffected by the fault (fabricated observables are
        # ~mm-exact; exclusion restores that)
        assert np.isfinite(err).all()
        assert err.max() < 10.0

    def test_without_raim_fault_corrupts_fix(self, raim_case):
        config, rx, track = raim_case
        cfg_off = dataclasses.replace(config, raim=False)
        sol, _ = post_navigate(cfg_off, _fault(config, track, 0, BIAS_M))
        err = _err3d(sol, rx)
        assert sol.raim_flag is None or np.all(sol.raim_flag == 0)
        # the biased satellite drags the unprotected fix by O(100 m)
        assert np.nanmax(err) > 50.0

    def test_dual_fault_invalidates_epochs(self, raim_case):
        """Two simultaneous faults defeat single-exclusion: the epochs are
        flagged non-isolable and the fixes withheld (NaN) rather than
        reported wrong."""
        config, rx, track = raim_case
        bad = _fault(config, track, 0, BIAS_M)
        bias2 = -0.7 * BIAS_M / config.speed_of_light * config.sampling_freq
        bad.absolute_sample[1, FAULT_MS:] += bias2
        sol, _ = post_navigate(config, bad)
        epoch_ms = sol.first_epoch_ms + sol._period_ms * np.arange(sol.n_epochs)
        after = epoch_ms >= FAULT_MS
        assert np.all(sol.raim_flag[after] == 2)
        assert np.all(np.isnan(sol.x[after]))
        # clean epochs before the onset are untouched
        assert np.all(sol.raim_flag[~after] == 0)
        assert np.isfinite(sol.x[~after]).all()

    def test_excluded_satellite_recovers(self, raim_case):
        """Per-epoch FDE: a fault that heals mid-capture re-admits the
        satellite at the first clean epoch (the elevation carry keeps it
        alive while excluded)."""
        config, rx, track = raim_case
        bad = _with_bias(track, None)
        bias = BIAS_M / config.speed_of_light * config.sampling_freq
        heal_ms = 28000
        bad.absolute_sample[0, FAULT_MS:heal_ms] += bias
        sol, _ = post_navigate(config, bad)
        epoch_ms = sol.first_epoch_ms + sol._period_ms * np.arange(sol.n_epochs)
        during = (epoch_ms >= FAULT_MS) & (epoch_ms < heal_ms)
        healed = epoch_ms >= heal_ms
        assert np.all(sol.raim_flag[during] == 1)
        assert np.all(sol.raim_flag[healed] == 0)
        # satellite contributes again after healing
        assert np.isfinite(sol.raw_p[0][healed]).all()

    def test_explicit_sigma(self, raim_case):
        """A configured UERE sigma bypasses auto-calibration and still
        detects the fault."""
        config, rx, track = raim_case
        cfg = dataclasses.replace(config, raim_sigma_m=5.0)
        sol, _ = post_navigate(cfg, _fault(config, track, 0, BIAS_M))
        assert np.any(sol.raim_flag == 1)
        assert _err3d(sol, rx).max() < 10.0
