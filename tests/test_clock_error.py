"""Receiver-oscillator (sampling-clock) error: synthesis + closed loop.

The reference assumes an exact front end (initialize.py:105-107); every
real capture has a TCXO offset.  Scenario.clock_ppm models it exactly
(synth.synthesize_dynamic docstring): common apparent carrier bias of
~ -f_L1*rho, code clock scaled by 1/(1+rho), and a rho*c m/s receiver
clock drift.  These tests check that fixes survive
+-2 ppm, the navigation clock_drift recovers the injected value, and the
assisted-acquisition hint-bias caveat (acquire/search.py docstring) is
exercised both ways.
"""

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.acquire import acquire
from softgnss_tpu.pipeline import run_receiver
from softgnss_tpu.scenario import build_scenario, synthesize_scenario

C_LIGHT = 299792458.0


def test_apparent_doppler_includes_oscillator_bias():
    """2 ppm fast clock: every PRN's measured carrier shifts by a common
    ~ -f_L1*rho on top of its geometric Doppler."""
    cfg = sg.fast_config(number_of_channels=5)
    sc0 = build_scenario(cfg, n_sats=5)
    synthesize_scenario(sc0, 2)            # fills geometry-only dopplers
    geo = sc0.dopplers.copy()

    sc = build_scenario(cfg, n_sats=5, clock_ppm=2.0)
    sig = synthesize_scenario(sc, 40)
    acq = acquire(cfg, sig)
    rho = 2e-6
    exp_bias = -cfg.l1_freq * rho / (1.0 + rho)
    for i, prn in enumerate(sc.prns):
        meas = acq.carr_freq[prn - 1] - cfg.intermediate_freq
        # truth table carries the apparent (biased) Doppler
        assert abs(meas - sc.dopplers[i]) < 5.0
        # bias vs the zero-ppm geometry is the common oscillator term
        # (geometry itself shifts only ~mHz from the 1e-6-scale time warp)
        assert abs((meas - geo[i]) - exp_bias) < 6.0


@pytest.mark.slow
@pytest.mark.parametrize("ppm", [2.0, -1.0])
def test_fix_and_clock_drift_survive_oscillator_offset(ppm):
    """Full closed loop at +-ppm: position unaffected (common-mode),
    navigation clock_drift recovers rho*c."""
    cfg = sg.fast_config(number_of_channels=5, ms_to_process=37000)
    sc = build_scenario(cfg, n_sats=5, clock_ppm=ppm)
    sig = synthesize_scenario(sc, 37020)
    res = run_receiver(cfg, signal=sig)
    assert res.has_fix
    sol = res.solutions
    xyz = np.stack([sol.x, sol.y, sol.z], 1)
    ok = np.isfinite(xyz).all(1)
    err = np.linalg.norm(xyz[ok] - np.asarray(sc.receiver_ecef), axis=1)
    assert ok.sum() >= sol.n_epochs - 1
    assert np.median(err) < 30.0

    # receiver clock bias slope: dt gains rho*c meters per second
    dt = np.asarray(sol.dt)[ok]
    t = np.arange(len(np.asarray(sol.dt)))[ok] * cfg.nav_sol_period_ms / 1e3
    slope = np.polyfit(t, dt, 1)[0]
    exp = ppm * 1e-6 * C_LIGHT
    assert abs(slope - exp) < max(5.0, 0.02 * abs(exp)), (slope, exp)

    # the velocity solution's clock_drift state sees the same value
    drift = np.asarray(sol.clock_drift)
    good = np.isfinite(drift)
    assert good.sum() > sol.n_epochs // 2
    assert abs(np.median(drift[good]) - exp) < 5.0


def test_assisted_acquisition_hint_bias_caveat():
    """Doppler hints are bias-blind (acquire/search.py docstring): at
    2 ppm the ~ -3.2 kHz oscillator term pushes the true peak outside the
    default 500 Hz hint window; widening the window (or correcting the
    hint by a known TCXO bias) recovers the cold-start-grade detection."""
    cfg = sg.fast_config(number_of_channels=5)
    sc = build_scenario(cfg, n_sats=5, clock_ppm=2.0)
    sig = synthesize_scenario(sc, 40)
    cold = acquire(cfg, sig)

    # geometry-only hints, as a bias-unaware assist would compute them
    sc0 = build_scenario(cfg, n_sats=5)
    synthesize_scenario(sc0, 2)
    hints = np.full(32, np.nan)
    for i, prn in enumerate(sc.prns):
        hints[prn - 1] = cfg.intermediate_freq + sc0.dopplers[i]

    narrow = acquire(cfg, sig, doppler_hints=hints, hint_halfwidth_hz=500.0)
    wide = acquire(cfg, sig, doppler_hints=hints, hint_halfwidth_hz=4000.0)
    bias_fixed = acquire(cfg, sig,
                         doppler_hints=hints - cfg.l1_freq * 2e-6,
                         hint_halfwidth_hz=500.0)
    for prn in sc.prns:
        i = prn - 1
        # the narrow bias-blind window cannot contain the true peak
        assert abs(narrow.carr_freq[i] - cold.carr_freq[i]) > 1000.0 \
            or narrow.peak_metric[i] < cfg.acq_threshold
        # widened to cover f_L1 * ppm, or bias-corrected: full recovery
        for rec in (wide, bias_fixed):
            assert rec.peak_metric[i] > cfg.acq_threshold
            assert rec.code_phase[i] == cold.code_phase[i]
            assert abs(rec.carr_freq[i] - cold.carr_freq[i]) < 1e-6
