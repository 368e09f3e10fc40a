"""Closed-loop coverage of the FULL broadcast ephemeris model.

The default golden scenario uses circular zero-clock orbits, so the
eccentricity, harmonic-correction, and clock-polynomial/T_GD branches of
the orbit model (reference geoFunctions:819-885) were only unit-tested.
Here build_scenario(full_model=True) drives them end-to-end: eccentric
orbits (e ~ 0.01) with all six harmonics and satellite clock terms flow
encode -> acquire -> track -> decode -> satpos -> PVT, and the fix must
land at the injected position within the same DLL-noise budget.
"""

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.nav.message import build_nav_stream, decode_ephemeris
from softgnss_tpu.nav.orbit import satellite_positions
from softgnss_tpu.pipeline import run_receiver
from softgnss_tpu.scenario import (
    build_scenario,
    circular_ephemeris,
    propagate_circular,
    propagate_orbit,
    satellite_clock_offset,
    synthesize_scenario,
)

N_MS = 37000


class TestTruthPropagator:
    """The scenario's NumPy truth model must agree with the receiver's
    jitted satpos on the same (decoded, quantized) ephemeris — otherwise
    the closed loop would hide a shared-convention bug."""

    def test_matches_receiver_satpos_on_decoded_ephemeris(self):
        cfg = sg.fast_config()
        sc = build_scenario(cfg, n_sats=5, full_model=True)
        t0 = sc.tow_count * 6.0
        for eph in sc.ephemerides:
            stream = build_nav_stream(eph, sc.tow_count - 1, 6)
            dec, _ = decode_ephemeris(stream[300:1800], stream[299])
            assert dec.complete
            for t in (t0, t0 + 17.0, t0 + 37.0):
                pos_r, clk_r = satellite_positions(t, [dec])
                # satpos takes satellite-clock time and evaluates the orbit
                # at t - clk; the truth propagator takes GPS time
                pos_t = propagate_orbit(dec, np.asarray([t - clk_r[0]]))[:, 0]
                clk_t = satellite_clock_offset(dec, np.asarray([t]))[0]
                assert np.linalg.norm(pos_t - pos_r[:, 0]) < 0.02
                assert abs(clk_t - clk_r[0]) * 3e8 < 0.02

    def test_reduces_to_circular_closed_form(self):
        ce = circular_ephemeris(i_0=1.0, omega_0=1.2, m_0=0.7, t_oe=420000.0)
        ts = 420000.0 + np.asarray([0.0, 10.0, 37.0])
        np.testing.assert_allclose(propagate_orbit(ce, ts),
                                   propagate_circular(ce, ts), rtol=0, atol=1e-6)
        assert np.all(satellite_clock_offset(ce, ts) == 0.0)

    def test_clock_offset_terms(self):
        from softgnss_tpu.scenario import keplerian_ephemeris

        eph = keplerian_ephemeris(t_oe=1000.0, e=0.01, a_f0=1e-4,
                                  a_f1=2e-11, t_gd=5e-9)
        t = np.asarray([1000.0 + 100.0])
        dt = satellite_clock_offset(eph, t)[0]
        # polynomial + relativistic - t_gd; relativistic bounded by
        # |F e sqrt_a| ~ 23 ns
        poly = 1e-4 + 2e-11 * 100.0 - 5e-9
        assert abs(dt - poly) < 25e-9
        assert dt != poly                   # relativistic term present


@pytest.fixture(scope="module")
def full_model_results():
    cfg = sg.fast_config(number_of_channels=5, ms_to_process=N_MS)
    scenario = build_scenario(cfg, n_sats=5, full_model=True)
    signal = synthesize_scenario(scenario, N_MS + cfg.acquisition_ms + 2)
    results = run_receiver(cfg, signal=signal)
    return cfg, scenario, results


@pytest.mark.slow
class TestFullModelEndToEnd:
    def test_ephemeris_decoded_with_clock_terms(self, full_model_results):
        cfg, scenario, results = full_model_results
        for i, prn in enumerate(scenario.prns):
            eph = results.ephemerides[prn - 1]
            truth = scenario.ephemerides[i]
            assert eph is not None and eph.complete
            assert truth.e > 0 and eph.e == pytest.approx(truth.e, abs=2.0**-32)
            assert eph.a_f0 == pytest.approx(truth.a_f0, abs=2.0**-30)
            assert eph.a_f1 == pytest.approx(truth.a_f1, abs=2.0**-42)
            assert eph.t_gd == pytest.approx(truth.t_gd, abs=2.0**-30)
            assert eph.c_rs == pytest.approx(truth.c_rs, abs=2.0**-4)
            d_omega = (eph.omega - truth.omega + np.pi) % (2 * np.pi) - np.pi
            assert abs(d_omega) < 2.0**-28

    def test_position_fix_matches_truth(self, full_model_results):
        """Satellite clock offsets up to ~60 km of equivalent range must be
        corrected away by the decoded clock polynomial: same error budget
        as the circular scenario (geometry/DOP differs by the draw)."""
        cfg, scenario, results = full_model_results
        assert results.has_fix
        sol = results.solutions
        rx = scenario.receiver_ecef
        ok = np.isfinite(sol.x)
        assert ok.sum() >= 0.9 * sol.n_epochs
        err = np.sqrt((sol.x[ok] - rx[0]) ** 2 + (sol.y[ok] - rx[1]) ** 2
                      + (sol.z[ok] - rx[2]) ** 2)
        assert np.median(err) < 30.0       # measured ~10 m (PDOP ~10)
        assert np.mean(err) < 40.0

    def test_velocity_with_satellite_clock_drift(self, full_model_results):
        """a_f1 clock drift enters measured Doppler exactly like range
        rate; the velocity solution corrects it — a
        static receiver must still solve to ~dm/s."""
        cfg, scenario, results = full_model_results
        sol = results.solutions
        v = np.sqrt(sol.vx**2 + sol.vy**2 + sol.vz**2)
        ok = np.isfinite(v)
        assert ok.sum() >= 0.9 * sol.n_epochs
        assert np.median(v[ok]) < 0.3
