"""Full-chain float64 oracle parity.

The textbook IF recordings the reference names (initialize.py:99,
main.py:60) are not shipped, so chain-for-chain parity is established on
a geometry-consistent synthetic capture: the independent NumPy oracle
(softgnss_tpu.oracle — reference-math loops, no jit, float64) and the
JAX receiver both process the same capture end-to-end and must agree.

Two layers:
* nav-stage EXACT parity: both navigation implementations consume the
  SAME tracking observables (reference-style integer sample counters) —
  pseudoranges, fixes, and DOP must match to float64 roundoff.
* full-chain parity: oracle acquisition -> oracle DLL/PLL tracking ->
  oracle navigation, fully independent of the receiver; fixes agree
  within the c/fs integer-pseudorange quantization that the reference's
  fid.tell() bookkeeping implies (BASELINE.md, ~150 m-scale at the fast
  config's 4.096 MHz; the receiver's own sub-sample path is ~5 m).
"""

import dataclasses

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.nav.solve import post_navigate
from softgnss_tpu.oracle.numpy_rx import (
    oracle_fine_freq,
    oracle_navigate,
    oracle_track_channel,
)
from softgnss_tpu.pipeline import run_receiver
from softgnss_tpu.scenario import build_scenario, synthesize_scenario


@pytest.fixture(scope="module")
def parity_setup():
    cfg = sg.fast_config(
        number_of_channels=5, ms_to_process=37000,
        # reference-parity knobs: pure per-epoch LS, no atmosphere, no
        # RAIM/smoothing/demotion (beyond-reference features off)
        use_trop_corr=False, use_iono_corr=False, raim=False,
        carrier_smoothing_epochs=0, nav_filter="lsq",
        lock_demotion=False, elevation_mask_deg=0.0)
    sc = build_scenario(cfg, n_sats=5)
    sig = synthesize_scenario(sc, 37020)
    res = run_receiver(cfg, signal=sig)
    assert res.has_fix
    return cfg, sc, sig, res


@pytest.mark.slow
class TestNavStageExactParity:
    """Same tracking observables through both navigation stacks."""

    def test_fix_pseudoranges_dop_match(self, parity_setup):
        cfg, sc, sig, res = parity_setup
        # reference-style integer pseudoranges in BOTH stacks
        track_int = dataclasses.replace(res.tracking, sample_frac=None)
        sol, ephs = post_navigate(cfg, track_int)   # ephs: 32-list by PRN
        assert sol is not None
        ora = oracle_navigate(cfg, np.asarray(track_int.absolute_sample),
                              np.asarray(track_int.i_p),
                              np.asarray(track_int.prn), ephs)

        # frame sync and TOW agree exactly
        assert ora["tow"] == pytest.approx(float(sol.tow), abs=0)
        n_ep = min(sol.n_epochs, ora["fix"].shape[0])
        assert n_ep >= 50

        # raw pseudoranges: identical floors and counters -> f64 roundoff
        act = np.flatnonzero(ora["first_subframe"] >= 0)
        np.testing.assert_allclose(
            np.asarray(sol.raw_p)[act, :n_ep], ora["raw_p"][act, :n_ep],
            atol=1e-6, rtol=0)

        # fixes: independent GN implementations on identical inputs
        rx_fix = np.stack([sol.x, sol.y, sol.z, sol.dt], 1)[:n_ep]
        d = np.linalg.norm(rx_fix[:, :3] - ora["fix"][:n_ep, :3], axis=1)
        assert np.nanmax(d) < 1e-3, f"max fix disagreement {np.nanmax(d)} m"
        np.testing.assert_allclose(rx_fix[:, 3], ora["fix"][:n_ep, 3],
                                   atol=1e-3)

        # DOP from the same final geometry (receiver stores (5, E))
        np.testing.assert_allclose(np.asarray(sol.dop).T[:n_ep],
                                   ora["dop"][:n_ep], rtol=1e-6, atol=1e-9)


@pytest.mark.slow
class TestFullChainOracle:
    """Oracle acquisition -> tracking -> navigation, no receiver code."""

    def test_oracle_chain_reaches_reference_grade_fix(self, parity_setup):
        cfg, sc, sig, res = parity_setup
        from softgnss_tpu.oracle.numpy_rx import oracle_acquire_grid

        n_ms = 37000
        c_ch = cfg.number_of_channels
        abs_s = np.zeros((c_ch, n_ms))
        i_p = np.zeros((c_ch, n_ms))
        prns = np.asarray(sc.prns[:c_ch])
        for ch, prn in enumerate(prns):
            _grid, phase, _b, metric = oracle_acquire_grid(cfg, sig, int(prn))
            assert metric > cfg.acq_threshold
            freq = oracle_fine_freq(cfg, sig, int(phase), int(prn))
            log = oracle_track_channel(cfg, sig, int(prn), freq, int(phase),
                                       n_ms)
            abs_s[ch] = log["absolute_sample"]
            i_p[ch] = log["i_p"]

        ephs = [None] * 32
        for prn, eph in zip(sc.prns, sc.ephemerides):
            ephs[prn - 1] = eph
        ora = oracle_navigate(cfg, abs_s, i_p, prns, ephs)

        truth = np.asarray(sc.receiver_ecef)
        err = np.linalg.norm(ora["fix"][:, :3] - truth, axis=1)
        # integer-pseudorange receiver at fs=4.096 MHz: c/fs ~ 73 m code
        # quantization, DOP-scaled (BASELINE.md measured ~150 m median
        # for the reference-style chain)
        assert np.isfinite(err).all()
        assert np.median(err) < 300.0, f"oracle chain median {np.median(err)} m"

        # cross-agreement with the receiver's fixes (same capture): the
        # sub-sample receiver sits within the same quantization envelope
        sol = res.solutions
        rx = np.stack([sol.x, sol.y, sol.z], 1)
        n_ep = min(len(rx), ora["fix"].shape[0])
        cross = np.linalg.norm(rx[:n_ep] - ora["fix"][:n_ep, :3], axis=1)
        assert np.nanmedian(cross) < 300.0
        # and the receiver itself is an order of magnitude tighter
        rx_err = np.linalg.norm(rx - truth, axis=1)
        assert np.nanmedian(rx_err) < 30.0
