"""Carrier-aided DLL (config.carrier_aided_dll, beyond the reference).

The aiding claim: with the code NCO riding the PLL's Doppler (scaled by
f_code/f_L1), the DLL only has to track residual code-carrier divergence,
so its noise bandwidth can shrink well below the unaided 2 Hz and the
code-phase jitter (hence pseudorange noise) falls accordingly, without
the dynamics lag an unaided narrow loop would suffer.
"""

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track import track

N_MS = 2500


@pytest.fixture(scope="module")
def capture():
    cfg = sg.fast_config(number_of_channels=2)
    rng = np.random.default_rng(11)
    sats = [SatelliteSignal(prn=3, doppler_hz=2700.0, delay_samples=512.0,
                            phase0=1.0,
                            nav_bits=tuple(rng.choice([-1, 1], size=32))),
            SatelliteSignal(prn=17, doppler_hz=-3100.0, delay_samples=2209.0,
                            phase0=4.2,
                            nav_bits=tuple(rng.choice([-1, 1], size=32)))]
    signal = synthesize_signal(cfg, sats, N_MS + 3, noise_std=2.0, seed=5)
    channels = Channels(
        prn=np.asarray([s.prn for s in sats]),
        acquired_freq=np.asarray(
            [cfg.intermediate_freq + s.doppler_hz for s in sats]),
        code_phase=np.asarray([int(s.delay_samples) for s in sats], np.int64),
        status=["T", "T"])
    return cfg, sats, signal, channels


def _boundary_jitter(res, tail=1000):
    """Std of the code-boundary positions around a linear (constant code
    rate) fit, in samples, per channel."""
    pos = (np.asarray(res.absolute_sample, np.float64)
           - np.asarray(res.sample_frac))[:, -tail:]
    t = np.arange(pos.shape[1])
    out = []
    for row in pos:
        coef = np.polyfit(t, row, 1)
        out.append(np.std(row - np.polyval(coef, t)))
    return np.asarray(out)


class TestCarrierAiding:
    def test_narrow_aided_cuts_code_jitter(self, capture):
        cfg, sats, signal, channels = capture
        res_ref = track(cfg, signal, channels, n_ms=N_MS)
        res_aid = track(cfg.with_options(carrier_aided_dll=True,
                                         dll_noise_bandwidth=0.5),
                        signal, channels, n_ms=N_MS)
        j_ref = _boundary_jitter(res_ref)
        j_aid = _boundary_jitter(res_aid)
        assert (j_aid < 0.55 * j_ref).all(), (j_ref, j_aid)

        # no bias: both loops land on the same code boundary (sub-sample)
        end_ref = (np.asarray(res_ref.absolute_sample[:, -1], np.float64)
                   - np.asarray(res_ref.sample_frac[:, -1]))
        end_aid = (np.asarray(res_aid.absolute_sample[:, -1], np.float64)
                   - np.asarray(res_aid.sample_frac[:, -1]))
        assert np.abs(end_ref - end_aid).max() < 0.5

    def test_aided_code_rate_tracks_doppler(self, capture):
        """The aided code frequency sits at the Doppler-consistent chip
        rate (code Doppler = carrier Doppler / 1540) instead of relying
        on the DLL to find it."""
        cfg, sats, signal, channels = capture
        res = track(cfg.with_options(carrier_aided_dll=True,
                                     dll_noise_bandwidth=0.5),
                    signal, channels, n_ms=N_MS)
        for i, s in enumerate(sats):
            expect = s.effective_code_freq(cfg)
            got = np.median(np.asarray(res.code_freq[i, -500:]))
            assert abs(got - expect) < 0.05, (i, got, expect)

    def test_aiding_onehot_matches_gather(self, capture):
        """The aided code loop runs the same through the one-hot
        correlator and the plain gather path."""
        cfg, sats, signal, channels = capture
        c = cfg.with_options(carrier_aided_dll=True, dll_noise_bandwidth=0.5,
                             track_block_ms=16)
        res_oh = track(c.with_options(correlator_impl="onehot"),
                       signal, channels, n_ms=96)
        res_ga = track(c.with_options(correlator_impl="gather"),
                       signal, channels, n_ms=96)
        np.testing.assert_array_equal(res_oh.absolute_sample,
                                      res_ga.absolute_sample)
        assert np.max(np.abs(res_oh.code_freq - res_ga.code_freq)) < 1e-4
        a = np.asarray(res_oh.i_p, np.float64)
        b = np.asarray(res_ga.i_p, np.float64)
        assert np.max(np.abs(a - b)) / np.sqrt(np.mean(b**2)) < 1e-4
