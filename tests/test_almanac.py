"""Almanac handling (subframe 4/5 pages — the reference discards them).

Closed loop: the golden scenario encodes every satellite's almanac page
(one per 30-s frame on subframe 5), the receiver collects the pages its
capture spans, and the collected almanac predicts satellite state well
enough for acquisition assistance.
"""

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.nav.message import (Almanac, almanac_to_ephemeris,
                                      build_nav_stream, decode_almanac_pages,
                                      ephemeris_to_almanac)
from softgnss_tpu.nav.orbit import satellite_positions
from softgnss_tpu.scenario import build_scenario, circular_ephemeris


def _scenario_eph():
    cfg = sg.fast_config()
    sc = build_scenario(cfg, n_sats=5)
    return sc


class TestAlmanacCodec:
    def test_roundtrip_at_quantization(self):
        sc = _scenario_eph()
        alm = {p: ephemeris_to_almanac(e, p)
               for p, e in zip(sc.prns, sc.ephemerides)}
        # 30 subframes = 6 frames -> subframe-5 pages for >= 5 PRNs
        stream = build_nav_stream(sc.ephemerides[0], sc.tow_count - 1, 35,
                                  almanac=alm)
        decoded = decode_almanac_pages(stream[300:], stream[299])
        assert set(sc.prns).issubset(decoded)
        for p in sc.prns:
            a, b = alm[p], decoded[p]
            assert b.t_oa == a.t_oa                      # exact (x 2^12 grid)
            assert abs(b.e - a.e) <= 2.0**-21
            assert abs(b.sqrt_a - a.sqrt_a) <= 2.0**-11
            for f, lsb in (("m_0", 2.0**-23), ("omega_0", 2.0**-23),
                           ("omega", 2.0**-23), ("delta_i", 2.0**-19),
                           ("omega_dot", 2.0**-38)):
                assert abs(getattr(b, f) - getattr(a, f)) <= lsb * 3.2, f
            assert abs(b.a_f0 - a.a_f0) <= 2.0**-20
            assert abs(b.a_f1 - a.a_f1) <= 2.0**-38

    def test_almanac_positions_near_ephemeris(self):
        """Almanac-propagated satellite positions sit within the almanac
        error budget (km-scale) of the full-ephemeris positions —
        usable for visibility and Doppler prediction."""
        sc = _scenario_eph()
        alm = {p: ephemeris_to_almanac(e, p)
               for p, e in zip(sc.prns, sc.ephemerides)}
        stream = build_nav_stream(sc.ephemerides[0], sc.tow_count - 1, 35,
                                  almanac=alm)
        decoded = decode_almanac_pages(stream[300:], stream[299])
        t = sc.tow_count * 6.0 + 10.0
        for p, eph in zip(sc.prns, sc.ephemerides):
            eph_a = almanac_to_ephemeris(decoded[p])
            pos_f, _ = satellite_positions(t, [eph])
            pos_a, _ = satellite_positions(t, [eph_a])
            err = np.linalg.norm(pos_f[:, 0] - pos_a[:, 0])
            assert err < 30_000.0, (p, err)   # km-scale almanac budget

    def test_t_oa_requantization_preserves_epoch(self):
        """t_oe off the 4096 s grid: the conversion re-epochs m_0/omega_0
        so propagation stays consistent (without it the along-track error
        is thousands of km)."""
        eph = circular_ephemeris(i_0=0.95, omega_0=1.0, m_0=2.0,
                                 t_oe=420000.0 + 1500.0)
        alm = ephemeris_to_almanac(eph, 7)
        assert alm.t_oa % 4096 == 0
        eph_a = almanac_to_ephemeris(alm)
        t = eph.t_oe + 30.0
        pos_f, _ = satellite_positions(t, [eph])
        pos_a, _ = satellite_positions(t, [eph_a])
        assert np.linalg.norm(pos_f[:, 0] - pos_a[:, 0]) < 30_000.0


class TestAlmanacAssist:
    def test_almanac_doppler_prediction(self):
        """Almanac-converted ephemerides drive the acquisition Doppler
        assist to within tens of Hz of the full-ephemeris prediction —
        a cold receiver with only a stored almanac can still narrow the
        +-7 kHz search."""
        from softgnss_tpu.nav.assist import predict_doppler

        cfg = sg.fast_config()
        sc = _scenario_eph()
        t = sc.tow_count * 6.0
        ephs_full: list = [None] * 32
        ephs_alm: list = [None] * 32
        for p, e in zip(sc.prns, sc.ephemerides):
            ephs_full[p - 1] = e
            ephs_alm[p - 1] = almanac_to_ephemeris(ephemeris_to_almanac(e, p))
        f_full = predict_doppler(cfg, ephs_full, sc.receiver_ecef, t)
        f_alm = predict_doppler(cfg, ephs_alm, sc.receiver_ecef, t)
        sel = np.isfinite(f_full)
        assert sel.sum() == len(sc.prns)
        assert np.nanmax(np.abs(f_alm[sel] - f_full[sel])) < 50.0


class TestAlmanacMergeAcrossChannels:
    def test_first_channel_parity_failure_does_not_end_collection(self):
        """A first channel whose almanac pages all fail parity must not
        stop the collection — pages from the remaining channels are
        merged (nav/solve.py almanac loop; the old code broke after the
        first eligible channel's decode attempt)."""
        from softgnss_tpu.nav.solve import post_navigate
        from test_postnav import (N_MS, TOW_COUNT, build_track,
                                        travel_time, visible_constellation)
        from softgnss_tpu.nav.geodesy import geo2cart

        config = sg.fast_config(number_of_channels=5, ms_to_process=N_MS,
                                use_trop_corr=False)
        rx = np.asarray(geo2cart(np.array([47.0, 0, 0]),
                                 np.array([8.5, 0, 0]), 500.0, 4))
        t_rx0 = TOW_COUNT * 6.0 - 0.35
        ephs = visible_constellation(rx, 5, TOW_COUNT * 6.0)
        alm = {p: ephemeris_to_almanac(ephs[(p - 1) % len(ephs)], p)
               for p in range(1, 25)}
        track = build_track(config, rx, ephs, t_rx0, almanac=alm)

        # corrupt ONLY channel 0's subframe-5 almanac data words: flip
        # alternate data bits of words 3..10 (0-based 2..9), keeping each
        # word's parity bits (so the D29*/D30* polarity chain into the
        # following subframe stays intact) and subframes 1-3 (so the
        # ephemeris decode succeeds and channel 0 stays active/first).
        eph0 = ephs[0]
        fs = config.sampling_freq  # noqa: F841  (geometry recompute below)
        tau0 = travel_time(rx, eph0, t_rx0)
        t_anchor = np.floor((t_rx0 - tau0) * 1000.0) / 1000.0
        m = np.arange(N_MS)
        t_tx = t_anchor + (m + 1) * 1e-3
        t_bits0 = (TOW_COUNT - 1) * 6.0
        bit_idx = np.floor((t_tx - 1e-3 / 2 - t_bits0) / 0.02).astype(np.int64)
        sf_id = (TOW_COUNT - 1 + bit_idx // 300) % 5 + 1
        b_in = bit_idx % 300
        w = b_in // 30
        b_in_w = b_in % 30
        flip = ((sf_id == 5) & (w >= 2) & (b_in_w < 24) & (b_in_w % 2 == 0))
        track.i_p[0, flip] *= -1.0

        sol, eph_by_prn = post_navigate(config, track)
        assert sol is not None
        assert eph_by_prn[0] is not None  # channel 0 (PRN 1) stayed decodable
        assert sol.almanac                # pages merged from channels 1+
        # and the merged pages are real: they round-trip the injected one
        for prn, page in sol.almanac.items():
            assert abs(page.sqrt_a - alm[prn].sqrt_a) <= 2.0 ** -11 + 1e-9


@pytest.mark.slow
class TestAlmanacEndToEnd:
    def test_receiver_collects_pages(self):
        from softgnss_tpu.pipeline import run_receiver
        from softgnss_tpu.scenario import synthesize_scenario

        cfg = sg.fast_config(number_of_channels=5, ms_to_process=37000)
        sc = build_scenario(cfg, n_sats=5)
        signal = synthesize_scenario(sc, 37000 + cfg.acquisition_ms + 2)
        res = run_receiver(cfg, signal=signal)
        assert res.has_fix
        alm = res.solutions.almanac
        assert alm is not None
        # one almanac page per 30-s frame: a 37-s capture spans 1-2 pages
        # (the full 25-page cycle takes 12.5 minutes of capture)
        assert len(set(alm) & set(sc.prns)) >= 1, sorted(alm or {})
        # collected pages predict the satellites within the almanac budget
        t = sc.tow_count * 6.0
        for p in sorted(set(alm) & set(sc.prns)):
            eph = sc.ephemerides[sc.prns.index(p)]
            eph_a = almanac_to_ephemeris(alm[p])
            pos_f, _ = satellite_positions(t, [eph])
            pos_a, _ = satellite_positions(t, [eph_a])
            assert np.linalg.norm(pos_f[:, 0] - pos_a[:, 0]) < 30_000.0
