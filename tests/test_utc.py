"""GPS->UTC parameters: subframe 4 page 18 words 6-10 (beyond the
reference, which discards subframes 4-5 entirely, ephemeris.py:88-91).

Encode -> parity -> decode roundtrip at the broadcast quantization, the
IS-GPS-200 20.3.3.5.2.4 offset arithmetic (leap-second event switching),
and the observables-level closed loop: a fabricated capture broadcasting
UTC parameters -> post_navigate reports the GPS-UTC offset.
"""

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.nav.geodesy import geo2cart
from softgnss_tpu.nav.message import (UtcParams, build_nav_stream,
                                      decode_iono, decode_utc,
                                      load_ephemerides, load_utc,
                                      save_ephemerides)
from softgnss_tpu.nav.solve import post_navigate
from test_geodesy_pvt import circular_eph
from test_postnav import TOW_COUNT, build_track, visible_constellation

#: realistic 2020s broadcast values
UTC = UtcParams(a0=-2.793967724e-9, a1=-7.105427358e-15, t_ot=147456.0,
                wn_t=2000 % 256, delta_t_ls=18, wn_lsf=1929 % 256, dn=7,
                delta_t_lsf=18)
IONO = np.array([1.2e-8, -7.45e-9, -5.96e-8, 1.19e-7,
                 9.2e4, -1.1e5, -6.5e4, 5.2e5])


def _roundtrip(utc, iono=None):
    eph = circular_eph(t_oe=12345 * 6.0)
    bits = np.asarray(build_nav_stream(eph, 12340, 6, iono=iono, utc=utc))
    # frames start at Z-counts divisible by 5 -> any 5-subframe window
    # contains subframe 4 (same slicing as tests/test_iono.py)
    return decode_utc(bits[300:1801], bits[299]), bits


class TestUtcCodec:
    def test_roundtrip_at_quantization(self):
        got, _ = _roundtrip(UTC)
        assert got is not None
        assert got.a0 == pytest.approx(UTC.a0, abs=2.0**-30)
        assert got.a1 == pytest.approx(UTC.a1, abs=2.0**-50)
        assert got.t_ot == UTC.t_ot
        assert got.wn_t == UTC.wn_t
        assert got.delta_t_ls == UTC.delta_t_ls
        assert got.wn_lsf == UTC.wn_lsf
        assert got.dn == UTC.dn
        assert got.delta_t_lsf == UTC.delta_t_lsf

    def test_shares_page_with_iono(self):
        """UTC and Klobuchar ride the same page 18; encoding both must
        decode both."""
        got_utc, bits = _roundtrip(UTC, iono=IONO)
        got_iono = decode_iono(bits[300:1801], bits[299])
        assert got_utc is not None and got_iono is not None
        assert got_utc.delta_t_ls == UTC.delta_t_ls
        np.testing.assert_allclose(got_iono[:4], IONO[:4], rtol=0.2)

    def test_absent_page_returns_none(self):
        eph = circular_eph(t_oe=12345 * 6.0)
        bits = np.asarray(build_nav_stream(eph, 12340, 6))
        assert decode_utc(bits[300:1801], bits[299]) is None

    def test_negative_a0_sign(self):
        got, _ = _roundtrip(UtcParams(a0=-5e-9, a1=0.0))
        assert got.a0 < 0


class TestUtcOffset:
    def test_offset_arithmetic(self):
        tow, week = 200000.0, 2000
        got = UTC.gps_to_utc_offset(tow, week)
        want = 18 + UTC.a0 + UTC.a1 * (tow - UTC.t_ot)
        assert got == pytest.approx(want, abs=1e-15)

    def test_leap_second_event_switch(self):
        """delta_t_LSF applies once (WN_LSF, DN) is past (both mod 256)."""
        utc = UtcParams(a0=0.0, a1=0.0, delta_t_ls=18, delta_t_lsf=19,
                        wn_lsf=100, dn=3, wn_t=100)
        week = 2148          # 2148 % 256 == 100 -> event week
        before = utc.gps_to_utc_offset(2 * 86400.0, week)   # day 2 < DN 3
        after = utc.gps_to_utc_offset(4 * 86400.0, week)    # day 4 >= DN 3
        assert before == 18.0
        assert after == 19.0
        assert utc.gps_to_utc_offset(0.0, week + 1) == 19.0
        assert utc.gps_to_utc_offset(0.0, week - 1) == 18.0


class TestUtcClosedLoop:
    def test_post_navigate_reports_utc(self):
        config = sg.fast_config(number_of_channels=5, ms_to_process=37000,
                                use_trop_corr=False)
        rx = np.asarray(geo2cart(np.array([47.0, 0, 0]),
                                 np.array([8.5, 0, 0]), 500.0, 4))
        t_rx0 = TOW_COUNT * 6.0 - 0.35
        ephs = visible_constellation(rx, 5, TOW_COUNT * 6.0)
        track = build_track(config, rx, ephs, t_rx0, utc=UTC)
        sol, _ = post_navigate(config, track)
        assert sol is not None
        assert sol.utc_params is not None
        assert sol.utc_params.delta_t_ls == UTC.delta_t_ls
        assert sol.week_number == 2000
        off = sol.utc_offset_s()
        want = UTC.gps_to_utc_offset(sol.tow + sol.first_epoch_ms / 1000.0,
                                     2000)
        assert off == pytest.approx(want, abs=1e-9)

    def test_warm_start_persistence(self, tmp_path):
        """save_ephemerides(utc=...) -> load_utc roundtrip."""
        path = str(tmp_path / "eph.npz")
        ephs = [None] * 32
        ephs[3] = circular_eph(t_oe=12345 * 6.0)
        save_ephemerides(path, ephs, utc=UTC)
        back = load_utc(path)
        assert back is not None
        assert back.a0 == pytest.approx(UTC.a0, rel=1e-12)
        assert back.delta_t_ls == UTC.delta_t_ls
        assert isinstance(back.delta_t_ls, int)
        assert load_ephemerides(path)[3] is not None
