"""Observables-level navigation integration: fabricated tracking output
(I_P nav-bit stream + absolute_sample counters consistent with a known
receiver position and satellite constellation) -> post_navigate recovers
the position.

This exercises preamble sync, parity, ephemeris decode, pseudoranges,
Kepler propagation, and the epoch-scan PVT without the RF/tracking layer
(that closed loop lives in tests/test_end_to_end.py).
"""

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.nav.geodesy import e_r_corr, geo2cart
from softgnss_tpu.nav.message import build_nav_stream
from softgnss_tpu.nav.orbit import satellite_positions
from softgnss_tpu.nav.preamble import find_preambles
from softgnss_tpu.nav.pvt import SPEED_OF_LIGHT
from softgnss_tpu.nav.solve import post_navigate
from test_geodesy_pvt import circular_eph

TOW_COUNT = 70000          # multiple of 5 -> frames start here
N_MS = 37000


def visible_constellation(rx, n_sats, t):
    """Circular-orbit ephemerides whose satellites sit above 15 deg at rx."""
    from softgnss_tpu.nav.geodesy import topocent

    ephs = []
    lat = np.deg2rad(47.0)
    rng = np.random.default_rng(11)
    # scatter node/anomaly so satellites land around the sky above rx
    trial = 0
    while len(ephs) < n_sats and trial < 400:
        trial += 1
        eph = circular_eph(
            i_0=float(rng.uniform(0.8, 1.1)),
            omega_0=float(rng.uniform(0, 2 * np.pi)),
            m_0=float(rng.uniform(0, 2 * np.pi)),
            t_oe=float(TOW_COUNT * 6),
        )
        pos, _ = satellite_positions(t, [eph])
        _, el, _ = topocent(rx, pos[:, 0] - rx)
        if float(el) > 20.0:
            ephs.append(eph)
    assert len(ephs) == n_sats, "constellation generation failed"
    return ephs


def travel_times(rx, eph, t_tx):
    """Signal flight time(s) from satellite (at transmit times) to rx, with
    earth-rotation correction — the same model the PVT solver inverts.
    Vectorized NumPy (uses the independent orbit oracle)."""
    from test_geodesy_pvt import numpy_satpos_oracle

    t_tx = np.atleast_1d(np.asarray(t_tx, np.float64))
    pos, _ = numpy_satpos_oracle(t_tx, eph)       # (3, T)
    tau = np.full(t_tx.shape, 0.07)
    w = 7.292115147e-5
    for _ in range(4):
        ang = w * tau
        rot = np.stack([np.cos(ang) * pos[0] + np.sin(ang) * pos[1],
                        -np.sin(ang) * pos[0] + np.cos(ang) * pos[1],
                        pos[2]])
        tau = np.linalg.norm(rot - rx[:, None], axis=0) / SPEED_OF_LIGHT
    return tau


def travel_time(rx, eph, t_tx):
    return float(travel_times(rx, eph, t_tx)[0])


class FakeTrack:
    pass


def build_track(config, rx, ephs, t_rx0, utc=None, almanac=None):
    """Fabricate TrackResults-like observables for the given geometry.

    ``t_rx0``: GPS time at tracked millisecond 0.  For channel i, the nav
    bit with index b (stream starts one subframe before TOW_COUNT) begins
    arriving at GPS time (TOW_COUNT-1)*6 + 0.02*b + tau_i.
    """
    c = len(ephs)
    n_bits = N_MS // 20 + 400
    t_bits0 = (TOW_COUNT - 1) * 6.0

    i_p = np.zeros((c, N_MS))
    absolute_sample = np.zeros((c, N_MS))
    carr_freq = np.zeros((c, N_MS))
    fs = config.sampling_freq
    cfg_l1_if = (config.intermediate_freq, config.l1_freq)
    amp = 5000.0
    m = np.arange(N_MS)

    for ch, eph in enumerate(ephs):
        stream = build_nav_stream(eph, TOW_COUNT - 1, n_bits // 300 + 2,
                                  utc=utc, almanac=almanac)
        tau0 = travel_time(rx, eph, t_rx0)
        # transmit times of the code periods logged at each ms.  A
        # code-locked tracker's period boundaries sit on the satellite's
        # own 1-ms code-epoch grid (integer ms of GPS time here), so anchor
        # there; 1-period lag like the reference's fid.tell() bookkeeping.
        t_anchor = np.floor((t_rx0 - tau0) * 1000.0) / 1000.0
        t_tx = t_anchor + (m + 1) * 1e-3
        tau = travel_times(rx, eph, t_tx)
        absolute_sample[ch] = (t_tx + tau - t_rx0) * fs
        bit_idx = np.floor((t_tx - 1e-3 / 2 - t_bits0) / 0.02).astype(np.int64)
        i_p[ch] = amp * stream[bit_idx % len(stream)]
        # Doppler-consistent carrier frequency history (for Hatch smoothing)
        dtau = np.gradient(tau) / 1e-3
        carr_freq[ch] = cfg_l1_if[0] - cfg_l1_if[1] * dtau

    track = FakeTrack()
    track.i_p = i_p
    track.absolute_sample = absolute_sample
    track.carr_freq = carr_freq
    track.status = ["T"] * c
    track.prn = np.arange(1, c + 1)
    return track


@pytest.fixture(scope="module")
def nav_case():
    config = sg.fast_config(number_of_channels=5, ms_to_process=N_MS,
                            use_trop_corr=False)
    rx = np.asarray(geo2cart(np.array([47.0, 0, 0]), np.array([8.5, 0, 0]), 500.0, 4))
    t_rx0 = TOW_COUNT * 6.0 - 0.35      # first preamble arrives ~350 ms in
    ephs = visible_constellation(rx, 5, TOW_COUNT * 6.0)
    track = build_track(config, rx, ephs, t_rx0)
    return config, rx, ephs, track, t_rx0


class TestPreambleSync:
    def test_finds_subframe_starts(self, nav_case):
        config, rx, ephs, track, t_rx0 = nav_case
        first, active = find_preambles(track.i_p, track.status)
        assert len(active) == len(ephs)
        for ch in active:
            # expected arrival ms of the TOW_COUNT subframe's first bit
            tau = travel_time(rx, ephs[ch], TOW_COUNT * 6.0)
            expect = (TOW_COUNT * 6.0 + tau - t_rx0) * 1000.0
            assert abs(first[ch] - expect) <= 1.5

    def test_no_preamble_in_noise(self, rng):
        i_p = rng.normal(size=(2, 8000))
        first, active = find_preambles(i_p, ["T", "T"])
        assert active.size == 0
        assert np.all(first == 0)


class TestPostNavigate:
    def test_recovers_receiver_position(self, nav_case):
        config, rx, ephs, track, _ = nav_case
        sol, eph_by_prn = post_navigate(config, track)
        assert sol is not None
        assert sol.tow == TOW_COUNT * 6
        assert sol.n_epochs >= 70
        ok = np.isfinite(sol.x)
        assert ok.all()
        err = np.sqrt((sol.x - rx[0]) ** 2 + (sol.y - rx[1]) ** 2 + (sol.z - rx[2]) ** 2)
        # absolute_sample carries exact (float) boundary times here; the
        # residual is broadcast-ephemeris quantization (~0.1 m ranges)
        # amplified by DOP
        assert np.max(err) < 5.0
        assert np.std(err) < 1.0
        assert np.all(np.isfinite(sol.dt))
        assert np.all(sol.dop[0][ok] > 0)
        assert eph_by_prn[0] is not None and eph_by_prn[0].complete
        assert np.isfinite(sol.e).all() and np.isfinite(sol.n).all()
        assert sol.utm_zone == 32
        lat_err = abs(sol.latitude - 47.0).max()
        assert lat_err < 1e-6

    def test_elevation_mask_and_el_az_ranges(self, nav_case):
        config, rx, ephs, track, _ = nav_case
        sol, _ = post_navigate(config, track)
        el = sol.el[np.isfinite(sol.el)]
        az = sol.az[np.isfinite(sol.az)]
        assert np.all(el >= config.elevation_mask_deg)
        assert np.all((az >= 0) & (az < 360))

    def test_velocity_solution_static_receiver(self, nav_case):
        """Doppler-based velocity (beyond the reference): a static receiver
        with exact fabricated observables solves to ~cm/s."""
        config, rx, ephs, track, _ = nav_case
        sol, _ = post_navigate(config, track)
        v = np.sqrt(sol.vx**2 + sol.vy**2 + sol.vz**2)
        ok = np.isfinite(v)
        assert ok.sum() >= 0.9 * sol.n_epochs
        assert np.median(v[ok]) < 0.05            # m/s
        assert np.nanmax(np.abs(sol.clock_drift[ok])) < 0.1

    def test_carrier_smoothing_cuts_code_noise(self, nav_case):
        """Hatch filter: with white code noise on the sample counters, the
        carrier-smoothed solution scatter shrinks ~sqrt(window)."""
        config, rx, ephs, track, _ = nav_case
        noisy = FakeTrack()
        rng = np.random.default_rng(5)
        noisy.i_p = track.i_p
        noisy.absolute_sample = (track.absolute_sample
                                 + rng.normal(0, 2.0, track.absolute_sample.shape))
        noisy.carr_freq = track.carr_freq
        noisy.status = track.status
        noisy.prn = track.prn

        def scatter(sol):
            ok = np.isfinite(sol.x)
            e = np.sqrt((sol.x[ok] - rx[0]) ** 2 + (sol.y[ok] - rx[1]) ** 2
                        + (sol.z[ok] - rx[2]) ** 2)
            return np.median(e)

        raw_sol, _ = post_navigate(config, noisy)
        sm_sol, _ = post_navigate(
            config.with_options(carrier_smoothing_epochs=20), noisy)
        raw_err, sm_err = scatter(raw_sol), scatter(sm_sol)
        assert sm_err < 0.5 * raw_err, (raw_err, sm_err)

    def test_calculate_pseudoranges_matches_epoch_scan(self, nav_case):
        """The reference-parity API (postNavigation.py:27-72) agrees with
        the raw pseudoranges the jitted epoch scan computes at epoch 0."""
        from softgnss_tpu.nav.solve import calculate_pseudoranges

        config, rx, ephs, track, _ = nav_case
        sol, _ = post_navigate(config, track)
        active = np.flatnonzero(sol.prn[:, 0] > 0)
        assert active.size >= 4
        p = calculate_pseudoranges(config, np.asarray(track.absolute_sample),
                                   sol.first_subframe, active)
        np.testing.assert_allclose(p[active], sol.raw_p[active, 0],
                                   rtol=0, atol=1e-6)
        # sanity: plausible GPS ranges and finite only on active channels
        assert np.all((p[active] > 1.8e7) & (p[active] < 3e7))

    def test_lock_demotion_excludes_corrupt_tail(self, nav_case):
        """A channel flagged by lock demotion is excluded from every epoch
        at/after its loss ms: corrupting its observables there must not
        touch the solution; with demotion disabled the same corruption
        blows the fix up (the reference's failure mode)."""
        config, rx, ephs, track, _ = nav_case
        loss_ms = 20000.0
        bad = FakeTrack()
        bad.i_p = track.i_p
        bad.carr_freq = track.carr_freq
        bad.status = track.status
        bad.prn = track.prn
        bad.absolute_sample = track.absolute_sample.copy()
        bad.absolute_sample[0, int(loss_ms):] += 300.0      # ~22 km range error
        bad.lock_loss_ms = np.asarray([loss_ms, np.inf, np.inf, np.inf, np.inf])

        # Hatch smoothing would drag pre-corruption epochs toward the
        # corrupt code ranges; disable to isolate the demotion mask
        cfg = config.with_options(carrier_smoothing_epochs=1)
        sol, _ = post_navigate(cfg, bad)
        err = np.sqrt((sol.x - rx[0]) ** 2 + (sol.y - rx[1]) ** 2
                      + (sol.z - rx[2]) ** 2)
        assert np.isfinite(err).all()
        assert np.max(err) < 5.0
        # demoted channel contributes no elevations/pseudoranges after loss
        late = np.flatnonzero(sol.first_subframe[0]
                              + cfg.nav_sol_period_ms * np.arange(sol.n_epochs)
                              >= loss_ms)
        assert late.size > 0
        assert np.all(np.isnan(sol.el[0, late]))
        assert np.all(np.isnan(sol.raw_p[0, late]))

        # with demotion off, RAIM is the next line of defense: the 22 km
        # fault is detected (not isolable at 5 satellites) and the
        # affected epochs are withheld rather than reported wrong
        sol_raim, _ = post_navigate(cfg.with_options(lock_demotion=False), bad)
        assert np.all(sol_raim.raim_flag[late] == 2)
        assert np.all(np.isnan(sol_raim.x[late]))

        # with BOTH defenses off: the reference's failure mode — the
        # corrupt channel silently blows the fix up
        sol_off, _ = post_navigate(
            cfg.with_options(lock_demotion=False, raim=False), bad)
        err_off = np.sqrt((sol_off.x - rx[0]) ** 2 + (sol_off.y - rx[1]) ** 2
                          + (sol_off.z - rx[2]) ** 2)
        assert np.nanmax(err_off) > 1000.0

    def test_too_short_record(self, nav_case):
        config, rx, ephs, track, _ = nav_case
        short = FakeTrack()
        short.i_p = track.i_p[:, :10000]
        short.absolute_sample = track.absolute_sample[:, :10000]
        short.status = track.status
        short.prn = track.prn
        sol, _ = post_navigate(config, short)
        assert sol is None

    def test_navigation_plot_renders(self, nav_case, tmp_path):
        config, rx, ephs, track, _ = nav_case
        sol, _ = post_navigate(config, track)
        from softgnss_tpu.plots import plot_navigation
        path = plot_navigation(config, sol, out_dir=str(tmp_path))
        import os
        assert os.path.getsize(path) > 10000

    def test_too_few_channels(self, nav_case):
        config, rx, ephs, track, _ = nav_case
        few = FakeTrack()
        few.i_p = track.i_p
        few.absolute_sample = track.absolute_sample
        few.status = ["T", "T", "T", "-", "-"]
        few.prn = track.prn
        sol, _ = post_navigate(config, few)
        assert sol is None
