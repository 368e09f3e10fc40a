"""Tracking tests: lock onto synthetic signals; parity vs the float64 oracle."""

import numpy as np
import pytest

from softgnss_tpu import fast_config
from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.oracle import oracle_track_channel
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track import track

N_MS = 400


@pytest.fixture(scope="module")
def cfg():
    return fast_config(number_of_channels=2)


@pytest.fixture(scope="module")
def setup(cfg):
    nav_bits = tuple((-1) ** i for i in range(40))  # alternating bits, worst case
    sats = [
        SatelliteSignal(prn=9, doppler_hz=1200.0, delay_samples=500.0, amplitude=1.0,
                        phase0=1.0, nav_bits=nav_bits),
        SatelliteSignal(prn=23, doppler_hz=-800.0, delay_samples=2000.0, amplitude=1.1,
                        phase0=2.5, nav_bits=nav_bits),
    ]
    signal = synthesize_signal(cfg, sats, N_MS + 3, noise_std=1.0, seed=11)
    # hand tracking the exact truth (as the reference gets it from acquisition)
    channels = Channels(
        prn=np.array([9, 23], np.int64),
        acquired_freq=np.array([cfg.intermediate_freq + 1200.0,
                                cfg.intermediate_freq - 800.0]),
        code_phase=np.array([500, 2000], np.int64),
        status=["T", "T"],
    )
    return sats, signal, channels


def test_tracking_locks_and_recovers_bits(cfg, setup):
    sats, signal, channels = setup
    res = track(cfg, signal, channels, n_ms=N_MS)
    assert res.i_p.shape == (2, N_MS)

    for c, sat in enumerate([s for s in sats]):
        # PLL locked: carrier freq near truth after settling
        truth_freq = cfg.intermediate_freq + sat.doppler_hz
        settled = res.carr_freq[c, 100:]
        assert abs(np.median(settled) - truth_freq) < 15.0
        # code freq near Doppler-consistent chipping rate
        # (the 2 Hz DLL settles slowly; judge the last 100 ms)
        truth_code = sat.effective_code_freq(cfg)
        assert abs(np.median(res.code_freq[c, -100:]) - truth_code) < 2.0
        # nav bits on I_P: sign flips every 20 ms (alternating bits), and
        # magnitude well above Q_P after lock
        ip = res.i_p[c, 100:]
        qp = res.q_p[c, 100:]
        assert np.mean(np.abs(ip)) > 4 * np.mean(np.abs(qp))
        # 20-ms bit structure: within-bit sign constancy
        bits = np.sign(ip[: (len(ip) // 20) * 20].reshape(-1, 20))
        consistency = np.abs(bits.sum(axis=1)) == 20
        assert consistency.mean() > 0.95


def test_absolute_sample_progression(cfg, setup):
    _, signal, channels = setup
    res = track(cfg, signal, channels, n_ms=N_MS)
    for c in range(2):
        diffs = np.diff(res.absolute_sample[c])
        spc = cfg.samples_per_code
        assert np.all(np.abs(diffs - spc) <= 2), "block sizes wander too far"
        assert res.absolute_sample[c, 0] >= channels.code_phase[c]


def test_parity_vs_float64_oracle(cfg, setup):
    """<1e-3 RMS correlator deviation vs the reference-math oracle (BASELINE.md)."""
    sats, signal, channels = setup
    res = track(cfg, signal, channels, n_ms=N_MS)
    for c, sat in enumerate(sats):
        ora = oracle_track_channel(cfg, signal, sat.prn,
                                   float(channels.acquired_freq[c]),
                                   int(channels.code_phase[c]), N_MS)
        scale = np.sqrt(np.mean(ora["i_p"] ** 2))
        for key in ("i_p", "q_p", "i_e", "i_l", "q_e", "q_l"):
            dev = np.sqrt(np.mean((res.__dict__[key][c] - ora[key]) ** 2)) / scale
            assert dev < 1e-3, f"{key} RMS deviation {dev:.2e}"
        # absolute sample counters must agree to within a sample
        assert np.max(np.abs(res.absolute_sample[c] - ora["absolute_sample"])) <= 1
        # loop-frequency trajectories
        assert np.max(np.abs(res.carr_freq[c] - ora["carr_freq"])) < 0.5
        assert np.max(np.abs(res.code_freq[c] - ora["code_freq"])) < 0.05


def test_frame_offset_beyond_table_coverage_is_flagged(cfg, setup):
    """A frame whose ms starts more than 2*track_frame_pre samples in is
    outside the one-hot tables' sub-chip shift coverage: the correlators
    would silently drop in-window samples, so the overflow channel must
    flag it (it used to fire only when the span left the window)."""
    import jax.numpy as jnp

    from softgnss_tpu.track.scan import (_frame_ms_packed, _packed_view,
                                         initial_state)
    from softgnss_tpu.track.tables import build_tables

    _, signal, channels = setup
    tables = build_tables(cfg, np.asarray(channels.prn),
                          np.asarray(channels.acquired_freq))
    st = initial_state(cfg, channels)
    pk = cfg.track_pack
    sig_pack = _packed_view(jnp.asarray(signal), pk)
    tab0 = __import__("jax").tree.map(lambda x: jnp.asarray(x)[0], tables)
    st0 = __import__("jax").tree.map(lambda x: x[0], st)

    def ovf_at(o):
        base = (int(st0.ptr) - o) // pk * pk
        frame = sig_pack[base // pk: base // pk + cfg.track_window // pk]
        _, _, ovf = _frame_ms_packed(cfg, frame, jnp.int64(base), tab0,
                                     jnp.float64(channels.acquired_freq[0]),
                                     jnp.bool_(True), st0)
        return int(ovf)

    assert ovf_at(2 * cfg.track_frame_pre - 2) == 0       # covered offset
    assert ovf_at(2 * cfg.track_frame_pre + 20) > 0       # beyond coverage


def test_pdi_parity_vs_oracle(cfg, setup):
    """Coherent integration (pdi_ms=4, beyond the reference's fixed 1 ms):
    the every-4-periods filter cadence matches the float64 oracle running
    the same accumulate-then-update math."""
    sats, signal, channels = setup
    c4 = cfg.with_options(pdi_ms=4)
    res = track(c4, signal, channels, n_ms=200)
    for c, sat in enumerate(sats):
        ora = oracle_track_channel(c4, signal, sat.prn,
                                   float(channels.acquired_freq[c]),
                                   int(channels.code_phase[c]), 200)
        scale = np.sqrt(np.mean(ora["i_p"] ** 2))
        for key in ("i_p", "q_p", "i_e", "i_l"):
            dev = np.sqrt(np.mean((res.__dict__[key][c] - ora[key]) ** 2)) / scale
            assert dev < 1e-3, f"{key} RMS deviation {dev:.2e}"
        assert np.max(np.abs(res.absolute_sample[c] - ora["absolute_sample"])) <= 1
        assert np.max(np.abs(res.carr_freq[c] - ora["carr_freq"])) < 0.5
    # frequencies hold between updates (at ms = 3 mod 4): the diff from
    # ms m to m+1 is nonzero only when m+1 is an update step
    changes = np.flatnonzero(np.diff(res.carr_freq[0]) != 0)
    assert np.all(changes % 4 == 2), changes[:10]


def test_pdi_resume_matches_uninterrupted(cfg, setup):
    """The coherent accumulators ride the state carry: a split run (the
    split NOT on a PDI boundary) equals the uninterrupted run."""
    _, signal, channels = setup
    c5 = cfg.with_options(pdi_ms=5)
    full = track(c5, signal, channels, n_ms=120)
    a = track(c5, signal, channels, n_ms=63)
    b = track(c5, signal, channels, n_ms=57, state=a.final_state)
    joined = np.concatenate([a.carr_freq, b.carr_freq], axis=1)
    np.testing.assert_array_equal(joined, full.carr_freq)
    np.testing.assert_array_equal(
        np.concatenate([a.absolute_sample, b.absolute_sample], axis=1),
        full.absolute_sample)


@pytest.mark.parametrize("pack,tile", [(1, 128), (2, 128), (4, 128),
                                       (2, 64), (4, 64), (4, 32)])
def test_onehot_matches_gather_impl(cfg, setup, pack, tile):
    """The gather-free one-hot correlator computes the same sums as the
    reference-style per-sample lookup (f32 accumulation order differs),
    across capture-word packings and tile widths: every byte-plane tile
    order and one-hot window width the tables support."""
    sats, signal, channels = setup
    c = cfg.with_options(track_pack_size=pack, track_tile=tile)
    assert c.track_pack == pack
    res_oh = track(c.with_options(correlator_impl="onehot"), signal, channels, n_ms=150)
    res_ga = track(c.with_options(correlator_impl="gather"), signal, channels, n_ms=150)
    np.testing.assert_array_equal(res_oh.absolute_sample, res_ga.absolute_sample)
    for key in ("i_p", "q_p", "i_e", "i_l", "q_e", "q_l"):
        a, b = getattr(res_oh, key), getattr(res_ga, key)
        scale = np.sqrt(np.mean(b**2))
        assert np.max(np.abs(a - b)) / scale < 1e-4, key
    np.testing.assert_allclose(res_oh.carr_freq, res_ga.carr_freq, atol=1e-6)


def test_narrow_correlator_spacing(cfg, setup):
    """Non-default early/late spacings (narrow correlator) drive the same
    sums through onehot and gather (the sub-chip subdivision generalizes
    the half-chip identities)."""
    sats, signal, channels = setup
    for spacing in (0.25, 0.1):
        c = cfg.with_options(dll_correlator_spacing=spacing)
        a = track(c.with_options(correlator_impl="onehot"), signal, channels, n_ms=80)
        b = track(c.with_options(correlator_impl="gather"), signal, channels, n_ms=80)
        np.testing.assert_array_equal(a.absolute_sample, b.absolute_sample)
        for key in ("i_p", "i_e", "i_l", "q_e", "q_l"):
            x, y = getattr(a, key), getattr(b, key)
            scale = np.sqrt(np.mean(y**2))
            assert np.max(np.abs(x - y)) / scale < 1e-4, (spacing, key)


def test_irrational_spacing_rejected():
    from softgnss_tpu.track.tables import subdivision

    cfg_bad = fast_config(dll_correlator_spacing=0.123456789)
    with pytest.raises(ValueError, match="gather"):
        subdivision(cfg_bad)


def test_onehot_window_margin_at_extreme_doppler(cfg):
    """The tile-local one-hot window must hold at the Doppler band edge
    (the gather path is exact regardless, so disagreement = clipping)."""
    for doppler in (7000.0, -7000.0):
        sat = SatelliteSignal(prn=14, doppler_hz=doppler, delay_samples=900.0)
        signal = synthesize_signal(cfg, [sat], 120, noise_std=0.5, seed=2)
        channels = Channels(
            prn=np.array([14, 0], np.int64),
            acquired_freq=np.array([cfg.intermediate_freq + doppler, 0.0]),
            code_phase=np.array([900, 0], np.int64),
            status=["T", "-"])
        a = track(cfg.with_options(correlator_impl="onehot"), signal, channels, n_ms=100)
        b = track(cfg.with_options(correlator_impl="gather"), signal, channels, n_ms=100)
        scale = np.sqrt(np.mean(b.i_p[0] ** 2))
        assert np.max(np.abs(a.i_p[0] - b.i_p[0])) / scale < 1e-4, doppler


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
def test_auto_correlator_resolution(cfg, monkeypatch, backend):
    """'auto' is the one-hot contraction whatever backend JAX reports;
    explicit values pass through untouched."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert cfg.correlator_impl == "auto"
    assert cfg.resolved_correlator == "onehot"
    assert cfg.track_pack > 1
    assert cfg.with_options(
        correlator_impl="gather").resolved_correlator == "gather"
    # the packed capture view is a one-hot layout: gather reads samples
    assert cfg.with_options(correlator_impl="gather").track_pack == 1
    assert cfg.with_options(track_pack_size=1).track_pack == 1


@pytest.mark.parametrize("impl", ["pallas", "megakernel"])
def test_removed_correlators_rejected(cfg, impl):
    """Correlator names that no longer exist fail loudly, naming the
    values that remain."""
    with pytest.raises(ValueError, match="'auto', 'onehot', 'gather'"):
        cfg.with_options(correlator_impl=impl)


def test_correlator_contractions_use_highest_precision(cfg, setup):
    """Every contraction of the tracking step asks for HIGHEST precision,
    so a GPU does not run it in TF32 (whose ~5e-4 relative error per
    baseband term would break the 1e-4 oracle parity)."""
    from chip_smoke import track_dot_precisions

    _, signal, channels = setup
    assert track_dot_precisions(cfg, signal, channels, 70) == {
        "(Precision.HIGHEST, Precision.HIGHEST)"}


def test_inactive_channel_stays_silent(cfg, setup):
    _, signal, _ = setup
    channels = Channels(
        prn=np.array([9, 0], np.int64),
        acquired_freq=np.array([cfg.intermediate_freq + 1200.0, 0.0]),
        code_phase=np.array([500, 0], np.int64),
        status=["T", "-"],
    )
    res = track(cfg, signal, channels, n_ms=50)
    assert np.all(res.i_p[1] == 0)
    assert np.all(res.absolute_sample[1] == 0)
    assert np.any(res.i_p[0] != 0)
