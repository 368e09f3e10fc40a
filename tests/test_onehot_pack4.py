"""The one-hot tracker on the int32-packed capture view (track_pack_size=4).

Four samples per capture word put every tile in byte-plane order four
real samples apart, the widest one-hot window of the supported packings.
These are the properties the tracker must keep there: a bit-exact resume,
frozen inactive channels, multi-ms coherent accumulation, and parity with
the float64 oracle.
"""

import numpy as np
import pytest

import softgnss_tpu as sg
from softgnss_tpu.acquire.search import Channels
from softgnss_tpu.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu.track import track


@pytest.fixture(scope="module")
def setup():
    cfg = sg.fast_config(number_of_channels=3, track_block_ms=16,
                         track_pack_size=4)
    assert cfg.track_pack == 4
    rng = np.random.default_rng(7)
    params = [(5, 1200.0, 333, 0.4), (11, -2500.0, 1777, 2.1),
              (20, 400.0, 40, 5.0)]
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=float(s),
                            phase0=ph,
                            nav_bits=tuple(rng.choice([-1, 1], size=8)))
            for p, d, s, ph in params]
    signal = synthesize_signal(cfg, sats, 100, noise_std=0.8, seed=4)
    channels = Channels(
        prn=np.asarray([p for p, *_ in params]),
        acquired_freq=np.asarray(
            [cfg.intermediate_freq + d for _, d, _, _ in params]),
        code_phase=np.asarray([s for _, _, s, _ in params], np.int64),
        status=["T"] * 3)
    return cfg, signal, channels


def test_resume_bit_exact(setup):
    """A split run (two track() calls through the saved state) equals the
    uninterrupted run bit for bit.  Split off the block grid, the lead
    segment is its own compilation: correlators and integer observables
    stay bit-exact, the f64 loop-filter streams agree to ~1 ulp."""
    cfg, signal, channels = setup
    full = track(cfg, signal, channels, n_ms=80)
    fields = ("i_p", "q_p", "absolute_sample", "sample_frac", "carr_freq",
              "code_freq", "dll_discr_filt", "pll_discr_filt")
    for n_first, exact in ((32, fields), (37, fields[:4])):
        first = track(cfg, signal, channels, n_ms=n_first)
        second = track(cfg, signal, channels, n_ms=80 - n_first,
                       state=first.final_state)
        for f in fields:
            a = np.asarray(getattr(full, f))
            b = np.concatenate([np.asarray(getattr(first, f)),
                                np.asarray(getattr(second, f))], axis=1)
            if f in exact:
                np.testing.assert_array_equal(a, b, err_msg=f"{f} @ {n_first}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{f} @ {n_first}")


def test_inactive_channel_frozen(setup):
    cfg, signal, channels = setup
    ch = Channels(prn=channels.prn.copy(),
                  acquired_freq=channels.acquired_freq.copy(),
                  code_phase=channels.code_phase.copy(),
                  status=["T", "-", "T"])
    res = track(cfg, signal, ch, n_ms=48)
    assert (res.i_p[1] == 0).all()
    assert (res.absolute_sample[1] == 0).all()
    st = res.final_state
    assert int(st.ms[1]) == 0
    assert float(st.carr_nco[1]) == 0.0
    assert int(st.ptr[1]) == int(channels.code_phase[1])
    assert (res.i_p[[0, 2]] != 0).any(axis=1).all()


def test_pdi_accumulation(setup):
    """pdi_ms=2 on the packed view: the filters update every second code
    period from the accumulated sums, matching the plain gather path."""
    cfg, signal, channels = setup
    c2 = cfg.with_options(pdi_ms=2)
    res_oh = track(c2, signal, channels, n_ms=64)
    res_ga = track(c2.with_options(correlator_impl="gather"),
                   signal, channels, n_ms=64)
    np.testing.assert_array_equal(res_oh.absolute_sample,
                                  res_ga.absolute_sample)
    a, b = res_oh.pll_discr_filt, res_ga.pll_discr_filt
    assert np.max(np.abs(a - b)) < 1e-4 * max(1.0, np.max(np.abs(b)))
    # filters hold between the every-K updates (K=2: ms 0 keeps the
    # initial zero filter state, ms 1 is the first update)
    assert (res_oh.pll_discr[:, 0] == 0).all()
    assert not (res_oh.pll_discr[:, 1] == 0).all()
    changes = np.flatnonzero(np.diff(res_oh.carr_freq[0]) != 0)
    assert np.all(changes % 2 == 0), changes[:10]


def test_oracle_parity(setup):
    """<1e-3 RMS correlator deviation vs the float64 NumPy oracle, and
    sample counters within the inherent one-sample quantization."""
    from softgnss_tpu.oracle import oracle_track_channel

    cfg, signal, channels = setup
    res = track(cfg, signal, channels, n_ms=60)
    for c in range(3):
        orc = oracle_track_channel(
            cfg, signal, int(channels.prn[c]),
            float(channels.acquired_freq[c]),
            int(channels.code_phase[c]), 60)
        scale = np.sqrt(np.mean(orc["i_p"] ** 2))
        i_p = np.asarray(res.i_p[c], np.float64)
        assert np.sqrt(np.mean((i_p - orc["i_p"]) ** 2)) / scale < 1e-3
        assert np.max(np.abs(np.asarray(res.absolute_sample[c])
                             - orc["absolute_sample"])) <= 1
