"""chip_smoke.py and bench.py: no result without a GPU; the parity phases
at small sizes here, and at the reference widths on a card (``gpu``)."""

import pytest

import bench
import chip_smoke
import softgnss_tpu as sg


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_correlator_parity_small():
    r = chip_smoke.correlator_parity(sg.fast_config(number_of_channels=4))
    assert r["precision"] == ["(Precision.HIGHEST, Precision.HIGHEST)"]
    assert r["onehot_vs_gather_maxdev"] < chip_smoke.IMPL_MAXDEV_TOL
    assert r["onehot_oracle_ip_rms"] < chip_smoke.ORACLE_RMS_TOL


def test_acquisition_parity_small():
    r = chip_smoke.acquisition_parity(sg.fast_config())
    assert r["prns"] == [3, 12, 19, 27]
    assert r["metric_rel_dev"] < chip_smoke.ACQ_METRIC_TOL


@pytest.mark.gpu
def test_correlator_parity_reference_widths(gpu):
    chip_smoke.correlator_parity(sg.default_config(number_of_channels=12))


@pytest.mark.gpu
def test_acquisition_parity_reference_widths(gpu):
    chip_smoke.acquisition_parity(sg.default_config())
