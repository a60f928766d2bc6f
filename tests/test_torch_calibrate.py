"""The port's auto-mode calibration (sslap_tpu_torch.calibrate), after the
reference's tests of ``sslap_tpu.calibrate`` (``tests/test_r3_fixes.py``):
the default without the switch, the forced measurement and its disk
cache, the device half's subprocess falling back, with a warning, where
it fails, and mode='auto' routing through ``crossover()``."""

import json
import socket

import numpy as np
import pytest

import sslap_tpu.calibrate as RCAL
import sslap_tpu_torch as P
import sslap_tpu_torch.calibrate as CAL
from sslap_tpu_torch import hybrid as PH


@pytest.fixture
def cal(tmp_path, monkeypatch):
    """calibrate with a fresh process cache and its disk cache in
    tmp_path; the switch off."""
    monkeypatch.delenv("SSLAP_TPU_CALIBRATE", raising=False)
    monkeypatch.setattr(CAL, "_cached", None)
    monkeypatch.setattr(CAL, "_cache_path",
                        lambda: str(tmp_path / "calib.json"))
    return CAL


def _fake_device(monkeypatch, kind="Fake_Card", ns=None):
    ns = CAL.REF_GATHER_NS if ns is None else ns
    monkeypatch.setattr(CAL, "_DEVICE_CODE",
                        f"print('CALIB_OK', {kind!r}, {ns!r})\n")


def test_default_without_the_switch(cal):
    assert cal.crossover() == cal.DEFAULT_CROSSOVER == 500_000
    assert cal._cached is None               # the default is not latched


def test_forced_crossover_is_measured_and_cached(cal, monkeypatch, tmp_path):
    _fake_device(monkeypatch)
    x = cal.crossover(force=True)
    assert 10_000 <= x <= 50_000_000
    blob = json.loads((tmp_path / "calib.json").read_text())
    assert blob["key"] == socket.gethostname()
    assert blob["crossover"] == x and blob["device_kind"] == "Fake_Card"
    host = blob["host_bids_per_s"]
    if PH.native_available():
        assert host > 0
        # the formula, at the reference gather constant
        want = 500_000 * host / cal.REF_HOST_BIDS_PER_S
        assert x == int(np.clip(want, 10_000, 50_000_000))
    # the disk cache answers next (no measurement: a failing device code
    # would warn)
    monkeypatch.setattr(cal, "_cached", None)
    monkeypatch.setattr(cal, "_DEVICE_CODE", "raise SystemExit(3)\n")
    monkeypatch.setenv("SSLAP_TPU_CALIBRATE", "1")
    assert cal.crossover() == x
    # unset switch: the default, and nothing latched
    monkeypatch.setattr(cal, "_cached", None)
    monkeypatch.delenv("SSLAP_TPU_CALIBRATE")
    assert cal.crossover() == cal.DEFAULT_CROSSOVER
    assert cal._cached is None
    monkeypatch.setenv("SSLAP_TPU_CALIBRATE", "1")
    assert cal.crossover() == x


def test_cache_of_another_host_is_remeasured(cal, monkeypatch, tmp_path):
    (tmp_path / "calib.json").write_text(json.dumps(
        {"key": "another-host", "crossover": 12_345}))
    _fake_device(monkeypatch, ns=cal.REF_GATHER_NS * 2)
    monkeypatch.setenv("SSLAP_TPU_CALIBRATE", "1")
    x = cal.crossover()
    assert x != 12_345
    assert json.loads((tmp_path / "calib.json").read_text())["key"] == \
        socket.gethostname()


def test_gather_scales_the_crossover(cal, monkeypatch):
    if not PH.native_available():
        pytest.skip("needs the native host runtime (g++)")
    monkeypatch.setattr(cal, "measure_host_rate",
                        lambda: cal.REF_HOST_BIDS_PER_S)
    _fake_device(monkeypatch, ns=cal.REF_GATHER_NS * 3)
    assert cal.crossover(force=True) == 1_500_000
    _fake_device(monkeypatch, ns=cal.REF_GATHER_NS / 1000)
    assert cal.crossover(force=True) == 10_000          # clipped


def test_device_timeout_falls_back_with_a_warning(cal, monkeypatch):
    monkeypatch.setenv("SSLAP_TPU_CALIBRATE_TIMEOUT", "0.001")
    with pytest.warns(RuntimeWarning, match="no answer within"):
        kind, ns = cal._measure_device()
    assert (kind, ns) == ("nodevice", cal.REF_GATHER_NS)
    with pytest.warns(RuntimeWarning, match="device measurement failed"):
        x = cal.crossover(force=True)
    assert 10_000 <= x <= 50_000_000


def test_device_failure_is_named_in_the_warning(cal, monkeypatch):
    monkeypatch.setattr(cal, "_DEVICE_CODE",
                        "raise RuntimeError('no card here')\n")
    with pytest.warns(RuntimeWarning, match="no card here"):
        assert cal._measure_device() == ("nodevice", cal.REF_GATHER_NS)


def test_device_code_imports_the_port_from_its_checkout(cal, monkeypatch):
    """The subprocess finds sslap_tpu_torch whatever the caller's path."""
    monkeypatch.delenv("PYTHONPATH", raising=False)
    monkeypatch.chdir("/")
    monkeypatch.setattr(cal, "_DEVICE_CODE", (
        "import sslap_tpu_torch.calibrate as c\n"
        "print('CALIB_OK', 'Imported', c.DEFAULT_CROSSOVER)\n"))
    assert cal._measure_device() == ("Imported", 500_000.0)


def test_measure_gather_ns_times_a_card_only():
    with pytest.raises(RuntimeError, match="CUDA"):
        CAL.measure_gather_ns("cpu")


def test_host_rate_and_cache_file_are_the_ports_own():
    if PH.native_available():
        assert CAL.measure_host_rate() > 0
    assert CAL._cache_path() != RCAL._cache_path()
    assert CAL.DEFAULT_CROSSOVER == RCAL.DEFAULT_CROSSOVER


@pytest.mark.parametrize("cross,mode", [(40, "hybrid"), (41, "cpu")])
def test_auto_mode_routes_through_crossover(monkeypatch, cross, mode):
    if not PH.native_available():
        pytest.skip("without the native runtime 'auto' is 'device'")
    monkeypatch.setattr(CAL, "crossover", lambda force=False: cross)
    rng = np.random.default_rng(0)
    C = rng.integers(1, 100, (40, 40))
    res = P.AuctionSolver(C, mode="auto", device="cpu").solve()
    assert res["meta"]["mode"] == mode and res["meta"]["soln_found"]
