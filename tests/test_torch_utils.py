"""The port's utils (sslap_tpu_torch.utils) against the reference's
(sslap_tpu.utils): snapshots cross between the packages both ways, and
the torch.profiler trace and the liveness probe work on the CPU (the
span recorder's tests are ``test_torch_tracing.py``)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sslap_tpu.utils import checkpoint as RCK
from sslap_tpu_torch.utils import device_alive, load_state, \
    profile_trace, save_state, trace_annotation
from sslap_tpu_torch.utils import checkpoint as PCK
from sslap_tpu_torch.utils import liveness as PLV


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshot_crosses_between_packages(tmp_path, dtype, direction):
    prices = (np.random.default_rng(1).random(17) * 100).astype(dtype)
    kw = dict(eps=0.25, rounds=123, phases=4, extra={"tag": "frame-7"})
    save, load = ((RCK.save_state, load_state)
                  if direction == "ref_to_port"
                  else (save_state, RCK.load_state))
    path = save(tmp_path / "snap.npz", prices, **kw)
    got, meta = load(path)
    assert got.dtype == prices.dtype
    np.testing.assert_array_equal(got, prices)
    assert meta == {"version": 1, "eps": 0.25, "rounds": 123, "phases": 4,
                    "extra": {"tag": "frame-7"}}
    assert PCK._FORMAT_VERSION == RCK._FORMAT_VERSION


def test_snapshot_of_a_tensor_and_the_version_error(tmp_path):
    p = save_state(tmp_path / "t.npz", torch.arange(5, dtype=torch.float32))
    np.testing.assert_array_equal(RCK.load_state(p)[0],
                                  np.arange(5, dtype=np.float32))
    bad = tmp_path / "v2.npz"
    np.savez(bad, prices=np.zeros(3), meta=json.dumps({"version": 2}))
    for load in (load_state, RCK.load_state):
        with pytest.raises(ValueError, match="unsupported checkpoint "
                                             "version: 2"):
            load(bad)


def test_profile_trace_holds_the_annotation(tmp_path):
    with profile_trace(str(tmp_path / "tr")):
        with trace_annotation("sslap_candidates_probe"):
            torch.arange(1000).float().sum()
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "sslap_candidates_probe" in names


def test_device_alive_runs_the_probe_in_a_subprocess(monkeypatch):
    monkeypatch.setattr(PLV, "_PROBE_CODE",
                        "import os; print('ok', os.getpid())\n")
    assert device_alive(wait_s=60) is True
    lines = []
    monkeypatch.setattr(PLV, "_PROBE_CODE", "import time; time.sleep(30)\n")
    assert device_alive(wait_s=0.5, log=lines.append) is False
    assert lines and "no answer within 0.5 s" in lines[0]
    monkeypatch.setattr(PLV, "_PROBE_CODE", "raise SystemExit(4)\n")
    assert device_alive(wait_s=60, log=lines.append) is False
    assert "exit code 4" in lines[-1]


def test_device_alive_answers_for_this_machine():
    """The real probe: True exactly when torch sees a card here."""
    os.environ.pop("SSLAP_TPU_DEVICE_WAIT_S", None)
    assert device_alive(wait_s=120) is torch.cuda.is_available()
