"""Measured crossover of the auto mode.  Counterpart of
``sslap_tpu/calibrate.py``.

``mode='auto'`` sends square instances of at least ``crossover()`` rows to
the hybrid device path and everything else to the native CPU engine.  The
default, 500k rows, is the reference's.  With ``SSLAP_TPU_CALIBRATE=1``
(or ``crossover(force=True)``) the crossover is scaled by this machine's
two rates against the reference machine's:

  host rate    bids/s of the native GS on a small synthetic instance whose
               price table stays in cache (``measure_host_rate``);
  device rate  ns per random scalar gather ``prices[cols]`` on the card,
               the primitive the device pass is made of, from a two-point
               fit of R chained gathers timed with CUDA events
               (``measure_gather_ns``).

  crossover = 500k * (host_rate / REF_HOST_BIDS_PER_S)
                   * (gather_ns / REF_GATHER_NS)

A faster host moves the crossover up, a faster gather down.  The result
is cached in a JSON file keyed by hostname (its own file name, so the two
packages never read each other's numbers), so the probe runs once per
machine.  The card is measured in a subprocess under
``SSLAP_TPU_CALIBRATE_TIMEOUT`` seconds (default 120); where that fails,
the reference gather constant stands in and a RuntimeWarning names the
failure.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional

import numpy as np

# The reference machine's pair: measure_host_rate() and
# measure_gather_ns() as chip_smoke.py phase 14(e) measured them on a
# machine with one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (17,187,905 bids/s and 0.012978 ns); there the calibrated crossover
# reproduces the 500k default.
REF_HOST_BIDS_PER_S = 1.72e7      # native GS, cache-resident instance
REF_GATHER_NS = 0.0130            # prices[cols] ns a gather, 2**20 columns
DEFAULT_CROSSOVER = 500_000

_cached: Optional[int] = None

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the subprocess of _measure_device runs
_DEVICE_CODE = (
    "import torch\n"
    "from sslap_tpu_torch.calibrate import measure_gather_ns\n"
    "kind = torch.cuda.get_device_name(0)\n"
    "print('CALIB_OK', kind.replace(' ', '_'), measure_gather_ns())\n")


def _cache_path() -> str:
    return os.path.join(tempfile.gettempdir(), "sslap_tpu_torch_calib.json")


def _measure_device() -> tuple:
    """(device name, gather ns) measured in a subprocess under the
    timeout; ("nodevice", REF_GATHER_NS) and a RuntimeWarning where that
    fails (no card, a timeout, an error)."""
    timeout = float(os.environ.get("SSLAP_TPU_CALIBRATE_TIMEOUT", "120"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        out = subprocess.run([sys.executable, "-c", _DEVICE_CODE],
                             capture_output=True, text=True,
                             timeout=timeout, env=env)
        for line in out.stdout.splitlines():
            if line.startswith("CALIB_OK"):
                _, kind, ns = line.split()
                return kind, float(ns)
        tail = (out.stderr.strip().splitlines() or ["no output"])[-1]
        why = f"exit code {out.returncode}: {tail}"
    except subprocess.TimeoutExpired:
        why = f"no answer within {timeout:g} s"
    except OSError as e:
        why = str(e)
    warnings.warn(f"calibrate: the device measurement failed ({why}); "
                  f"using REF_GATHER_NS = {REF_GATHER_NS}", RuntimeWarning,
                  stacklevel=2)
    return "nodevice", REF_GATHER_NS


def measure_host_rate() -> float:
    """Native GS bids/s on a small synthetic instance (its price table
    stays in cache: the regime where the CPU engine wins); 0.0 without
    the native runtime."""
    from sslap_tpu_torch import hybrid as _hybrid
    if not _hybrid.native_available():
        return 0.0
    rng = np.random.default_rng(0)
    n = 4096
    k = 10
    indptr = np.arange(n + 1, dtype=np.int64) * k
    indices = rng.integers(0, n, n * k).astype(np.int32)
    indices[np.arange(n) * k] = rng.permutation(n).astype(np.int32)
    data = -(rng.random(n * k).astype(np.float32) * 1000 + 1)
    best = float("inf")
    for _ in range(3):
        prices = np.zeros(n, np.float32)
        sigma = np.full(n, -1, np.int32)
        owner = np.full(n, -1, np.int32)
        t0 = time.perf_counter()
        bids = _hybrid._gs(indptr, indices, data, prices, sigma, owner,
                           np.float32(1.0), np.float32(1002.0), 0, 10 ** 8)
        dt = time.perf_counter() - t0
        if bids > 0:
            best = min(best, dt / bids)
    return 1.0 / best if best < float("inf") else 0.0


def measure_gather_ns(device="cuda") -> float:
    """ns per random scalar gather on the card: R chained rounds of
    ``w = prices[cols]`` over [2**20, 8] random columns of a 2**20 price
    table (the headline's), each round's sum fed back into the prices,
    timed with CUDA events at R = 8 and 72; the difference over 64 rounds,
    per gather."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_gather_ns times a CUDA device")
    n = 1 << 20
    k = 8
    rng = np.random.default_rng(0)
    cols = torch.from_numpy(rng.integers(0, n, (n, k),
                                         dtype=np.int64)).to(dev)
    prices = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)

    def timed(R: int) -> float:
        best = float("inf")
        for _ in range(3):                       # the first one warms up
            p = prices.clone()
            acc = torch.zeros((), device=dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(R):
                s = p[cols].sum() * 1e-30
                p = p + s
                acc = acc + s
            end.record()
            end.synchronize()
            float(acc)
            best = min(best, start.elapsed_time(end) * 1e-3)
        return best

    t1, t2 = timed(8), timed(72)
    per_round = max((t2 - t1) / 64, 1e-9)
    return per_round / cols.numel() * 1e9


def crossover(force: bool = False) -> int:
    """The auto mode's hybrid crossover (rows) on this machine:
    DEFAULT_CROSSOVER unless SSLAP_TPU_CALIBRATE=1 (or ``force``), then
    the measured value, computed once and cached on disk."""
    global _cached
    enabled = force or os.environ.get("SSLAP_TPU_CALIBRATE") == "1"
    if not enabled:
        # not latched: SSLAP_TPU_CALIBRATE=1 set later in the same process
        # must still reach the measured value
        return DEFAULT_CROSSOVER
    if _cached is not None and not force:
        return _cached
    key = socket.gethostname()       # never touches the card
    path = _cache_path()
    try:
        with open(path) as f:
            blob = json.load(f)
        if not force and blob.get("key") == key:
            _cached = int(blob["crossover"])
            return _cached
    except (OSError, ValueError, KeyError, TypeError):
        pass
    host_rate = measure_host_rate()
    device_kind, gather_ns = _measure_device()
    if host_rate <= 0:
        # no native engine: the device path wins at every size
        # (api's _resolve_mode decides that before asking here)
        _cached = DEFAULT_CROSSOVER
        return _cached
    x = DEFAULT_CROSSOVER * (host_rate / REF_HOST_BIDS_PER_S) \
        * (gather_ns / REF_GATHER_NS)
    _cached = int(np.clip(x, 10_000, 50_000_000))
    try:
        with open(path, "w") as f:
            json.dump({"key": key, "device_kind": device_kind,
                       "crossover": _cached, "host_bids_per_s": host_rate,
                       "gather_ns": gather_ns}, f)
    except OSError:
        pass
    return _cached
