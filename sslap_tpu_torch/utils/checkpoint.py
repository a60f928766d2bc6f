"""Checkpoint, resume and warm start.  Counterpart of
``sslap_tpu/utils/checkpoint.py``, with the same npz payload and format
version, so a snapshot written by either package loads in the other.

The solver's state is small (prices [m], eps, the round counts), so a
checkpoint is a host-side npz snapshot.  The same payload warm-starts a
similar instance: ``AuctionSolver.solve(warm_prices=...)`` (and
``eps_start=`` to resume a partly annealed schedule).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

_FORMAT_VERSION = 1


def save_state(path, prices, *, eps: Optional[float] = None,
               rounds: int = 0, phases: int = 0, extra: Optional[dict] = None):
    """Snapshot solver state to ``path`` (.npz); ``prices`` may be a numpy
    array or a tensor on any device."""
    path = Path(path)
    if hasattr(prices, "detach"):
        prices = prices.detach().cpu().numpy()
    meta = {"version": _FORMAT_VERSION, "eps": eps, "rounds": int(rounds),
            "phases": int(phases), "extra": extra or {}}
    np.savez(path, prices=np.asarray(prices), meta=json.dumps(meta))
    return path


def load_state(path):
    """Load a snapshot: (prices ndarray, meta dict with 'eps', 'rounds',
    'phases' and 'extra')."""
    with np.load(Path(path), allow_pickle=False) as z:
        prices = z["prices"]
        meta = json.loads(str(z["meta"]))
    if meta.get("version") != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version: {meta.get('version')}")
    return prices, meta
