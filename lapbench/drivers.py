"""The one general driver of the benchmark: a cell's set-up and one of its
requests, put together from three kinds of module found by name.

- ``generators/<config["generator"]>.py``: ``make(config, seed, k)``, pool
  item k drawn from the seed: ``{"loc": [...], "vals": [...]}``, one COO
  pair an instance of a request.
- ``patterns/<traffic["pattern"]>.py``: ``Pattern(driver, seed)``, which
  makes the pool (``pool``) and runs request k (``request(k, spans)``).
- ``entries/<config["entry"]>.py``: ``call(driver, item, k, spans,
  solver=None, solve=None)``, one call of a public entry of the program
  on a pool item; it returns the answer and the meta's scalars.

Configurations (``configs/``) and traffic mixes (``traffic/``) are data
that name these modules and hold their parameters, so a new cell, and a
new pattern, generator or entry, is a new file.  Every pattern is a
closed loop with one client.  The program is reached through its public
entries only: ``AuctionSolver``, ``from_coo``, ``stack_problems`` and
``auction_solve_batched``.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import List

import numpy as np
import torch

META_SCALARS = ("obj", "soln_found", "its", "host_bids", "phases",
                "final_eps", "unassigned", "time", "device_time",
                "readback_time", "host_gs_time", "n_shards", "mode")


def bf16(vals: np.ndarray) -> np.ndarray:
    """Costs rounded to bfloat16 (the control's precision), kept float32."""
    return torch.from_numpy(np.ascontiguousarray(vals)).to(
        torch.bfloat16).to(torch.float32).numpy()


def scalars(meta: dict) -> dict:
    """The scalars of a solve's meta that a record keeps."""
    return {k: meta[k] for k in META_SCALARS if k in meta}


def plugin(kind: str, name: str):
    """The module ``lapbench/<kind>/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"{kind} {name!r} is not a module name")
    return importlib.import_module(f"lapbench.{kind}.{name}")


class Spans:
    """Host-clock spans of the harness around each call into the program;
    with ``annotate`` each is also a profiler annotation
    ``lapbench/<name>/<req>``, so a trace can place them."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.items: List[dict] = []

    @contextlib.contextmanager
    def __call__(self, name: str, req: int):
        note = (torch.profiler.record_function(f"lapbench/{name}/{req}")
                if self.annotate else contextlib.nullcontext())
        with note:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.items.append({"name": name, "req": req, "t0": t0,
                                   "t1": time.perf_counter()})


class Driver:
    """Set-up (inputs from the seed) and one request of a cell on
    ``chips`` cards; with ``control`` the program is handed the costs
    rounded to bfloat16."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", control: bool = False,
                 chips: int = 1):
        self.config, self.traffic = config, traffic
        self.device, self.control, self.chips = device, control, int(chips)
        self.n, self.m = int(config["n"]), int(config["m"])
        self.entry = plugin("entries", config["entry"])
        self.generator = plugin("generators", config["generator"])
        self.pattern = plugin("patterns", traffic["pattern"]).Pattern(
            self, seed)

    @property
    def pool(self) -> List[dict]:
        return self.pattern.pool

    @property
    def instances(self) -> int:
        return int(self.config.get("instances", 1))

    def make(self, seed: int, k: int) -> dict:
        return self.generator.make(self.config, seed, k)

    def fed(self, vals: np.ndarray) -> np.ndarray:
        """The costs handed to the program: the input, or in the control
        the input rounded to bfloat16."""
        return bf16(vals) if self.control else vals

    def call(self, k: int, idx: int, spans, pool=None, **kw) -> dict:
        """Request ``k``'s record: the entry's call on pool item ``idx``
        (of ``pool`` while the pattern is still making its own)."""
        items = self.pool if pool is None else pool
        rec = self.entry.call(self, items[idx], k, spans, **kw)
        return dict(rec, req=k, inst=idx)

    def request(self, k: int, spans) -> dict:
        """Run request ``k`` (k < 0: the warm-up) and return its record:
        the pool index, the answer and the meta's scalars."""
        return self.pattern.request(k, spans)

    def nnz(self, idx: int) -> List[int]:
        return [int(v.shape[0]) for v in self.pool[idx]["vals"]]
