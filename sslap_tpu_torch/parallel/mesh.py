"""Meshes of torch devices, single process.  Counterpart of
``sslap_tpu/parallel/mesh.py``.

A ``Mesh`` is a 1-D list of devices under one axis name; a device may
repeat (``[torch.device("cpu")] * 4`` stands in for the reference's eight
virtual CPU devices, ``[cuda:0] * 4`` runs four shards on one card).  One
process drives every shard of a mesh: ``run_spmd`` runs one function per
mesh entry, each in its own thread bound to its device, and
``ThreadGroup`` gives those threads the collectives (all-reduce) that
JAX's ``shard_map`` gave the reference; the threads run one at a time,
each until its next collective, so a run is deterministic.
Process-spanning meshes (``initialize_multihost``, torch.distributed) are
not ported yet.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices along one named axis: ``devices`` (list of torch.device),
    ``axis_names`` and ``shape`` (axis name -> size), read as the
    reference's ``mesh.shape[axis]``."""

    def __init__(self, devices: Sequence, axis_name: str = "rows"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis_name,)
        self.shape = {axis_name: len(self.devices)}


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "rows") -> Mesh:
    """1-D mesh over the given devices, or over all local CUDA devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= (e.g. "
                               "[torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis_name)


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None) -> None:
    """Meshes that span processes are not ported yet."""
    from sslap_tpu_torch.api import _not_ported
    raise _not_ported("initialize_multihost (process-spanning meshes, "
                      "ROADMAP.md queue 1 item 3b)")


def put_global(x, mesh: Mesh, spec=None):
    """Single process: ``x`` unchanged (each shard takes its rows where it
    runs)."""
    return x


def fetch_global(x) -> np.ndarray:
    """Host numpy value of a tensor (or array) held in this process."""
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


class GroupAborted(RuntimeError):
    """Another rank of the group failed."""


class ThreadGroup:
    """All-reduce among the ``size`` shard threads of one process.  The
    ranks take turns: one runs at a time, until its next collective, then
    hands on to the next rank (so the threads never contend for the
    interpreter lock, which every torch call releases and retakes).  At a
    collective each rank deposits its tensor; the last rank reduces them in
    rank order on rank 0's device; each rank, at its next turn, takes its
    own copy of the result on its device.  All ranks must call the same
    collectives in the same order; ``abort`` wakes every waiting rank with
    GroupAborted."""

    def __init__(self, size: int):
        self.size = size
        self._go = [threading.Semaphore(1 if r == 0 else 0)
                    for r in range(size)]
        self._aborted = False
        self._slots: List[Optional[torch.Tensor]] = [None] * size
        self._result: Optional[torch.Tensor] = None

    def wait_turn(self, rank: int) -> None:
        self._go[rank].acquire()
        if self._aborted:
            raise GroupAborted("another shard failed")

    def _pass(self, rank: int) -> None:
        self._go[(rank + 1) % self.size].release()

    def all_reduce(self, rank: int, t: torch.Tensor,
                   op: Callable) -> torch.Tensor:
        """``op`` (elementwise, associative) over every rank's ``t``."""
        if self.size == 1:
            return t.clone()
        self._slots[rank] = t
        if rank == self.size - 1:
            dev = self._slots[0].device
            acc = self._slots[0]
            for x in self._slots[1:]:
                acc = op(acc, x.to(dev))
            self._result = acc
            self._slots = [None] * self.size
        self._pass(rank)
        self.wait_turn(rank)
        return self._result.to(t.device, copy=True)

    def finish(self, rank: int) -> None:
        """Rank ``rank`` is done: hand the turn on for good."""
        if self.size > 1:
            self._pass(rank)

    def abort(self) -> None:
        self._aborted = True
        for go in self._go:
            go.release()


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def run_spmd(mesh: Mesh, fn: Callable) -> list:
    """``fn(rank, group)`` once per mesh entry, each bound to its device
    (one entry: in the caller's thread); returns the results in rank
    order.  A rank that raises aborts the group, and the first error is
    raised here once every thread has ended."""
    size = len(mesh.devices)
    group = ThreadGroup(size)
    if size == 1:
        with _on(mesh.devices[0]):
            return [fn(0, group)]
    results: list = [None] * size
    errors: list = [None] * size

    def body(rank: int) -> None:
        try:
            group.wait_turn(rank)
            with _on(mesh.devices[rank]):
                results[rank] = fn(rank, group)
            group.finish(rank)
        except BaseException as e:          # re-raised by the caller below
            errors[rank] = e
            group.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"shard-{r}") for r in range(size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    first = next((e for e in errors
                  if e is not None and not isinstance(e, GroupAborted)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results
