"""Meshes of torch devices, in one process or across processes.
Counterpart of ``sslap_tpu/parallel/mesh.py``.

A ``Mesh`` is a 1-D list of devices under one axis name; a device may
repeat (``[torch.device("cpu")] * 4`` stands in for the reference's eight
virtual CPU devices, ``[cuda:0] * 4`` runs four shards on one card).  Each
entry belongs to a process (``Mesh.processes``): a mesh built by
``make_mesh`` under an initialised ``torch.distributed`` group
(``initialize_multihost``) spans every process, world size times this
process's devices, in process-major order.

``run_spmd`` runs this process's shards, one thread per entry bound to its
device, and hands them a group with the collectives (all-reduce,
all-gather) that JAX's ``shard_map`` gave the reference.  One interface,
two implementations: ``ThreadGroup`` for a mesh held by one process, and
``ProcessSpanGroup``, which reduces across this process's threads in rank
order, then across processes with ``torch.distributed`` (also
asynchronously: a handle that is waited on later).  The threads of a
process run one at a time, each until its next collective, so a run is
deterministic.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sslap_tpu_torch.utils import profiling as _prof


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the initialised group (0 without one)."""
    return dist.get_rank() if _initialised() else 0


def process_count() -> int:
    """Processes in the initialised group (1 without one)."""
    return dist.get_world_size() if _initialised() else 1


class Mesh:
    """Devices along one named axis: ``devices`` (list of torch.device, as
    the owning process names them), ``processes`` (the rank of the process
    that owns each entry; default: this process), ``axis_names`` and
    ``shape`` (axis name -> size), read as the reference's
    ``mesh.shape[axis]``."""

    def __init__(self, devices: Sequence, axis_name: str = "rows",
                 processes: Optional[Sequence[int]] = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.processes = ([process_index()] * len(self.devices)
                          if processes is None else list(processes))
        if len(self.processes) != len(self.devices):
            raise ValueError("one process rank per mesh entry")
        self.axis_names = (axis_name,)
        self.shape = {axis_name: len(self.devices)}

    @property
    def spans_processes(self) -> bool:
        return len(set(self.processes)) > 1

    def local_ranks(self) -> List[int]:
        """The entries this process runs, in mesh order."""
        me = process_index()
        return [r for r, p in enumerate(self.processes) if p == me]


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "rows") -> Mesh:
    """1-D mesh over the given devices, or over all local CUDA devices.
    Under an initialised process group ``devices`` (default: every local
    CUDA device) are this process's entries, every process gives as many,
    and the mesh spans them all:
    world size times ``devices``, process-major (the reference's fallback
    order, which keeps a process's shards adjacent on the axis)."""
    if devices is None:
        if torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            raise RuntimeError("no CUDA device: pass devices= (e.g. "
                               "[torch.device('cpu')] * 4)")
    devices = list(devices)
    world = process_count()
    if world == 1:
        return Mesh(devices, axis_name)
    return Mesh(devices * world, axis_name,
                processes=[p for p in range(world) for _ in devices])


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         timeout: Optional[float] = None) -> None:
    """Join this process to a ``torch.distributed`` group
    (``init_method="tcp://<coordinator_address>"``, world size
    ``num_processes``, rank ``process_id``).  A no-op when a group is
    already initialised, or when nothing is given and the environment
    names no group (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK; a group
    it names joins by ``env://``).  An explicit request that fails raises.

    ``backend``: Gloo for CPU meshes, NCCL for CUDA ones by default (NCCL
    when this host has a CUDA device).  NCCL refuses two ranks on one
    card.  Gloo all-reduces CUDA tensors but all-gathers on the host;
    NCCL takes every collective on the card (``_staged``).
    ``timeout``: seconds the group waits for its peers (torch's default
    when None)."""
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not dist.is_available():
        if explicit:
            raise RuntimeError("torch.distributed is not available")
        return
    if dist.is_initialized():
        return
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("initialize_multihost needs coordinator_address, "
                             "num_processes and process_id together")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in "
                             f"[0, {num_processes})")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                       "WORLD_SIZE", "RANK")):
        kw = dict(init_method="env://")
    else:
        return
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"), **kw)


class ProcessRows:
    """Rows of a row-sharded result that spans processes: ``local`` holds
    this process's entries' rows, in mesh order (dim 0); ``fetch_global``
    gathers every process's."""

    def __init__(self, local):
        self.local = torch.as_tensor(local)


def put_global(x, mesh: Mesh, spec=None):
    """A host array that is IDENTICAL on every process, for ``mesh``.
    Single process: ``x`` unchanged (each shard takes its rows where it
    runs).  Process-spanning: a host numpy copy, since a tensor on a device
    is local to its process; each process's shards take their rows of it
    (``spec``: 'rows' or None for replicated, as the reference's
    PartitionSpec says; the shards read it from the solver)."""
    if process_count() == 1:
        return x
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def put_global_args(mesh: Mesh, specs, args):
    """``put_global`` over an argument tuple (one spec per arg): the one
    placement path every distributed backend shares."""
    if process_count() == 1:
        return tuple(args)
    return tuple(put_global(a, mesh, s)
                 for a, s in zip(args, specs, strict=True))


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the process group's all-gather takes it: on the host
    under Gloo (which gathers host tensors only), on a card under NCCL
    (which takes CUDA tensors only)."""
    if dist.get_backend() == "gloo":
        return t.cpu().contiguous()
    return (t if t.is_cuda else t.cuda()).contiguous()


def fetch_global(x) -> np.ndarray:
    """Host numpy value of a result.  A ``ProcessRows`` is gathered from
    every process (a COLLECTIVE: every process calls this on the same
    results in the same order, the SPMD rule all of parallel/ follows);
    a tensor or array held by this process converts directly."""
    if isinstance(x, ProcessRows):
        local = _staged(x.local)
        parts = [torch.empty_like(local) for _ in range(process_count())]
        dist.all_gather(parts, local)
        return torch.cat(parts).cpu().numpy()
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


class GroupAborted(RuntimeError):
    """Another rank of the group failed."""


# torch.distributed's reduce op for each elementwise op a group takes
_DIST_OPS = {torch.add: "SUM", torch.maximum: "MAX", torch.minimum: "MIN"}


class Handle:
    """An all-reduce in flight (``all_reduce_async``): the reduced tensor,
    complete once ``work`` (None: already) is.  ``wait()`` returns it on
    the caller's device: read-only, since every rank of the process may
    share it."""

    def __init__(self, value: torch.Tensor, work, device: torch.device):
        self._value, self._work, self._device = value, work, device

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._value.to(self._device)


class ThreadGroup:
    """Collectives among the shard threads of one process: global ranks
    ``ranks`` of a mesh of ``world`` entries.  The ranks take turns: one
    runs at a time, until its next collective, then hands on to the next
    rank (so the threads never contend for the interpreter lock, which
    every torch call releases and retakes).  At a collective each rank
    deposits its tensor; the last rank reduces (or concatenates) them in
    rank order on the first rank's device (and, in a ``ProcessSpanGroup``,
    across the processes); each rank, at its next turn, takes the result
    on its device.  All ranks must call the same collectives in the same
    order; ``abort`` wakes every waiting rank with GroupAborted.
    ``turn_wait_s`` counts, per rank (in ``ranks`` order), the seconds
    blocked waiting for a turn."""

    def __init__(self, ranks: Sequence[int], world: int):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.world = world
        self._index = {r: i for i, r in enumerate(self.ranks)}
        self._go = [threading.Semaphore(1 if i == 0 else 0)
                    for i in range(self.size)]
        self._aborted = False
        self._slots: List[Optional[torch.Tensor]] = [None] * self.size
        self._result = None
        self.turn_wait_s = [0.0] * self.size

    def wait_turn(self, rank: int) -> None:
        i = self._index[rank]
        t0 = time.perf_counter()
        self._go[i].acquire()
        self.turn_wait_s[i] += time.perf_counter() - t0
        if self._aborted:
            raise GroupAborted("another shard failed")

    def _pass(self, rank: int) -> None:
        self._go[(self._index[rank] + 1) % self.size].release()

    def _across(self, acc: torch.Tensor, op: Callable, wait: bool):
        """(result, work) of the reduction across processes: none within
        one."""
        return acc, None

    def _gather_across(self, local: torch.Tensor) -> torch.Tensor:
        """This process's ranks' tensors, concatenated, gathered from every
        process: nothing to gather within one."""
        return local

    def _exchange(self, rank: int, t: torch.Tensor, combine: Callable):
        """Every rank deposits ``t``; the last rank of the process calls
        ``combine`` on the deposits, in rank order, on the first rank's
        device; each rank, at its next turn, takes the result."""
        if self.size == 1:
            return combine([t])
        self._slots[self._index[rank]] = t
        if self._index[rank] == self.size - 1:
            dev = self._slots[0].device
            self._result = combine([x.to(dev) for x in self._slots])
            self._slots = [None] * self.size
        self._pass(rank)
        self.wait_turn(rank)
        return self._result

    def _reduce(self, rank: int, t: torch.Tensor, op: Callable, wait: bool):
        def fold(xs):
            acc = xs[0].clone() if len(xs) == 1 else xs[0]
            for x in xs[1:]:
                acc = op(acc, x)
            return self._across(acc, op, wait)
        return self._exchange(rank, t, fold)

    def all_reduce(self, rank: int, t: torch.Tensor,
                   op: Callable) -> torch.Tensor:
        """``op`` (elementwise, associative) over every rank's ``t``: a
        new tensor on ``t``'s device."""
        value, _ = self._reduce(rank, t, op, True)
        return value.to(t.device, copy=True)

    def all_reduce_async(self, rank: int, t: torch.Tensor,
                         op: Callable) -> Handle:
        """``all_reduce`` started now, its result read at ``wait()``.
        Within one process the threads take turns, so the reduction is
        done by the time this returns: nothing overlaps."""
        return Handle(*self._reduce(rank, t, op, False), t.device)

    def all_gather(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on every rank) concatenated
        along dim 0 in global rank order, on ``t``'s device: read-only,
        since every rank of the process may share it."""
        value = self._exchange(
            rank, t, lambda xs: self._gather_across(torch.cat(xs)))
        return value.to(t.device)

    def finish(self, rank: int) -> None:
        """Rank ``rank`` is done: hand the turn on for good."""
        if self.size > 1:
            self._pass(rank)

    def abort(self) -> None:
        self._aborted = True
        for go in self._go:
            go.release()


class ProcessSpanGroup(ThreadGroup):
    """A ``ThreadGroup`` whose collectives go on across the processes of
    the initialised ``torch.distributed`` group: the last thread of each
    process reduces (or concatenates) its process's tensors in rank order,
    then all-reduces (or all-gathers) that across the processes (ops
    ``torch.add``, ``torch.maximum``, ``torch.minimum``; integers reduce
    in any order to the same result; a
    float max loses the rank order of -0.0 against +0.0, which no solve
    bids).  ``all_reduce_async`` returns before the cross-process
    reduction is done."""

    def _across(self, acc: torch.Tensor, op: Callable, wait: bool):
        if op not in _DIST_OPS:
            raise ValueError(f"no torch.distributed reduce op for {op}")
        flat = acc.reshape(-1)           # a 0-d count travels as [1]
        work = dist.all_reduce(flat, op=getattr(dist.ReduceOp,
                                                _DIST_OPS[op]),
                               async_op=not wait)
        return flat.reshape(acc.shape), work

    def _gather_across(self, local: torch.Tensor) -> torch.Tensor:
        # the ranks of a process are adjacent on the mesh (process-major),
        # so the processes' blocks in process order are the ranks'
        # tensors in rank order
        part = _staged(local)
        out = part.new_empty((process_count() * part.shape[0],)
                             + tuple(part.shape[1:]))
        dist.all_gather_into_tensor(out, part)
        return out.to(local.device)


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def run_spmd(mesh: Mesh, fn: Callable) -> list:
    """``fn(rank, group)`` once per mesh entry of this process, each bound
    to its device (one entry: in the caller's thread), ``rank`` its
    global rank on the mesh; returns the results in rank order.  A rank
    that raises aborts this process's group, and the first error is
    raised here once every thread has ended (the other processes'
    shards then wait in their next collective: the launcher's timeout
    ends them).  Each rank runs in a span ``shard_pass`` under the
    caller's open span, with its turn wait counted."""
    ranks = mesh.local_ranks()
    if not ranks:
        raise ValueError("no entry of this mesh belongs to this process")
    cls = ProcessSpanGroup if mesh.spans_processes else ThreadGroup
    group = cls(ranks, len(mesh.devices))
    if len(ranks) == 1:
        with _prof.span("shard_pass", rank=ranks[0]) as sp, \
                _on(mesh.devices[ranks[0]]):
            out = [fn(ranks[0], group)]
            sp.count("turn_wait_s", group.turn_wait_s[0])
        return out
    results: dict = {}
    errors: dict = {}
    caller = _prof.current()

    def body(i: int, rank: int) -> None:
        try:
            with _prof.span("shard_pass", parent=caller, rank=rank) as sp:
                group.wait_turn(rank)
                with _on(mesh.devices[rank]):
                    results[rank] = fn(rank, group)
                group.finish(rank)
                sp.count("turn_wait_s", group.turn_wait_s[i])
        except BaseException as e:          # re-raised by the caller below
            errors[rank] = e
            group.abort()

    threads = [threading.Thread(target=body, args=(i, r), daemon=True,
                                name=f"shard-{r}")
               for i, r in enumerate(ranks)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    errs = [errors[r] for r in ranks if r in errors]
    first = next((e for e in errs if not isinstance(e, GroupAborted)),
                 errs[0] if errs else None)
    if first is not None:
        raise first
    return [results[r] for r in ranks]
