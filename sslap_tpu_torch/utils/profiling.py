"""Tracing: the program's own spans and counters, and torch.profiler
helpers.  Counterpart of ``sslap_tpu/utils/profiling.py``.

``span(name)`` times a stretch of the program on ``time.perf_counter()``,
the clock the benchmark's harness times its own spans on.  A span knows
its parent (the span open on its thread, or the one handed over to a
thread with ``parent=``), the root ``solve`` span of its request, its
thread and, for a shard, its ``rank``; ``Span.count`` adds to its
counters.  Closed spans are kept in memory, the newest ``MAX_SPANS``
(``spans()``, ``clear()``).  While a torch.profiler runs, and only then,
a span is also a profiler range ``sslap/<name>``, so the program's spans
and the device's kernels share one timeline.  Each public entry opens
the root span with ``entry()``.

``trace_annotation`` is a span under its own range name (and an NVTX
range once the process uses the card); ``profile_trace`` writes a Chrome
trace (which perfetto opens) of every thread.  Per-round observability
is ``auction.solve_ell``'s ``on_round`` hook.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Iterator, List, Optional

MAX_SPANS = 65536

_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    """This thread's open spans, outermost first."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _profiling() -> bool:
    """True while a torch.profiler runs (its process-wide flag; no
    profiler can run before torch is imported)."""
    tap = sys.modules.get("torch.autograd.profiler")
    return tap is not None and getattr(tap, "_is_profiler_enabled", False)


class Span:
    """One span, a context manager: ``with span(name) as sp:``.  Recorded
    when it closes, with its counters (``sp.count(key, v)``)."""

    __slots__ = ("name", "id", "parent", "root", "rank", "t0", "t1",
                 "counts", "_given", "_root_span", "_label", "_range")

    def __init__(self, name: str, parent: Optional["Span"] = None,
                 rank: Optional[int] = None, label: Optional[str] = None):
        self.name = name
        self.rank = rank
        self.counts: dict = {}
        self._given = parent
        self._label = label
        self._range = None

    def count(self, key: str, v=1) -> None:
        self.counts[key] = self.counts.get(key, 0) + v

    def __enter__(self) -> "Span":
        stack = _stack()
        up = stack[-1] if stack else self._given
        self.id = next(_ids)
        if up is None:
            self.parent, self.root, self._root_span = None, self.id, self
        else:
            self.parent, self.root = up.id, up.root
            self._root_span = up._root_span
            if self.rank is None:
                self.rank = up.rank
        if _profiling():
            import torch
            self._range = torch.profiler.record_function(
                self._label or f"sslap/{self.name}")
            self._range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _records.append({
            "name": self.name, "id": self.id, "parent": self.parent,
            "root": self.root, "thread": threading.get_ident(),
            "rank": self.rank, "t0": self.t0, "t1": self.t1,
            "counts": self.counts})


def span(name: str, *, parent: Optional[Span] = None,
         rank: Optional[int] = None) -> Span:
    """A span named ``name``, the child of the span open on this thread;
    on a thread with none open, of ``parent`` (a span of the thread that
    started this one), else a root."""
    return Span(name, parent, rank)


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def entry() -> Iterator[Span]:
    """A public entry's root ``solve`` span; under an open span, that
    span's root (an entry called by another opens no second root).  Also
    a decorator."""
    stack = _stack()
    if stack:
        yield stack[-1]._root_span
        return
    with Span("solve") as sp:
        yield sp



def spans() -> List[dict]:
    """A copy of the recorded spans, oldest closed first: ``name``, ``id``,
    ``parent``, ``root``, ``thread``, ``rank``, ``t0``, ``t1``,
    ``counts``."""
    return list(_records)


def clear() -> None:
    _records.clear()


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """A span whose profiler range is named ``name``, and an NVTX range
    too once this process uses the card."""
    import torch
    with Span(name, label=name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def _all_threads_config():
    """torch.profiler's option to record the ranges of every thread, not
    only the starting thread's (None where this torch lacks it)."""
    import torch
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def profile_trace(log_dir: str, *, create_perfetto_link: bool = False
                  ) -> Iterator[None]:
    """Profile the block (CPU, and CUDA where a card is present; every
    thread's ranges where torch can) and write its Chrome trace into
    ``log_dir`` as ``trace_<pid>_<ns>.json``.  ``create_perfetto_link``
    is the reference's keyword; it has no effect here (perfetto opens the
    file)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    config = _all_threads_config()
    prof = torch.profiler.profile(
        activities=acts,
        **({} if config is None else {"experimental_config": config}))
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
