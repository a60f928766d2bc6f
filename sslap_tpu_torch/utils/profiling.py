"""Tracing hooks.  Counterpart of ``sslap_tpu/utils/profiling.py`` over
torch.profiler: annotate solve phases and write a Chrome trace (which
perfetto opens) without importing the profiler everywhere.  Per-round
observability is ``auction.solve_ell``'s ``on_round`` hook.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """A named range in the trace: a torch.profiler record, and an NVTX
    range too once this process uses the card."""
    import torch
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def profile_trace(log_dir: str, *, create_perfetto_link: bool = False
                  ) -> Iterator[None]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    its Chrome trace into ``log_dir`` as ``trace_<pid>_<ns>.json``.
    ``create_perfetto_link`` is the reference's keyword; it has no effect
    here (perfetto opens the file)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def throughput_counters(nnz: int, meta: dict) -> dict:
    """Rates of a solve's meta dict: ``touched_nnz_per_s`` (nnz times
    device rounds over the solve's time: the entries the rounds could
    touch, not the benchmark's nnz/s) and ``rounds_per_s``."""
    t = max(meta.get("time", 0.0), 1e-12)
    rounds = meta.get("its", 0)
    return {
        "touched_nnz_per_s": nnz * rounds / t,
        "rounds_per_s": rounds / t,
        "time": t,
        "rounds": rounds,
    }
