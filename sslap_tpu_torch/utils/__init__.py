"""Checkpoints, tracing and a device liveness probe.  Counterpart of
``sslap_tpu/utils``: a snapshot crosses between the two packages in both
directions; tracing is the program's own spans and counters
(``profiling.span``) and torch.profiler's traces (with NVTX ranges on
the card)."""

from sslap_tpu_torch.utils.checkpoint import load_state, save_state
from sslap_tpu_torch.utils.liveness import device_alive
from sslap_tpu_torch.utils.profiling import profile_trace, trace_annotation

__all__ = ["save_state", "load_state", "profile_trace", "trace_annotation",
           "device_alive"]
