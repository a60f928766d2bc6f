"""Device liveness probe.  Counterpart of ``sslap_tpu/utils/liveness.py``,
thin: a local card raises where the reference's relayed TPU hung, so
there is no relay to wait for and no retry loop.  One small CUDA
operation runs in a throwaway subprocess under a timeout and its result
is read back.

    from sslap_tpu_torch.utils import device_alive
    if not device_alive():
        ...            # the caller decides; nothing routes around the card
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Callable, Optional

__all__ = ["device_alive"]

# a matmul on the card and its sum read back on the host
_PROBE_CODE = (
    "import torch\n"
    "x = torch.ones((64, 64), device='cuda')\n"
    "assert float((x @ x).sum()) == 64 * 64 * 64\n"
    "print('ok')\n"
)


def device_alive(wait_s: Optional[float] = None,
                 log: Optional[Callable[[str], None]] = None) -> bool:
    """True iff a fresh subprocess runs one operation on the card and reads
    its result back within ``wait_s`` seconds (default: env
    ``SSLAP_TPU_DEVICE_WAIT_S``, else 120).  ``log`` receives one line on
    failure."""
    if wait_s is None:
        wait_s = float(os.environ.get("SSLAP_TPU_DEVICE_WAIT_S", "120"))
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                           capture_output=True, timeout=wait_s)
        if r.returncode == 0 and b"ok" in r.stdout:
            return True
        why = (r.stderr.decode(errors="replace").strip().splitlines()
               or [f"exit code {r.returncode}"])[-1]
    except subprocess.TimeoutExpired:
        why = f"no answer within {wait_s:g} s"
    if log is not None:
        log(f"device probe failed: {why}")
    return False
