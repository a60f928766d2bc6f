"""Hand-written Hopper kernels of the port, each beside its plain twin.

bid.py    -- K1, ``bid_topk``: bid stage (+ phase-start violator scan) of
             a compacted round; replaces sslap_tpu/ops/bid.py::_bid_kernel
commit.py -- K2, ``commit``: resolve + commit of a compacted round;
             replaces sslap_tpu/ops/commit.py::_commit_kernel

A wrapper runs its plain twin for CPU tensors and launches its CUDA kernel
(``csrc/*.cu``, built by ``_build.py`` at first use) for CUDA tensors; it
never falls back.  ``<wrapper>.launches`` counts kernel launches.
"""

from sslap_tpu_torch.ops.bid import bid_topk, bid_topk_plain
from sslap_tpu_torch.ops.commit import commit, commit_plain

__all__ = ["bid_topk", "bid_topk_plain", "commit", "commit_plain"]
