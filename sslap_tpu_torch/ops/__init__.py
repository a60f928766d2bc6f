"""Hand-written Hopper kernels of the port, each beside its plain twin.

bid.py       -- K1, ``bid_topk``: bid stage (+ phase-start violator scan)
                of a compacted round; replaces
                sslap_tpu/ops/bid.py::_bid_kernel
commit.py    -- K2, ``commit``: resolve + commit of a compacted round;
                replaces sslap_tpu/ops/commit.py::_commit_kernel
gs_kernel.py -- K3, ``gs_auction_device``: the serial Gauss-Seidel auction
                on the device (with the reference's ``prefetch`` and
                ``_scan`` surface); replaces
                sslap_tpu/ops/gs_kernel.py::_gs_kernel
probe_gs.py  -- P1-P17, the GS micro-probes of
                benchmarks/probe_mosaic_gs.py (row copies, scalar table
                access, queue-driven copy loops, K3 rebuilt in stages);
                ``python -m sslap_tpu_torch.ops.probe_gs`` runs them

A wrapper runs its plain twin for CPU tensors and launches its CUDA kernel
(``csrc/*.cu``, built by ``_build.py`` at first use) for CUDA tensors; it
never falls back.  ``<wrapper>.launches`` counts kernel launches.
"""

from sslap_tpu_torch.ops.bid import bid_topk, bid_topk_plain
from sslap_tpu_torch.ops.commit import commit, commit_plain
from sslap_tpu_torch.ops.gs_kernel import gs_auction_device, gs_auction_plain

__all__ = ["bid_topk", "bid_topk_plain", "commit", "commit_plain",
           "gs_auction_device", "gs_auction_plain"]
