"""Hand-written Hopper kernels of the port, each beside its plain twin.

bid.py       -- K1, ``bid_topk``: bid stage (+ phase-start violator scan)
                of a compacted round; replaces
                sslap_tpu/ops/bid.py::_bid_kernel; ``bid_topk_batched`` is
                its batched entry (per-instance eps and bigp)
commit.py    -- K2, ``commit``: resolve + commit of a compacted round;
                replaces sslap_tpu/ops/commit.py::_commit_kernel;
                ``resolve`` is its first launch alone and ``commit_keys``
                the fused key commit of the sharded and overlapped rounds
                (no TPU kernel behind it: XLA jnp ops in the reference)
ladder.py    -- ``ladder_phase``: one eps phase of the square tiered solve
                (phase start, wide loop, tier ladder) as one persistent
                kernel whose rounds are K1's bid + K2's resolve and
                commit with the relist and the loop control on the
                device; redesigns K1 and K2 for that path (the standalone
                launches serve auction.jacobi_round)
dense_bid.py -- DK, ``dense_bid``: the dense top-2 bid of the batched
                dense engine (no TPU kernel behind it: it replaces the
                XLA-compiled sslap_tpu/dense_batch.py::_dense_bids)
gs_kernel.py -- K3, ``gs_auction_device``: the serial Gauss-Seidel auction
                on the device (with the reference's ``prefetch`` and
                ``_scan`` surface; a commit warp, and with prefetch
                look-ahead bid warps whose results it validates); replaces
                sslap_tpu/ops/gs_kernel.py::_gs_kernel
probe_gs.py  -- P1-P17, the GS micro-probes of
                benchmarks/probe_mosaic_gs.py (row copies, scalar table
                access, queue-driven copy loops, K3 rebuilt in stages);
                ``python -m sslap_tpu_torch.ops.probe_gs`` runs them

A wrapper runs its plain twin for CPU tensors and launches its CUDA kernel
(``csrc/*.cu``, built by ``_build.py`` at first use) for CUDA tensors; it
never falls back.  ``<wrapper>.launches`` counts kernel launches.
"""

from sslap_tpu_torch.ops.bid import bid_topk, bid_topk_batched, \
    bid_topk_batched_plain, bid_topk_plain
from sslap_tpu_torch.ops.commit import commit, commit_plain
from sslap_tpu_torch.ops.dense_bid import dense_bid, dense_bid_plain
from sslap_tpu_torch.ops.gs_kernel import gs_auction_device, gs_auction_plain
from sslap_tpu_torch.ops.ladder import ladder_phase, ladder_phase_plain

__all__ = ["bid_topk", "bid_topk_batched", "bid_topk_batched_plain",
           "bid_topk_plain", "commit", "commit_plain", "dense_bid",
           "dense_bid_plain", "gs_auction_device", "gs_auction_plain",
           "ladder_phase", "ladder_phase_plain"]
