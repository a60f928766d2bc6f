"""sslap_tpu_torch: the PyTorch + CUDA port of sslap_tpu (sparse linear
assignment by the auction algorithm with epsilon-scaling).

First slice: the square hybrid solve (device rounds through the
hand-written Hopper kernels in ``ops/``, then the shared native C++ host
finisher) and the native CPU mode.  ``sslap_tpu`` (JAX) stays the
reference; this package imports torch and numpy, never jax.
"""

from sslap_tpu_torch.api import (
    AuctionSolution,
    AuctionSolver,
    InfeasibleError,
    auction_solve,
)
from sslap_tpu_torch.config import AuctionConfig
from sslap_tpu_torch.ingest import ELLProblem, from_coo, from_csr, from_dense

__all__ = [
    "AuctionConfig",
    "AuctionSolution",
    "AuctionSolver",
    "ELLProblem",
    "InfeasibleError",
    "auction_solve",
    "from_coo",
    "from_csr",
    "from_dense",
]
