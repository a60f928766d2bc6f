"""sslap_tpu_torch: the PyTorch + CUDA port of sslap_tpu (sparse linear
assignment by the auction algorithm with epsilon-scaling).

Ported so far: the square and rectangular hybrid solves (device rounds
through the hand-written Hopper kernels in ``ops/``, then the native C++
host finisher), the dense engine (``engine='dense'``), the pure device
mode, the native CPU mode, the batched solves of many independent
instances (``auction_solve_batched`` over ``stack_problems`` /
``batch_from_dense``), ``hopcroft_solve``, ``linear_sum_assignment``,
the device Gauss-Seidel op ``gs_auction_device``, the device greedy seed
of the Hopcroft-Karp check (``feasibility_device``), the sharded,
overlapped and sharded hybrid solves over a mesh of devices
(``parallel``), the candidate-list engine (``engine='candidates'``,
``candidate``), the auto mode's calibration (``calibrate``) and
checkpoints, tracing and a liveness probe (``utils``).  As in the
reference, those modules are imported by name, not re-exported here.
``sslap_tpu`` (JAX) stays the reference; this package imports torch and
numpy, never jax.
"""

from sslap_tpu_torch.api import (
    AuctionSolution,
    AuctionSolver,
    InfeasibleError,
    auction_solve,
    hopcroft_solve,
    linear_sum_assignment,
)
from sslap_tpu_torch.batch import auction_solve_batched, batch_from_dense, \
    stack_problems
from sslap_tpu_torch.config import AuctionConfig
from sslap_tpu_torch.ingest import ELLProblem, from_coo, from_csr, \
    from_dense, to_dense
from sslap_tpu_torch.ops import gs_auction_device

__version__ = "0.1.0"

__all__ = [
    "AuctionConfig",
    "AuctionSolution",
    "AuctionSolver",
    "ELLProblem",
    "InfeasibleError",
    "auction_solve",
    "auction_solve_batched",
    "batch_from_dense",
    "from_coo",
    "from_csr",
    "from_dense",
    "gs_auction_device",
    "hopcroft_solve",
    "linear_sum_assignment",
    "stack_problems",
    "to_dense",
    "__version__",
]
