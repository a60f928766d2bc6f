"""Distribution layer: the row-sharded auction over a mesh of devices, in
one process or across processes (``torch.distributed``).  Counterpart of
``sslap_tpu/parallel/``: ``partition.py``, ``mesh.py``, ``sharded.py``,
``overlap.py``, ``scaling.py`` and ``sharded_compact.py`` (the sharded
hybrid) are ported; ``multiproc.py`` launches the multi-process runs."""

from sslap_tpu_torch.parallel.mesh import Mesh, initialize_multihost, \
    make_mesh
from sslap_tpu_torch.parallel.partition import pad_rows_for_mesh, \
    partition_rows, shard_nnz_counts
from sslap_tpu_torch.parallel.sharded import auction_solve_sharded, \
    sharded_solve_ell
from sslap_tpu_torch.parallel.overlap import auction_solve_overlapped, \
    solve_ell_overlapped
from sslap_tpu_torch.parallel.scaling import measure_round_breakdown
from sslap_tpu_torch.parallel.sharded_compact import \
    auction_solve_sharded_hybrid, balanced_cap, comm_bytes_model, \
    sharded_ladder_tiers

__all__ = [
    "Mesh",
    "make_mesh",
    "initialize_multihost",
    "pad_rows_for_mesh",
    "partition_rows",
    "shard_nnz_counts",
    "auction_solve_sharded",
    "auction_solve_overlapped",
    "sharded_solve_ell",
    "solve_ell_overlapped",
    "measure_round_breakdown",
    "auction_solve_sharded_hybrid",
    "sharded_ladder_tiers",
    "balanced_cap",
    "comm_bytes_model",
]
