"""Distribution layer: the row-sharded Jacobi auction over a mesh of
devices, driven by one process.  Counterpart of ``sslap_tpu/parallel/``;
ported so far: ``partition.py``, ``mesh.py`` (single process) and
``sharded.py``.  The overlapped and sharded-hybrid solves, the scaling
harness and process-spanning meshes are not ported yet (ROADMAP.md)."""

from sslap_tpu_torch.parallel.mesh import Mesh, initialize_multihost, \
    make_mesh
from sslap_tpu_torch.parallel.partition import pad_rows_for_mesh, \
    partition_rows, shard_nnz_counts
from sslap_tpu_torch.parallel.sharded import auction_solve_sharded, \
    sharded_solve_ell

__all__ = [
    "Mesh",
    "make_mesh",
    "initialize_multihost",
    "pad_rows_for_mesh",
    "partition_rows",
    "shard_nnz_counts",
    "auction_solve_sharded",
    "sharded_solve_ell",
]
