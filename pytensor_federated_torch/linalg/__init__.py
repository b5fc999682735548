"""Distributed block-partitioned linear algebra over the pool.

The port of the JAX package's ``linalg/``.  Per *Large Scale
Distributed Linear Algebra With TPUs* (PAPERS.md): block-partitioned
GEMM, Cholesky, and triangular solve expressed on the package's
existing machinery — fed programs for the map/reduce-shaped rounds, the
stateful block store (:mod:`.service`, tiles resident on its device)
for the panel-factorization loops where tiles ship once.
:mod:`.blocks` owns the tile geometry and the wire headers (declared in
``service/wire_registry.py`` first, like every wire feature).
"""

from .blocks import BlockError, BlockLayout
from .ops import (
    BlockedCholesky,
    BlockedMatmul,
    block_quadratic_form,
    cholesky,
    matmul,
    matmul_per_shard,
    quadratic_per_shard,
    triangular_solve,
)
from .service import LocalBlockClient, make_block_store_compute

__all__ = [
    "BlockError",
    "BlockLayout",
    "BlockedCholesky",
    "BlockedMatmul",
    "LocalBlockClient",
    "block_quadratic_form",
    "cholesky",
    "make_block_store_compute",
    "matmul",
    "matmul_per_shard",
    "quadratic_per_shard",
    "triangular_solve",
]
