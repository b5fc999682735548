"""Block layouts for distributed tiled linear algebra.

The port of the JAX package's ``linalg/blocks.py``; numpy only, so its
header bytes and tile geometry are the JAX package's byte for byte.

A :class:`BlockLayout` describes a 2-D tile grid over a matrix: how a
``rows x cols`` array splits into ``grid_rows x grid_cols`` tiles of at
most ``block_rows x block_cols`` elements (edge tiles are smaller, never
padded — padding would silently change Cholesky/GEMM numerics on the
edge panels).  The layout also owns the two wire headers every linalg
operation leads with — packed per :data:`..service.wire_registry.
LINALG_OP_STRUCT` / :data:`..service.wire_registry.LINALG_TILE_STRUCT`,
imported from the registry so the declaration and the single
implementation cannot drift — and the deterministic block -> replica
placement the block store and the driver must agree on.

Any geometry mismatch, missing tile, duplicate tile, or malformed
header is a loud :class:`BlockError` (a ``WireError`` subclass), never
a silently mis-assembled matrix.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..service.npwire import WireError
from ..service.wire_registry import (
    LINALG_OP_STRUCT,
    LINALG_OPCODES,
    LINALG_TILE_STRUCT,
)

__all__ = [
    "BlockError",
    "BlockLayout",
    "encode_op_header",
    "decode_op_header",
    "OPCODES",
]

#: Opcode table re-exported from the registry (the registry is the
#: declaration; this module is the one implementation).
OPCODES: Dict[str, int] = dict(LINALG_OPCODES)
_OPCODE_NAMES = {v: k for k, v in OPCODES.items()}

_OP_STRUCT = struct.Struct(LINALG_OP_STRUCT)
_TILE_STRUCT = struct.Struct(LINALG_TILE_STRUCT)


class BlockError(WireError):
    """A blocked-linalg geometry or protocol violation.

    Subclasses ``WireError`` so every transport, pool, and chaos lane
    classifies it like any other corrupt-frame condition: loud,
    deterministic, non-retryable.
    """


def encode_op_header(opcode: int, step: int = 0, count: int = 0) -> np.ndarray:
    """Pack one operation header as the leading ``uint8`` request array."""
    if opcode not in _OPCODE_NAMES:
        raise BlockError(f"unknown linalg opcode {opcode!r}")
    return np.frombuffer(
        _OP_STRUCT.pack(opcode, step, count, 0), dtype=np.uint8
    ).copy()


def decode_op_header(arr: np.ndarray) -> Tuple[int, int, int]:
    """Unpack ``(opcode, step, count)``; loud on malformed headers."""
    a = np.ascontiguousarray(arr)
    if a.dtype != np.uint8 or a.nbytes != _OP_STRUCT.size:
        raise BlockError(
            "linalg op header must be a "
            f"uint8[{_OP_STRUCT.size}] array, got dtype {a.dtype} "
            f"with {a.nbytes} bytes"
        )
    opcode, step, count, flags = _OP_STRUCT.unpack(a.tobytes())
    if flags != 0:
        raise BlockError(
            f"linalg op header carries unknown flag bits {flags:#x} "
            "(reserved field must be zero)"
        )
    if opcode not in _OPCODE_NAMES:
        raise BlockError(f"unknown linalg opcode {opcode}")
    return opcode, step, count


@dataclass(frozen=True)
class BlockLayout:
    """A 2-D tile grid over a ``rows x cols`` matrix."""

    rows: int
    cols: int
    block_rows: int
    block_cols: int

    def __post_init__(self) -> None:
        for name in ("rows", "cols", "block_rows", "block_cols"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v <= 0:
                raise BlockError(f"BlockLayout.{name} must be > 0, got {v!r}")
        if self.block_rows > self.rows or self.block_cols > self.cols:
            raise BlockError(
                f"block shape ({self.block_rows}, {self.block_cols}) "
                f"exceeds matrix shape ({self.rows}, {self.cols})"
            )

    # -- geometry ----------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @property
    def grid_rows(self) -> int:
        return -(-self.rows // self.block_rows)

    @property
    def grid_cols(self) -> int:
        return -(-self.cols // self.block_cols)

    @classmethod
    def for_matrix(cls, a: np.ndarray, block: int) -> "BlockLayout":
        a = np.asarray(a)
        if a.ndim != 2:
            raise BlockError(f"expected a 2-D matrix, got shape {a.shape}")
        b = int(block)
        return cls(a.shape[0], a.shape[1], min(b, a.shape[0]), min(b, a.shape[1]))

    def tile_shape(self, i: int, j: int) -> Tuple[int, int]:
        self._check_coord(i, j)
        r = min(self.block_rows, self.rows - i * self.block_rows)
        c = min(self.block_cols, self.cols - j * self.block_cols)
        return (r, c)

    def tile_slice(self, i: int, j: int) -> Tuple[slice, slice]:
        r, c = self.tile_shape(i, j)
        r0 = i * self.block_rows
        c0 = j * self.block_cols
        return (slice(r0, r0 + r), slice(c0, c0 + c))

    def _check_coord(self, i: int, j: int) -> None:
        if not (0 <= i < self.grid_rows and 0 <= j < self.grid_cols):
            raise BlockError(
                f"tile ({i}, {j}) outside the "
                f"{self.grid_rows}x{self.grid_cols} grid"
            )

    def coords(self) -> Iterator[Tuple[int, int]]:
        for i in range(self.grid_rows):
            for j in range(self.grid_cols):
                yield (i, j)

    def lower_coords(self) -> Iterator[Tuple[int, int]]:
        """Coordinates of the lower-triangle tiles (j <= i) — the tile
        set a Cholesky factorization stores and touches."""
        for i in range(self.grid_rows):
            for j in range(min(i, self.grid_cols - 1) + 1):
                yield (i, j)

    # -- placement ---------------------------------------------------------

    def owner(self, i: int, j: int, n_replicas: int) -> int:
        """Deterministic block -> replica placement: block-ROW cyclic.

        Row-cyclic (not 2-D cyclic) on purpose: the right-looking
        Cholesky's panel solve and trailing update are row-local, so
        owning whole block-rows keeps every per-step op a single
        request per replica and balances the trailing work to within
        one block-row.
        """
        self._check_coord(i, j)
        n = int(n_replicas)
        if n < 1:
            raise BlockError(f"n_replicas must be >= 1, got {n_replicas!r}")
        return i % n

    def rows_owned(self, replica: int, n_replicas: int) -> List[int]:
        return [i for i in range(self.grid_rows) if i % int(n_replicas) == replica]

    # -- split / assemble --------------------------------------------------

    def split(self, a: np.ndarray) -> Dict[Tuple[int, int], np.ndarray]:
        """Tile a matrix.  Tiles are contiguous COPIES (stable objects
        the shm and ring lanes' pin cache can key on across iterations)."""
        a = np.asarray(a)
        if a.shape != self.shape:
            raise BlockError(
                f"matrix shape {a.shape} does not match layout "
                f"shape {self.shape}"
            )
        return {
            (i, j): np.ascontiguousarray(a[self.tile_slice(i, j)])
            for i, j in self.coords()
        }

    def assemble(
        self,
        tiles: Dict[Tuple[int, int], np.ndarray],
        *,
        lower_only: bool = False,
    ) -> np.ndarray:
        """Reassemble a matrix from tiles; loud on missing/extra tiles,
        wrong tile shapes, or mixed dtypes.  ``lower_only=True``
        accepts exactly the lower-triangle tile set and zero-fills the
        strict upper triangle (a Cholesky factor)."""
        want = set(self.lower_coords() if lower_only else self.coords())
        got = set(tiles)
        if got != want:
            missing = sorted(want - got)
            extra = sorted(got - want)
            raise BlockError(
                "cannot assemble: "
                f"missing tiles {missing[:8]}{'...' if len(missing) > 8 else ''}, "
                f"unexpected tiles {extra[:8]}{'...' if len(extra) > 8 else ''}"
            )
        dtypes = sorted({str(np.asarray(t).dtype) for t in tiles.values()})
        if len(dtypes) > 1:
            raise BlockError(f"cannot assemble tiles of mixed dtypes {dtypes}")
        out = np.zeros(self.shape, dtype=np.asarray(next(iter(tiles.values()))).dtype)
        for (i, j), t in tiles.items():
            t = np.asarray(t)
            if t.shape != self.tile_shape(i, j):
                raise BlockError(
                    f"tile ({i}, {j}) has shape {t.shape}, layout "
                    f"expects {self.tile_shape(i, j)}"
                )
            out[self.tile_slice(i, j)] = t
        return out

    # -- wire headers ------------------------------------------------------

    def encode_tile_header(self, i: int, j: int) -> np.ndarray:
        r, c = self.tile_shape(i, j)
        return np.frombuffer(
            _TILE_STRUCT.pack(self.grid_rows, self.grid_cols, i, j, r, c),
            dtype=np.uint8,
        ).copy()

    def decode_tile_header(self, arr: np.ndarray) -> Tuple[int, int]:
        """Unpack and VALIDATE one tile header against this layout ->
        ``(row, col)``.  Every mismatch is a loud :class:`BlockError`."""
        a = np.ascontiguousarray(arr)
        if a.dtype != np.uint8 or a.nbytes != _TILE_STRUCT.size:
            raise BlockError(
                "linalg tile header must be a "
                f"uint8[{_TILE_STRUCT.size}] array, got dtype {a.dtype} "
                f"with {a.nbytes} bytes"
            )
        gr, gc, i, j, r, c = _TILE_STRUCT.unpack(a.tobytes())
        if (gr, gc) != (self.grid_rows, self.grid_cols):
            raise BlockError(
                f"tile header is for a {gr}x{gc} grid, this store's "
                f"layout is {self.grid_rows}x{self.grid_cols} "
                f"({self.rows}x{self.cols} in blocks of "
                f"{self.block_rows}x{self.block_cols})"
            )
        self._check_coord(i, j)
        if (r, c) != self.tile_shape(i, j):
            raise BlockError(
                f"tile ({i}, {j}) header claims shape ({r}, {c}), "
                f"layout expects {self.tile_shape(i, j)}"
            )
        return (i, j)

    def check_tile(self, i: int, j: int, tile: np.ndarray) -> np.ndarray:
        """Validate a tile array's shape against the layout (loud)."""
        t = np.asarray(tile)
        if t.shape != self.tile_shape(i, j):
            raise BlockError(
                f"tile ({i}, {j}) array has shape {t.shape}, layout "
                f"expects {self.tile_shape(i, j)}"
            )
        return t


def pack_coords(coords: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Coordinate list -> the ``int64 (n, 2)`` wire array."""
    if not coords:
        return np.zeros((0, 2), dtype=np.int64)
    return np.asarray(list(coords), dtype=np.int64).reshape(-1, 2)


def unpack_coords(arr: np.ndarray) -> List[Tuple[int, int]]:
    a = np.asarray(arr)
    if a.dtype != np.int64 or a.ndim != 2 or a.shape[1] != 2:
        raise BlockError(
            f"coordinate array must be int64 (n, 2), got {a.dtype} {a.shape}"
        )
    return [(int(i), int(j)) for i, j in a]
