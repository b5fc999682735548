"""The block-store node compute.

The port of the JAX package's ``linalg/service.py``.  A stateful
arrays-in/arrays-out compute serving the blocked-linalg operation set
declared in :mod:`..service.wire_registry` (``LINALG_OPCODES``): tiles
ship ONCE (``PUT``), live node-side keyed by grid coordinate, and every
subsequent panel operation references them by block id — steady-state
factorization steps move only the panel, never the matrix.  Deployed on
any transport lane (``serve_tcp_once``/``serve_shm``/``serve_ring``)
like any other compute.

The store keeps its tiles as torch tensors on its device (``cuda``
unless the caller asks for the CPU; without a GPU it raises rather than
quietly holding them on the CPU).  Arrays become numpy only at the
wire: request arrays are copied onto the device, reply tiles copied
back.  Both float32 and float64 tiles run as torch operations on that
device — on an H100 float64 too, which its tensor cores support.

Protocol state is deliberately minimal — a tile dict plus one
``applied_step`` counter — because the DRIVER (:mod:`.ops`) owns
recovery: on a replica failure it restores that replica's trailing
state with a fresh ``PUT`` before retrying the step, so every op here
can assume its inputs are current.  ``applied_step`` exists to make a
retried trailing update idempotent (an update the node already applied
whose reply was lost must not double-subtract) and to make a MISSED
update a loud :class:`.blocks.BlockError` instead of silent numerical
corruption.

Contractions route through :func:`..precision.pdot` for float32 tiles
(the TF32 hazard on Hopper); float64 tiles contract with
``torch.matmul`` directly (the split path is a float32 mitigation and
would downcast).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..precision import matmul_precision_ctx, pdot, resolve_policy
from ..utils import resolve_device
from .blocks import (
    OPCODES,
    BlockError,
    BlockLayout,
    decode_op_header,
    unpack_coords,
)

__all__ = [
    "make_block_store_compute",
    "LocalBlockClient",
    "chol_kernel",
    "trsm_kernel",
    "dot_kernel",
    "is_restore_needed",
]

#: In-band refusals a DRIVER can heal by restoring the replica's
#: trailing tiles and retrying the leg (the store is in the wrong
#: state, not the wrong geometry).  Transport clients retry
#: transparently (reconnect + re-send), so a re-sent panel op can land
#: on a cold respawned store with no transport error ever reaching the
#: driver — these markers are how the stateful protocol reports that
#: loss in-band.  Kept as exact message fragments because the error
#: crosses the wire as text (:class:`..service.tcp.RemoteComputeError`
#: erases the type).
_RESTORE_MARKS = (
    "must be restored with PUT first",
    "the driver must restore before retrying",
    "a missed panel would silently corrupt the factor",
)


def is_restore_needed(exc: BaseException) -> bool:
    """True when ``exc`` is a block-store state refusal the driver heals
    with a restore (re-``PUT`` of trailing tiles) + retry.  Geometry and
    numerical refusals (wrong layout, non-PD tile) never match — those
    are deterministic and must propagate."""
    msg = str(exc)
    return any(mark in msg for mark in _RESTORE_MARKS)


# ---------------------------------------------------------------------------
# numeric kernels (shared with the driver in ops.py — one implementation,
# so a driver-side recovery recompute on the same device is BIT-identical
# to the node's path)
# ---------------------------------------------------------------------------


def dot_kernel(
    a: torch.Tensor, b: torch.Tensor, policy: Optional[str] = None
) -> torch.Tensor:
    """Policy-routed tile contraction ``a @ b`` on one device."""
    if a.dtype == torch.float64 or b.dtype == torch.float64:
        return torch.matmul(a, b)
    return pdot(a, b, policy).to(torch.promote_types(a.dtype, b.dtype))


def chol_kernel(a: torch.Tensor, policy: Optional[str] = None) -> torch.Tensor:
    """Lower Cholesky of one diagonal tile; loud on non-PD input.

    Not :func:`..utils.cholesky_or_nan`: a sampler wants NaN, a
    factorization must refuse.  The check reads one flag back to the
    host, which the panel reply (numpy on the wire) needs anyway."""
    with matmul_precision_ctx(policy):
        l, info = torch.linalg.cholesky_ex(a)
    if bool((info != 0) | ~torch.isfinite(l).all()):
        why = (f"the leading minor of order {int(info)} is not positive"
               if int(info) else "non-finite factor")
        raise BlockError(f"diagonal tile is not positive definite: {why}")
    return l


def trsm_kernel(
    a_ik: torch.Tensor, l_kk: torch.Tensor, policy: Optional[str] = None
) -> torch.Tensor:
    """Panel solve ``X = A_ik @ inv(L_kk)^T`` (right-looking Cholesky's
    off-diagonal step), as the triangular solve ``X L_kk^T = A_ik``."""
    with matmul_precision_ctx(policy):
        x = torch.linalg.solve_triangular(l_kk.mT, a_ik, upper=True, left=False)
    return x.contiguous()


def _host(x: Any) -> np.ndarray:
    """A tile (a tensor on any device, or an array) as the wire carries
    it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the block store
# ---------------------------------------------------------------------------


class _BlockStore:
    """One node's tile state: the dict plus the trailing-update clock."""

    def __init__(
        self, layout: BlockLayout, policy: Optional[str], device: torch.device
    ) -> None:
        self.layout = layout
        self.policy = policy
        self.device = device
        self.tiles: Dict[Tuple[int, int], torch.Tensor] = {}
        #: Number of trailing updates applied (updates for panel steps
        #: ``0..applied_step-1`` are in the stored tiles).
        self.applied_step = 0
        #: Exactly-once replay cache for the current step's panel ops.
        #: CHOL_PANEL/TRSM_PANEL solve tiles IN PLACE, so a re-sent
        #: request (transport clients reconnect and re-send after a
        #: lost reply) re-solving an already-solved panel would be
        #: silent corruption — the replay returns the recorded reply
        #: instead.  Invalidated by PUT (a restore replaces the tiles)
        #: and by the step advancing.
        self._panel_replies: Dict[Tuple[str, int], List[np.ndarray]] = {}

    def _on_device(self, tile: np.ndarray) -> torch.Tensor:
        return torch.tensor(tile, device=self.device)

    # -- op handlers -------------------------------------------------------

    def put(self, step: int, count: int, args: List[np.ndarray]) -> List[np.ndarray]:
        if len(args) != 2 * count:
            raise BlockError(
                f"PUT header claims {count} tiles but carries "
                f"{len(args)} arrays (want {2 * count}: header+tile pairs)"
            )
        staged: Dict[Tuple[int, int], np.ndarray] = {}
        for t in range(count):
            coord = self.layout.decode_tile_header(args[2 * t])
            if coord in staged:
                raise BlockError(f"PUT ships tile {coord} twice")
            staged[coord] = self.layout.check_tile(*coord, args[2 * t + 1])
        self.tiles.update({c: self._on_device(t) for c, t in staged.items()})
        # The driver stamps the restore point: tiles as shipped have
        # exactly `step` trailing updates applied.
        self.applied_step = step
        self._panel_replies.clear()
        return [np.int64(len(self.tiles))]

    def get(self, args: List[np.ndarray]) -> List[np.ndarray]:
        if len(args) != 1:
            raise BlockError(f"GET wants one coordinate array, got {len(args)}")
        out = []
        for coord in unpack_coords(args[0]):
            tile = self.tiles.get(coord)
            if tile is None:
                raise BlockError(
                    f"GET of tile {coord} this store does not hold "
                    f"({len(self.tiles)} tiles stored) — geometry "
                    "disagreement or a restarted replica"
                )
            out.append(_host(tile))
        return out

    def gemm_panel(self, args: List[np.ndarray]) -> List[np.ndarray]:
        if len(args) != 2:
            raise BlockError(f"GEMM_PANEL wants [a, b], got {len(args)} arrays")
        a, b = args
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise BlockError(
                f"GEMM_PANEL shapes do not contract: {a.shape} @ {b.shape}"
            )
        return [_host(dot_kernel(self._on_device(a), self._on_device(b), self.policy))]

    def _own_panel_rows(self, k: int) -> List[int]:
        return sorted(i for (i, j) in self.tiles if j == k and i > k)

    def _require(self, coord: Tuple[int, int], what: str) -> torch.Tensor:
        tile = self.tiles.get(coord)
        if tile is None:
            raise BlockError(
                f"{what} needs tile {coord} this store does not hold — "
                "a restarted replica must be restored with PUT first"
            )
        return tile

    def _check_step(self, op: str, k: int) -> None:
        if self.applied_step != k:
            raise BlockError(
                f"{op} step {k} but this store has "
                f"{self.applied_step} trailing updates applied — "
                "the driver must restore before retrying"
            )

    def _solve_own_rows(self, k: int, l_kk: torch.Tensor, out: List[np.ndarray]) -> None:
        rows = self._own_panel_rows(k)
        out.append(np.asarray(rows, dtype=np.int64))
        for i in rows:
            l_ik = trsm_kernel(self.tiles[(i, k)], l_kk, self.policy)
            self.tiles[(i, k)] = l_ik
            out.append(_host(l_ik))

    def chol_panel(self, k: int, args: List[np.ndarray]) -> List[np.ndarray]:
        if args:
            raise BlockError("CHOL_PANEL carries no arrays beyond the header")
        self._check_step("CHOL_PANEL", k)
        cached = self._panel_replies.get(("chol", k))
        if cached is not None:
            # A re-sent request after a lost reply: the solves already
            # happened in place; solving again would corrupt silently.
            return cached
        a_kk = self._require((k, k), f"CHOL_PANEL({k})")
        l_kk = chol_kernel(a_kk, self.policy)
        self.tiles[(k, k)] = l_kk
        out: List[np.ndarray] = [_host(l_kk)]
        self._solve_own_rows(k, l_kk, out)
        self._panel_replies[("chol", k)] = out
        return out

    def trsm_panel(self, k: int, args: List[np.ndarray]) -> List[np.ndarray]:
        if len(args) != 1:
            raise BlockError(f"TRSM_PANEL wants [L_kk], got {len(args)} arrays")
        self._check_step("TRSM_PANEL", k)
        cached = self._panel_replies.get(("trsm", k))
        if cached is not None:
            return cached
        l_kk = self._on_device(self.layout.check_tile(k, k, args[0]))
        out: List[np.ndarray] = []
        self._solve_own_rows(k, l_kk, out)
        self._panel_replies[("trsm", k)] = out
        return out

    def syrk_update(self, k: int, args: List[np.ndarray]) -> List[np.ndarray]:
        if not args:
            raise BlockError("SYRK_UPDATE wants [rows, panel tiles...]")
        rows_arr = args[0]
        if rows_arr.dtype != np.int64 or rows_arr.ndim != 1:
            raise BlockError(
                f"SYRK_UPDATE rows must be int64 (n,), got "
                f"{rows_arr.dtype} {rows_arr.shape}"
            )
        if self.applied_step > k:
            # Already applied (a retried update whose reply was lost):
            # idempotent no-op, signalled in-band with the -1 sentinel.
            return [np.int64(-1)]
        if self.applied_step < k:
            raise BlockError(
                f"SYRK_UPDATE step {k} but only {self.applied_step} "
                "updates applied — a missed panel would silently "
                "corrupt the factor"
            )
        rows = [int(i) for i in rows_arr]
        if len(args) != 1 + len(rows):
            raise BlockError(
                f"SYRK_UPDATE claims {len(rows)} panel rows but "
                f"carries {len(args) - 1} tiles"
            )
        panel = {}
        for i, tile in zip(rows, args[1:]):
            if i <= k:
                raise BlockError(
                    f"SYRK_UPDATE({k}) panel row {i} is not below the panel"
                )
            panel[i] = self._on_device(self.layout.check_tile(i, k, tile))
        updated = 0
        for (i, j), tile in list(self.tiles.items()):
            if j <= k or j > i:
                continue
            l_ik = panel.get(i)
            l_jk = panel.get(j)
            if l_ik is None or l_jk is None:
                raise BlockError(
                    f"SYRK_UPDATE({k}) needs panel rows {i} and {j} "
                    f"for stored tile ({i}, {j}) but the request only "
                    f"carries rows {sorted(panel)}"
                )
            self.tiles[(i, j)] = tile - dot_kernel(
                l_ik, l_jk.mT, self.policy
            ).to(tile.dtype)
            updated += 1
        self.applied_step = k + 1
        # The step advanced: step-k panel replays are now impossible
        # (the applied_step guard refuses them loudly) and the cache
        # would only pin dead tiles.
        self._panel_replies.clear()
        return [np.int64(updated)]

    def reset(self) -> List[np.ndarray]:
        n = len(self.tiles)
        self.tiles.clear()
        self.applied_step = 0
        self._panel_replies.clear()
        return [np.int64(n)]

    def stats(self) -> List[np.ndarray]:
        return [
            np.int64(len(self.tiles)),
            np.int64(sum(t.numel() * t.element_size() for t in self.tiles.values())),
        ]


def make_block_store_compute(
    layout: BlockLayout,
    *,
    policy: Optional[str] = None,
    device: Any = None,
) -> Callable[..., List[np.ndarray]]:
    """Node-side compute serving the block-store operation set for ONE
    block layout (the layout bakes at deploy time, like a pool
    compute's per-shard function; a driver speaking a different
    geometry gets a loud in-band :class:`BlockError`).  The tiles live
    on ``device``: ``cuda`` unless the caller passes ``device="cpu"``."""
    resolve_policy(policy)  # typo'd policies refuse at deploy time
    store = _BlockStore(layout, policy, resolve_device(device))
    ops = OPCODES

    def compute(*arrays: Any) -> List[np.ndarray]:
        if not arrays:
            raise BlockError("block-store request carries no op header")
        args = [np.asarray(a) for a in arrays]
        opcode, step, count = decode_op_header(args[0])
        rest = args[1:]
        if opcode == ops["PUT"]:
            return store.put(step, count, rest)
        if opcode == ops["GET"]:
            return store.get(rest)
        if opcode == ops["GEMM_PANEL"]:
            return store.gemm_panel(rest)
        if opcode == ops["CHOL_PANEL"]:
            return store.chol_panel(step, rest)
        if opcode == ops["TRSM_PANEL"]:
            return store.trsm_panel(step, rest)
        if opcode == ops["SYRK_UPDATE"]:
            return store.syrk_update(step, rest)
        if opcode == ops["RESET"]:
            return store.reset()
        if opcode == ops["STATS"]:
            return store.stats()
        raise BlockError(f"unhandled linalg opcode {opcode}")

    # Tests and the local lane reach the state for accounting.
    compute.store = store  # type: ignore[attr-defined]
    return compute


class LocalBlockClient:
    """In-process stand-in for a transport client over one block-store
    compute — the clientless lane (``linalg.cholesky(a)`` with no pool)
    and the unit-test seam.  Mirrors the pinned-client ``evaluate``
    surface the driver uses."""

    def __init__(
        self, layout: BlockLayout, *, policy: Optional[str] = None, device: Any = None
    ) -> None:
        self._compute = make_block_store_compute(layout, policy=policy, device=device)

    @property
    def store(self) -> _BlockStore:
        return self._compute.store  # type: ignore[attr-defined]

    def evaluate(self, *arrays: np.ndarray) -> List[np.ndarray]:
        return [np.asarray(a) for a in self._compute(*arrays)]

    def close(self) -> None:  # surface parity with transport clients
        pass
