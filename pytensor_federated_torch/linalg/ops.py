"""Blocked linear-algebra drivers.

The port of the JAX package's ``linalg/ops.py``.  Two families, per the
paper's "N^2 data, N workers" spine (*Large Scale Distributed Linear
Algebra With TPUs*, PAPERS.md):

- **fed-program ops** — :func:`matmul` (SUMMA-style k-panel GEMM:
  partial products per shard, ``fed_sum`` reduction),
  :func:`block_quadratic_form` (block-row reduce through
  :func:`..fed.lowering.canonical_round` — scalar contract, so a
  ``PoolPlacement(reduce=True)`` lowers it to ONE reduced window), and
  the per-step row-update round inside :func:`triangular_solve`.  These
  run on mesh slots, TCP/shm/ring pools, or eagerly, like every other
  fed program, in the inputs' dtype.
- **block-store ops** — :class:`BlockedCholesky` (:func:`cholesky`)
  and :class:`BlockedMatmul` drive the stateful store compute
  (:mod:`.service`): tiles ship once, each factorization step moves
  only the panel, and a replica failure is recovered by restoring THAT
  replica's trailing tiles — never by re-shipping the matrix, and
  never by silently continuing with a stale store (the node refuses
  mismatched steps loudly).

Arrays given as numpy go to the card unless the caller passes
``device="cpu"``; tensors stay where they lie unless ``device`` says
otherwise.  float32 contractions route through :mod:`..precision`'s
policy seam (``pdot``/``dot_kernel``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fed.lowering import canonical_round, program
from ..fed.primitives import fed_broadcast, fed_map, fed_sum
from ..precision import matmul_precision_ctx, pdot, resolve_policy
from ..telemetry import flightrec as _flightrec
from ..utils import resolve_device
from .blocks import (
    OPCODES,
    BlockError,
    BlockLayout,
    encode_op_header,
)
from .service import LocalBlockClient, _host, dot_kernel, is_restore_needed

__all__ = [
    "matmul",
    "matmul_per_shard",
    "block_quadratic_form",
    "quadratic_per_shard",
    "triangular_solve",
    "triangular_update_per_shard",
    "cholesky",
    "BlockedCholesky",
    "BlockedMatmul",
]

#: Transport failures the Cholesky driver treats as a dead/restartable
#: replica (restore-then-retry).  Deterministic failures — in-band
#: ``RemoteComputeError`` (RuntimeError), ``WireError``/``BlockError``
#: (ValueError) — propagate: retrying them would re-run the same wrong
#: request, and a silently absorbed geometry error is exactly the
#: corruption the loud-failure contract forbids.
_TRANSIENT = (ConnectionError, TimeoutError, OSError)


def _device_of(x: Any, device: Any) -> torch.device:
    """Where an op on ``x`` runs: ``device`` when given, else where the
    tensor ``x`` lies, else (numpy input) the card."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# fed-program ops
# ---------------------------------------------------------------------------


def matmul_per_shard(policy: Optional[str] = None) -> Callable:
    """The per-shard SUMMA term ``(a_k, b_k) -> a_k @ b_k`` — exposed
    so pool nodes deploy the SAME callable the driver's ``fed_map``
    maps (``fed.make_node_compute(matmul_per_shard(...),
    grads=False)``), the no-drift convention every fed lane follows."""

    def per_shard(a_k: Any, b_k: Any) -> Any:
        return pdot(a_k, b_k, policy)

    return per_shard


def _k_panels(
    a: torch.Tensor, b: torch.Tensor, n_shards: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split the contraction axis into ``n_shards`` equal panels,
    zero-padding the tail panel (zero columns of ``a`` against zero
    rows of ``b`` contribute exactly zero to every partial product)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise BlockError(
            f"matmul shapes do not contract: {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    s = int(n_shards)
    if s < 1:
        raise BlockError(f"n_shards must be >= 1, got {n_shards!r}")
    k = a.shape[1]
    s = min(s, k)
    kb = -(-k // s)
    pad = s * kb - k
    if pad:
        a = torch.cat([a, a.new_zeros((a.shape[0], pad))], dim=1)
        b = torch.cat([b, b.new_zeros((pad, b.shape[1]))], dim=0)
    ap = a.reshape(a.shape[0], s, kb).permute(1, 0, 2).contiguous()
    bp = b.reshape(s, kb, b.shape[1]).contiguous()
    return ap, bp


def matmul(
    a: Any,
    b: Any,
    *,
    n_shards: int,
    placement: Any = None,
    policy: Optional[str] = None,
    device: Any = None,
) -> torch.Tensor:
    """Blocked GEMM ``a @ b`` as a fed program: the contraction axis
    splits into ``n_shards`` k-panels, each shard contributes one
    partial product, and ``fed_sum`` reduces them — SUMMA's
    broadcast-multiply-reduce round on the federated algebra.

    ``placement=None`` runs eagerly in-process; a ``MeshPlacement``
    shards over devices; a ``PoolPlacement`` ships each panel pair as
    one request to nodes deployed with :func:`matmul_per_shard`.
    Computes in the inputs' dtype; for pinned steady-state iteration
    over a block store use :class:`BlockedMatmul`.
    """
    resolve_policy(policy)
    dev = _device_of(a, device)
    ap, bp = _k_panels(_tensor(a, dev), _tensor(b, dev), n_shards)
    per_shard = matmul_per_shard(policy)

    def model(sa: Any, sb: Any) -> Any:
        parts = fed_map(lambda sh: per_shard(sh[0], sh[1]), (sa, sb))
        return fed_sum(parts)

    return program(model, placement)(ap, bp)


def quadratic_per_shard(policy: Optional[str] = None) -> Callable:
    """Per-shard block-row term of ``x^T A x``:
    ``(x, (panel, x_rows)) -> x_rows @ (panel @ x)`` — one scalar per
    shard, the logp-style contract that keeps the reduce-window
    lowering eligible."""

    def per_shard(x: Any, shard_data: Any) -> Any:
        panel, x_rows = shard_data
        return pdot(x_rows, pdot(panel, x, policy), policy)

    return per_shard


def block_quadratic_form(
    a: Any,
    x: Any,
    *,
    n_shards: int,
    placement: Any = None,
    policy: Optional[str] = None,
    device: Any = None,
) -> torch.Tensor:
    """``x^T A x`` with ``A`` sharded by block-rows, through the
    canonical broadcast->map->sum round (:func:`canonical_round`).

    The per-shard term is scalar and every inexact mapped operand is
    either broadcast-derived (``x``) or a constant of the program (the
    row panels), so under ``PoolPlacement(reduce=True)`` the whole
    round lowers to ONE reduced window — reply bytes scale with pool
    width, not shard count.
    """
    resolve_policy(policy)
    dev = _device_of(a, device)
    a = _tensor(a, dev)
    x = _tensor(x, dev)
    if a.dim() != 2 or x.dim() != 1 or a.shape[1] != x.shape[0]:
        raise BlockError(
            "quadratic form shapes do not contract: "
            f"{tuple(a.shape)} with {tuple(x.shape)}"
        )
    s = min(int(n_shards), a.shape[0])
    if s < 1:
        raise BlockError(f"n_shards must be >= 1, got {n_shards!r}")
    rb = -(-a.shape[0] // s)
    pad = s * rb - a.shape[0]
    rows = torch.cat([a, a.new_zeros((pad, a.shape[1]))], dim=0)
    # x padded along ROWS pairs with the zero panels: zero contribution.
    xr = torch.cat([x, x.new_zeros(pad)])
    panels = rows.reshape(s, rb, a.shape[1]).contiguous()
    x_rows = xr.reshape(s, rb).contiguous()
    model = canonical_round(quadratic_per_shard(policy), (panels, x_rows), s)
    return program(model, placement)(x)


def triangular_update_per_shard(policy: Optional[str] = None) -> Callable:
    """Per-shard term of the triangular solve's trailing row update:
    ``(x_j, l_rows, b_rows) -> b_rows - l_rows @ x_j``.  Exposed so
    pool nodes deploy the same callable the driver maps."""

    def per_shard(x_j: Any, l_rows: Any, b_rows: Any) -> Any:
        return b_rows - pdot(l_rows, x_j, policy)

    return per_shard


def _fwd_solve(
    l_jj: torch.Tensor, rhs: torch.Tensor, policy: Optional[str]
) -> torch.Tensor:
    """``x = inv(L_jj) @ rhs`` for one lower-triangular diagonal tile."""
    with matmul_precision_ctx(policy):
        return torch.linalg.solve_triangular(l_jj, rhs, upper=False)


def _bwd_solve(
    l_jj: torch.Tensor, rhs: torch.Tensor, policy: Optional[str]
) -> torch.Tensor:
    """``x = inv(L_jj^T) @ rhs`` (the transposed/backward tile solve)."""
    with matmul_precision_ctx(policy):
        return torch.linalg.solve_triangular(l_jj.mT, rhs, upper=True)


def triangular_solve(
    l: Any,
    b: Any,
    *,
    block: int = 64,
    policy: Optional[str] = None,
    placement: Any = None,
    n_shards: Optional[int] = None,
    trans: bool = False,
    device: Any = None,
) -> torch.Tensor:
    """Blocked triangular solve ``L x = b`` (``trans=True`` solves
    ``L^T x = b``) for lower-triangular ``L`` — forward (or backward)
    substitution over the tile grid.

    The sequential spine is the per-step diagonal solve; the
    parallelizable bulk is each step's trailing row update
    ``b_rest -= L_panel @ x_j``, which runs as a fed round
    (broadcast ``x_j``, map over row shards) when ``placement`` and
    ``n_shards`` are given, and as one contraction otherwise.
    """
    resolve_policy(policy)
    dev = _device_of(l, device)
    l = _tensor(l, dev)
    b = _tensor(b, dev)
    if l.dim() != 2 or l.shape[0] != l.shape[1]:
        raise BlockError(f"L must be square, got {tuple(l.shape)}")
    vec = b.dim() == 1
    rhs = b.reshape(-1, 1) if vec else b
    if rhs.shape[0] != l.shape[0]:
        raise BlockError(
            f"rhs has {rhs.shape[0]} rows, L is {l.shape[0]}x{l.shape[1]}"
        )
    n = l.shape[0]
    bb = min(int(block), n)
    nb = -(-n // bb)
    x = rhs.to(torch.promote_types(l.dtype, rhs.dtype)).clone()
    steps = range(nb) if not trans else range(nb - 1, -1, -1)
    for j in steps:
        j0 = j * bb
        j1 = min(n, j0 + bb)
        if not trans:
            x[j0:j1] = _fwd_solve(l[j0:j1, j0:j1], x[j0:j1], policy)
            if j1 < n:
                x[j1:] = _row_update(
                    l[j1:, j0:j1], x[j0:j1], x[j1:],
                    placement, n_shards, policy,
                )
        else:
            x[j0:j1] = _bwd_solve(l[j0:j1, j0:j1], x[j0:j1], policy)
            if j0 > 0:
                x[:j0] = _row_update(
                    l[j0:j1, :j0].mT.contiguous(),
                    x[j0:j1], x[:j0], placement, n_shards, policy,
                )
    return x[:, 0] if vec else x


def _row_update(
    l_panel: torch.Tensor,
    x_j: torch.Tensor,
    b_rest: torch.Tensor,
    placement: Any,
    n_shards: Optional[int],
    policy: Optional[str],
) -> torch.Tensor:
    """``b_rest - l_panel @ x_j``, as a fed row-shard round when a
    placement is given (zero-padded tail shard: zero panel rows update
    zero rhs rows — exact), else one contraction."""
    if placement is None or not n_shards or b_rest.shape[0] < 2:
        return b_rest - dot_kernel(l_panel, x_j, policy).to(b_rest.dtype)
    s = min(int(n_shards), b_rest.shape[0])
    r = b_rest.shape[0]
    rb = -(-r // s)
    pad = s * rb - r
    lp = torch.cat(
        [l_panel, l_panel.new_zeros((pad,) + tuple(l_panel.shape[1:]))]
    ).reshape(s, rb, l_panel.shape[1])
    bp = torch.cat(
        [b_rest, b_rest.new_zeros((pad,) + tuple(b_rest.shape[1:]))]
    ).reshape(s, rb, b_rest.shape[1])

    per_shard = triangular_update_per_shard(policy)

    def model(xj: Any, slp: Any, sbp: Any) -> Any:
        pb = fed_broadcast((xj,), s)
        return fed_map(
            lambda sh: per_shard(sh[0][0], sh[1][0], sh[1][1]),
            (pb, (slp, sbp)),
        )

    out = program(model, placement)(x_j.contiguous(), lp, bp)
    return out.reshape(s * rb, b_rest.shape[1])[:r].to(b_rest.dtype)


# ---------------------------------------------------------------------------
# block-store drivers
# ---------------------------------------------------------------------------


class BlockedMatmul:
    """Steady-state blocked GEMM over ONE block-store replica.

    The k-panels split once into stable contiguous arrays and every
    :meth:`run` re-sends the SAME objects, so on the shm/ring lanes
    the pin cache promotes them after the second sighting and
    subsequent iterations move zero request payload bytes.  The replies
    are summed, in panel order, on ``device`` (the card unless the
    caller passes ``device="cpu"``).
    """

    def __init__(
        self,
        a: Any,
        b: Any,
        client: Any,
        *,
        n_panels: int = 4,
        window: int = 8,
        policy: Optional[str] = None,
        device: Any = None,
    ) -> None:
        cpu = torch.device("cpu")
        ap, bp = _k_panels(_tensor(_host(a), cpu), _tensor(_host(b), cpu), n_panels)
        hdr = encode_op_header(OPCODES["GEMM_PANEL"])
        # One shared header object + per-panel stable arrays: every
        # request operand keeps its identity across run() calls.
        self._requests: List[Tuple[np.ndarray, ...]] = [
            (hdr, ap[i].numpy(), bp[i].numpy()) for i in range(ap.shape[0])
        ]
        self.client = client
        self.window = int(window)
        self.device = resolve_device(device)

    def run(self) -> torch.Tensor:
        if hasattr(self.client, "evaluate_many"):
            replies = self.client.evaluate_many(
                self._requests, window=self.window
            )
        else:
            replies = [self.client.evaluate(*r) for r in self._requests]
        out = _tensor(replies[0][0], self.device).clone()
        for r in replies[1:]:
            out += _tensor(r[0], self.device)
        return out


class BlockedCholesky:
    """Distributed right-looking blocked Cholesky over a pool of
    block-store replicas (block-row cyclic placement).

    Per outer step ``k``: the owner of block-row ``k`` factors the
    diagonal tile and panel-solves its own rows (``CHOL_PANEL``), the
    other replicas panel-solve theirs against the shipped ``L_kk``
    (``TRSM_PANEL``), the driver gathers the full panel column from
    the replies, and one ``SYRK_UPDATE`` broadcast applies the
    trailing update — wire traffic per step is O(panel), the matrix
    itself having shipped exactly once at distribution time.

    The driver assembles ``L`` from the panel REPLIES, so node stores
    are only ever read forward; that is what makes recovery local: a
    replica that dies mid-factorization (classified by a transient
    transport error) is reconnected, restored with a fresh ``PUT`` of
    ITS rows' current trailing state, and the step leg retries.  The
    driver recomputes that state on ``device`` from the original tiles
    and the collected panels with :func:`.service.dot_kernel`, the
    node's own SYRK path: on the stores' kind of device the restored
    tiles equal the node path's bit for bit, so a recovered factor
    equals an uninterrupted one.  No other replica re-ships anything,
    and the node's step checks turn any missed/duplicated update into a
    loud :class:`BlockError` instead of a silently wrong factor.

    ``device`` (the card unless the caller passes ``device="cpu"``) is
    where that recompute runs, where the clientless lane's store keeps
    its tiles, and where :meth:`factor` returns the factor.
    """

    def __init__(
        self,
        layout: BlockLayout,
        clients: Optional[Sequence[Any]] = None,
        *,
        policy: Optional[str] = None,
        reconnect: Optional[Callable[[int], Any]] = None,
        restore_attempts: int = 4,
        reconnect_timeout_s: float = 30.0,
        device: Any = None,
    ) -> None:
        if layout.rows != layout.cols or layout.block_rows != layout.block_cols:
            raise BlockError(
                "Cholesky needs a square layout with square tiles, got "
                f"{layout.shape} in {layout.block_rows}x{layout.block_cols}"
            )
        resolve_policy(policy)
        self.layout = layout
        self.policy = policy
        self.device = resolve_device(device)
        self.clients: List[Any] = (
            list(clients)
            if clients is not None
            else [LocalBlockClient(layout, policy=policy, device=self.device)]
        )
        if not self.clients:
            raise BlockError("need at least one block-store client")
        self.reconnect = reconnect
        self.restore_attempts = int(restore_attempts)
        self.reconnect_timeout_s = float(reconnect_timeout_s)
        #: Accounting for the O(panel) / recovery-locality claims:
        #: (replica, coord) of every tile shipped, split by phase.
        self.shipped: List[Tuple[int, Tuple[int, int]]] = []
        self.reshipped: List[Tuple[int, Tuple[int, int]]] = []
        self.restores = 0
        self._a0: Dict[Tuple[int, int], np.ndarray] = {}
        self._l: Dict[Tuple[int, int], np.ndarray] = {}

    # -- placement helpers -------------------------------------------------

    def _owned(self, p: int) -> List[Tuple[int, int]]:
        n = len(self.clients)
        return [c for c in self.layout.lower_coords() if c[0] % n == p]

    def _has_rows_after(self, p: int, k: int) -> bool:
        rows = self.layout.rows_owned(p, len(self.clients))
        return bool(rows) and max(rows) > k

    # -- transport ---------------------------------------------------------

    def _call(self, p: int, k: int, arrays: Sequence[np.ndarray]) -> List[Any]:
        last: Optional[BaseException] = None
        needs_restore = False
        for _attempt in range(self.restore_attempts + 1):
            if needs_restore:
                try:
                    self._restore(p, k)
                    needs_restore = False
                except _TRANSIENT as e2:
                    # A restore that itself hits the dying connection
                    # (the replica is still coming back) burns one
                    # attempt and MUST run again before the leg — a
                    # leg retried over an unrestored store would only
                    # bounce off the node's state guards.
                    last = e2
                    continue
            try:
                return self.clients[p].evaluate(*arrays)
            except _TRANSIENT as e:
                last = e
                _flightrec.record(
                    "linalg.replica_lost",
                    replica=p, step=k, error=type(e).__name__,
                )
                needs_restore = True
            except (BlockError, RuntimeError) as e:
                # The stateful protocol's OTHER loss signal: transport
                # clients reconnect and re-send transparently, so a
                # request can land on a cold restarted store with no
                # transport error ever reaching this driver — the
                # node's state guards report it in-band instead.
                # Geometry/numerical refusals never classify and
                # propagate deterministically.
                if not is_restore_needed(e):
                    raise
                last = e
                _flightrec.record(
                    "linalg.replica_lost",
                    replica=p, step=k, error="stale_store",
                )
                needs_restore = True
        raise BlockError(
            f"replica {p} failed step {k} after "
            f"{self.restore_attempts} restores: {last!r}"
        ) from last

    def _distribute(self, p: int) -> None:
        """Initial tile distribution with the same transient posture as
        the factorization steps: a replica dying mid-PUT reconnects and
        re-ships, bounded by the attempt budget."""
        tiles = {c: self._a0[c] for c in self._owned(p)}
        last: Optional[BaseException] = None
        for _attempt in range(self.restore_attempts + 1):
            try:
                self._put(p, tiles, step=0)
                return
            except _TRANSIENT as e:
                last = e
                _flightrec.record(
                    "linalg.replica_lost",
                    replica=p, step=0, error=type(e).__name__,
                )
                try:
                    self._reconnect(p)
                except _TRANSIENT as e2:
                    last = e2
        raise BlockError(
            f"replica {p} failed initial distribution after "
            f"{self.restore_attempts} reconnects: {last!r}"
        ) from last

    def _reconnect(self, p: int) -> None:
        if self.reconnect is None:
            return
        deadline = time.monotonic() + self.reconnect_timeout_s
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                fresh = self.reconnect(p)
                # Transport constructors are LAZY (no connect until the
                # first evaluate), so a fresh client against a replica
                # that is still respawning looks healthy here and every
                # downstream attempt fast-fails — probe with a stateless
                # STATS round trip so THIS loop (bounded by
                # reconnect_timeout_s) is the one that waits out the
                # respawn.
                fresh.evaluate(encode_op_header(OPCODES["STATS"]))
                old, self.clients[p] = self.clients[p], fresh
                try:
                    old.close()
                except Exception:
                    pass
                return
            except _TRANSIENT as e:
                last = e
                time.sleep(0.2)
        raise BlockError(
            f"could not reconnect replica {p} within "
            f"{self.reconnect_timeout_s:.0f}s: {last!r}"
        ) from last

    # -- recovery ----------------------------------------------------------

    def _trailing_value(self, i: int, j: int, k: int) -> np.ndarray:
        """The current value of trailing tile ``(i, j)`` with ``k``
        updates applied: ``A0_ij - sum_{t<k} L_it @ L_jt^T`` — the
        driver-side twin of the node's SYRK path, on ``device``."""
        dev = self.device
        v = torch.tensor(self._a0[(i, j)], device=dev)
        for t in range(k):
            l_it = torch.tensor(self._l[(i, t)], device=dev)
            l_jt = torch.tensor(self._l[(j, t)], device=dev)
            v = v - dot_kernel(l_it, l_jt.mT, self.policy).to(v.dtype)
        return _host(v)

    def _restore(self, p: int, k: int) -> None:
        """Reconnect replica ``p`` and re-ship ONLY its rows' live
        trailing tiles (columns >= k; earlier columns are finalized in
        the driver's collected factor and never read again)."""
        self.restores += 1
        self._reconnect(p)
        coords = [(i, j) for (i, j) in self._owned(p) if j >= k]
        tiles = {c: self._trailing_value(c[0], c[1], k) for c in coords}
        self._put(p, tiles, step=k, reship=True)
        _flightrec.record(
            "linalg.replica_restored",
            replica=p, step=k, tiles=len(coords),
        )

    def _put(
        self,
        p: int,
        tiles: Dict[Tuple[int, int], np.ndarray],
        *,
        step: int,
        reship: bool = False,
    ) -> None:
        coords = sorted(tiles)
        req: List[np.ndarray] = [
            encode_op_header(OPCODES["PUT"], step, len(coords))
        ]
        for c in coords:
            req.append(self.layout.encode_tile_header(*c))
            req.append(np.ascontiguousarray(tiles[c]))
        self.clients[p].evaluate(*req)
        log = self.reshipped if reship else self.shipped
        log.extend((p, c) for c in coords)

    # -- the factorization -------------------------------------------------

    def factor(self, a: Any) -> torch.Tensor:
        """The lower factor of ``a`` (numpy or a tensor), on ``device``."""
        lay = self.layout
        a = _host(a)
        if a.shape != lay.shape:
            raise BlockError(
                f"matrix shape {a.shape} does not match layout {lay.shape}"
            )
        n_grid = lay.grid_rows
        n_rep = len(self.clients)
        self._a0 = {
            c: np.ascontiguousarray(a[lay.tile_slice(*c)])
            for c in lay.lower_coords()
        }
        self._l = {}
        self.shipped.clear()
        self.reshipped.clear()
        for p in range(n_rep):
            if self._owned(p):
                self._distribute(p)
        for k in range(n_grid):
            owner = k % n_rep
            reply = self._call(
                owner, k, [encode_op_header(OPCODES["CHOL_PANEL"], k)]
            )
            if len(reply) < 2:
                raise BlockError(
                    f"CHOL_PANEL({k}) reply carries {len(reply)} arrays"
                )
            l_kk = np.asarray(reply[0])
            self._l[(k, k)] = l_kk
            panel = self._merge_panel({}, k, reply[1], reply[2:])
            for q in range(n_rep):
                if q == owner or not self._has_rows_after(q, k):
                    continue
                rep = self._call(
                    q, k,
                    [encode_op_header(OPCODES["TRSM_PANEL"], k), l_kk],
                )
                panel = self._merge_panel(panel, k, rep[0], rep[1:])
            want = set(range(k + 1, n_grid))
            if set(panel) != want:
                raise BlockError(
                    f"panel column {k} incomplete: have rows "
                    f"{sorted(panel)}, want {sorted(want)} — refusing "
                    "to assemble a silently partial factor"
                )
            for i, tile in panel.items():
                self._l[(i, k)] = tile
            if panel:
                rows_arr = np.asarray(sorted(panel), dtype=np.int64)
                ptiles = [panel[int(i)] for i in rows_arr]
                req = [
                    encode_op_header(
                        OPCODES["SYRK_UPDATE"], k, len(ptiles)
                    ),
                    rows_arr,
                    *ptiles,
                ]
                for q in range(n_rep):
                    if self._has_rows_after(q, k):
                        self._call(q, k, req)
        return torch.from_numpy(lay.assemble(self._l, lower_only=True)).to(self.device)

    def _merge_panel(
        self,
        panel: Dict[int, np.ndarray],
        k: int,
        rows: Any,
        tiles: Sequence[Any],
    ) -> Dict[int, np.ndarray]:
        rows_arr = np.asarray(rows)
        if rows_arr.dtype != np.int64 or rows_arr.ndim != 1:
            raise BlockError(
                f"panel rows reply must be int64 (n,), got "
                f"{rows_arr.dtype} {rows_arr.shape}"
            )
        if len(tiles) != rows_arr.shape[0]:
            raise BlockError(
                f"panel reply claims {rows_arr.shape[0]} rows but "
                f"carries {len(tiles)} tiles"
            )
        for i, t in zip(rows_arr, tiles):
            i = int(i)
            if i <= k:
                raise BlockError(f"panel column {k} reply names row {i}")
            if i in panel:
                raise BlockError(
                    f"panel row {i} replied by two replicas — "
                    "placement disagreement"
                )
            panel[i] = self.layout.check_tile(i, k, np.asarray(t))
        return panel


def cholesky(
    a: Any,
    *,
    block: int = 64,
    clients: Optional[Sequence[Any]] = None,
    policy: Optional[str] = None,
    reconnect: Optional[Callable[[int], Any]] = None,
    device: Any = None,
) -> torch.Tensor:
    """Lower-Cholesky of a symmetric positive-definite matrix via the
    blocked right-looking factorization.

    With ``clients=None`` the whole algorithm runs against one
    in-process block store on ``device`` (the clientless lane — same
    code path, no wire); with a list of transport clients the tiles
    distribute block-row-cyclically and the factorization runs over the
    pool.  The factor comes back on ``device``: where the tensor ``a``
    lies unless given, the card for numpy input.
    """
    dev = _device_of(a, device)
    a = _host(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise BlockError(f"cholesky needs a square matrix, got {a.shape}")
    bb = min(int(block), a.shape[0])
    layout = BlockLayout(a.shape[0], a.shape[1], bb, bb)
    return BlockedCholesky(
        layout, clients, policy=policy, reconnect=reconnect, device=dev
    ).factor(a)
