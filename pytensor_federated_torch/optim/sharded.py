"""ZeRO-style sharded optimizer over the replica pool.

Port of the JAX package's ``optim/sharded.py``.  The driver side is the
JAX package's numpy and threads.  The node side takes the port's
optax-shaped Adam (``_adam.adam``; the JAX package takes any ``optax``
transformation, the port ports Adam only) and runs it on the CPU over
the node's O(model/N) slice: slice and state go to the
:class:`~.state.ShardStore` on every step anyway, and the gradient comes
from ``grad_fn`` on whatever device computed it.

A driver-centric loop (the JAX package's ``ppl.svi.StreamingSVI``) keeps
ALL optimizer state on the driver and ships the full gradient home
every step — ``O(model × n_mc × windows)`` reply bytes and
``O(model)`` gradient + ``2×O(model)`` adam state resident on the
driver.  This module inverts that, the DeepSpeed-ZeRO partitioning
applied to the pool wire:

- the flat parameter vector is split by
  :func:`~..routing.partition.plan_partitions` into one contiguous
  shard per OWNER replica;
- each step, the driver sends every owner the step inputs (params
  broadcast whole — they ride the arena pin cache, so steady-state
  requests move almost no payload) stamped with the shard's expected
  step version (the VERSION wire block, flag 128 / field 21 / shm 32);
- the node computes the FULL gradient locally — the gradient never
  crosses the wire — slices its owned shard, applies Adam on the
  slice, CHECKPOINTS the new shard state
  (:class:`~.state.ShardStore`, before the reply leaves), and returns
  only ``[loss, update_slice]`` at ``version + 1``;
- the driver applies each returned update slice to its parameter copy
  (`params[slice] += update` — the same elementwise add
  ``optax.apply_updates`` performs, so driver-centric and sharded
  trajectories are BIT-IDENTICAL for the same inputs).

Exactly-once under failure: the checkpoint-before-reply rule means a
replica killed mid-update leaves either no trace (driver retries) or a
durably applied shard whose retry refusal (``holds == expected + 1``)
tells the driver to RECOVER the slice via the param-refresh lane (a
zero-array versioned request) instead of double-stepping.  Because
adam's step count IS the shard version, ``opt_steps == accepted``
holds per shard under chaos.

Ownership is SOFT: the checkpoint store is a shared directory, so when
a :class:`~..routing.pool.NodePool` is driving, a dead owner's shard
re-binds onto any live replica (which restores the shard from the
store) — failover without losing optimizer state.
"""

from __future__ import annotations

import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import (
    Any,
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from ..faultinject import runtime as _fi
from ..routing.partition import (
    GradPartition,
    PartitionError,
    Reassembler,
    plan_partitions,
)
from ..service.npwire import WireError
from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics
from .state import ShardStore, StaleShardError, parse_stale_error

__all__ = [
    "ShardResult",
    "ShardedOptimizer",
    "make_update_compute",
]

SHARD_UPDATES = _metrics.counter(
    "pftpu_sharded_updates_total",
    "Sharded-optimizer per-shard step outcomes",
    ("outcome",),
)

GradFn = Callable[..., Tuple[Any, Any]]
ArraysFor = Union[
    Sequence[np.ndarray],
    Callable[[int, GradPartition], Sequence[np.ndarray]],
]


# ---------------------------------------------------------------------------
# node side: the versioned update compute
# ---------------------------------------------------------------------------


def _restore_opt_state(optimizer: Any, leaves: List[np.ndarray]) -> Any:
    """Rebuild the optimizer state from checkpointed leaves (the
    structure is the optimizer's own, never stored), so any replica
    running the same optimizer restores any replica's checkpoint, a JAX
    node's included."""
    expected = len(optimizer.init(torch.zeros(0)))
    if len(leaves) != expected:
        raise WireError(
            f"shard checkpoint has {len(leaves)} optimizer-state leaves "
            f"but this optimizer expects {expected} — the store was "
            "written by a different optimizer"
        )
    return optimizer.restore(leaves)


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_update_compute(
    grad_fn: GradFn,
    optimizer: Any,
    store: ShardStore,
    *,
    params_of: Callable[[Sequence[np.ndarray]], np.ndarray],
) -> Callable[..., list]:
    """Node-side compute for a sharded-optimizer OWNER replica.

    ``grad_fn(*arrays) -> (loss, flat_grad)`` computes the step loss
    and the FULL flat gradient (length = the partition's ``total``)
    from the request arrays — built from the same loss function the
    driver lane differentiates, so the two lanes cannot drift.
    ``params_of(arrays)`` extracts the full flat parameter vector from
    the request (used once, to initialize the shard at version 0).

    The returned compute REFUSES plain calls (a sharded-optimizer node
    only serves versioned requests) and carries the
    ``versioned_update(arrays, part, step_version)`` handler the
    tcp/shm servers dispatch versioned frames to:

    - **update** (arrays present): version-check against the shard's
      checkpoint (mismatch → :class:`~.state.StaleShardError`, in-band
      and machine-parseable), slice the local gradient, apply the
      optimizer on the slice, checkpoint at ``version + 1`` BEFORE
      replying ``[loss, update_slice]``;
    - **refresh** (zero arrays): return ``[param_slice]`` at the
      shard's checkpointed version — the lazy all-gather lane a driver
      uses to recover a slice whose update applied but whose reply was
      lost.  A shard OLDER than the requested version is refused
      (StaleShardError): the driver already saw newer state, so
      serving the old slice would silently rewind it.
    """

    def compute(*arrays: Any) -> list:
        raise RuntimeError(
            "sharded-optimizer node: plain (unversioned) requests are "
            "not served here — stamp a step version (evaluate_versioned)"
        )

    def versioned_update(
        arrays: Sequence[np.ndarray],
        part: Optional[Tuple[int, ...]],
        step_version: int,
    ) -> Tuple[List[np.ndarray], int]:
        if part is None:
            raise WireError(
                "versioned sharded-optimizer request without a "
                "partition block — the version stamps a SHARD"
            )
        p = GradPartition(*part).validate()

        if not arrays:  # -- refresh lane --------------------------------
            state = store.load(p)
            if state is None:
                raise WireError(
                    f"refresh of uninitialized shard {p.index}/{p.count} "
                    f"(geometry total={p.total}) — no checkpoint in the "
                    "store"
                )
            if state.version < step_version:
                raise StaleShardError(p, state.version, step_version)
            return [np.asarray(state.params)], state.version

        # -- update lane ---------------------------------------------
        state = store.load(p)
        if state is None:
            if step_version != 0:
                # A lost checkpoint under a non-zero expectation is
                # divergence, not init — holds=0 makes the driver's
                # classification refuse loudly.
                raise StaleShardError(p, 0, step_version)
            full = np.asarray(params_of(arrays)).ravel()
            if full.size != p.total:
                raise PartitionError(
                    f"request params carry {full.size} elements but the "
                    f"partition declares total {p.total}"
                )
            params_slice = full[p.offset : p.offset + p.length].copy()
            opt_state = optimizer.init(torch.from_numpy(params_slice))
        else:
            if state.version != step_version:
                raise StaleShardError(p, state.version, step_version)
            params_slice = np.asarray(state.params)
            opt_state = _restore_opt_state(optimizer, state.opt_leaves)

        loss, flat_grad = grad_fn(*arrays)
        flat_grad = _to_numpy(flat_grad).ravel()
        if flat_grad.size != p.total:
            raise PartitionError(
                f"grad_fn produced {flat_grad.size} gradient elements "
                f"but the partition declares total {p.total}"
            )
        gslice = torch.from_numpy(flat_grad[p.offset : p.offset + p.length].copy())
        updates, new_opt_state = optimizer.update(gslice, opt_state)
        update_slice = updates.numpy()
        new_params = (torch.from_numpy(params_slice) + updates).numpy()
        # Checkpoint BEFORE the reply leaves: the exactly-once story.
        store.save(
            p,
            step_version + 1,
            new_params,
            optimizer.leaves(new_opt_state),
        )
        return [_to_numpy(loss), update_slice], step_version + 1

    compute.versioned_update = versioned_update  # type: ignore[attr-defined]
    return compute


# ---------------------------------------------------------------------------
# driver side
# ---------------------------------------------------------------------------


class ShardResult(NamedTuple):
    """One shard's outcome for one step.

    ``status``:

    - ``"applied"`` — the node stepped; ``update`` is the optimizer's
      update slice (ADD it to the owned parameter range).
    - ``"recovered"`` — the update had ALREADY applied node-side (a
      lost reply); ``params`` is the refreshed parameter slice
      (OVERWRITE the owned range).  Counts as an accepted step.
    - ``"stale"`` — the node refused without stepping (a bad stamp,
      e.g. chaos ``stale_param_version``); nothing to apply.
    - ``"failed"`` — transport/compute failure after the pool's
      failover budget; ``error`` carries the exception for the
      caller's classification.
    """

    index: int
    status: str
    version: int
    loss: Optional[float] = None
    update: Optional[np.ndarray] = None
    params: Optional[np.ndarray] = None
    error: Optional[BaseException] = None

    @property
    def accepted(self) -> bool:
        return self.status in ("applied", "recovered")


class ShardedOptimizer:
    """Driver-side coordinator of one sharded-optimizer group.

    ``clients``: pinned transport clients (tcp/shm), one OWNER per
    shard — or pass ``pool=`` (a :class:`~..routing.pool.NodePool` of
    tcp/shm replicas) with ``count=`` and shards bind to replicas
    lazily, re-binding on failure (the shared
    :class:`~.state.ShardStore` makes any replica able to restore any
    shard).  gRPC replicas have no versioned-update lane and are
    refused loudly at bind time.

    The driver here holds NO gradient and NO optimizer state — only
    the per-shard version vector and, transiently, one update slice
    per shard (``O(model/N)`` each; ``max_reply_elems`` records the
    high-water mark, asserted O(model/N) in tests).
    """

    def __init__(
        self,
        total: int,
        *,
        clients: Optional[Sequence[Any]] = None,
        pool: Optional[Any] = None,
        count: Optional[int] = None,
        failover_retries: int = 2,
    ) -> None:
        if (clients is None) == (pool is None):
            raise ValueError("pass exactly one of clients= or pool=")
        if clients is not None:
            count = len(clients)
        if not count or count < 1:
            raise ValueError("count must be >= 1 (pass count= with pool=)")
        self.total = int(total)
        self.count = int(count)
        self.parts: List[GradPartition] = plan_partitions(
            self.total, self.count
        )
        self._clients = list(clients) if clients is not None else None
        self._pool = pool
        self._owners: List[Optional[Any]] = [None] * self.count
        self.failover_retries = int(failover_retries)
        #: Per-shard step version — the driver's belief of each shard's
        #: checkpointed version; equals the shard's accepted-step count.
        self.versions: List[int] = [0] * self.count
        #: High-water mark of reply elements received for one shard —
        #: the driver-residency witness (never exceeds ceil(total/N)).
        self.max_reply_elems = 0
        self._hwm_lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = None
        # Transport clients are lock-step (one frame in flight per
        # socket): two shards bound to the SAME replica must serialize
        # their calls or interleave frames on one connection.
        self._client_locks: Dict[int, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    # -- shard → client binding ---------------------------------------

    @staticmethod
    def _require_versioned(client: Any, who: str) -> Any:
        if not hasattr(client, "evaluate_versioned"):
            raise TypeError(
                f"{who} has no versioned-update lane "
                "(evaluate_versioned) — sharded optimizers need tcp or "
                "shm replicas, not grpc"
            )
        return client

    def _bind(self, k: int, *, exclude: Sequence[str] = ()) -> Any:
        """The shard's current client; with a pool, (re)bind to an
        admitted replica — preferring replicas not already owning a
        shard — and validate the transport."""
        if self._clients is not None:
            return self._require_versioned(
                self._clients[k], f"shard {k}'s client"
            )
        owner = self._owners[k]
        if owner is not None and owner.breaker.available():
            if owner.address not in exclude:
                return self._require_versioned(
                    self._pool.client_for(owner),
                    f"replica {owner.address}",
                )
        taken = {
            r.address
            for j, r in enumerate(self._owners)
            if r is not None and j != k
        }
        picked = self._pool.pick(1, exclude=list(taken | set(exclude)))
        if not picked:  # every replica already owns a shard: share
            picked = self._pool.pick(1, exclude=list(exclude))
        if not picked:
            raise ConnectionError(
                f"no admitted replica available to own shard {k}"
            )
        self._owners[k] = picked[0]
        _flightrec.record(
            "optim.shard_bound", shard=k, replica=picked[0].address
        )
        return self._require_versioned(
            self._pool.client_for(picked[0]), f"replica {picked[0].address}"
        )

    def _owner_address(self, k: int) -> Optional[str]:
        owner = self._owners[k]
        return None if owner is None else owner.address

    def _record(self, k: int, ok: bool) -> None:
        if self._pool is not None and self._owners[k] is not None:
            self._pool.record_result(self._owners[k], ok)

    # -- the step -------------------------------------------------------

    def _client_lock(self, client: Any) -> threading.Lock:
        with self._locks_guard:
            lock = self._client_locks.get(id(client))
            if lock is None:
                lock = self._client_locks[id(client)] = threading.Lock()
            return lock

    def _refresh(self, k: int, client: Any, want: int) -> np.ndarray:
        """The param-refresh lane: a zero-array versioned request for
        shard ``k`` at version ``want``; returns the parameter slice."""
        if _fi.active_plan is not None:  # chaos seam: refresh lane
            _fi.refresh_filter("optim.refresh", peer=self._owner_address(k))
        with self._client_lock(client):
            outputs, rv = client.evaluate_versioned(
                partition=self.parts[k], version=want
            )
        if rv is None or rv < want or not outputs:
            raise WireError(
                f"shard {k} refresh returned version {rv} "
                f"(wanted >= {want}) with {len(outputs)} arrays"
            )
        slice_ = np.asarray(outputs[0]).ravel()
        if slice_.size != self.parts[k].length:
            raise PartitionError(
                f"shard {k} refresh carried {slice_.size} elements but "
                f"the partition declares length {self.parts[k].length}"
            )
        self.versions[k] = int(rv)
        return slice_

    def _step_shard(
        self, k: int, arrays: Sequence[np.ndarray]
    ) -> ShardResult:
        part = self.parts[k]
        want = self.versions[k]
        attempts = 0
        exclude: List[str] = []
        while True:
            try:
                client = self._bind(k, exclude=exclude)
            except ConnectionError as e:
                SHARD_UPDATES.labels(outcome="failed").inc()
                return ShardResult(k, "failed", want, error=e)
            stamp = want
            if _fi.active_plan is not None:  # chaos seam: version stamp
                stamp = _fi.version_filter(
                    "optim.update.version", want,
                    peer=self._owner_address(k),
                )
            try:
                with self._client_lock(client):
                    outputs, rv = client.evaluate_versioned(
                        *arrays, partition=part, version=stamp
                    )
            except (ConnectionError, OSError, TimeoutError) as e:
                # Transport failure: the node may or may not have
                # applied — the retry's version check disambiguates
                # (an applied update refuses holds == want + 1 below).
                self._record(k, ok=False)
                if (
                    self._pool is None
                    or attempts >= self.failover_retries
                    or not self._pool.allow_retry("shard_failover")
                ):
                    SHARD_UPDATES.labels(outcome="failed").inc()
                    return ShardResult(k, "failed", want, error=e)
                attempts += 1
                if self._owners[k] is not None:
                    exclude.append(self._owners[k].address)
                    self._owners[k] = None
                _flightrec.record("optim.shard_failover", shard=k)
                continue
            except RuntimeError as e:
                stale = parse_stale_error(str(e))
                if stale is None:
                    self._record(k, ok=True)  # the node answered
                    SHARD_UPDATES.labels(outcome="failed").inc()
                    return ShardResult(k, "failed", want, error=e)
                _idx, _cnt, holds, _expected = stale
                if holds == want + 1:
                    # Applied but the reply was lost (or a retry after
                    # a mid-reply death): recover the slice.
                    try:
                        slice_ = self._refresh(k, client, holds)
                    except (ConnectionError, OSError, TimeoutError) as re:
                        self._record(k, ok=False)
                        SHARD_UPDATES.labels(outcome="failed").inc()
                        return ShardResult(k, "failed", want, error=re)
                    self._record(k, ok=True)
                    # Adopt the node's version: without this the next
                    # step re-sends the stale stamp and "recovers"
                    # forever — the shard would never step again.
                    self.versions[k] = int(holds)
                    with self._hwm_lock:
                        self.max_reply_elems = max(
                            self.max_reply_elems, slice_.size
                        )
                    SHARD_UPDATES.labels(outcome="recovered").inc()
                    _flightrec.record(
                        "optim.shard_recovered", shard=k, version=holds
                    )
                    return ShardResult(
                        k, "recovered", holds, params=slice_
                    )
                if holds == want:
                    # The node did NOT step (a twisted/corrupt stamp —
                    # chaos stale_param_version): nothing to apply,
                    # nothing to count.
                    self._record(k, ok=True)
                    SHARD_UPDATES.labels(outcome="stale").inc()
                    return ShardResult(k, "stale", want, error=e)
                raise WireError(
                    f"shard {k} diverged: node holds version {holds}, "
                    f"driver believes {want} — refusing to continue "
                    "(a silent rewind or double-step would corrupt the "
                    "trajectory)"
                ) from e
            # -- success -------------------------------------------------
            self._record(k, ok=True)
            if rv != want + 1:
                raise WireError(
                    f"shard {k} update replied version {rv}, expected "
                    f"{want + 1}"
                )
            if len(outputs) != 2:
                raise WireError(
                    f"shard {k} update replied {len(outputs)} arrays, "
                    "expected [loss, update_slice]"
                )
            update = np.asarray(outputs[1]).ravel()
            if update.size != part.length:
                raise PartitionError(
                    f"shard {k} update slice carries {update.size} "
                    f"elements but the partition declares {part.length}"
                )
            self.versions[k] = int(rv)
            with self._hwm_lock:
                self.max_reply_elems = max(
                    self.max_reply_elems, update.size
                )
            SHARD_UPDATES.labels(outcome="applied").inc()
            return ShardResult(
                k,
                "applied",
                int(rv),
                loss=float(np.asarray(outputs[0])),
                update=update,
            )

    def step(self, arrays_for: ArraysFor) -> List[ShardResult]:
        """One sharded step: dispatch every owner's versioned update.

        ``arrays_for`` is either one shared request array list (every
        owner sees the same minibatch — the exact-equivalence mode) or
        a callable ``(shard_index, partition) -> arrays`` (disjoint
        per-owner minibatches — the bandwidth mode).  Returns one
        :class:`ShardResult` per shard; per-shard failures are
        returned, not raised (the caller owns classification), but
        version DIVERGENCE raises — that is never safe to continue
        past.

        Owners are dispatched CONCURRENTLY (each shard talks to its
        own replica connection; per-shard state — version, owner
        binding — is only ever touched by its own dispatch), so a
        step's wall clock is the slowest owner, not the sum.  The
        ambient deadline crosses the executor hop via the repo's
        ``copy_context`` convention."""

        def one(k: int) -> ShardResult:
            arrays = (
                arrays_for(k, self.parts[k])
                if callable(arrays_for)
                else arrays_for
            )
            return self._step_shard(k, list(arrays))

        if self.count == 1:
            return [one(0)]
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=min(self.count, 16),
                thread_name_prefix="pftpu-sharded-step",
            )
        futures = [
            self._executor.submit(contextvars.copy_context().run, one, k)
            for k in range(self.count)
        ]
        # Collect in shard order; a divergence WireError from any
        # shard propagates after every in-flight dispatch settles
        # (never leaves a straggler racing the caller).
        results: List[Union[ShardResult, BaseException]] = []
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                results.append(e)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return results  # type: ignore[return-value]

    # -- applying results ------------------------------------------------

    def apply(
        self, flat_params: np.ndarray, results: Sequence[ShardResult]
    ) -> Tuple[np.ndarray, List[int]]:
        """Fold a step's shard results into the driver's flat parameter
        copy: ``applied`` slices ADD their update (the elementwise
        ``optax.apply_updates`` add), ``recovered`` slices OVERWRITE
        with the refreshed params.  Returns ``(new_flat, accepted shard
        indices)``; the input array is not mutated."""
        flat = np.array(flat_params, copy=True).ravel()
        if flat.size != self.total:
            raise PartitionError(
                f"flat params carry {flat.size} elements, expected "
                f"{self.total}"
            )
        accepted: List[int] = []
        for res in results:
            p = self.parts[res.index]
            if res.status == "applied":
                flat[p.offset : p.offset + p.length] += res.update
                accepted.append(res.index)
            elif res.status == "recovered":
                flat[p.offset : p.offset + p.length] = res.params
                accepted.append(res.index)
        return flat, accepted

    def flat_update(
        self, results: Sequence[ShardResult]
    ) -> Tuple[float, np.ndarray]:
        """The exact lane's assembly: every shard must have APPLIED
        (loud :class:`~..routing.partition.PartitionError` otherwise,
        via the Reassembler's completeness check); returns
        ``(mean_loss, full flat update vector)``."""
        applied = [r for r in results if r.status == "applied"]
        dtype = (
            applied[0].update.dtype if applied else np.dtype(np.float64)
        )
        asm = Reassembler(self.total, self.count, dtype)
        for res in applied:
            asm.add(self.parts[res.index], res.update)
        flat = asm.result()
        losses = [r.loss for r in applied if r.loss is not None]
        return float(np.mean(losses)), flat
