"""Replica-pool registry: health/load probing, breakers, routing state.

The reference design polls each node's ``GetLoad`` to decide where
work goes (reference: service.py:88-96, 240-263) — but its clients
stay pinned to whichever server they connected to, so one slow or
dead node stalls the whole graph.  :class:`NodePool` is the missing
registry between "arrays-in/arrays-out RPC" and multi-node
throughput: a set of interchangeable replicas serving the SAME
compute, each carrying

- a :class:`~.breaker.CircuitBreaker` (trip on consecutive failures,
  half-open probe, jittered exponential backoff),
- the last advertised load (the enriched npwire GetLoad reply — queue
  depth, batcher tallies, latency quantiles — or the reference's
  3-field protobuf reply; auto-detected per reply like
  ``get_load_async``), with STALE-LOAD EVICTION: a reply older than
  ``load_stale_s`` stops informing routing decisions,
- this driver's own observations (EWMA per-request latency, local
  in-flight count) as the fallback signal.

Probing lanes per transport:

- ``transport="grpc"`` — the existing ``GetLoad`` lane
  (:func:`~pytensor_federated_torch.service.client.get_load_async`);
  npwire-JSON and reference-protobuf replies both parse.
- ``transport="tcp"`` — the ZERO-ITEM batch probe frame
  (:meth:`~pytensor_federated_torch.service.tcp.TcpArraysClient._probe_batch`'s
  capability handshake) reused as the health check: a live node echoes
  an empty batch reply with the probe's uuid; anything else — refused
  connect, garbage, silence — is a failed probe.  The TCP protocol has
  no GetLoad, so liveness is all it advertises (load fields stay
  ``None`` and routing falls back to EWMA/in-flight).

``start()`` runs the probe sweep on a background daemon thread;
``probe_once()`` is the synchronous sweep (tests, on-demand recovery).
Probe failures feed the SAME breakers as call failures, so a dead
replica is quarantined even while no traffic flows.

Metric families (``pftpu_pool_*``) and
flight-recorder events (``pool.*``) are emitted here and by
:mod:`.pooled_client`; per-replica gauges are labeled by ``replica``
("host:port") so the exposition endpoint renders pool health directly
(``tools/metrics_dump.py --pool``).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import uuid as uuid_mod
from functools import lru_cache
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from concurrent.futures import ThreadPoolExecutor

from ..faultinject import runtime as _fi
from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics
from .breaker import CircuitBreaker
from .budget import RetryBudget
from .policies import get_policy

__all__ = ["NodePool", "Replica"]

HostPort = Tuple[str, int]

# -- pool metric families ---------------

_POOL_REPLICAS = _metrics.gauge(
    "pftpu_pool_replicas",
    "Pool replicas by breaker state",
    ("state",),
)
_POOL_PICKS = _metrics.counter(
    "pftpu_pool_picks_total",
    "Replica picks, by routing policy",
    ("policy",),
)
_POOL_FAILOVERS = _metrics.counter(
    "pftpu_pool_failovers_total",
    "Mid-call failovers onto another replica",
    ("transport",),
)
_POOL_HEDGES = _metrics.counter(
    "pftpu_pool_hedges_total",
    "Hedged requests, by outcome (fired / won / lost)",
    ("outcome",),
)
_POOL_BREAKER_TRANSITIONS = _metrics.counter(
    "pftpu_pool_breaker_transitions_total",
    "Circuit-breaker state transitions, by destination state",
    ("to",),
)
_POOL_PROBE_S = _metrics.histogram(
    "pftpu_pool_probe_seconds", "Per-replica health/load probe latency"
)
_POOL_UP = _metrics.gauge(
    "pftpu_pool_replica_up",
    "1 while the replica's breaker admits traffic, else 0",
    ("replica",),
)
_POOL_QDEPTH = _metrics.gauge(
    "pftpu_pool_replica_queue_depth",
    "Last advertised queue depth (-1 = unknown or stale)",
    ("replica",),
)
_POOL_EWMA = _metrics.gauge(
    "pftpu_pool_replica_ewma_seconds",
    "EWMA per-request latency observed by this driver",
    ("replica",),
)

_EWMA_ALPHA = 0.3


@lru_cache(maxsize=1)
def _remote_compute_error() -> type:
    """Resolve RemoteComputeError once — ``is_transient`` runs per
    member failure, and a per-call import there costs on every
    failure.
    Lazy because routing/ must not import service/ at module level
    (service/tcp.py imports routing.partition — a module-level import
    here would cycle)."""
    from ..service.tcp import RemoteComputeError

    return RemoteComputeError


class Replica:
    """One pool member: address + breaker + routing signals.

    The lazily-created transport client and (sync lanes) its dedicated
    single worker thread hang off the replica so connection state keeps
    the thread/loop affinity the transports require (service/client.py
    connection cache; tcp.py's single-socket lock-step contract).
    ``transport`` is PER REPLICA (default: the pool's), so one pool can
    mix shm replicas (colocated, zero-copy) with grpc/tcp ones — the
    policies, breakers, and failover machinery are transport-blind.
    """

    def __init__(
        self,
        host: str,
        port: int,
        breaker: CircuitBreaker,
        transport: str = "grpc",
        client_kwargs: Optional[dict] = None,
    ) -> None:
        self.host = host
        self.port = int(port)
        self.breaker = breaker
        self.transport = transport
        self.client_kwargs = client_kwargs
        self.ewma_latency_s: Optional[float] = None
        self.load: Optional[dict] = None
        self.load_ts: Optional[float] = None
        self.inflight = 0
        self.client: Optional[Any] = None  # created by NodePool.client_for
        self._executor: Optional["ThreadPoolExecutor"] = None  # TCP worker
        self._lock = threading.Lock()
        self._load_stale_s = 10.0  # overwritten by the owning pool

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def queue_depth(self) -> Optional[float]:
        """Advertised backlog from the last FRESH load reply: server
        batcher queue depth, else in-flight RPCs, else ``n_clients``;
        ``None`` when no load is known or the last one went stale
        (stale-load eviction — routing must not keep trusting a
        snapshot of a node that stopped answering probes)."""
        with self._lock:
            if self.load is None or self.load_ts is None:
                return None
            if time.monotonic() - self.load_ts > self._load_stale_s:
                self.load = None  # evict: stale load misroutes
                return None
            load = self.load
        batch = load.get("batch")
        if isinstance(batch, dict) and "queue_depth" in batch:
            return float(batch["queue_depth"])
        rpc = load.get("rpc")
        if isinstance(rpc, dict) and rpc.get("inflight") is not None:
            return float(rpc["inflight"])
        n = load.get("n_clients")
        return None if n is None else float(n)

    def record_load(self, load: Optional[dict]) -> None:
        with self._lock:
            if load is None:
                self.load = None
                self.load_ts = None
            else:
                self.load = load
                self.load_ts = time.monotonic()

    def record_latency(self, per_request_s: float) -> None:
        with self._lock:
            prev = self.ewma_latency_s
            self.ewma_latency_s = (
                per_request_s
                if prev is None
                else _EWMA_ALPHA * per_request_s + (1 - _EWMA_ALPHA) * prev
            )
        _POOL_EWMA.labels(replica=self.address).set(self.ewma_latency_s)


def _tcp_probe(host: str, port: int, *, timeout: float) -> bool:
    """One-shot TCP liveness check: the zero-item batch probe frame
    over a fresh connection.  A batch-aware node echoes an empty batch
    reply carrying the probe's uuid (tcp.py `_probe_batch` — the same
    frame that negotiates the batch capability); a pre-batch node
    answers SOMETHING well-formed (zero-arrays reply or a decode-error
    frame), which still proves liveness.  Refused/closed/garbled/slow
    is a failed probe."""
    from ..service.npwire import decode_arrays_all, decode_batch, encode_batch, is_batch_frame

    uid = uuid_mod.uuid4().bytes
    frame = encode_batch([], uuid=uid)
    try:
        with socket.create_connection((host, port), timeout=timeout) as s:
            s.settimeout(timeout)
            s.sendall(struct.pack("<I", len(frame)) + frame)
            hdr = b""
            while len(hdr) < 4:
                b = s.recv(4 - len(hdr))
                if not b:
                    return False
                hdr += b
            (n,) = struct.unpack("<I", hdr)
            payload = b""
            while len(payload) < n:
                b = s.recv(n - len(payload))
                if not b:
                    return False
                payload += b
    except (OSError, ConnectionError):
        return False
    try:
        if is_batch_frame(payload):
            items, ruid, err, _tid, _sp = decode_batch(payload)
            return ruid == uid and err is None and not items
        # Pre-batch peer: any decodable npwire reply proves liveness.
        decode_arrays_all(payload)
        return True
    # A garbled reply is a FAILED PROBE — False is this lane's loud
    # in-band verdict (the breaker records it), not a swallowed error.
    except Exception:  # graftlint: disable=wire-loudness -- probe verdict lane
        return False


class NodePool:
    """Registry of interchangeable replicas with probing and routing.

    ``replicas``: a sequence of ``(host, port)``; more can be added or
    removed while the pool runs (:meth:`add_replica` /
    :meth:`remove_replica`).  ``policy``: "p2c" (default),
    "round_robin", "ewma", or any object with ``pick(candidates, k)``.
    ``transport``: "grpc" (GetLoad probe lane + async clients) or
    "tcp" (zero-item-frame probe lane + per-replica worker threads).
    ``client_kwargs`` forwards to the per-replica transport client
    constructor (e.g. ``codec=``, ``use_stream=`` on the gRPC lane).
    """

    def __init__(
        self,
        replicas: Sequence[HostPort] = (),
        *,
        transport: str = "grpc",
        policy: object = "p2c",
        client_kwargs: Optional[dict] = None,
        probe_interval_s: float = 1.0,
        probe_timeout_s: float = 2.0,
        load_stale_s: float = 10.0,
        breaker_kwargs: Optional[dict] = None,
        member_retries: int = 2,
        retry_budget: Optional[RetryBudget] = None,
    ) -> None:
        if transport not in ("grpc", "tcp", "shm", "ring"):
            raise ValueError(
                f"transport must be 'grpc', 'tcp', 'shm' or 'ring', "
                f"got {transport!r}"
            )
        self.transport = transport
        self.policy = get_policy(policy)
        self.policy_name = getattr(self.policy, "name", "custom")
        self.client_kwargs = dict(client_kwargs or {})
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.load_stale_s = float(load_stale_s)
        self.breaker_kwargs = dict(breaker_kwargs or {})
        # fanout_exec.run_members' retry policy when handed this pool:
        # how many times a TRANSIENT member failure is re-run before it
        # surfaces (the member's own pooled client fails over between
        # attempts, so a retry is a different replica, not an instant
        # replay against the dead one).
        self.member_retries = int(member_retries)
        # Retry budget: every amplifying recovery attempt —
        # hedges, failover re-picks, member re-runs — spends from this
        # token bucket via allow_retry(), so a sick pool degrades to
        # one attempt per call instead of multiplying its own load.
        # Always present by default; pass an explicit RetryBudget to
        # tune rate/burst (there is deliberately no "unlimited" knob:
        # unbounded amplification is the overload-collapse mode this
        # subsystem exists to remove).
        self.retry_budget = (
            retry_budget if retry_budget is not None else RetryBudget()
        )
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._probe_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        for host, port in replicas:
            self.add_replica(host, port)

    # -- registry ---------------------------------------------------------

    def _make_replica(
        self,
        host: str,
        port: int,
        transport: Optional[str] = None,
        client_kwargs: Optional[dict] = None,
    ) -> Replica:
        addr = f"{host}:{int(port)}"
        if (transport or self.transport) == "grpc":
            # No gRPC replica can be made in the port yet: loud at
            # registration, never a replica that a later call would
            # have to refuse.
            from ..service._grpc_lane import grpc_lane_unavailable

            grpc_lane_unavailable(f"pool replica {addr}")

        def on_transition(old: str, new: str, _addr: str = addr) -> None:
            _POOL_BREAKER_TRANSITIONS.labels(to=new).inc()
            _flightrec.record(f"pool.breaker_{new}", replica=_addr)
            self._refresh_state_gauges()

        replica = Replica(
            host,
            port,
            CircuitBreaker(on_transition=on_transition, **self.breaker_kwargs),
            transport or self.transport,
            client_kwargs,
        )
        replica._load_stale_s = self.load_stale_s
        return replica

    def add_replica(
        self,
        host: str,
        port: int,
        *,
        transport: Optional[str] = None,
        client_kwargs: Optional[dict] = None,
    ) -> Replica:
        """Register one replica; ``transport`` overrides the pool
        default for THIS replica (``"shm"`` mixes a colocated
        zero-copy node into a grpc/tcp pool).  ``client_kwargs``
        overrides the pool-level kwargs for this replica — a replica
        of a DIFFERENT transport never inherits the pool default's
        kwargs (they target another client class)."""
        if transport is not None and transport not in (
            "grpc", "tcp", "shm", "ring"
        ):
            raise ValueError(
                f"transport must be 'grpc', 'tcp', 'shm' or 'ring', "
                f"got {transport!r}"
            )
        replica = self._make_replica(host, port, transport, client_kwargs)
        with self._lock:
            existing = self._replicas.get(replica.address)
            if existing is not None:
                # Idempotent re-add is fine; a CONFLICTING override is
                # not — silently keeping the old transport would route
                # every call down a lane the caller believes replaced.
                if (
                    transport is not None
                    and existing.transport != transport
                ) or (
                    client_kwargs is not None
                    and existing.client_kwargs != client_kwargs
                ):
                    raise ValueError(
                        f"replica {replica.address} is already "
                        f"registered as transport="
                        f"{existing.transport!r}; remove_replica() "
                        "first to re-register with different settings"
                    )
                return existing
            self._replicas[replica.address] = replica
        _flightrec.record("pool.replica_added", replica=replica.address)
        self._refresh_state_gauges()
        return replica

    def remove_replica(self, host: str, port: int) -> None:
        addr = f"{host}:{int(port)}"
        with self._lock:
            replica = self._replicas.pop(addr, None)
        if replica is None:
            return
        _flightrec.record("pool.replica_removed", replica=addr)
        _POOL_UP.labels(replica=addr).set(0)
        if replica.client is not None:
            close = getattr(replica.client, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        if replica._executor is not None:
            replica._executor.shutdown(wait=False)
        self._refresh_state_gauges()

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def replica_at(self, host: str, port: int) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(f"{host}:{int(port)}")

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- transport clients ------------------------------------------------

    def client_for(self, replica: Replica) -> Any:
        """The replica's lazily-created transport client (dispatched on
        the REPLICA's transport — mixed pools construct per kind).
        ``retries=0`` on purpose: the POOL owns retry/failover — an
        inner retry loop would replay against the very replica being
        failed away from."""
        if replica.client is None:
            # Per-replica kwargs win; pool-level kwargs apply only to
            # replicas of the pool's own transport (they target one
            # specific client class — a codec= meant for grpc must not
            # reach the shm constructor in a mixed pool).
            if replica.client_kwargs is not None:
                kwargs = dict(replica.client_kwargs)
            elif replica.transport == self.transport:
                kwargs = dict(self.client_kwargs)
            else:
                kwargs = {}
            if replica.transport == "grpc":
                from ..service._grpc_lane import grpc_lane_unavailable

                grpc_lane_unavailable(f"a client for {replica.address}")
            elif replica.transport == "shm":
                from ..service.shm import ShmArraysClient

                replica.client = ShmArraysClient(
                    replica.host,
                    replica.port,
                    retries=0,
                    **kwargs,
                )
            elif replica.transport == "ring":
                from ..service.ring import RingArraysClient

                replica.client = RingArraysClient(
                    replica.host,
                    replica.port,
                    retries=0,
                    **kwargs,
                )
            else:
                from ..service.tcp import TcpArraysClient

                replica.client = TcpArraysClient(
                    replica.host,
                    replica.port,
                    retries=0,
                    **kwargs,
                )
        return replica.client

    def executor_for(self, replica: Replica) -> "ThreadPoolExecutor":
        """Sync lanes (tcp/shm): the replica's single worker thread
        (the sync socket client is driven off the event loop via
        ``run_in_executor``; one dedicated thread preserves the
        lock-step single-caller contract)."""
        if replica._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            replica._executor = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"pftpu-pool-{replica.address}",
            )
        return replica._executor

    # -- probing ----------------------------------------------------------

    async def _probe_replica_grpc(self, replica: Replica) -> bool:
        """The GetLoad probe: the gRPC lane's, which the port does not
        carry yet (:mod:`..service._grpc_lane`)."""
        from ..service._grpc_lane import grpc_lane_unavailable

        grpc_lane_unavailable(f"the GetLoad probe of {replica.address}")

    async def probe_once_async(self) -> int:
        """One concurrent probe sweep, dispatched PER REPLICA (mixed
        pools probe each member over its own lane); returns the number
        of replicas that answered.  Success/failure feeds each
        replica's breaker exactly like call outcomes do."""
        import asyncio

        replicas = self.replicas
        loop = asyncio.get_running_loop()

        def one(r: Replica) -> bool:
            if _fi.active_plan is not None:  # chaos seam: probe lane
                if not _fi.probe_filter(r.address):
                    r.record_load(None)
                    return False
            t0 = time.perf_counter()
            # The zero-item batch probe frame: the TCP health check,
            # which the shm doorbell answers too (its npwire fallback
            # lane) — one probe shape for both sync transports.
            ok = _tcp_probe(
                r.host, r.port, timeout=self.probe_timeout_s
            )
            _POOL_PROBE_S.observe(time.perf_counter() - t0)
            # No load schema on the sync probe: liveness only.
            r.record_load({} if ok else None)
            return ok

        results = await asyncio.gather(
            *(
                self._probe_replica_grpc(r)
                if r.transport == "grpc"
                else loop.run_in_executor(None, one, r)
                for r in replicas
            )
        )
        up = 0
        for replica, ok in zip(replicas, results):
            if ok:
                up += 1
                # A probe success RESTORES a tripped/half-open breaker
                # (background probing is the recovery lane) but does
                # not touch a closed one: resetting the call-failure
                # count on every sweep would let a node whose event
                # loop answers probes while its compute path fails
                # hover forever below the trip threshold.
                if replica.breaker.state != "closed":
                    replica.breaker.record_success()
            else:
                _flightrec.record(
                    "pool.probe_failed", replica=replica.address
                )
                replica.breaker.record_failure()
        self._refresh_state_gauges()
        return up

    def probe_once(self) -> int:
        """Sync wrapper over :meth:`probe_once_async`."""
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(self.probe_once_async())

    def start(self) -> None:
        """Start the background probe loop (idempotent)."""
        with self._lock:
            if (
                self._probe_thread is not None
                and self._probe_thread.is_alive()
            ):
                return
            self._stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop,
                name="pftpu-pool-probe",
                daemon=True,
            )
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:  # a probe sweep must never kill the loop
                pass
            self._stop.wait(self.probe_interval_s)

    def stop(self) -> None:
        self._stop.set()
        thread = self._probe_thread
        if thread is not None:
            thread.join(timeout=self.probe_timeout_s + 5.0)
            self._probe_thread = None

    def close(self) -> None:
        """Stop probing and drop every replica (closes clients)."""
        self.stop()
        for replica in self.replicas:
            self.remove_replica(replica.host, replica.port)

    # -- routing ----------------------------------------------------------

    def available_replicas(
        self, exclude: Sequence = ()
    ) -> List[Replica]:
        excluded = {
            e if isinstance(e, str) else e.address for e in exclude
        }
        return [
            r
            for r in self.replicas
            if r.address not in excluded and r.breaker.available()
        ]

    def pick(
        self, k: int = 1, *, exclude: Sequence = ()
    ) -> List[Replica]:
        """Up to ``k`` distinct admitted replicas, policy-ranked.  Each
        returned replica passed ``breaker.acquire()`` — in half-open
        that claims the single probe token, so a recovering replica
        receives exactly one trial call."""
        candidates = self.available_replicas(exclude)
        chosen = []
        for replica in self.policy.pick(candidates, k):
            if replica.breaker.acquire():
                _POOL_PICKS.labels(policy=self.policy_name).inc()
                chosen.append(replica)
        return chosen

    def record_result(
        self,
        replica: Replica,
        ok: bool,
        *,
        latency_s: Optional[float] = None,
        n_requests: int = 1,
    ) -> None:
        """Feed one call outcome back into routing state: breaker,
        EWMA per-request latency, gauges."""
        if ok:
            replica.breaker.record_success()
            if latency_s is not None and n_requests > 0:
                replica.record_latency(latency_s / n_requests)
        else:
            replica.breaker.record_failure()
        self._refresh_state_gauges()

    def start_collector(self, **kwargs: Any) -> Any:
        """Start a fleet collector riding THIS pool's live replica
        registry (:class:`~..telemetry.collector.FleetCollector` with
        ``pool=self``, started): every sweep re-reads the registry, so
        replicas added, removed, or failed over mid-run are followed
        automatically; grpc replicas are scraped over the GetLoad
        ``b"telemetry"`` lane, other transports are reported
        ``unscraped`` unless an ``http_targets=`` exporter mapping is
        passed through.  ``interval_s`` defaults to this pool's probe
        cadence — the fleet view refreshes as often as the health
        view.  The caller owns the returned collector
        (``stop()``/context manager)."""
        from ..telemetry.collector import FleetCollector

        kwargs.setdefault("interval_s", self.probe_interval_s)
        return FleetCollector(pool=self, **kwargs).start()

    # -- recovery + introspection -----------------------------------------

    def recover(self) -> int:
        """On-demand recovery sweep (the elastic-sampling tier): probe
        every replica NOW, let the breakers quarantine the dead, and
        return how many replicas currently admit traffic.  Cheap and
        side-effect-bounded — safe to call from an exception path."""
        try:
            self.probe_once()
        except Exception:
            pass
        return len(self.available_replicas())

    # fanout_exec.run_members' retry policy hooks ------------------------

    def is_transient(self, exc: BaseException) -> bool:
        """Whether a member/call failure is worth retrying through the
        pool (transport trouble) vs deterministic (re-raising).  The
        same classification the transports use: RemoteComputeError and
        other RuntimeErrors are the request's own fault."""
        if isinstance(exc, _remote_compute_error()):
            return False
        from .pooled_client import _grpc_classifier

        aio_error, is_retryable = _grpc_classifier()
        if aio_error is not None and isinstance(exc, aio_error):
            return is_retryable(exc)
        return isinstance(exc, (ConnectionError, OSError, TimeoutError))

    def allow_retry(self, what: str = "retry") -> bool:
        """Charge one amplifying recovery attempt to the pool's retry
        budget (:mod:`.budget`).  ``False`` = exhausted: the caller
        must degrade to single-attempt behavior — skip the hedge, stop
        the failover loop, surface the member failure.  First attempts
        are never charged; only the MULTIPLIER is rationed."""
        return self.retry_budget.try_spend(what=what)

    def backoff_sleep(self, attempt: int) -> None:
        """Jittered exponential pause between member retries."""
        import random

        base = min(0.05 * (2.0 ** attempt), 0.5)
        time.sleep(base * (0.5 + random.random()))

    def _refresh_state_gauges(self) -> None:
        counts = {"closed": 0, "open": 0, "half_open": 0}
        for replica in self.replicas:
            state = replica.breaker.state
            counts[state] = counts.get(state, 0) + 1
            _POOL_UP.labels(replica=replica.address).set(
                1.0 if replica.breaker.available() else 0.0
            )
            depth = replica.queue_depth()
            _POOL_QDEPTH.labels(replica=replica.address).set(
                -1.0 if depth is None else depth
            )
        for state, n in counts.items():
            _POOL_REPLICAS.labels(state=state).set(n)

    def snapshot(self) -> dict:
        """JSON-friendly routing state (mirrors what the per-replica
        gauges expose; used by tests and ad-hoc debugging)."""
        now = time.monotonic()
        return {
            "transport": self.transport,
            "policy": self.policy_name,
            "retry_budget": self.retry_budget.snapshot(),
            "replicas": [
                {
                    "replica": r.address,
                    "state": r.breaker.state,
                    "up": r.breaker.available(),
                    "queue_depth": r.queue_depth(),
                    "ewma_latency_s": r.ewma_latency_s,
                    "inflight": r.inflight,
                    "load_age_s": (
                        None
                        if r.load_ts is None
                        else round(now - r.load_ts, 3)
                    ),
                }
                for r in self.replicas
            ],
        }
