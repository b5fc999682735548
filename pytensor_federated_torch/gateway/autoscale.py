"""Replica autoscaling for the gateway tier.

Spawn and drain pool replicas from OBSERVED pressure — the signals the
fleet plane already computes, not guesses: the gateway's
fair-queue depth, the pool's EWMA per-request latency, and the
gateway's shed/denial rate.  Scaling actions ride the machinery the
pool already has:

- **scale-up** registers the new replica only after it answers the
  liveness probe (the zero-item batch frame) — a cold replica never
  receives a traffic share it cannot serve — and from there the
  breaker's half-open ladder owns warm-up: a fresh replica that flaps
  is quarantined after ``failure_threshold`` failures and wins traffic
  back through a SINGLE half-open probe, never a thundering herd
  (:mod:`..routing.breaker`).
- **scale-down** is the graceful-drain shape: the replica leaves
  the pool registry FIRST (no new picks; the gateway's in-flight
  upstream window completes on its own connection), then after
  ``drain_grace_s`` the operator's ``stop_replica`` callback reaps the
  process.  A registered collector is told to drop the replica's
  scrape target in the same step (departed replicas must not linger
  as stale targets).

**Hysteresis** so flapping replicas don't thrash the scaler: an action
fires only after ``consecutive`` consecutive over-threshold
observations, scale-up and scale-down have separate thresholds with a
dead band between them, and each action arms a per-direction cooldown.
Decisions and outcomes are loud: ``pftpu_gateway_autoscale_total``
plus ``gateway.autoscale`` flight-recorder points.

``step()`` is the synchronous, clock-injectable decision function
(tests drive it directly); ``start()`` runs it on a daemon thread at
``interval_s``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..routing.pool import NodePool, _tcp_probe
from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics

__all__ = ["Autoscaler", "ReplicaHandle"]

_AUTOSCALE = _metrics.counter(
    "pftpu_gateway_autoscale_total",
    "Autoscaler actions, by direction and outcome",
    ("direction", "outcome"),
)
_AUTOSCALE_REPLICAS = _metrics.gauge(
    "pftpu_gateway_autoscaled_replicas",
    "Replicas currently owned (spawned) by the gateway autoscaler",
)

#: (host, port, opaque-handle) — what ``spawn_replica`` returns; the
#: handle travels back into ``stop_replica`` untouched.
ReplicaHandle = Tuple[str, int, Any]


class Autoscaler:
    """Queue-pressure-driven replica scaling over a
    :class:`~..routing.pool.NodePool`.

    ``signals``: a callable returning the gateway's observation dict
    (:meth:`~.server.GatewayServer.signals`: ``queue_depth`` plus
    rolling ``shed``/``denied`` counters).  ``spawn_replica()`` must
    start a node and return ``(host, port, handle)``;
    ``stop_replica(handle)`` reaps it.  ``collector`` (optional): a
    :class:`~..telemetry.collector.FleetCollector` whose http-target
    registry follows spawned/drained replicas (``exporter_of(host,
    port)`` maps a replica to its exporter address when the node
    exposes one)."""

    def __init__(
        self,
        pool: NodePool,
        signals: Callable[[], Dict[str, float]],
        spawn_replica: Callable[[], ReplicaHandle],
        stop_replica: Callable[[Any], None],
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        scale_up_queue_depth: float = 16.0,
        scale_down_queue_depth: float = 2.0,
        scale_up_ewma_s: Optional[float] = None,
        scale_up_shed_rate: Optional[float] = None,
        consecutive: int = 2,
        cooldown_up_s: float = 2.0,
        cooldown_down_s: float = 10.0,
        warmup_timeout_s: float = 20.0,
        drain_grace_s: float = 1.0,
        interval_s: float = 1.0,
        transport: str = "tcp",
        collector: Optional[Any] = None,
        exporter_of: Optional[
            Callable[[str, int], Optional[Tuple[str, int]]]
        ] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if scale_down_queue_depth >= scale_up_queue_depth:
            raise ValueError(
                "need scale_down_queue_depth < scale_up_queue_depth "
                "(the hysteresis dead band), got "
                f"{scale_down_queue_depth} >= {scale_up_queue_depth}"
            )
        self.pool = pool
        self.signals = signals
        self.spawn_replica = spawn_replica
        self.stop_replica = stop_replica
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_queue_depth = float(scale_up_queue_depth)
        self.scale_down_queue_depth = float(scale_down_queue_depth)
        self.scale_up_ewma_s = scale_up_ewma_s
        self.scale_up_shed_rate = scale_up_shed_rate
        self.consecutive = int(consecutive)
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.warmup_timeout_s = float(warmup_timeout_s)
        self.drain_grace_s = float(drain_grace_s)
        self.interval_s = float(interval_s)
        self.transport = transport
        self.collector = collector
        self.exporter_of = exporter_of
        self._clock = clock
        #: Replicas THIS scaler spawned (never drains the seed set).
        self.owned: List[ReplicaHandle] = []
        self._hot_streak = 0
        self._cold_streak = 0
        self._cooldown_until = {"up": 0.0, "down": 0.0}
        self._last_shed: Optional[float] = None
        self._last_step_t: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()

    # -- observation ------------------------------------------------------

    def _shed_rate(self, sig: Dict[str, float], now: float) -> float:
        """Sheds+denials per second since the previous step (rolling
        counters differenced against the injectable clock)."""
        total = float(sig.get("shed", 0.0)) + float(sig.get("denied", 0.0))
        if self._last_shed is None or self._last_step_t is None:
            rate = 0.0
        else:
            dt = max(now - self._last_step_t, 1e-6)
            rate = max(0.0, total - self._last_shed) / dt
        self._last_shed = total
        self._last_step_t = now
        return rate

    def _max_ewma_s(self) -> float:
        vals = [
            r.ewma_latency_s
            for r in self.pool.replicas
            if r.ewma_latency_s is not None
        ]
        return max(vals) if vals else 0.0

    def _pressure(self, sig: Dict[str, float], now: float) -> bool:
        if float(sig.get("queue_depth", 0.0)) >= self.scale_up_queue_depth:
            return True
        if (
            self.scale_up_ewma_s is not None
            and self._max_ewma_s() >= self.scale_up_ewma_s
        ):
            return True
        if (
            self.scale_up_shed_rate is not None
            and self._shed_rate(sig, now) >= self.scale_up_shed_rate
        ):
            return True
        return False

    # -- decision ---------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One observation + (maybe) one action; returns ``"up"``,
        ``"down"``, or ``None``.  Thread-safe against concurrent
        ``start()``-loop steps."""
        with self._lock:
            return self._step_locked(
                self._clock() if now is None else now
            )

    def _step_locked(self, now: float) -> Optional[str]:
        sig = self.signals()
        hot = self._pressure(sig, now)
        depth = float(sig.get("queue_depth", 0.0))
        cold = depth <= self.scale_down_queue_depth and not hot
        self._hot_streak = self._hot_streak + 1 if hot else 0
        self._cold_streak = self._cold_streak + 1 if cold else 0
        n = len(self.pool)
        if (
            self._hot_streak >= self.consecutive
            and n < self.max_replicas
            and now >= self._cooldown_until["up"]
        ):
            self._hot_streak = 0
            self._cooldown_until["up"] = now + self.cooldown_up_s
            return "up" if self._scale_up() else None
        if (
            self._cold_streak >= self.consecutive
            and self.owned
            and n > self.min_replicas
            and now >= self._cooldown_until["down"]
        ):
            self._cold_streak = 0
            self._cooldown_until["down"] = now + self.cooldown_down_s
            return "down" if self._scale_down() else None
        return None

    def _scale_up(self) -> bool:
        try:
            host, port, handle = self.spawn_replica()
        except Exception as e:
            _AUTOSCALE.labels(direction="up", outcome="spawn_failed").inc()
            _flightrec.record(
                "gateway.autoscale", direction="up",
                outcome="spawn_failed", error=str(e)[:200],
            )
            return False
        # Warm-up gate: the replica joins the pool only once it answers
        # the liveness probe — before that it has no traffic share at
        # all; after joining, the breaker half-open ladder owns any
        # subsequent flap (module docstring).
        deadline = time.monotonic() + self.warmup_timeout_s
        while time.monotonic() < deadline:
            if _tcp_probe(host, port, timeout=1.0):
                break
            time.sleep(0.05)
        else:
            _AUTOSCALE.labels(
                direction="up", outcome="warmup_timeout"
            ).inc()
            _flightrec.record(
                "gateway.autoscale", direction="up",
                outcome="warmup_timeout", replica=f"{host}:{port}",
            )
            try:
                self.stop_replica(handle)
            except Exception:
                pass
            return False
        self.pool.add_replica(host, port, transport=self.transport)
        self.owned.append((host, port, handle))
        _AUTOSCALE_REPLICAS.set(len(self.owned))
        self._register_scrape(host, port)
        _AUTOSCALE.labels(direction="up", outcome="ok").inc()
        _flightrec.record(
            "gateway.autoscale", direction="up", outcome="ok",
            replica=f"{host}:{port}", pool_size=len(self.pool),
        )
        return True

    def _scale_down(self) -> bool:
        host, port, handle = self.owned.pop()
        # Graceful drain: leave the registry first (no new picks; the
        # gateway finishes any in-flight window on its own upstream
        # connection), linger for the grace period, then reap.
        self.pool.remove_replica(host, port)
        self._unregister_scrape(host, port)
        if self.drain_grace_s > 0:
            time.sleep(self.drain_grace_s)
        try:
            self.stop_replica(handle)
        except Exception as e:
            _AUTOSCALE.labels(
                direction="down", outcome="stop_failed"
            ).inc()
            _flightrec.record(
                "gateway.autoscale", direction="down",
                outcome="stop_failed", replica=f"{host}:{port}",
                error=str(e)[:200],
            )
            _AUTOSCALE_REPLICAS.set(len(self.owned))
            return True  # the replica DID leave the pool
        _AUTOSCALE_REPLICAS.set(len(self.owned))
        _AUTOSCALE.labels(direction="down", outcome="ok").inc()
        _flightrec.record(
            "gateway.autoscale", direction="down", outcome="ok",
            replica=f"{host}:{port}", pool_size=len(self.pool),
        )
        return True

    def _register_scrape(self, host: str, port: int) -> None:
        if self.collector is None or self.exporter_of is None:
            return
        target = self.exporter_of(host, port)
        if target is not None:
            self.collector.add_http_target(f"{host}:{port}", target)

    def _unregister_scrape(self, host: str, port: int) -> None:
        if self.collector is None:
            return
        remove = getattr(self.collector, "remove_http_target", None)
        if remove is not None:
            remove(f"{host}:{port}")

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pftpu-autoscaler", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.step()
            except Exception as e:
                # One bad step must never kill the loop — but a
                # persistently-failing scaler silently pinning the
                # fleet size would be the quiet failure this repo
                # forbids: every miss is metered and flight-recorded.
                _AUTOSCALE.labels(
                    direction="step", outcome="error"
                ).inc()
                _flightrec.record(
                    "gateway.autoscale", direction="step",
                    outcome="error",
                    error=f"{type(e).__name__}: {str(e)[:200]}",
                )
            self._stop_evt.wait(self.interval_s)

    def stop(self, *, drain_owned: bool = False) -> None:
        self._stop_evt.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.interval_s + 5.0)
            self._thread = None
        if drain_owned:
            with self._lock:
                while self.owned:
                    self._scale_down()
