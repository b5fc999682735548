"""Per-replica circuit breaker: closed → open → half-open → closed.

The failure-isolation primitive of the replica pool
(:mod:`.pool`).  A replica that keeps failing must stop receiving
traffic *before* every caller has personally timed out against it —
the classic circuit-breaker contract — and must win traffic back only
by proving itself on a single half-open probe, never by a thundering
herd of optimistic retries.

State machine (one lock, monotonic clock):

- **closed** — normal service.  ``consecutive_failures`` counts
  ``record_failure`` calls; reaching ``failure_threshold`` trips the
  breaker OPEN and arms a jittered backoff deadline.
- **open** — ``available()``/``acquire()`` refuse until the deadline.
  The backoff doubles on every re-trip up to ``max_backoff_s``; the
  deadline is jittered ±``jitter_frac`` so a pool of drivers that all
  tripped on the same dead node does not re-probe it in lockstep (the
  same de-sync argument as ``connect_balanced``'s sleep,
  service/client.py).
- **half-open** — after the deadline, exactly ONE caller wins
  ``acquire()`` (the probe); everyone else keeps being refused.  The
  probe's ``record_success`` closes the breaker and resets the
  backoff ladder; its ``record_failure`` re-opens with doubled
  backoff.

``available()`` is deliberately non-mutating so routing policies can
*rank* candidates without consuming the half-open probe token;
``acquire()`` is the mutating admission check the pool performs on the
one replica it actually picked.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

__all__ = ["CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Thread-safe three-state breaker with jittered exponential backoff.

    ``on_transition(old_state, new_state)`` (optional) fires outside
    the hot path whenever the state changes — the pool uses it to emit
    ``pool.breaker_*`` flight-recorder events and the transition
    counter without this module depending on telemetry.
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        jitter_frac: float = 0.2,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        if backoff_s <= 0 or max_backoff_s < backoff_s:
            raise ValueError(
                f"need 0 < backoff_s <= max_backoff_s, got "
                f"{backoff_s}/{max_backoff_s}"
            )
        self.failure_threshold = int(failure_threshold)
        self.base_backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter_frac = float(jitter_frac)
        self._clock = clock
        self._rng = rng or random.Random()
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._backoff_s = self.base_backoff_s
        self._open_until = 0.0
        self._probing = False  # half-open probe token held

    # -- introspection ----------------------------------------------------

    @property
    def state(self) -> str:
        """Current state; an expired OPEN deadline reads as half_open
        (the lazily-evaluated transition — there is no timer thread)."""
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        if self._state == OPEN and self._clock() >= self._open_until:
            return HALF_OPEN
        return self._state

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive_failures

    @property
    def backoff_s(self) -> float:
        """The backoff the NEXT trip would arm (doubles per re-trip)."""
        return self._backoff_s

    def available(self) -> bool:
        """Non-mutating: would a call be admitted right now?  True in
        closed, and in half-open while the probe token is unclaimed."""
        with self._lock:
            eff = self._effective_state()
            if eff == CLOSED:
                return True
            if eff == HALF_OPEN:
                return not self._probing
            return False

    # -- admission + outcome ----------------------------------------------

    def acquire(self) -> bool:
        """Mutating admission: True admits the call.  In half-open this
        claims the single probe token — concurrent acquirers lose."""
        transition = None
        with self._lock:
            eff = self._effective_state()
            if eff == CLOSED:
                return True
            if eff == HALF_OPEN and not self._probing:
                if self._state == OPEN:
                    transition = (self._state, HALF_OPEN)
                    self._state = HALF_OPEN
                self._probing = True
                ok = True
            else:
                ok = False
        if transition is not None:
            self._notify(*transition)
        return ok

    def release(self) -> None:
        """Give back an acquired half-open probe token WITHOUT recording
        an outcome — for calls that were admitted but then abandoned
        (hedge loser, a spread window benching the replica).  Leaving
        the token claimed would park the breaker in half-open forever
        when no background probe loop runs."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        """A served call completed: close (from half-open), reset the
        failure count and the backoff ladder."""
        transition = None
        with self._lock:
            if self._state != CLOSED:
                transition = (self._state, CLOSED)
            self._state = CLOSED
            self._probing = False
            self._consecutive_failures = 0
            self._backoff_s = self.base_backoff_s
        if transition is not None:
            self._notify(*transition)

    def record_failure(self) -> None:
        """A call (or health probe) failed: count toward the trip
        threshold; in half-open, a failed probe re-opens immediately
        with doubled backoff."""
        transition = None
        with self._lock:
            self._consecutive_failures += 1
            eff = self._effective_state()
            if eff == CLOSED:
                if self._consecutive_failures >= self.failure_threshold:
                    transition = (self._state, OPEN)
                    self._trip_locked()
            else:
                # half-open probe failed, or extra failures landing
                # while open (stragglers from calls admitted earlier):
                # re-arm the deadline; only escalate the backoff for a
                # genuine failed PROBE, not for stragglers.
                escalate = eff == HALF_OPEN
                if self._state != OPEN:
                    transition = (self._state, OPEN)
                self._trip_locked(escalate=escalate)
        if transition is not None:
            self._notify(*transition)

    def _trip_locked(self, *, escalate: bool = False) -> None:
        if escalate:
            self._backoff_s = min(self._backoff_s * 2.0, self.max_backoff_s)
        jitter = 1.0 + self.jitter_frac * (2.0 * self._rng.random() - 1.0)
        self._state = OPEN
        self._probing = False
        self._open_until = self._clock() + self._backoff_s * jitter

    def _notify(self, old: str, new: str) -> None:
        if self._on_transition is not None:
            try:
                self._on_transition(old, new)
            except Exception:  # a metrics hook must never break routing
                pass
