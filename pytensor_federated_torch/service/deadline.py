"""End-to-end deadline budgets for the serving stack.

The reference runtime's driver waits forever: every RPC blocks until
the peer answers and every failure is retried blindly — exactly what
melts down first under overload (ROADMAP item 3's front-door tier
needs the *protection* half before any accept path can scale).  This
module is the budget that threads through the whole stack:

- the DRIVER binds a deadline with :func:`deadline_scope`; it lives in
  a :mod:`contextvars` var, so it crosses ``await`` points, executor
  hops made with ``contextvars.copy_context`` (the repo convention),
  and nested calls without any plumbing;
- CLIENTS stamp the REMAINING budget into each request as a wire field
  — npwire flag bit 16, npproto extension field 18, shm doorbell flag
  bit 4, all declared in :mod:`.wire_registry` first — as *relative
  seconds*, never an absolute timestamp: peer clocks are not ours;
- SERVERS enforce it at admission (an already-expired request is
  answered with a :data:`DEADLINE_ERROR_PREFIX` in-band error and
  never computed), in the micro-batcher queue (expired entries are
  shed before compute, never vmap'd in), and across the compute
  handoff (:func:`budget_scope` re-binds the budget node-side so
  nested work inherits it);
- CLIENTS classify the reply: an in-band error carrying the prefix
  raises :class:`DeadlineExceeded` — deliberately a ``RuntimeError``
  subclass, because every lane already treats ``RuntimeError`` as a
  DETERMINISTIC, non-retryable verdict (re-sending work whose deadline
  is spent would multiply load for a caller that already gave up: the
  retry-storm amplification deadlines exist to remove).

No deadline bound (the shipping default) costs one contextvar read on
the encode path — bench.py's ``deadline_overhead`` gate holds that
line — and produces BYTE-IDENTICAL frames on every codec
(property-tested), so deadline-free peers interoperate unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
import socket
import time
from typing import IO, Callable, Iterator, Optional

from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics

__all__ = [
    "DEADLINE_ERROR_PREFIX",
    "DeadlineExceeded",
    "bounded_reader",
    "budget_scope",
    "check_remaining",
    "current_deadline",
    "deadline_error",
    "deadline_scope",
    "expired",
    "is_deadline_error",
    "recv_budget_s",
    "remaining_s",
    "shed_expired_admission",
    "wire_budget",
]

#: The in-band error classification marker.  Every server that rejects
#: or sheds expired work builds its error string with
#: :func:`deadline_error`; every client maps a reply error containing
#: the marker to :class:`DeadlineExceeded` via :func:`is_deadline_error`
#: (substring, not prefix: servers may wrap the message in their own
#: stage prefixes, e.g. ``"compute error: deadline exceeded: …"``).
DEADLINE_ERROR_PREFIX = "deadline exceeded"

#: Deadline instrumentation (catalog: docs/observability.md).
DEADLINE_EXPIRED = _metrics.counter(
    "pftpu_deadline_expired_total",
    "Work abandoned because its deadline budget was spent, by stage",
    ("stage",),
)
DEADLINE_BUDGET_S = _metrics.histogram(
    "pftpu_deadline_budget_seconds",
    "Remaining deadline budget observed at server admission",
)
#: Same family as the server/batcher declarations (the metrics registry
#: is get-or-create): admission sheds are ONE counter across lanes.
ADMISSION_SHED = _metrics.counter(
    "pftpu_admission_shed_total",
    "Requests shed by server-side admission control, by reason",
    ("reason",),
)


class DeadlineExceeded(RuntimeError):
    """A call's deadline budget was spent — before send, at server
    admission, in a shedding queue, or waiting for the reply.

    A ``RuntimeError`` on purpose: the transports, the replica pool,
    and the chaos harness all classify ``RuntimeError`` as a
    deterministic (non-transient, non-retryable) failure, which is the
    correct posture — the caller's budget is gone everywhere at once,
    so failover or retry can only add load, never an answer in time.
    """


def deadline_error(detail: str) -> str:
    """The in-band error string for a deadline rejection/shed."""
    return f"{DEADLINE_ERROR_PREFIX}: {detail}"


def is_deadline_error(error: Optional[str]) -> bool:
    """Whether a reply's in-band error string is the deadline
    classification (clients raise :class:`DeadlineExceeded` for it)."""
    return error is not None and DEADLINE_ERROR_PREFIX in error


#: The ambient deadline: an ABSOLUTE ``time.monotonic()`` instant, or
#: ``None`` (unbounded — the shipping default).  Monotonic on purpose:
#: wall clocks jump; only the wire form is relative.
_DEADLINE: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "pftpu_deadline", default=None
)


def current_deadline() -> Optional[float]:
    """The ambient absolute deadline (``time.monotonic()`` units), or
    ``None`` when the context is unbounded."""
    return _DEADLINE.get()


def remaining_s() -> Optional[float]:
    """Seconds of budget left in this context (possibly negative once
    spent), or ``None`` when unbounded."""
    d = _DEADLINE.get()
    return None if d is None else d - time.monotonic()


def expired() -> bool:
    """Whether the ambient deadline has been spent."""
    d = _DEADLINE.get()
    return d is not None and time.monotonic() >= d


def check_remaining(where: str) -> Optional[float]:
    """Remaining budget, raising :class:`DeadlineExceeded` (and booking
    the ``client`` expiry metric) when it is already spent — the
    fail-fast guard clients run before paying for an attempt."""
    r = remaining_s()
    if r is not None and r <= 0.0:
        DEADLINE_EXPIRED.labels(stage="client").inc()
        raise DeadlineExceeded(
            deadline_error(f"budget spent before {where}")
        )
    return r


@contextlib.contextmanager
def deadline_scope(timeout_s: Optional[float]) -> Iterator[None]:
    """Bind a deadline of ``timeout_s`` seconds from now for the
    calling context.  Nested scopes only ever TIGHTEN (the effective
    deadline is the min of the ambient one and the new one), so an
    inner retry loop cannot mint itself fresh budget.  ``None`` is a
    no-op, keeping call sites unconditional."""
    if timeout_s is None:
        yield
        return
    new = time.monotonic() + float(timeout_s)
    cur = _DEADLINE.get()
    if cur is not None:
        new = min(new, cur)
    token = _DEADLINE.set(new)
    try:
        yield
    finally:
        _DEADLINE.reset(token)


@contextlib.contextmanager
def budget_scope(budget_s: Optional[float]) -> Iterator[None]:
    """Server-side twin of :func:`deadline_scope`: adopt a budget that
    arrived OFF THE WIRE (relative seconds) as this context's deadline,
    so the compute handoff, the micro-batcher, and any nested outbound
    calls inherit the caller's remaining time."""
    with deadline_scope(budget_s):
        yield


def shed_expired_admission(
    budget: Optional[float], *, transport: str
) -> Optional[str]:
    """Admission enforcement shared by EVERY serving lane (grpc
    handler, tcp accept loop, shm doorbell), so their shed semantics
    and telemetry cannot diverge: observe the advertised budget, and
    when it is already spent emit the full shed record —
    ``pftpu_admission_shed_total{reason=expired}``,
    ``pftpu_deadline_expired_total{stage=admission}``, flightrec
    ``admission.shed`` — and return the in-band deadline error text
    for the lane to wrap in its own reply shape (or raise, on the
    error-field-free npproto wire).  ``None`` means admit."""
    if budget is None:
        return None
    DEADLINE_BUDGET_S.observe(budget)
    if budget > 0.0:
        return None
    ADMISSION_SHED.labels(reason="expired").inc()
    DEADLINE_EXPIRED.labels(stage="admission").inc()
    _flightrec.record(
        "admission.shed", transport=transport, reason="expired"
    )
    return deadline_error("budget spent before admission")


def wire_budget() -> Optional[float]:
    """The remaining budget to stamp into an outgoing request, or
    ``None`` when the context is unbounded (the frame then stays
    byte-identical to the deadline-free wire).  Clamped at a small
    positive floor: callers fail fast on a spent budget via
    :func:`check_remaining` BEFORE encoding, so a non-positive value
    here only happens in the race between check and encode — ship the
    floor and let the server's admission check be the judge."""
    r = remaining_s()
    if r is None:
        return None
    return max(r, 1e-6)


def recv_budget_s(timeout_s: Optional[float]) -> Optional[float]:
    """Effective bound for one reply read: the explicit per-call
    ``timeout_s`` knob and the ambient deadline's remaining budget,
    whichever is tighter; ``None`` keeps the historical blocking read
    (bounded only by the connect-era socket timeout)."""
    r = remaining_s()
    cands = [t for t in (timeout_s, r) if t is not None]
    return min(cands) if cands else None


#: One bounded chunk = at most ONE underlying ``recv`` (``read1``), so
#: the remaining budget is re-armed between kernel reads — a socket
#: timeout is PER RECV, and a peer dripping bytes just under it would
#: otherwise stretch a multi-recv frame read far past the budget.
_BOUNDED_CHUNK = 1 << 16


@contextlib.contextmanager
def bounded_reader(
    sock: socket.socket,
    rfile: IO[bytes],
    timeout_s: Optional[float],
    close: Callable[[], None],
) -> Iterator[Callable[[int], bytes]]:
    """Yield ``read_exact(n) -> bytes`` whose TOTAL wall time across
    every read in the ``with`` body is bounded by ``timeout_s`` (from
    :func:`recv_budget_s`) — the shared bounded-read posture the TCP
    socket lane and the shm doorbell both delegate to, so their
    deadline semantics cannot diverge:

    - an already-spent budget (``timeout_s <= 0``): the reply is
      unread and the connection desynchronized — ``close()`` so the
      next call reconnects cleanly, and classify as deadline;
    - the budget exhausted mid-frame, or one chunk's recv timing out:
      the connection cannot be trusted to stay correlated —
      ``close()``, and raise ``TimeoutError`` (an OSError: the
      transient classification drives retry/failover);
    - a short read: ``ConnectionError`` (peer closed mid-frame);
    - ``None`` keeps the historical blocking read (bounded only by
      the connect-era socket timeout);
    - the socket's connect-era timeout is restored on exit.

    Bounded reads go through ``rfile.read1`` — buffer-first, at most
    one underlying ``recv`` per chunk — with the REMAINING budget
    re-armed before each chunk, so a slowly-dripping peer cannot
    evade the bound the way a per-recv ``settimeout`` alone allows.
    """
    if timeout_s is None:

        def read_blocking(n: int) -> bytes:
            buf = rfile.read(n)
            if buf is None or len(buf) < n:
                raise ConnectionError("peer closed mid-frame")
            return buf

        yield read_blocking
        return
    if timeout_s <= 0:
        close()
        DEADLINE_EXPIRED.labels(stage="client").inc()
        raise DeadlineExceeded(
            deadline_error("budget spent awaiting reply")
        )
    deadline = time.monotonic() + timeout_s
    prev = sock.gettimeout()

    def read_bounded(n: int) -> bytes:
        got = bytearray()
        while len(got) < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                close()
                raise TimeoutError(
                    "reply read exceeded the deadline budget"
                )
            sock.settimeout(remaining)
            try:
                chunk = rfile.read1(  # type: ignore[attr-defined]
                    min(n - len(got), _BOUNDED_CHUNK)
                )
            except TimeoutError:
                close()
                raise
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            got += chunk
        return bytes(got)

    try:
        yield read_bounded
    finally:
        try:
            sock.settimeout(prev)
        except OSError:
            # close() above already tore the socket down.
            pass
