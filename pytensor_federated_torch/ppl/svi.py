"""Stochastic variational inference on compiled ``ppl`` programs —
batch mode and STREAMING mode.

The port of the JAX package's ``ppl/svi.py``.  Batch mode
(:func:`svi_fit`) is mean-field SVI through the shared ELBO core
(:mod:`.elbo`): an eager loop of first-order ``torch.autograd`` steps
and optax's Adam (the JAX loop is one jitted ``lax.scan``), with an
optional unbiased minibatch estimator (``compiled.logp_minibatch``) per
step — doubly stochastic VI over federated shards.

Streaming mode (:class:`StreamingSVI`) is the scenario the exact
NUTS/tempering lane cannot serve: optimizer state lives on the driver,
per-shard likelihood+gradient work rides the replica pool — typically
THROUGH the gateway (``PoolPlacement`` over a ``TcpArraysClient`` dialed
at the front door, per-tenant quotas and all) — and minibatches arrive
as live traffic instead of a schedule.  Every step runs under the
deadline regime:

- a batch whose windows exceed the step budget is SHED
  (``DeadlineExceeded`` — the gateway/node classification arrives
  in-band) and the optimizer does NOT step;
- a batch denied by the gateway's tenant quota is shed as overload;
- transient transport/compute failures skip the batch loudly;
- a batch is applied at most once — the optimizer's own step counter
  is the proof (``opt_steps == accepted``), so shed work can never
  double-count.

Where the JAX code takes a PRNG key these take a ``torch.Generator`` (or
an int seed).  A streaming step draws one int64 seed from it and the
step's Monte Carlo noise comes from a fresh generator seeded with that,
on the parameters' device; sharded-mode requests carry the seed, so an
owner draws the driver-centric lane's noise on the same device.

Convergence telemetry: ``pftpu_svi_batches_total{outcome}``,
``pftpu_svi_elbo``, and ``svi.step`` / ``svi.shed`` flight events.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..optim._adam import adam
from ..samplers.util import ravel
from ..service import deadline as _deadline
from ..service.npwire import WireError as _WireError
from ..telemetry import flightrec as _flightrec
from ..telemetry import metrics as _metrics
from ..utils import value_and_grad
from .compiler import CompiledModel
from .elbo import Noise, gaussian_entropy, meanfield_draws, meanfield_neg_elbo, normal, scan_vi
from .handlers import PPLError

__all__ = [
    "StreamingSVI",
    "SVIResult",
    "make_meanfield_neg_elbo",
    "make_sharded_update_compute",
    "svi_fit",
]

SVI_BATCHES = _metrics.counter(
    "pftpu_svi_batches_total",
    "Streaming-SVI minibatch outcomes",
    labelnames=("outcome",),
)
SVI_ELBO = _metrics.gauge("pftpu_svi_elbo", "Latest streaming-SVI ELBO estimate")

_SEED_HIGH = 2**63 - 1


class SVIResult(NamedTuple):
    """Mean-field fit in user parameter structure (the
    :class:`~..samplers.advi.ADVIResult` contract)."""

    mean: Any
    sd: Any
    elbo_trace: torch.Tensor
    flat_mean: torch.Tensor
    flat_log_sd: torch.Tensor

    def sample(self, generator: Noise, n: int, unravel: Callable[[torch.Tensor], Any]) -> Any:
        eps = normal(generator, (n, self.flat_mean.shape[0]), self.flat_mean)
        return unravel(self.flat_mean[None, :] + torch.exp(self.flat_log_sd)[None, :] * eps)


def _generator(generator: Union[int, torch.Generator]) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


def svi_fit(
    compiled: CompiledModel,
    *,
    generator: torch.Generator,
    num_steps: int = 1000,
    n_mc: int = 8,
    learning_rate: float = 1e-2,
    init_log_sd: float = -2.0,
    minibatch: bool = False,
    batch_size: Optional[int] = None,
    init_params: Optional[Any] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[SVIResult, Callable[[torch.Tensor], Any]]:
    """Batch mean-field SVI on a compiled model; returns ``(result,
    unravel)``.  ``minibatch=True`` estimates each step's logp on a
    random shard subsample (``compiled.logp_minibatch`` from
    ``generator`` — unbiased by the plate scaling), so per-step cost
    drops with the batch while the ELBO gradient stays unbiased.  Best
    with ``placement=None``; pool placements should prefer
    :class:`StreamingSVI`.

    The Monte Carlo draws come from ``generator`` (on the parameters'
    device), or, where ``noise`` is given, from it: one ``(n_mc, dim)``
    tensor of standard normal draws per step (the tests inject the JAX
    package's draws)."""
    init = init_params if init_params is not None else compiled.init_params()
    flat0, unravel = ravel(init)
    flat0 = flat0.detach()
    dim = int(flat0.shape[0])

    if minibatch:

        def e_logp_fn(x: torch.Tensor, _noise: Any) -> torch.Tensor:
            # One minibatch per draw, drawn in turn: a generator cannot
            # be threaded through vmap.
            return torch.stack([
                compiled.logp_minibatch(unravel(xi), generator, batch_size=batch_size) for xi in x
            ]).mean()

    else:
        batch_logp = torch.func.vmap(lambda xi: compiled.logp(unravel(xi)))

        def e_logp_fn(x: torch.Tensor, _noise: Any) -> torch.Tensor:
            return torch.mean(batch_logp(x))

    neg_elbo = meanfield_neg_elbo(e_logp_fn, dim, n_mc=n_mc, split_keys=minibatch)
    if noise is not None:
        draws = iter(noise)
        estimator = neg_elbo

        def neg_elbo(var: Any, _gen: Any) -> torch.Tensor:
            return estimator(var, next(draws))

    var0 = (flat0, torch.full((dim,), init_log_sd, dtype=flat0.dtype, device=flat0.device))
    (mu, log_sd), elbos = scan_vi(
        neg_elbo, var0, generator=generator, num_steps=num_steps, learning_rate=learning_rate
    )
    result = SVIResult(
        mean=unravel(mu),
        sd=unravel(torch.exp(log_sd)),
        elbo_trace=elbos,
        flat_mean=mu,
        flat_log_sd=log_sd,
    )
    return result, unravel


def make_meanfield_neg_elbo(
    compiled: CompiledModel,
    unravel: Callable[[torch.Tensor], Any],
    dim: int,
    n_mc: int,
) -> Callable[..., torch.Tensor]:
    """The ONE streaming neg-ELBO estimator, shared by the
    driver-centric lane (:meth:`StreamingSVI._neg_elbo`) and the
    sharded-optimizer node compute (:func:`make_sharded_update_compute`)
    — the two lanes differentiate the SAME function with the same noise,
    which is why their parameter trajectories are bit-identical on one
    device."""

    def neg_elbo(var: Tuple[torch.Tensor, torch.Tensor], noise: Noise, idx: Any) -> torch.Tensor:
        mu, log_sd = var
        x = meanfield_draws(mu, log_sd, noise, n_mc)
        # Python-mean over the MC draws: each draw is one pool window
        # (vmap over a pool-placed program would serialize anyway via
        # the window's sequential vmap rule).
        terms = [compiled.logp_indices(unravel(x[i]), idx) for i in range(n_mc)]
        e_logp = sum(terms[1:], terms[0]) / float(n_mc)
        return -(e_logp + gaussian_entropy(dim, torch.sum(log_sd)))

    return neg_elbo


def _step_noise(seed: int, device: torch.device) -> torch.Generator:
    """The noise source of one streaming step: a generator on ``device``
    seeded with the step's seed."""
    return torch.Generator(device=device).manual_seed(int(seed))


def make_sharded_update_compute(
    compiled: CompiledModel,
    store: Any,
    *,
    learning_rate: float = 5e-2,
    n_mc: int = 2,
    init_params: Optional[Any] = None,
) -> Callable[..., list]:
    """The OWNER-replica compute of a sharded streaming-SVI group:
    wraps :func:`~..optim.sharded.make_update_compute` around this
    model's neg-ELBO gradient.  Requests carry ``[mu, log_sd, seed,
    idx]`` (the driver's step inputs, params broadcast whole so the pin
    cache absorbs them; ``seed`` one int64, the step's noise seed); the
    node differentiates the same estimator the driver lane uses, on
    ``compiled.device``, slices its owned shard of the flat
    ``concat(mu, log_sd)`` vector, applies Adam (``learning_rate``) on
    the slice, and checkpoints into ``store`` (a
    :class:`~..optim.state.ShardStore`) before replying.

    Every owner of one group must be built with the SAME
    ``learning_rate``/``n_mc``/``init_params`` — the shard version
    protocol catches drift in TIME, not in hyperparameters."""
    from ..optim.sharded import make_update_compute

    init = init_params if init_params is not None else compiled.init_params()
    flat0, unravel = ravel(init)
    dim = int(flat0.shape[0])
    neg_elbo = make_meanfield_neg_elbo(compiled, unravel, dim, int(n_mc))
    dev = compiled.device

    def grad_fn(mu: np.ndarray, log_sd: np.ndarray, seed: np.ndarray,
                idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        var = (torch.as_tensor(np.asarray(mu), device=dev),
               torch.as_tensor(np.asarray(log_sd), device=dev))
        noise = _step_noise(np.asarray(seed).ravel()[0], dev)
        idx_t = torch.as_tensor(np.asarray(idx, np.int32), device=dev)
        loss, (g_mu, g_log_sd) = value_and_grad(lambda v: neg_elbo(v, noise, idx_t), var)
        return loss.cpu().numpy(), np.concatenate(
            [g_mu.cpu().numpy().ravel(), g_log_sd.cpu().numpy().ravel()]
        )

    def params_of(arrays: Any) -> np.ndarray:
        return np.concatenate([np.asarray(arrays[0]).ravel(), np.asarray(arrays[1]).ravel()])

    return make_update_compute(grad_fn, adam(learning_rate), store, params_of=params_of)


def _classify_skip(exc: BaseException) -> Optional[str]:
    """Map a step failure to its shed/skip outcome, or None when the
    exception is a programming error that must propagate (the loud
    posture: only CLASSIFIED failures are absorbed).

    A pool window's failure comes out of the window's autograd Function
    as the transport raised it; a failure relayed in-band (a node's or
    the gateway's error text in a ``RemoteComputeError``) keeps only its
    MESSAGE — so classification also matches the in-band deadline and
    overload strings, and a message naming ``PPLError`` propagates even
    where the type was lost, as the JAX package's does for the errors
    its callback layer wraps."""
    text = str(exc)
    if isinstance(exc, PPLError) or "PPLError" in text:
        # A model/contract bug is deterministic: propagate even when
        # the type was erased (the text still names it) — retrying or
        # skipping forever would be silent.
        return None
    if isinstance(exc, _deadline.DeadlineExceeded) or _deadline.is_deadline_error(text):
        return "shed_deadline"
    from ..gateway.fairness import is_overload_error

    if is_overload_error(text):
        return "shed_overload"
    if isinstance(exc, (RuntimeError, ValueError, ConnectionError, OSError)):
        return "failed"
    return None


class StreamingSVI:
    """Mean-field SVI whose minibatches arrive as live traffic.

    ``compiled`` is a :class:`~.compiler.CompiledModel`, typically with
    a ``PoolPlacement(TcpArraysClient(gateway_host, gateway_port,
    tenant=...), tag="svi")`` so likelihood windows ride the gateway.
    Each arriving batch is a 1-D array of shard indices (the federated
    minibatch: data never leaves the nodes, only indices and parameters
    travel).  Call :meth:`step` per batch; outcomes are ``"accepted"``,
    ``"shed_deadline"``, ``"shed_overload"``, or ``"failed"``.
    ``generator`` (a ``torch.Generator`` or an int seed) gives each
    step's noise seed.

    Accounting contract:

    - ``opt_steps`` (read from the optimizer state itself) ==
      ``accepted`` — a shed batch can NEVER have stepped the optimizer,
      and no batch steps it twice;
    - ``offered == accepted + sum(skipped.values())`` — every batch is
      accounted exactly once;
    - unclassified exceptions propagate (nothing is silently eaten).

    **Sharded mode**: pass ``sharded=`` a
    :class:`~..optim.sharded.ShardedOptimizer` whose owner replicas run
    :func:`make_sharded_update_compute` for this model.  Optimizer state
    then lives ON the owners (``O(model/N)`` each — the driver holds no
    Adam state and never sees a gradient), each step dispatches one
    versioned update per shard, and the accounting contract becomes PER
    SHARD: ``shard_opt_steps[k] == shard_accepted[k]`` for every shard.
    ``minibatch_mode="shared"`` sends every owner the same index batch
    (trajectories bit-identical to driver-centric mode on one device);
    ``"split"`` gives each owner a disjoint slice of the batch.
    """

    def __init__(
        self,
        compiled: CompiledModel,
        *,
        generator: Union[int, torch.Generator],
        learning_rate: float = 5e-2,
        n_mc: int = 2,
        init_log_sd: float = -2.0,
        deadline_s: Optional[float] = None,
        init_params: Optional[Any] = None,
        sharded: Optional[Any] = None,
        minibatch_mode: str = "shared",
    ) -> None:
        self.compiled = compiled
        self.deadline_s = deadline_s
        self.n_mc = int(n_mc)
        init = init_params if init_params is not None else compiled.init_params()
        flat0, self._unravel = ravel(init)
        flat0 = flat0.detach()
        self.dim = int(flat0.shape[0])
        self.mu = flat0
        self.log_sd = torch.full((self.dim,), init_log_sd, dtype=flat0.dtype, device=flat0.device)
        self._neg_elbo_fn = make_meanfield_neg_elbo(compiled, self._unravel, self.dim, self.n_mc)
        if minibatch_mode not in ("shared", "split"):
            raise ValueError(f"minibatch_mode must be 'shared' or 'split', got {minibatch_mode!r}")
        self.minibatch_mode = minibatch_mode
        self._sharded = sharded
        if sharded is not None:
            if sharded.total != 2 * self.dim:
                raise ValueError(
                    f"sharded optimizer covers {sharded.total} elements "
                    f"but this model's flat (mu, log_sd) vector has "
                    f"{2 * self.dim}"
                )
            # No driver-side optimizer: Adam state lives on the owners.
            self._opt = None
            self._opt_state = None
            self.shard_accepted: List[int] = [0] * sharded.count
        else:
            # Adam over concat(mu, log_sd): elementwise, so the same
            # arithmetic as optax's over the (mu, log_sd) pair.
            self._opt = adam(learning_rate)
            self._opt_state = self._opt.init(torch.cat([self.mu, self.log_sd]))
            self.shard_accepted = []
        self._generator = _generator(generator)
        self.offered = 0
        self.accepted = 0
        self.skipped: Dict[str, int] = {}
        self.elbo_trace: List[float] = []

    # -- accounting ----------------------------------------------------

    @property
    def opt_steps(self) -> int:
        """The optimizer's OWN step counter — the ground truth the
        accepted-batch count is checked against.  Driver-centric mode
        reads Adam's count; sharded mode reads the MINIMUM shard version
        (the steps completed on EVERY shard — per-shard truth is
        :attr:`shard_opt_steps`)."""
        if self._sharded is not None:
            return min(self._sharded.versions)
        return int(self._opt_state.count)

    @property
    def shard_opt_steps(self) -> List[int]:
        """Sharded mode: each shard's step version — the OWNER-side Adam
        step counter (the version IS the count).  The per-shard
        invariant is ``shard_opt_steps[k] == shard_accepted[k]``."""
        if self._sharded is None:
            raise RuntimeError("shard_opt_steps needs sharded mode")
        return list(self._sharded.versions)

    # -- the ELBO estimator --------------------------------------------

    def _neg_elbo(self, var: Tuple[torch.Tensor, torch.Tensor], noise: Noise, idx: Any) -> torch.Tensor:
        # Delegates to the shared estimator so the driver-centric lane
        # and the sharded owner compute differentiate the SAME function
        # (the bit-identical-trajectory precondition).
        return self._neg_elbo_fn(var, noise, idx)

    def _next_seed(self) -> int:
        g = self._generator
        return int(torch.randint(0, _SEED_HIGH, (), generator=g, device=g.device))

    def _shed(self, outcome: str, exc: Optional[BaseException], **extra: Any) -> str:
        self.skipped[outcome] = self.skipped.get(outcome, 0) + 1
        SVI_BATCHES.labels(outcome=outcome).inc()
        _flightrec.record(
            "svi.shed",
            outcome=outcome,
            offered=self.offered,
            **extra,
            error=f"{type(exc).__name__}: {str(exc)[:120]}" if exc is not None else "",
        )
        return outcome

    def step(self, batch_idx: Any) -> str:
        """Consume one arriving minibatch (1-D shard-index array).
        Applies at most ONE optimizer update; returns the outcome."""
        self.offered += 1
        seed = self._next_seed()
        idx = torch.as_tensor(np.asarray(batch_idx)).to(torch.int32)
        if self._sharded is not None:
            return self._step_sharded(seed, idx)
        try:
            with _deadline.deadline_scope(self.deadline_s):
                noise = _step_noise(seed, self.mu.device)
                loss, (g_mu, g_log_sd) = value_and_grad(
                    lambda var: self._neg_elbo(var, noise, idx), (self.mu, self.log_sd)
                )
        except Exception as exc:  # noqa: BLE001 - classified below
            outcome = _classify_skip(exc)
            if outcome is None:
                raise
            return self._shed(outcome, exc)
        with torch.no_grad():
            updates, self._opt_state = self._opt.update(torch.cat([g_mu, g_log_sd]), self._opt_state)
            flat = torch.cat([self.mu, self.log_sd]) + updates
        self.mu, self.log_sd = flat[: self.dim], flat[self.dim :]
        self.accepted += 1
        elbo = float(-loss)
        self.elbo_trace.append(elbo)
        SVI_BATCHES.labels(outcome="accepted").inc()
        SVI_ELBO.set(elbo)
        _flightrec.record("svi.step", step=self.accepted, elbo=round(elbo, 3), batch=int(idx.shape[0]))
        return "accepted"

    def _step_sharded(self, seed: int, idx: torch.Tensor) -> str:
        """One sharded-optimizer step: dispatch a versioned update to
        every owner, fold the returned slices into the driver's
        parameter copy.  A failed shard sheds only ITSELF — its version
        (and so its accepted count) does not move, which is exactly the
        per-shard ``opt_steps == accepted`` invariant; the BATCH counts
        accepted only when every shard accepted."""
        opt = self._sharded
        mu_np = self.mu.cpu().numpy()
        log_sd_np = self.log_sd.cpu().numpy()
        seed_np = np.asarray([seed], np.int64)
        idx_np = idx.cpu().numpy().astype(np.int32)
        if self.minibatch_mode == "shared":
            arrays_for: Any = [mu_np, log_sd_np, seed_np, idx_np]
        else:
            slices = np.array_split(idx_np, opt.count)

            def arrays_for(k: int, part: Any, _s: List[np.ndarray] = slices) -> List[np.ndarray]:
                return [mu_np, log_sd_np, seed_np, _s[k]]

        try:
            with _deadline.deadline_scope(self.deadline_s):
                results = opt.step(arrays_for)
        except Exception as exc:  # noqa: BLE001 - classified below
            # A raise out of ShardedOptimizer.step is version
            # divergence or a protocol/geometry violation (per-shard
            # transport failures come back as ShardResults) — that is
            # corruption, never a sheddable batch: propagate.
            if isinstance(exc, _WireError):
                raise
            outcome = _classify_skip(exc)
            if outcome is None:
                raise
            return self._shed(outcome, exc)
        flat = np.concatenate([mu_np.ravel(), log_sd_np.ravel()])
        new_flat, accepted_shards = opt.apply(flat, results)
        for k in accepted_shards:
            self.shard_accepted[k] += 1
        new_flat = torch.as_tensor(new_flat, dtype=self.mu.dtype, device=self.mu.device)
        self.mu, self.log_sd = new_flat[: self.dim], new_flat[self.dim :]
        failures = [r for r in results if not r.accepted]
        if failures:
            first = next((r.error for r in failures if r.error is not None), None)
            outcome = _classify_skip(first) if first is not None else "failed"
            if outcome is None:
                raise first  # unclassified: the loud posture
            return self._shed(outcome, first, shards_failed=[r.index for r in failures])
        self.accepted += 1
        losses = [r.loss for r in results if r.loss is not None]
        if losses:
            elbo = float(-np.mean(losses))
            self.elbo_trace.append(elbo)
            SVI_ELBO.set(elbo)
        SVI_BATCHES.labels(outcome="accepted").inc()
        _flightrec.record(
            "svi.step",
            step=self.accepted,
            elbo=round(self.elbo_trace[-1], 3) if self.elbo_trace else None,
            batch=int(idx_np.shape[0]),
            sharded=True,
        )
        return "accepted"

    def consume(self, batches: Any) -> Dict[str, int]:
        """Drain an iterable of index batches through :meth:`step`;
        returns the outcome tally."""
        tally: Dict[str, int] = {}
        for batch in batches:
            outcome = self.step(batch)
            tally[outcome] = tally.get(outcome, 0) + 1
        return tally

    def result(self) -> Tuple[SVIResult, Callable[[torch.Tensor], Any]]:
        """The fit so far, in the :func:`svi_fit` result shape."""
        res = SVIResult(
            mean=self._unravel(self.mu),
            sd=self._unravel(torch.exp(self.log_sd)),
            elbo_trace=torch.as_tensor(self.elbo_trace),
            flat_mean=self.mu,
            flat_log_sd=self.log_sd,
        )
        return res, self._unravel
