"""Pathfinder variational inference (Zhang, Carpenter et al., JMLR 2022).

Port of the JAX package's ``samplers/pathfinder.py``.  Follow an L-BFGS
path toward the posterior mode, fit a local Gaussian at every iterate
from the windowed-BFGS curvature, score each by its Monte-Carlo ELBO
(common random numbers), and return draws from the best one.

The JAX package drives the path with ``optax.lbfgs`` (memory 10, scaled
initial preconditioner, the zoom line search with at most 20 steps) and
maps paths with ``vmap``.  :func:`_lbfgs_paths` writes that optimizer
out over a batch of paths in lockstep: one L-BFGS step of every path at
once, and one line-search iteration of every path at once, each a single
batched value+grad (through the linreg kernel, one launch for all
paths).  As under JAX's ``vmap`` of a ``while_loop``, a path whose line
search has finished keeps its state while the others go on; the loop
asks the host once per line-search iteration whether any path is still
searching.  The ELBO draws of every point of every path are one batched
evaluation (one launch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..utils import cholesky_or_nan
from .mcmc import make_batch_logp_and_grad
from .util import flatten_logp

# optax.lbfgs's defaults: memory_size, and its zoom line search's
# max_linesearch_steps, tol, increase_factor, slope_rtol, curv_rtol,
# approx_dec_rtol and stepsize_precision (the interval threshold).
_MEMORY = 10
_LS_STEPS, _TOL, _INCREASE = 20, 0.0, 2.0
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL, _INTERVAL_THRESHOLD = 1e-4, 0.9, 1e-6, 1e-5
# The window of curvature pairs each iterate's inverse Hessian is rebuilt from.
_WINDOW = 20


@dataclasses.dataclass
class PathfinderResult:
    """Draws from the ELBO-best Gaussian along the path(s)."""

    samples: Any  # pytree, leading axis num_draws
    elbo: torch.Tensor  # scalar, ELBO of the selected approximation
    best_iter: torch.Tensor  # iterate index of the selected point (its path)
    best_path: torch.Tensor  # path index (always 0 for single-path)
    mean_flat: torch.Tensor
    cov_flat: torch.Tensor
    unravel: Callable[[torch.Tensor], Any]


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def _sel(mask, new, old):
    """``where(mask, new, old)`` with a per-path mask against ``(P,)``
    or ``(P, d)`` values."""
    if new.dim() > mask.dim():
        mask = mask[:, None]
    return torch.where(mask, new, old)


def _precondition(updates, dw, du, rhos, identity_scale, memory_idx):
    """optax's two-loop recursion: ``updates`` (P, d) times the L-BFGS
    inverse Hessian of the memory ``dw``, ``du`` (P, m, d), ``rhos`` (P, m)."""
    m = rhos.shape[1]
    indices = [(memory_idx + i) % m for i in range(m)]
    alphas = {}
    vec = updates
    for idx in reversed(indices):
        alpha = rhos[:, idx] * _vdot(dw[:, idx], vec)
        vec = vec + (-alpha)[:, None] * du[:, idx]
        alphas[idx] = alpha
    vec = identity_scale[:, None] * vec
    for idx in indices:
        beta = rhos[:, idx] * _vdot(du[:, idx], vec)
        vec = vec + (alphas[idx] - beta)[:, None] * dw[:, idx]
    return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc**2 * r1 + (-(db**2)) * r2) / denom
    B = ((-(dc**3)) * r1 + db**3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = torch.maximum(
        slope - (2 * _SLOPE_RTOL - 1.0) * slope_init,
        value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init),
    )
    err = torch.clamp(torch.minimum(approx, err), min=0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _curvature_error(slope, slope_init):
    err = torch.clamp(torch.abs(slope) - _CURV_RTOL * torch.abs(slope_init), min=0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _zoom_linesearch(neg_vg, params, updates, value, grad, counter):
    """optax's ``scale_by_zoom_linesearch`` (initial guess 1) for every
    path at once: the step size along ``updates`` and the value and
    gradient there.  ``neg_vg(X) -> (f (P,), grad f (P, d))``."""
    P = params.shape[0]
    zero = torch.zeros_like(value)
    slope = _vdot(updates, grad)
    s = dict(
        count=torch.zeros(P, dtype=torch.long, device=params.device), stepsize=zero,
        value=value, grad=grad, slope=slope, decrease_error=torch.full_like(value, math.inf),
        interval_found=torch.zeros(P, dtype=torch.bool, device=params.device),
        done=torch.zeros(P, dtype=torch.bool, device=params.device),
        failed=torch.zeros(P, dtype=torch.bool, device=params.device),
        low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
        slope_high=slope, cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero,
        safe_value=value, safe_grad=grad,
    )
    value_init, slope_init = value, slope
    while True:
        active = ~(s["done"] | s["failed"])
        counter["syncs"] += 1
        if not bool(active.any()):
            break
        found, count = s["interval_found"], s["count"]
        # The step each branch tries: the interval search doubles, the
        # zoom interpolates inside [low, high].
        search_step = torch.where(count == 0, torch.ones_like(value), _INCREASE * s["stepsize"])
        low, high = s["low"], s["high"]
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic = _cubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                          s["cubic_ref"], s["value_cubic_ref"])
        use_cubic = (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)
        quad = _quadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
        use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, cubic, s["cubic_ref"])
        middle = torch.where(use_quad, quad, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        step = torch.where(found, middle, search_step)

        new_value, new_grad = neg_vg(params + step[:, None] * updates)
        counter["evals"] += 1
        new_slope = _vdot(new_grad, updates)
        dec = _decrease_error(step, new_value, new_slope, value_init, slope_init)
        curv = _curvature_error(new_slope, slope_init)
        error = torch.maximum(dec, curv)
        done = error <= _TOL

        # _search_interval
        safe = dec <= _TOL
        a_safe = (torch.where(safe, step, s["safe_stepsize"]),
                  torch.where(safe, new_value, s["safe_value"]),
                  _sel(safe, new_grad, s["safe_grad"]))
        set_high = (dec > 0.0) | ((new_value >= s["value"]) & (count > 0))
        set_low = (new_slope >= 0.0) & ~set_high
        prev = (s["stepsize"], s["value"], s["slope"])
        new = (step, new_value, new_slope)
        a_low = tuple(torch.where(set_low, n, p) for n, p in zip(new, prev))
        a_high = tuple(torch.where(set_low, p, n) for n, p in zip(new, prev))
        a = dict(
            interval_found=set_high | set_low | done, done=done,
            failed=(count + 1 >= _LS_STEPS) & ~done,
            low=a_low[0], value_low=a_low[1], slope_low=a_low[2],
            high=a_high[0], value_high=a_high[1], slope_high=a_high[2],
            cubic_ref=a_low[0], value_cubic_ref=a_low[1],
            safe_stepsize=a_safe[0], safe_value=a_safe[1], safe_grad=a_safe[2],
        )

        # _zoom_into_interval
        upd_safe = safe & (new_value < s["safe_value"])
        z_safe = (torch.where(upd_safe, step, s["safe_stepsize"]),
                  torch.where(upd_safe, new_value, s["safe_value"]),
                  _sel(upd_safe, new_grad, s["safe_grad"]))
        hi_mid = (dec > 0.0) | (new_value >= s["value_low"])
        hi_low = (new_slope * (high - low) >= 0.0) & ~hi_mid
        lo_mid = ~hi_mid
        old_low = (low, s["value_low"], s["slope_low"])
        old_high = (high, s["value_high"], s["slope_high"])
        z_high = tuple(torch.where(hi_mid, n, h) for n, h in zip(new, old_high))
        z_high = tuple(torch.where(hi_low, lo, h) for lo, h in zip(old_low, z_high))
        z_low = tuple(torch.where(lo_mid, n, lo) for n, lo in zip(new, old_low))
        ref = hi_mid | hi_low
        z = dict(
            interval_found=found, done=done,
            failed=((count + 1 >= _LS_STEPS) | ((delta <= _INTERVAL_THRESHOLD)
                                                & (z_safe[0] > 0.0))) & ~done,
            low=z_low[0], value_low=z_low[1], slope_low=z_low[2],
            high=z_high[0], value_high=z_high[1], slope_high=z_high[2],
            cubic_ref=torch.where(ref, high, low),
            value_cubic_ref=torch.where(ref, s["value_high"], s["value_low"]),
            safe_stepsize=z_safe[0], safe_value=z_safe[1], safe_grad=z_safe[2],
        )

        nxt = {k: _sel(found, z[k], a[k]) for k in a}
        nxt.update(count=count + 1, stepsize=step, value=new_value, grad=new_grad,
                   slope=new_slope, decrease_error=dec)
        # _try_safe_step, for the paths whose search just failed.
        fallback = nxt["failed"] & ((nxt["safe_stepsize"] > 0.0) | torch.isinf(dec))
        nxt["stepsize"] = torch.where(fallback, nxt["safe_stepsize"], nxt["stepsize"])
        nxt["value"] = torch.where(fallback, nxt["safe_value"], nxt["value"])
        nxt["grad"] = _sel(fallback, nxt["safe_grad"], nxt["grad"])
        s = {k: _sel(active, nxt[k], s[k]) for k in s}
    return s["stepsize"], s["value"], s["grad"]


def _lbfgs_paths(lg, x0, num_steps, counter):
    """``num_steps`` steps of optax's L-BFGS on ``-logp`` for every path
    in ``x0`` (P, d), in lockstep.

    Returns ``(xs, gs)``: the iterates ``(P, num_steps + 1, d)`` from
    ``x0`` on, and the gradients of logp at each."""

    def neg_vg(x):
        v, g = lg(x)
        return -v, -g

    P, d = x0.shape
    dtype, device = x0.dtype, x0.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    dw, du, rhos = zeros(P, _MEMORY, d), zeros(P, _MEMORY, d), zeros(P, _MEMORY)
    prev_params, prev_updates = zeros(P, d), zeros(P, d)
    value, grad = torch.full((P,), math.inf, dtype=dtype, device=device), zeros(P, d)
    x, xs, gs = x0, [x0], []
    for count in range(num_steps):
        # optax.value_and_grad_from_state: the line search's value and
        # gradient, recomputed where the value is not finite.
        stale = ~torch.isfinite(value)
        counter["syncs"] += 1
        if bool(stale.any()):
            v_new, g_new = neg_vg(x)
            counter["evals"] += 1
            value, grad = torch.where(stale, v_new, value), _sel(stale, g_new, grad)
        # scale_by_lbfgs
        memory_idx, prev_idx = count % _MEMORY, (count - 1) % _MEMORY
        diff_params, diff_updates = x - prev_params, grad - prev_updates
        vdot_dd = _vdot(diff_updates, diff_params)
        weight = torch.where(vdot_dd == 0.0, torch.zeros_like(vdot_dd), 1.0 / vdot_dd)
        if count == 0:
            diff_params, diff_updates, weight = (torch.zeros_like(t) for t in
                                                 (diff_params, diff_updates, weight))
        dw, du, rhos = dw.clone(), du.clone(), rhos.clone()
        dw[:, prev_idx], du[:, prev_idx], rhos[:, prev_idx] = diff_params, diff_updates, weight
        if count == 0:
            identity_scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=-1), max=1.0)
        else:
            num = _vdot(diff_updates, diff_params)
            den = _vdot(diff_updates, diff_updates)
            identity_scale = torch.where(den > 0.0, num / den, torch.ones_like(den))
        direction = -_precondition(grad, dw, du, rhos, identity_scale, memory_idx)
        prev_params, prev_updates = x, grad
        # the zoom line search
        stepsize, ls_value, ls_grad = _zoom_linesearch(neg_vg, x, direction, value, grad, counter)
        gs.append(-grad)  # the gradient of logp before the step
        x = x + stepsize[:, None] * direction
        value, grad = ls_value, ls_grad
        xs.append(x)
    _, g_last = neg_vg(x)
    counter["evals"] += 1
    gs.append(-g_last)
    return torch.stack(xs, dim=1), torch.stack(gs, dim=1)


def _curvature_ok(s, y):
    # RELATIVE curvature condition: an absolute threshold would reject
    # the tiny (but informative) steps of a converged optimizer.
    sty = _vdot(s, y)
    scale = torch.linalg.vector_norm(s, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
    return sty > 1e-4 * scale


def _inv_hessians(xs, gs):
    """The windowed-BFGS inverse-Hessian estimate at each iterate after
    the first: ``(H (..., L, d, d), has_curv (..., L))`` from the
    ``_WINDOW`` most recent curvature pairs, as the JAX package builds
    it (zero-padded pre-path pairs fail the curvature condition)."""
    *batch, n, d = xs.shape
    L = n - 1
    s_pairs = xs[..., 1:, :] - xs[..., :-1, :]
    y_pairs = gs[..., :-1, :] - gs[..., 1:, :]
    pad = torch.zeros((*batch, _WINDOW - 1, d), dtype=xs.dtype, device=xs.device)
    s_pad = torch.cat([pad, s_pairs], dim=-2)
    y_pad = torch.cat([pad, y_pairs], dim=-2)
    # windows (..., L, J, d): window l holds pairs l .. l + J - 1
    sw = s_pad.unfold(-2, _WINDOW, 1).movedim(-1, -2)[..., :L, :, :]
    yw = y_pad.unfold(-2, _WINDOW, 1).movedim(-1, -2)[..., :L, :, :]
    valid = _curvature_ok(sw, yw)
    stys, ytys = _vdot(sw, yw), _vdot(yw, yw)
    gammas = torch.where(valid, stys / torch.where(valid, ytys, torch.ones_like(ytys)),
                         torch.ones_like(stys))
    has_valid = valid.any(dim=-1)
    j = torch.arange(_WINDOW, device=xs.device)
    newest_idx = torch.argmax(torch.where(valid, j, -1), dim=-1, keepdim=True)
    newest = torch.where(has_valid, torch.gather(gammas, -1, newest_idx)[..., 0],
                         torch.ones_like(has_valid, dtype=xs.dtype))
    eye = torch.eye(d, dtype=xs.dtype, device=xs.device)
    H = newest[..., None, None] * eye
    for k in range(_WINDOW):
        s, y = sw[..., k, :], yw[..., k, :]
        ok = _curvature_ok(s, y)
        sty = _vdot(s, y)
        rho = 1.0 / torch.where(ok, sty, torch.ones_like(sty))
        V = eye - rho[..., None, None] * (s[..., :, None] * y[..., None, :])
        H_new = V @ H @ V.transpose(-1, -2) + rho[..., None, None] * (s[..., :, None]
                                                                       * s[..., None, :])
        H = torch.where(ok[..., None, None], H_new, H)
    return H, has_valid


def _gaussian_logq(z, mu, chol):
    """log N(z; mu, chol chol') for draws ``z`` (..., K, d)."""
    d = mu.shape[-1]
    sol = torch.linalg.solve_triangular(chol, (z - mu[..., None, :]).transpose(-1, -2),
                                        upper=False).transpose(-1, -2)
    return (-0.5 * torch.sum(sol**2, dim=-1)
            - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)[..., None]
            - 0.5 * d * math.log(2.0 * math.pi))


def _fit_paths(flat_logp, unravel, inits, eps_common, *, num_steps, jitter, counter):
    """Every path of ``inits`` (P, d) → per-iterate ``(elbo, mu, cov,
    has_curv)``, each with leading ``(P, num_steps)`` axes."""
    lg = make_batch_logp_and_grad(flat_logp, unravel)
    xs, gs = _lbfgs_paths(lg, inits, num_steps, counter)
    H, has_curv = _inv_hessians(xs, gs)
    d = inits.shape[-1]
    cov = H + jitter * torch.eye(d, dtype=inits.dtype, device=inits.device)
    chol = cholesky_or_nan(cov)
    mu = xs[:, 1:] + (H @ gs[:, 1:, :, None])[..., 0]  # Newton correction
    z = mu[..., None, :] + eps_common @ chol.transpose(-1, -2)  # (P, L, K, d)
    logq = _gaussian_logq(z, mu, chol)
    with torch.no_grad():
        logp = torch.func.vmap(flat_logp)(z.reshape(-1, d)).reshape(z.shape[:-1])
    counter["elbo_evals"] += 1
    elbo = torch.mean(logp - logq, dim=-1)
    # A NaN ELBO (divergent path point) must never win the argmax, nor a
    # point with no curvature information (q = N(., gamma I)).
    elbo = torch.where(torch.isfinite(elbo), elbo, -torch.inf)
    elbo = torch.where(has_curv, elbo, -torch.inf)
    return elbo, mu, cov, has_curv


def _draw(mu, cov, unravel, generator, num_draws):
    chol = cholesky_or_nan(cov)
    eps = torch.randn((num_draws,) + tuple(mu.shape), generator=generator, dtype=mu.dtype,
                      device=mu.device)
    return unravel(mu + eps @ chol.T)


def _select(elbos, mus, covs, unravel, generator, num_draws, counter):
    flat_idx = int(torch.argmax(elbos.reshape(-1)))
    best_path, best_iter = divmod(flat_idx, elbos.shape[1])
    mu_b, cov_b = mus[best_path, best_iter], covs[best_path, best_iter]
    return PathfinderResult(
        samples=_draw(mu_b, cov_b, unravel, generator, num_draws),
        elbo=elbos[best_path, best_iter],
        best_iter=torch.tensor(best_iter),
        best_path=torch.tensor(best_path),
        mean_flat=mu_b,
        cov_flat=cov_b,
        unravel=unravel,
    )


def pathfinder(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    generator: torch.Generator,
    *,
    num_steps: int = 200,
    num_elbo_draws: int = 16,
    num_draws: int = 1000,
    jitter: float = 1e-6,
    counter: dict | None = None,
) -> PathfinderResult:
    """Single-path Pathfinder from ``init_params``.

    Returns draws from the Gaussian ``N(x_l + H_l g_l, H_l)`` at the
    path point ``l`` with the highest Monte-Carlo ELBO (common random
    numbers across candidates).  Raises ``ValueError`` when the path
    produced no curvature information at all.  ``counter``, if given,
    gains the batched evaluations of the path (``evals``), of the ELBO
    draws (``elbo_evals``) and the host syncs of the loops (``syncs``).
    """
    counter = _counter(counter)
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)
    flat_init = flat_init.detach()
    eps_common = torch.randn((num_elbo_draws, flat_init.shape[0]), generator=generator,
                             dtype=flat_init.dtype, device=flat_init.device)
    elbos, mus, covs, has_curv = _fit_paths(
        flat_logp, unravel, flat_init[None], eps_common, num_steps=num_steps, jitter=jitter,
        counter=counter)
    if not bool(has_curv.any()):
        raise ValueError(
            "no path point produced valid curvature (did the path start "
            "at a stationary point?); cannot fit a Gaussian — use "
            "laplace_approximation from a mode instead"
        )
    return _select(elbos, mus, covs, unravel, generator, num_draws, counter)


def multipath_pathfinder(
    logp_fn: Callable[[Any], torch.Tensor],
    init_params: Any,
    generator: torch.Generator,
    *,
    num_paths: int = 4,
    init_jitter: float = 1.0,
    num_steps: int = 200,
    num_elbo_draws: int = 16,
    num_draws: int = 1000,
    jitter: float = 1e-6,
    counter: dict | None = None,
) -> PathfinderResult:
    """Multi-path Pathfinder: ``num_paths`` paths from jittered inits,
    run in lockstep; the winner is the highest-ELBO point across all
    paths' points, scored with the same common random numbers."""
    counter = _counter(counter)
    flat_logp, flat_init, unravel = flatten_logp(logp_fn, init_params)
    flat_init = flat_init.detach()
    inits = flat_init + init_jitter * torch.randn(
        (num_paths,) + tuple(flat_init.shape), generator=generator, dtype=flat_init.dtype,
        device=flat_init.device)
    eps_common = torch.randn((num_elbo_draws, flat_init.shape[0]), generator=generator,
                             dtype=flat_init.dtype, device=flat_init.device)
    elbos, mus, covs, has_curv = _fit_paths(
        flat_logp, unravel, inits, eps_common, num_steps=num_steps, jitter=jitter,
        counter=counter)
    if not bool(has_curv.any()):
        raise ValueError(
            "no path of any seed produced valid curvature; cannot fit "
            "a Gaussian approximation"
        )
    return _select(elbos, mus, covs, unravel, generator, num_draws, counter)


def _counter(counter):
    counter = {} if counter is None else counter
    for k in ("evals", "elbo_evals", "syncs"):
        counter.setdefault(k, 0)
    return counter
