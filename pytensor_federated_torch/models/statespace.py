"""Linear-Gaussian state-space models with parallel-in-time inference.

Port of the single-device part of the JAX package's
``models/statespace.py``.  The Kalman filter is a sequential recursion;
the parallel form (Särkkä & García-Fernández, IEEE TAC 2021) rewrites
filtering and smoothing as associative operators, so a parallel prefix
scan (:func:`.._assoc_scan.associative_scan`) evaluates all T steps in
O(log T) depth, each level one batched set of small matrix products.

Model (``m0``/``P0`` are the moments of a *time-0* latent, so the first
observed state is ``z_1 ~ N(F m0, F P0 Fᵀ + Q)``)::

    z_0 ~ N(m0, P0)            latent, dim d
    z_t = F z_{t-1} + N(0, Q)  t = 1..T
    y_t = H z_t     + N(0, R)  observed, dim k, t = 1..T

Evaluation paths, exact and equal to one another:

- :func:`kalman_logp_seq` — the classic filter, a Python loop over T
  (the golden reference; O(T) depth, tens of small launches per step);
- :func:`kalman_logp_parallel` — the associative scan over the 5-tuple
  filtering elements ``(A, b, C, J, eta)``.

Every factorization and solve uses :func:`..utils.cholesky_or_nan` /
:func:`..utils.solve_or_nan`: no host sync, and NaN (as in JAX) where a
matrix is not positive definite or is singular.

:class:`SeqShardedLGSSM` cuts the time axis over a mesh axis: each slot
scans its own segment, and the segments' summaries are composed into
each slot's exclusive prefix (and, for the smoother, suffix) in time
order, once per slot (:func:`_exclusive_segment_fold`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .._assoc_scan import associative_scan
from ..precision import matmul_precision_ctx
from ..parallel.mesh import SEQ_AXIS, Mesh
from ..utils import cholesky_or_nan, resolve_device, solve_or_nan, tree_map, value_and_grad

__all__ = [
    "FederatedLGSSMPanel",
    "SeqShardedLGSSM",
    "default_lgssm_params",
    "ekf_logp",
    "generate_lgssm_data",
    "kalman_forecast",
    "kalman_logp_parallel",
    "kalman_logp_seq",
    "kalman_smoother_parallel",
    "kalman_smoother_seq",
    "kalman_smoother_with_lag1",
    "lgssm_em",
    "panel_em",
    "sample_latents",
]


def _mT(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``a @ v`` over leading axes."""
    return (a @ v[..., None])[..., 0]


def _mvn_logpdf(x, mean, cov):
    d = x.shape[-1]
    diff = x - mean
    chol = cholesky_or_nan(cov)
    sol = torch.linalg.solve_triangular(chol, diff[..., None], upper=False)[..., 0]
    return (
        -0.5 * torch.sum(sol**2, dim=-1)
        - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        - 0.5 * d * math.log(2.0 * math.pi)
    )


def generate_lgssm_data(
    T: int = 128,
    *,
    d: int = 2,
    k: int = 1,
    seed: int = 7,
    device: Any = None,
):
    """A stable rotation-plus-decay latent with noisy observations.

    numpy's ``default_rng`` makes the data, so they are byte-identical to
    the JAX package's; ``(y (T, k), params)`` land on ``device``
    (``cuda`` unless the caller says otherwise), float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    F = 0.95 * (rot if d == 2 else np.eye(d))
    H = rng.normal(size=(k, d)) / np.sqrt(d)
    Q = 0.1 * np.eye(d)
    R = 0.5 * np.eye(k)
    z = rng.normal(size=d)
    ys = []
    for _ in range(T):
        z = F @ z + rng.multivariate_normal(np.zeros(d), Q)
        ys.append(H @ z + rng.multivariate_normal(np.zeros(k), R))
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    params = {
        "F": f32(F),
        "H": f32(H),
        "log_q": f32(np.log(0.1)),
        "log_r": f32(np.log(0.5)),
        "m0": torch.zeros((d,), dtype=torch.float32, device=dev),
    }
    return f32(np.stack(ys)), params


def default_lgssm_params(d: int = 2, k: int = 1, *, device: Any = None) -> dict:
    """Default parameter tree (the keys ``_unpack`` expects), float32 on
    ``device`` (``cuda`` unless the caller says otherwise)."""
    dev = resolve_device(device)
    return {
        "F": 0.9 * torch.eye(d, device=dev),
        "H": torch.ones((k, d), device=dev) / d,
        "log_q": torch.tensor(-1.0, device=dev),
        "log_r": torch.tensor(-0.5, device=dev),
        "m0": torch.zeros((d,), device=dev),
    }


def _unpack(params):
    F = params["F"]
    H = params["H"]
    d = F.shape[0]
    k = H.shape[0]
    eye_d = torch.eye(d, dtype=F.dtype, device=F.device)
    Q = torch.exp(params["log_q"]) * eye_d
    R = torch.exp(params["log_r"]) * torch.eye(k, dtype=F.dtype, device=F.device)
    m0 = params["m0"]
    P0 = eye_d
    return F, H, Q, R, m0, P0


# ---------------------------------------------------------------------------
# Sequential reference filter (golden model; O(T) depth)
# ---------------------------------------------------------------------------


def _as_mask(mask, T, dtype, device=None):
    """Normalize an optional observation mask to a float (T,) tensor
    (1 = observed, 0 = missing)."""
    if mask is None:
        return torch.ones((T,), dtype=dtype, device=device)
    return torch.as_tensor(mask, dtype=dtype, device=device)


def _sanitize(y, mask):
    """Zero out masked rows so NaN-encoded missing observations cannot
    poison the filter: 0 * NaN = NaN, so masked values must be
    *replaced*, not just weight-zeroed."""
    return torch.where(mask[:, None] > 0, y, torch.zeros_like(y))


def kalman_logp_seq(params: Any, y: torch.Tensor, mask: Any = None, *, precision: Any = None):
    """Marginal log-likelihood via the classic sequential Kalman filter.

    ``mask`` (optional, shape ``(T,)``): 1 where ``y_t`` is observed,
    0 where missing.  Missing steps contribute no likelihood term and
    perform a pure prediction (no measurement update).  Masked rows of
    ``y`` may hold any value, including NaN.

    ``precision``: float32 contraction policy name (:mod:`..precision`);
    ``"highest"``/``"strict"`` run every matrix product and solve with
    TF32 off.
    """
    with matmul_precision_ctx(precision):
        return _kalman_logp_seq_body(params, y, mask)


def _kalman_logp_seq_body(params, y, mask):
    F, H, Q, R, m0, P0 = _unpack(params)
    mask = _as_mask(mask, y.shape[0], F.dtype, F.device)
    y = _sanitize(y, mask)
    m, Pcov = m0, P0
    lls = []
    for t in range(y.shape[0]):
        y_t, obs = y[t], mask[t]
        # predict
        mp = F @ m
        Pp = F @ Pcov @ F.T + Q
        # observe
        S = H @ Pp @ H.T + R
        v = y_t - H @ mp
        ll = _mvn_logpdf(v, torch.zeros_like(v), S)
        K = solve_or_nan(S, H @ Pp).T
        m = torch.where(obs > 0, mp + K @ v, mp)
        Pcov = torch.where(obs > 0, Pp - K @ S @ K.T, Pp)
        lls.append(obs * ll)
    return torch.sum(torch.stack(lls))


# ---------------------------------------------------------------------------
# Associative filtering elements (Särkkä & García-Fernández 2021, §III)
# ---------------------------------------------------------------------------


def _generic_elements(F, H, Q, R, y, mask):
    """Generic (non-prior) elements for every row of ``y``: the
    conditioning of one transition on its observation.  Masked-out rows
    degrade to the pure prediction element ``(F, 0, Q, 0, 0)``.
    ``mask`` must be a normalized float tensor and ``y`` sanitized.

    The gain does not depend on ``y_t``, so it is computed once and the
    per-step parts are one batched product each."""
    T, d = y.shape[0], F.shape[0]
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    obs = (mask > 0)[:, None]
    S = H @ Q @ H.T + R  # innovation cov given exact previous state
    K = solve_or_nan(S, H @ Q).T
    HF = H @ F
    A = torch.where(obs[..., None], (eye - K @ H) @ F, F)
    b = torch.where(obs, y @ K.T, torch.zeros((T, d), dtype=F.dtype, device=F.device))
    C = torch.where(obs[..., None], (eye - K @ H) @ Q, Q)
    J = torch.where(obs[..., None], HF.T @ solve_or_nan(S, HF), torch.zeros_like(eye))
    eta = torch.where(obs, _mT(HF.T @ solve_or_nan(S, y.T)), torch.zeros((T, d), dtype=F.dtype,
                                                                     device=F.device))
    return A, b, C, J, eta


def _prior_element(F, H, Q, R, m0, P0, y1, obs1):
    """Element for global t=1: condition the prior predictive
    ``N(F m0, F P0 F' + Q)`` on ``y_1`` directly (or, when ``y_1`` is
    masked out, keep the prior predictive unconditioned).  Its ``A`` is
    zero, so composition discards the dependence on the non-existent
    state 0."""
    d = F.shape[0]
    Pp = F @ P0 @ F.T + Q
    mp = F @ m0
    S1 = H @ Pp @ H.T + R
    K1 = solve_or_nan(S1, H @ Pp).T
    b1 = torch.where(obs1 > 0, mp + K1 @ (y1 - H @ mp), mp)
    C1 = torch.where(obs1 > 0, Pp - K1 @ S1 @ K1.T, Pp)
    zero = torch.zeros((d, d), dtype=F.dtype, device=F.device)
    return zero, b1, C1, zero, torch.zeros((d,), dtype=F.dtype, device=F.device)


def _filter_elements(F, H, Q, R, m0, P0, y, mask=None):
    """Per-step elements ``(A, b, C, J, eta)`` such that composing
    elements 1..t yields the filtered mean/cov at t in ``(b, C)``.
    Normalizes the mask and sanitizes ``y``."""
    mask = _as_mask(mask, y.shape[0], F.dtype, F.device)
    y = _sanitize(y, mask)
    elems = _generic_elements(F, H, Q, R, y, mask)
    prior = _prior_element(F, H, Q, R, m0, P0, y[0], mask[0])
    return tuple(torch.cat([p[None], g[1:]], dim=0) for g, p in zip(elems, prior))


def _combine(e1, e2):
    """Associative composition of filtering elements (batched)."""
    A1, b1, C1, J1, eta1 = e1
    A2, b2, C2, J2, eta2 = e2
    d = A1.shape[-1]
    eye = torch.eye(d, dtype=A1.dtype, device=A1.device)
    # (I + C1 J2)^{-1}, applied from the right to A2 / to (b1 + C1 eta2).
    M = eye + C1 @ J2
    A2M = _mT(solve_or_nan(_mT(M), _mT(A2)))  # = A2 @ M^{-1}
    b = _mv(A2M, b1 + _mv(C1, eta2)) + b2
    C = A2M @ C1 @ _mT(A2) + C2
    A = A2M @ A1
    # (I + J2 C1)^{-1}
    N = eye + J2 @ C1
    A1T = _mT(A1)
    eta = (A1T @ solve_or_nan(N, (eta2 - _mv(J2, b1))[..., None]))[..., 0] + eta1
    J = A1T @ solve_or_nan(N, J2 @ A1) + J1
    return A, b, C, J, eta


def _predictive_one(F, H, Q, R, y_t, m, Pcov):
    """``log p(y_t | y_{1:t-1})`` from the filtered moments at t-1
    (batched over leading axes of ``y_t``, ``m`` and ``Pcov``)."""
    mp = m @ F.T
    Pp = F @ Pcov @ F.T + Q
    S = H @ Pp @ H.T + R
    return _mvn_logpdf(y_t - mp @ H.T, torch.zeros_like(y_t), S)


def _predictive_logp(F, H, Q, R, m0, P0, y, means, covs, mask=None):
    """Σ_t log p(y_t | y_{1:t-1}) from filtered moments at t-1 (masked
    steps contribute nothing)."""
    mask = _as_mask(mask, y.shape[0], F.dtype, F.device)
    y = _sanitize(y, mask)
    prev_m = torch.cat([m0[None], means[:-1]], dim=0)
    prev_P = torch.cat([P0[None], covs[:-1]], dim=0)
    return torch.sum(mask * _predictive_one(F, H, Q, R, y, prev_m, prev_P))


def kalman_logp_parallel(params: Any, y: torch.Tensor, mask: Any = None, *,
                         precision: Any = None):
    """Marginal log-likelihood with the O(log T)-depth associative scan.
    ``mask`` and ``precision`` as in :func:`kalman_logp_seq` (the scan
    composes d x d products over T steps, so reduced-precision error
    compounds)."""
    with matmul_precision_ctx(precision):
        F, H, Q, R, m0, P0 = _unpack(params)
        means, covs = _filtered_moments(params, y, mask)
        return _predictive_logp(F, H, Q, R, m0, P0, y, means, covs, mask)


# ---------------------------------------------------------------------------
# Smoothing (RTS): sequential golden + parallel associative scan
# ---------------------------------------------------------------------------


def _filtered_moments(params, y, mask=None):
    """All filtered means/covs via the associative scan."""
    F, H, Q, R, m0, P0 = _unpack(params)
    elems = _filter_elements(F, H, Q, R, m0, P0, y, mask)
    _, means, covs, _, _ = associative_scan(_combine, elems)
    return means, covs


def _smoother_gain(F, Q, Pf):
    """RTS smoother gain ``G = Pf F' (F Pf F' + Q)^{-1}`` (batched over
    leading axes of ``Pf``) and the predicted covariance."""
    Pp = F @ Pf @ F.T + Q
    return _mT(solve_or_nan(Pp, F @ Pf)), Pp


def kalman_smoother_seq(params: Any, y: torch.Tensor, mask: Any = None, *,
                        precision: Any = None):
    """Smoothed marginals ``(means, covs)`` via the classic backward
    Rauch-Tung-Striebel recursion (golden reference; O(T) depth).
    ``precision`` as in :func:`kalman_logp_seq`."""
    with matmul_precision_ctx(precision):
        return _kalman_smoother_seq_body(params, y, mask)


def _kalman_smoother_seq_body(params, y, mask):
    F, H, Q, R, m0, P0 = _unpack(params)
    means, covs = _filtered_moments(params, y, mask)
    ms_next, Ps_next = means[-1], covs[-1]
    sm, sP = [ms_next], [Ps_next]
    for t in range(means.shape[0] - 2, -1, -1):
        m, Pcov = means[t], covs[t]
        G, Pp = _smoother_gain(F, Q, Pcov)
        ms_next = m + G @ (ms_next - F @ m)
        Ps_next = Pcov + G @ (Ps_next - Pp) @ G.T
        sm.append(ms_next)
        sP.append(Ps_next)
    return torch.stack(sm[::-1]), torch.stack(sP[::-1])


def _smooth_elements(F, Q, means, covs, *, terminal: bool = True):
    """Per-step smoothing elements ``(E, g, L)``: the backward kernel
    ``z_t | z_{t+1} ~ N(E_t z_{t+1} + g_t, L_t)`` for t < T, and (with
    ``terminal=True``) the filtered terminal ``(0, m_T, P_T)`` at T."""
    G, Pp = _smoother_gain(F, Q, covs)
    E = G
    g = means - _mv(G, means @ F.T)
    L = covs - G @ Pp @ _mT(G)
    if not terminal:
        return E, g, L
    E = torch.cat([E[:-1], torch.zeros_like(E[-1:])], dim=0)
    g = torch.cat([g[:-1], means[-1:]], dim=0)
    L = torch.cat([L[:-1], covs[-1:]], dim=0)
    return E, g, L


def _smooth_combine(e1, e2):
    """Associative composition of backward kernels (e1 earlier)."""
    E1, g1, L1 = e1
    E2, g2, L2 = e2
    E = E1 @ E2
    g = _mv(E1, g2) + g1
    L = E1 @ L2 @ _mT(E1) + L1
    return E, g, L


def _smooth_from_filtered(F, Q, means, covs):
    """Smoothed marginals from precomputed filtered moments (one
    reverse associative scan; no second filter pass)."""
    elems = _smooth_elements(F, Q, means, covs)
    # reverse=True passes the accumulated *suffix* (the later
    # composition) as the first argument; _smooth_combine expects
    # (earlier, later), so flip.
    _, sm, sP = associative_scan(lambda a, b: _smooth_combine(b, a), elems, reverse=True)
    return sm, sP


def kalman_smoother_parallel(params: Any, y: torch.Tensor, mask: Any = None, *,
                             precision: Any = None):
    """Smoothed marginals with O(log T)-depth associative scans (one
    forward for filtering, one reverse for smoothing).  Masking enters
    through the filter alone.  ``precision`` as in
    :func:`kalman_logp_seq`."""
    with matmul_precision_ctx(precision):
        F, H, Q, R, m0, P0 = _unpack(params)
        means, covs = _filtered_moments(params, y, mask)
        return _smooth_from_filtered(F, Q, means, covs)


def _lag1_from_moments(F, Q, f_covs, sP):
    """Lag-one smoothed cross-covs: ``P^s_{t+1,t} = P^s_{t+1} G_t'``."""
    Gs, _ = _smoother_gain(F, Q, f_covs[:-1])
    return sP[1:] @ _mT(Gs)


def kalman_smoother_with_lag1(params: Any, y: torch.Tensor, mask: Any = None, *,
                              precision: Any = None):
    """Smoothed marginals plus lag-one smoothed cross-covariances.

    Returns ``(means, covs, lag1)`` with ``lag1[t] =
    Cov(z_{t+2}, z_{t+1} | y_{1:T})`` for ``t = 0..T-2`` — the RTS
    identity ``P^s_{t+1,t} = P^s_{t+1} G_t'``, the cross-moments the EM
    M-step needs (see :func:`lgssm_em`)."""
    with matmul_precision_ctx(precision):
        F, H, Q, R, m0, P0 = _unpack(params)
        f_means, f_covs = _filtered_moments(params, y, mask)
        sm, sP = _smooth_from_filtered(F, Q, f_means, f_covs)
        return sm, sP, _lag1_from_moments(F, Q, f_covs, sP)


def lgssm_em(params: Any, y: torch.Tensor, *, num_iters: int = 20, mask: Any = None,
             fit_H: bool = False, precision: Any = None):
    """Closed-form EM for the LGSSM (Shumway-Stoffer): each iteration
    runs the O(log T)-depth smoother as the E-step and updates ``F``
    (and optionally ``H``) plus the isotropic noise scales
    ``log_q``/``log_r`` in closed form.

    Conventions as in the JAX package: ``Q = exp(log_q) I`` and
    ``R = exp(log_r) I`` (full M-step solutions projected to their
    isotropic part via the trace); the prior ``(m0, P0)`` is held fixed
    and the transition sum runs over ``t = 2..T``.  Masked steps drop out
    of the emission update.

    Returns ``(params, loglik_history)``, the history being the exact
    marginal log-likelihood BEFORE each iteration's update.  The
    single-series case of :func:`panel_em`.
    """
    y = torch.as_tensor(y)
    if y.ndim == 1:
        y = y[:, None]
    return panel_em(
        params, y[None], num_iters=num_iters,
        masks=None if mask is None else torch.as_tensor(mask)[None],
        fit_H=fit_H, precision=precision,
    )


def panel_em(params: Any, ys: torch.Tensor, *, num_iters: int = 20, masks: Any = None,
             fit_H: bool = False, precision: Any = None):
    """Federated EM: one set of LGSSM parameters fit to a whole panel of
    series (the :class:`FederatedLGSSMPanel` layout).

    The E-step smooths every series independently (``torch.func.vmap``
    over series, each an O(log T) scan); the M-step pools the sufficient
    statistics across series before the closed-form update — every node
    contributes a handful of d x d matrices, never its raw series.

    ``ys``: ``(n_series, T)`` or ``(n_series, T, k)``; ``masks``
    (optional) ``(n_series, T)``.  Returns ``(params, loglik_history)``.
    """
    with matmul_precision_ctx(precision):
        return _panel_em_body(params, ys, num_iters=num_iters, masks=masks, fit_H=fit_H)


def _panel_em_body(params, ys, *, num_iters, masks, fit_H):
    ys = torch.as_tensor(ys)
    if ys.ndim == 2:
        ys = ys[..., None]
    S, T, k = ys.shape
    if masks is None:
        masks = torch.ones((S, T), dtype=ys.dtype, device=ys.device)
    else:
        masks = torch.as_tensor(masks, dtype=ys.dtype, device=ys.device)
    ys = torch.where(masks[..., None] > 0, ys, torch.zeros_like(ys))

    lls = []
    for _ in range(num_iters):
        F, H, Q, R, m0, P0 = _unpack(params)
        d = F.shape[0]

        def estep(y_i, mask_i):
            f_means, f_covs = _filtered_moments(params, y_i, mask_i)
            ll = _predictive_logp(F, H, Q, R, m0, P0, y_i, f_means, f_covs, mask_i)
            sm, sP = _smooth_from_filtered(F, Q, f_means, f_covs)
            lag1 = _lag1_from_moments(F, Q, f_covs, sP)
            Ezz = sP + sm[:, :, None] * sm[:, None, :]
            Ezz1 = lag1 + sm[1:, :, None] * sm[:-1, None, :]
            A = torch.sum(Ezz[:-1], dim=0)
            B = torch.sum(Ezz1, dim=0)
            C = torch.sum(Ezz[1:], dim=0)
            # Emission statistics in residual form (against the current
            # H): the raw-moment identity cancels catastrophically in
            # float32 when |y| is large relative to the noise.
            resid = y_i - sm @ H.T
            rr = torch.sum(mask_i * torch.sum(resid**2, dim=-1))
            Rz = torch.sum(mask_i[:, None, None] * (resid[:, :, None] * sm[:, None, :]), dim=0)
            Mzz = torch.sum(mask_i[:, None, None] * (sm[:, :, None] * sm[:, None, :]), dim=0)
            SP_obs = torch.sum(mask_i[:, None, None] * sP, dim=0)
            return ll, A, B, C, rr, Rz, Mzz, SP_obs, torch.sum(mask_i) * k

        outs = torch.func.vmap(estep)(ys, masks)
        ll, A, B, C, rr, Rz, Mzz, SP_obs, n_obs = (torch.sum(o, dim=0) for o in outs)
        F_new = solve_or_nan(A.T, B.T).T
        q_new = torch.trace((C - F_new @ B.T) / (S * (T - 1))) / d
        if fit_H:
            # Σ y sm' = Rz + H Mzz;  Σ E[z z']|obs = Mzz + SP_obs.
            H_new = solve_or_nan((Mzz + SP_obs).T, (Rz + H @ Mzz).T).T
        else:
            H_new = H
        # E Σ||y - H_new z||² via the residual stats and dH = H_new - H.
        dH = H_new - H
        r_new = (
            rr
            - 2.0 * torch.trace(dH @ Rz.T)
            + torch.trace(dH @ Mzz @ dH.T)
            + torch.trace(H_new @ SP_obs @ H_new.T)
        ) / torch.clamp(n_obs, min=1.0)
        params = dict(
            params,
            F=F_new,
            H=H_new,
            log_q=torch.log(torch.clamp(q_new, min=1e-12)),
            log_r=torch.log(torch.clamp(r_new, min=1e-12)),
        )
        lls.append(ll)
    return params, torch.stack(lls)


def kalman_forecast(params: Any, y: torch.Tensor, horizon: int, mask: Any = None, *,
                    precision: Any = None):
    """h-step-ahead predictive moments of future observations.

    Returns ``(means, covs)`` with shapes ``(horizon, k)`` and
    ``(horizon, k, k)``: the Gaussian moments of ``y_{T+h} | y_{1:T}``
    for h = 1..horizon.  One filter pass plus an affine associative scan
    over the horizon.  ``precision`` as in :func:`kalman_logp_seq`.
    """
    with matmul_precision_ctx(precision):
        y = torch.as_tensor(y)
        if y.ndim == 1:
            y = y[:, None]
        F, H, Q, R, m0, P0 = _unpack(params)
        means, covs = _filtered_moments(params, y, mask)
        return _forecast_from_terminal(F, H, Q, R, means[-1], covs[-1], horizon)


def _forecast_from_terminal(F, H, Q, R, m_T, P_T, horizon):
    """Predictive observation moments for h = 1..horizon given the
    terminal filtered state.  Latent moments at T+h are prefix
    compositions of the affine-moment element ``(F, Q)``:
    compose((A1,B1),(A2,B2)) = (A2 A1, A2 B1 A2' + B2)."""
    d = F.shape[0]
    A = F.expand(horizon, d, d)
    B = Q.expand(horizon, d, d)

    def moment(e1, e2):
        A1, B1 = e1
        A2, B2 = e2
        return A2 @ A1, A2 @ B1 @ _mT(A2) + B2

    Fh, Vh = associative_scan(moment, (A, B))
    mz = _mv(Fh, m_T)
    Pz = Fh @ P_T @ _mT(Fh) + Vh
    my = mz @ H.T
    Py = torch.einsum("ij,hjk,lk->hil", H, Pz, H) + R
    return my, Py


# ---------------------------------------------------------------------------
# Nonlinear models: extended Kalman filter (autodiff Jacobians)
# ---------------------------------------------------------------------------


def ekf_logp(f: Callable, h: Callable, params: Any, y: torch.Tensor, *, Q, R, m0, P0,
             mask: Any = None) -> torch.Tensor:
    """Approximate marginal log-likelihood of a *nonlinear* state-space
    model via the extended Kalman filter.

    ``z_t = f(params, z_{t-1}) + N(0, Q)``,
    ``y_t = h(params, z_t) + N(0, R)``.

    The per-step linearization Jacobians come from ``torch.func.jacfwd``;
    the recursion is sequential (a Python loop over T).  It equals
    :func:`kalman_logp_parallel` when ``f``/``h`` are affine.
    Differentiable in ``params`` (and ``Q``/``R``/``m0``/``P0``).
    """
    y = torch.as_tensor(y)
    if y.ndim == 1:
        y = y[:, None]
    mask_arr = _as_mask(mask, y.shape[0], y.dtype, y.device)
    y = _sanitize(y, mask_arr)

    f_jac = torch.func.jacfwd(f, argnums=1)
    h_jac = torch.func.jacfwd(h, argnums=1)
    m, Pcov = m0, P0
    lls = []
    for t in range(y.shape[0]):
        y_t, obs = y[t], mask_arr[t]
        # predict through the nonlinear transition, linearized at m
        Fm = f_jac(params, m)
        mp = f(params, m)
        Pp = Fm @ Pcov @ Fm.T + Q
        # observe through the nonlinear emission, linearized at mp
        Hm = h_jac(params, mp)
        v = y_t - h(params, mp)
        S = Hm @ Pp @ Hm.T + R
        ll = _mvn_logpdf(v, torch.zeros_like(v), S)
        K = solve_or_nan(S, Hm @ Pp).T
        m = torch.where(obs > 0, mp + K @ v, mp)
        Pcov = torch.where(obs > 0, Pp - K @ S @ K.T, Pp)
        lls.append(obs * ll)
    return torch.sum(torch.stack(lls))


# ---------------------------------------------------------------------------
# Federated panel of time series (shards axis x parallel-in-time filter)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class FederatedLGSSMPanel:
    """A panel of time series: each federated shard owns one private
    series, all sharing the LGSSM parameters.

    ``logp(params) = Σ_shards kalman_logp(params, y_shard)`` — within
    every shard the filter is the O(log T)-depth associative scan, and
    the shards are mapped by :class:`..parallel.sharded.FederatedLogp`.

    ``ys``: ``(n_series, T)`` or ``(n_series, T, k)``.  ``masks``
    (optional, ``(n_series, T)``): 1 = observed — ragged panels (pad
    shorter series and mask the padding) and irregular sampling.  A
    ``ys`` given as a tensor keeps its device; one given as an array
    lands on ``device`` (``cuda`` unless the caller says otherwise; with
    a mesh, the first slot's device).

    ``mesh`` (a :class:`..parallel.mesh.Mesh`) cuts the series over its
    ``axis``, each slot evaluating its block of series on its device
    (:class:`..parallel.sharded.FederatedLogp`'s mesh); ``n_series``
    must divide evenly.
    """

    ys: Any
    masks: Any = None
    device: Any = None
    mesh: Any = None
    axis: str = "shards"

    def __post_init__(self):
        from ..parallel.sharded import FederatedLogp

        if torch.is_tensor(self.ys):
            ys = self.ys
        else:
            device = self.device
            if device is None and self.mesh is not None and self.axis in self.mesh.axis_names:
                device = self.mesh.slot_devices(self.axis)[0]
            ys = torch.as_tensor(np.asarray(self.ys), device=resolve_device(device))
        if ys.ndim not in (2, 3):
            raise ValueError(
                f"expected ys of shape (n_series, T) or (n_series, T, k), got {tuple(ys.shape)}"
            )
        if ys.ndim == 2:
            ys = ys[..., None]
        self.ys = ys
        if self.masks is None:
            self.masks = torch.ones(ys.shape[:2], dtype=ys.dtype, device=ys.device)
        else:
            self.masks = torch.as_tensor(self.masks, dtype=ys.dtype, device=ys.device)
            if tuple(self.masks.shape) != tuple(ys.shape[:2]):
                raise ValueError(
                    f"masks shape {tuple(self.masks.shape)} != (n_series, T) "
                    f"{tuple(ys.shape[:2])}"
                )

        def per_shard_logp(params, shard):
            y_shard, mask_shard = shard
            return kalman_logp_parallel(params, y_shard, mask_shard)

        self.fed = FederatedLogp(
            per_shard_logp, (self.ys, self.masks), mesh=self.mesh, axis=self.axis
        )

    def logp(self, params: Any) -> torch.Tensor:
        return self.fed.logp(params)

    def logp_and_grad(self, params: Any):
        return self.fed.logp_and_grad(params)

    def init_params(self, d: int = 2) -> Any:
        return default_lgssm_params(d, self.ys.shape[-1], device=self.ys.device)


# ---------------------------------------------------------------------------
# Posterior latent sampling (Durbin-Koopman simulation smoother)
# ---------------------------------------------------------------------------


def _affine_combine(e1, e2):
    """Composition of affine recurrence elements (e1 earlier):
    ``z -> A2(A1 z + b1) + b2``."""
    A1, b1 = e1
    A2, b2 = e2
    return A2 @ A1, _mv(A2, b1) + b2


def _draw_noise(params, generator: torch.Generator, T: int):
    """The model's noise draws ``(z0, w, v)`` from ``generator``."""
    F, H, Q, R, m0, P0 = _unpack(params)
    d, k = F.shape[0], H.shape[0]
    normal = lambda *shape: torch.randn(shape, generator=generator, dtype=F.dtype,
                                        device=F.device)
    z0 = m0 + cholesky_or_nan(P0) @ normal(d)
    w = normal(T, d) @ cholesky_or_nan(Q).T
    v = normal(T, k) @ cholesky_or_nan(R).T
    return z0, w, v


def _simulate(params, T: int, *, generator: Optional[torch.Generator] = None, noise=None):
    """One unconditional draw ``(z*, y*)`` from the model, from ``noise``
    ``(z0, w, v)`` when given (tests inject the JAX package's draws),
    else from :func:`_draw_noise` on ``generator``.  The latent
    recurrence ``z_t = F z_{t-1} + w_t`` is itself an associative scan
    over affine elements ``(A, b)``."""
    F, H, Q, R, m0, P0 = _unpack(params)
    d = F.shape[0]
    z0, w, v = _draw_noise(params, generator, T) if noise is None else noise
    b = torch.cat([(w[0] + F @ z0)[None], w[1:]], dim=0)
    A = F.expand(T, d, d)
    _, z = associative_scan(_affine_combine, (A, b))
    y = z @ H.T + v
    return z, y


def sample_latents(params: Any, y: torch.Tensor, generator: torch.Generator,
                   num_draws: int = 1, mask: Any = None) -> torch.Tensor:
    """Joint posterior draws of the latent path ``z_{1:T} | y_{1:T}``.

    Durbin & Koopman's simulation smoother: draw an unconditional
    ``(z*, y*)`` from the model, then ``z_draw = E[z|y] + (z* -
    E[z|y*])`` — exact for linear-Gaussian models; each draw costs two
    O(log T)-depth smoother passes.  Returns ``(num_draws, T, d)``.
    """
    y = torch.as_tensor(y)
    if y.ndim == 1:
        y = y[:, None]
    T = y.shape[0]
    # The synthetic draw conditions on the SAME observation pattern.
    sm_y, _ = kalman_smoother_parallel(params, y, mask)
    draws = []
    for _ in range(num_draws):
        z_star, y_star = _simulate(params, T, generator=generator)
        sm_star, _ = kalman_smoother_parallel(params, y_star, mask)
        draws.append(sm_y + z_star - sm_star)
    return torch.stack(draws)


# ---------------------------------------------------------------------------
# Sequence-sharded filter, smoother and simulation smoother
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class SeqShardedLGSSM:
    """LGSSM likelihood with the time axis cut over ``axis`` of ``mesh``.

    Slot ``i`` holds the contiguous segment ``y[i*Tb:(i+1)*Tb]`` on its
    device and associative-scans its filtering elements there; each
    segment's summary (the fold of the segment, one ``(A, b, C, J, eta)``
    element of O(d²) numbers) goes to the later slots, each slot composes
    the exclusive prefix of the segments before it, and folds it into its
    local scan.  The JAX package all-gathers the summaries and every
    device folds all of them under ``where`` predicates; here each
    slot's prefix is composed once, in time order.

    ``y`` (``(T,)`` or ``(T, k)``, numpy or a tensor) and ``mask``
    (``(T,)``, 1 = observed) land on the first slot's device; ``T`` must
    divide over the axis.  Differentiable end to end; results come back
    on the first slot's device, in time order.
    """

    y: Any
    mesh: Mesh
    axis: str = SEQ_AXIS
    mask: Any = None

    def __post_init__(self):
        if self.axis not in self.mesh.axis_names:
            raise ValueError(f"mesh has no axis {self.axis!r}: {self.mesh.axis_names}")
        self._devices = self.mesh.slot_devices(self.axis)
        n = len(self._devices)
        home = self._devices[0]
        y = self.y if torch.is_tensor(self.y) else torch.as_tensor(np.asarray(self.y))
        y = y.to(home)
        if y.ndim == 1:
            y = y[:, None]
        if y.shape[0] % n != 0:
            raise ValueError(f"sequence length {y.shape[0]} not divisible by {n}")
        self.y = y
        self.mask = _as_mask(self.mask, y.shape[0], y.dtype, home).to(home)
        self._y_blocks = _cut(y, self._devices)
        self._mask_blocks = _cut(self.mask, self._devices)

    def logp(self, params: Any) -> torch.Tensor:
        return _sharded_lgssm_logp(params, self._y_blocks, self._mask_blocks, self._devices)

    def logp_and_grad(self, params: Any):
        return _sharded_lgssm_vg(params, self._y_blocks, self._mask_blocks, self._devices)

    def smoothed_moments(self, params: Any):
        """Smoothed marginals ``(means, covs)``, ``(T, d)`` and ``(T, d,
        d)``: the reverse mirror of the filter's segment prefixes (see
        :func:`_sharded_lgssm_smoother`)."""
        sm, sP = _sharded_lgssm_smoother(params, self._y_blocks, self._mask_blocks,
                                         self._devices)
        return _join(sm, self._devices[0]), _join(sP, self._devices[0])

    def sample_latents(self, params: Any, generator: Optional[torch.Generator] = None,
                       num_draws: int = 1, *, noise=None) -> torch.Tensor:
        """Durbin-Koopman simulation smoother over the slots: joint
        posterior draws of ``z_{1:T} | y``, ``(num_draws, T, d)``.  The
        unconditional simulation is an affine prefix scan over the slots
        (the same exclusive segment fold as the filter); each draw costs
        two sharded smoother passes, every draw at once (``vmap``).
        ``noise`` ``(z0 (D, d), w (D, T, d), v (D, T, k))`` replaces the
        draws from ``generator`` (:func:`_draw_noise`, draw by draw, as
        :func:`sample_latents` takes them)."""
        return _sharded_lgssm_sampler(params, self._y_blocks, self._mask_blocks,
                                      self._devices, generator, num_draws, noise)

    def forecast(self, params: Any, horizon: int):
        """h-step-ahead predictive observation moments from the sharded
        filter: only the terminal filtered state crosses to the first
        slot, then the affine-moment horizon scan runs there.  Equals
        :func:`kalman_forecast`."""
        m_T, P_T = _sharded_lgssm_terminal_filtered(params, self._y_blocks, self._mask_blocks,
                                                    self._devices)
        F, H, Q, R, _, _ = _unpack(_to(params, self._devices[0]))
        return _forecast_from_terminal(F, H, Q, R, m_T, P_T, horizon)

    def init_params(self, d: int = 2) -> Any:
        return default_lgssm_params(d, self.y.shape[-1], device=self._devices[0])


def _to(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda a: a.to(device), tree)


def _cut(x: torch.Tensor, devices) -> list:
    """Slot ``i``'s contiguous block of ``x``'s leading (time) axis, on
    its device."""
    per = x.shape[0] // len(devices)
    return [x[i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)]


def _join(blocks, home: torch.device) -> torch.Tensor:
    return torch.cat([b.to(home) for b in blocks], dim=0)


def _broadcast_rows(elem, n: int):
    return tuple(a.expand((n,) + a.shape) for a in elem)


def _exclusive_segment_fold(summaries, combine, identities, *, suffix):
    """Each slot's exclusive composition of the other segments' summaries:
    of the segments strictly BEFORE it (``suffix=False``) or strictly
    AFTER it (``suffix=True``).  ``combine(earlier, later)`` composes in
    time order either way, starting from the slot's ``identities`` entry
    (the identity element on its device), with the accumulated element
    as the earlier operand, as the JAX package's fold does; each slot's
    result is composed on its own device.  Shared by the filter, the
    simulation and the smoother."""
    n = len(summaries)
    out = []
    for idx, acc in enumerate(identities):
        device = acc[0].device
        others = range(idx + 1, n) if suffix else range(idx)
        for r in others:
            acc = combine(acc, tuple(a.to(device) for a in summaries[r]))
        out.append(acc)
    return out


def _local_filtered(F, H, Q, R, m0, P0, y_local, mask_local, first: bool):
    """A slot's associative scan of its segment's filtering elements.
    Generic elements everywhere; the prior-conditioned element only
    exists at global t = 1, row 0 of the first slot (``first``), which
    takes it whether or not that step is observed."""
    elems = _generic_elements(F, H, Q, R, y_local, mask_local)
    if first:
        prior = _prior_element(F, H, Q, R, m0, P0, y_local[0], mask_local[0])
        elems = tuple(torch.cat([p[None], g[1:]], dim=0) for g, p in zip(elems, prior))
    return associative_scan(_combine, elems)


def _filter_identity(F):
    d = F.shape[0]
    kw = dict(dtype=F.dtype, device=F.device)
    zeros = torch.zeros((d, d), **kw)
    return (torch.eye(d, **kw), torch.zeros((d,), **kw), zeros, zeros, torch.zeros((d,), **kw))


def _local_filter_prologue(params, y_blocks, mask_blocks, devices):
    """The first act of every sharded-LGSSM evaluation: each slot
    unpacks the parameters on its device, sanitizes its segment and
    scans it; the exclusive prefixes of the segments' summaries are
    composed; each slot folds its prefix into its local scan.  Returns,
    per slot, ``(unpacked, y_local, means, covs, prefix)`` (the prefix
    is the identity element on the first slot)."""
    unpacked, ys, scans = [], [], []
    for i, (d, y_local, mask_local) in enumerate(zip(devices, y_blocks, mask_blocks)):
        up = _unpack(_to(params, d))
        F, H, Q, R, m0, P0 = up
        y_local = _sanitize(y_local, mask_local)
        unpacked.append(up)
        ys.append(y_local)
        scans.append(_local_filtered(F, H, Q, R, m0, P0, y_local, mask_local, i == 0))
    summaries = [tuple(a[-1] for a in s) for s in scans]
    prefixes = _exclusive_segment_fold(summaries, _combine,
                                       [_filter_identity(up[0]) for up in unpacked],
                                       suffix=False)
    out = []
    for up, y_local, scan, prefix in zip(unpacked, ys, scans, prefixes):
        _, means, covs, _, _ = _combine(_broadcast_rows(prefix, y_local.shape[0]), scan)
        out.append((up, y_local, means, covs, prefix))
    return out


def _sharded_lgssm_logp(params, y_blocks, mask_blocks, devices):
    """Σ_t log p(y_t | y_{1:t-1}) over the slots: the predictive terms of
    a segment need the filtered state at t - 1, which for its row 0 is
    its prefix (the previous segment's last filtered state; the prior
    m0, P0 on the first slot).  The slots' sums are added on the first
    slot's device, in slot order."""
    parts = []
    for i, ((F, H, Q, R, m0, P0), y_local, means, covs, prefix) in enumerate(
            _local_filter_prologue(params, y_blocks, mask_blocks, devices)):
        first_m, first_P = (m0, P0) if i == 0 else (prefix[1], prefix[2])
        prev_m = torch.cat([first_m[None], means[:-1]], dim=0)
        prev_P = torch.cat([first_P[None], covs[:-1]], dim=0)
        lp = _predictive_one(F, H, Q, R, y_local, prev_m, prev_P)
        parts.append(torch.sum(mask_blocks[i] * lp))
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def _sharded_lgssm_vg(params, y_blocks, mask_blocks, devices):
    """(logp, grad) of the sharded filter, one forward and one backward."""
    return value_and_grad(lambda p: _sharded_lgssm_logp(p, y_blocks, mask_blocks, devices),
                          params)


def _sharded_lgssm_terminal_filtered(params, y_blocks, mask_blocks, devices):
    """Terminal filtered moments ``(m_T, P_T)``: the last slot's last
    row, on the first slot's device — the only state a forecast needs."""
    *_, (_, _, means, covs, _) = _local_filter_prologue(params, y_blocks, mask_blocks, devices)
    return means[-1].to(devices[0]), covs[-1].to(devices[0])


def _sharded_lgssm_simulate(F, z0, w_blocks, devices):
    """The latent affine recurrence ``z_t = F z_{t-1} + w_t`` over the
    slots: a local affine scan per slot (the first slot's row 0 carries
    ``F z0``) and the exclusive segment prefix fold.  ``F`` and ``z0``
    lie on the first slot's device; returns each slot's ``z`` block."""
    d = F.shape[0]
    scans, Fs = [], []
    for i, (dev, w_local) in enumerate(zip(devices, w_blocks)):
        Fd = F.to(dev)
        b = torch.cat([(w_local[0] + Fd @ z0.to(dev))[None], w_local[1:]]) if i == 0 else w_local
        scans.append(associative_scan(_affine_combine, (Fd.expand(w_local.shape[0], d, d), b)))
        Fs.append(Fd)
    summaries = [tuple(a[-1] for a in s) for s in scans]
    identities = [(torch.eye(d, dtype=Fd.dtype, device=Fd.device),
                   torch.zeros((d,), dtype=Fd.dtype, device=Fd.device)) for Fd in Fs]
    prefixes = _exclusive_segment_fold(summaries, _affine_combine, identities, suffix=False)
    return [_affine_combine(_broadcast_rows(prefix, w_local.shape[0]), scan)[1]
            for prefix, scan, w_local in zip(prefixes, scans, w_blocks)]


def _sharded_lgssm_smoother(params, y_blocks, mask_blocks, devices):
    """Sharded RTS smoother: the reverse mirror of the filter's segment
    prefixes.  Each slot builds backward-kernel elements from its
    filtered moments (the terminal element ``(0, m_T, P_T)`` on the last
    slot's last row), reverse-scans its segment, and folds in the
    exclusive suffix of the segments after it.  Returns each slot's
    ``(means, covs)`` blocks."""
    prologue = _local_filter_prologue(params, y_blocks, mask_blocks, devices)
    n = len(devices)
    scans, identities = [], []
    for i, ((F, H, Q, R, m0, P0), _, means, covs, _) in enumerate(prologue):
        E, g, L = _smooth_elements(F, Q, means, covs, terminal=(i == n - 1))
        # Local suffix scan: row t holds elems[t] ∘ ... ∘ elems[last].
        scans.append(associative_scan(lambda a, b: _smooth_combine(b, a), (E, g, L),
                                      reverse=True))
        d = F.shape[0]
        identities.append((torch.eye(d, dtype=F.dtype, device=F.device),
                           torch.zeros((d,), dtype=F.dtype, device=F.device),
                           torch.zeros((d, d), dtype=F.dtype, device=F.device)))
    summaries = [tuple(a[0] for a in s) for s in scans]
    suffixes = _exclusive_segment_fold(summaries, _smooth_combine, identities, suffix=True)
    out_m, out_P = [], []
    for scan, suffix in zip(scans, suffixes):
        _, sm, sP = _smooth_combine(scan, _broadcast_rows(suffix, scan[0].shape[0]))
        out_m.append(sm)
        out_P.append(sP)
    return out_m, out_P


def _sharded_lgssm_sampler(params, y_blocks, mask_blocks, devices, generator, num_draws,
                           noise=None):
    """Durbin-Koopman draws ``sm(y) + z* - sm(y*)`` over the slots, every
    draw at once under ``torch.func.vmap``; the noise of draw ``j`` is
    ``noise``'s row ``j`` or, without ``noise``, :func:`_draw_noise` on
    ``generator`` draw by draw (on the first slot's device)."""
    home = devices[0]
    p_home = _to(params, home)
    F, H = p_home["F"], p_home["H"]
    T = sum(int(b.shape[0]) for b in y_blocks)
    sm_y, _ = _sharded_lgssm_smoother(params, y_blocks, mask_blocks, devices)
    sm_y = _join(sm_y, home)
    if noise is None:
        draws = [_draw_noise(p_home, generator, T) for _ in range(num_draws)]
        noise = tuple(torch.stack(parts) for parts in zip(*draws))
    z0s, ws, vs = (torch.as_tensor(a).to(home) for a in noise)

    def one(z0, w, v):
        z_star = _join(_sharded_lgssm_simulate(F, z0, _cut(w, devices), devices), home)
        y_star = z_star @ H.T + v
        sm_star, _ = _sharded_lgssm_smoother(params, _cut(y_star, devices), mask_blocks,
                                             devices)
        return sm_y + z_star - _join(sm_star, home)

    return torch.func.vmap(one)(z0s, ws, vs)
