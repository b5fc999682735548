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
matrix is not positive definite or is singular.  The time axis sharded
over GPUs (the JAX package's ``SeqShardedLGSSM``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .._assoc_scan import associative_scan
from ..precision import matmul_precision_ctx
from ..utils import cholesky_or_nan, resolve_device, solve_or_nan

__all__ = [
    "FederatedLGSSMPanel",
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
    lands on ``device`` (``cuda`` unless the caller says otherwise).
    """

    ys: Any
    masks: Any = None
    device: Any = None

    def __post_init__(self):
        from ..parallel.sharded import FederatedLogp

        if torch.is_tensor(self.ys):
            ys = self.ys
        else:
            ys = torch.as_tensor(np.asarray(self.ys), device=resolve_device(self.device))
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

        self.fed = FederatedLogp(per_shard_logp, (self.ys, self.masks))

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
