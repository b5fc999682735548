"""Federated Gaussian-process regression: exact per shard, and sparse.

Port of the JAX package's ``models/gp.py``.  A full GP likelihood
couples every observation with every other.  The inducing-point
(SGPR/VFE, Titsias 2009) formulation factors that coupling through M
global inducing locations, and the collapsed bound decomposes into
per-shard *moment statistics* that are summed over shards:

    A_i = K_zf^(i) K_fz^(i)      (M x M)
    b_i = K_zf^(i) y^(i)         (M,)
    c_i = Σ_j k(x_j, x_j),  y2_i = Σ_j y_j², n_i = |shard i|

Collapsed VFE bound (what :meth:`FederatedSparseGP.logp` returns):

    L = -1/2 [ n log(2πσ²) + (y'y - β' B^{-1} β)/σ²
               + log|B| - log|K_zz| + trace_term ]
    B = K_zz + A/σ²,  β = b/σ,  trace_term = (c - tr(K_zz^{-1} A))/σ²

:class:`FederatedExactGP` is the exact counterpart: an independent GP
per shard with shared hyperparameters, one batched ``(n, n)`` Cholesky
per evaluation.

Kernels: squared-exponential (default), Matérn 3/2 and 5/2, the
non-stationary ``linear`` trend kernel and composite specs
(``"sqexp+linear"``, ``"sqexp*matern32"``, see :func:`get_kernel`).
Learned ``log_variance``, ``log_lengthscale``, ``log_noise``.  Every
Cholesky is :func:`..utils.cholesky_or_nan`: no host sync, and NaN (as
in JAX) for a covariance that is not positive definite, so a sampler
rejects the proposal instead of crashing — except a posterior draw's of
a concrete covariance of order >= 256, which the blocked
:func:`..linalg.cholesky` factors (:func:`_posterior_chol`).  The
arithmetic runs in the data's dtype (float32 from
:func:`generate_gp_data`, as in JAX).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.mesh import SHARDS_AXIS, Mesh
from ..parallel.packing import ShardedData, pack_shards
from ..parallel.sharded import FederatedLogp, sharded_compute
from ..precision import matmul_precision_ctx, pdot, resolve_policy, wrap_policy
from ..utils import LOG_2PI, cholesky_or_nan, solve_or_nan, value_and_grad

__all__ = [
    "FederatedExactGP",
    "FederatedSparseGP",
    "dense_vfe_logp",
    "generate_gp_data",
    "get_kernel",
    "kernel_components",
    "kernel_hyper_shape",
    "stationary_prior_diag",
]

_JITTER = 1e-4  # float32 Cholesky needs real jitter (relative to variance)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(L Lᵀ)⁻¹ b`` for a lower factor ``l`` and a vector ``b``: two
    triangular solves (``jax.scipy.linalg.cho_solve``).  Not
    ``torch.cholesky_solve``, whose backward synchronizes the host on
    CUDA."""
    half = torch.linalg.solve_triangular(l, b[..., None], upper=False)
    return torch.linalg.solve_triangular(l.mT, half, upper=True)[..., 0]


def _prod_positive(v: torch.Tensor) -> torch.Tensor:
    """Product of the positive entries of ``v`` (one component: the entry
    itself), as ``exp(Σ log v)``: the backward of ``torch.prod`` looks
    for zeros with ``nonzero()``, a host sync on CUDA."""
    if v.shape[-1] == 1:
        return v[..., 0]
    return torch.exp(torch.sum(torch.log(v), dim=-1))


def _jitter_scale(variance):
    """Scalar magnitude for jitter terms: composite kernels carry a
    VECTOR variance (one slot per component).  ``max(sum, prod)`` bounds
    the kernel diagonal of sum and product composites alike; single
    kernels give the variance itself."""
    v = torch.atleast_1d(torch.as_tensor(variance))
    return torch.maximum(torch.sum(v), _prod_positive(v))


#: Posterior covariances at or above this order route their draw
#: Cholesky through the blocked factorization (:func:`..linalg.cholesky`)
#: when the values are concrete.  Below it the dense kernel wins on
#: dispatch overhead; tests shrink it to gate the two paths against each
#: other on the same matrix.
_BLOCKED_CHOL_MIN = 256


def _concrete(cov, vjit) -> bool:
    """Whether ``cov`` (with its jitter ``vjit``) may leave the traced
    world for the blocked factorization: not a ``torch.func`` transform's
    wrapped tensor, not while a ``fed.program`` records its graph or a
    CUDA graph is captured, and carrying no gradient (the blocked path
    leaves autograd, where ``jax.grad`` would have made the value a
    tracer)."""
    from ..fed.lowering import _is_wrapped
    from ..fed.primitives import _recorder

    tensors = [t for t in (cov, vjit) if isinstance(t, torch.Tensor)]
    if any(_is_wrapped(t) for t in tensors) or _recorder() is not None:
        return False
    if cov.is_cuda and torch.cuda.is_current_stream_capturing():
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def _posterior_chol(cov, vjit, policy=None, *, block: int = 128):
    """Jitter-stabilized Cholesky of a posterior covariance.

    A concrete 2-D covariance (:func:`_concrete`) of order >=
    :data:`_BLOCKED_CHOL_MIN` factors through :func:`..linalg.cholesky`
    (the blocked right-looking path, on ``cov``'s device, loud with a
    ``BlockError`` on a covariance that is not positive definite);
    everything else — batched covariances, small matrices, values under
    ``torch.func``, a recording ``fed.program``, a CUDA graph capture or
    a gradient — stays on the dense :func:`..utils.cholesky_or_nan`
    (NaN where it fails).  The two paths are equality-gated against
    each other in tests/test_torch_gp.py.  ``policy`` selects the
    contraction precision."""
    n = cov.shape[-1]
    if cov.dim() == 2 and n >= _BLOCKED_CHOL_MIN and _concrete(cov, vjit):
        from ..linalg import cholesky as _blocked_cholesky

        a = cov.detach() + torch.as_tensor(vjit, dtype=cov.dtype, device=cov.device) * _eye(n, cov)
        return _blocked_cholesky(a, block=block, policy=policy, device=cov.device).to(cov.dtype)
    with matmul_precision_ctx(policy):
        return cholesky_or_nan(cov + vjit * _eye(n, cov))


def _masked_cov(x, mask, variance, lengthscale, noise, kern=None):
    """Masked exact-GP covariance with identity rows on padded slots.

    Real block: K + (noise² + jitter·var) I; padded rows/cols become
    exact e_i rows (diag 1, off-diag 0) so each padded slot contributes
    logN(0|0,1) to a Gaussian quadratic/logdet — removable analytically.
    The one implementation shared by the likelihood and the posterior."""
    n = x.shape[0]
    mm = mask[:, None] * mask[None, :]
    kern = kern or _sqexp
    vjit = _JITTER * _jitter_scale(variance)
    eye = _eye(n, mask)
    k = kern(x, x, variance, lengthscale) * mm
    k = k + (noise**2 + vjit) * eye
    return k + (1.0 - mask) * (1.0 - noise**2 - vjit) * eye


def generate_gp_data(
    n_shards: int = 8,
    *,
    n_obs: int = 128,
    lengthscale: float = 0.4,
    variance: float = 1.0,
    noise: float = 0.1,
    seed: int = 42,
    device: Any = None,
) -> tuple[ShardedData, np.ndarray]:
    """Per-shard (x, y) drawn from one global GP sample path.

    All shards observe the *same* latent function at private input
    locations; returns the packed shards (on ``device``, ``cuda`` unless
    the caller says otherwise) and the dense (x, y) pool as numpy.
    numpy makes the data, so they are byte-identical to the JAX
    package's.
    """
    rng = np.random.default_rng(seed)
    n_total = n_shards * n_obs
    x = np.sort(rng.uniform(-2.0, 2.0, size=n_total)).astype(np.float32)
    d2 = (x[:, None] - x[None, :]) ** 2
    k = variance * np.exp(-0.5 * d2 / lengthscale**2)
    # Eigh-based sampling: robust to the (numerically singular) kernel
    # of many closely spaced points, unlike Cholesky.
    w, q = np.linalg.eigh(k.astype(np.float64))
    f = q @ (np.sqrt(np.clip(w, 0.0, None)) * rng.normal(size=n_total))
    y = (f + noise * rng.normal(size=n_total)).astype(np.float32)
    order = rng.permutation(n_total)
    shards = [(x[order[i::n_shards]], y[order[i::n_shards]]) for i in range(n_shards)]
    packed = pack_shards(shards, device=device)
    return packed, np.stack([x, y])


def _sq_dist(x1, x2, lengthscale, policy=None):
    """Pairwise SQUARED scaled distance — the one ndim dispatch,
    validation and expansion every kernel shares.  ``policy``: float32
    contraction policy (:mod:`..precision`) for the 2-D branch's cross
    term."""
    if x1.ndim != x2.ndim:
        raise ValueError(
            f"kernel inputs must have matching ndim, got {x1.ndim} and "
            f"{x2.ndim} — for ARD both must be (n, d); for scalar "
            "covariates both must be (n,)"
        )
    if x1.ndim == 1:
        ls = torch.as_tensor(lengthscale)
        if ls.ndim != 0:
            raise ValueError(
                "1-D inputs take a scalar lengthscale; a vector "
                "lengthscale (ARD) needs (n, d) inputs"
            )
        return ((x1[:, None] - x2[None, :]) / ls) ** 2
    s1 = x1 / lengthscale  # (n1, d) with (d,) or scalar lengthscale
    s2 = x2 / lengthscale
    sq1 = torch.sum(s1**2, dim=1)
    sq2 = torch.sum(s2**2, dim=1)
    d2 = sq1[:, None] + sq2[None, :] - 2.0 * pdot(s1, s2.T, policy)
    return torch.clamp(d2, min=0.0)


def _sqexp(x1, x2, variance, lengthscale, policy=None):
    """Squared-exponential kernel matrix.  Inputs ``(n,)`` or ``(n, d)``;
    with 2-D inputs a ``(d,)`` lengthscale gives ARD.  The 2-D branch
    uses ``|a-b|² = |a|² + |b|² - 2ab``: one matrix product instead of an
    ``(n1, n2, d)`` broadcast."""
    return variance * torch.exp(-0.5 * _sq_dist(x1, x2, lengthscale, policy))


def _unpack(params):
    return (
        torch.exp(params["log_variance"]),
        torch.exp(params["log_lengthscale"]),
        torch.exp(params["log_noise"]),
    )


def _scaled_dist(x1, x2, lengthscale, policy=None):
    """Pairwise scaled Euclidean distance (the Matérn kernels').
    sqrt'(0) = inf, so the argument is nudged to keep zero-distance
    gradients finite."""
    return torch.sqrt(_sq_dist(x1, x2, lengthscale, policy) + 1e-12)


def _matern32(x1, x2, variance, lengthscale, policy=None):
    """Matérn 3/2: once-differentiable sample paths."""
    r = 3.0**0.5 * _scaled_dist(x1, x2, lengthscale, policy)
    return variance * (1.0 + r) * torch.exp(-r)


def _matern52(x1, x2, variance, lengthscale, policy=None):
    """Matérn 5/2: twice-differentiable sample paths."""
    r = 5.0**0.5 * _scaled_dist(x1, x2, lengthscale, policy)
    return variance * (1.0 + r + r**2 / 3.0) * torch.exp(-r)


def _linear(x1, x2, variance, lengthscale, policy=None):
    """(Non-stationary) linear kernel ``variance * (x1/ls)·(x2/ls)`` — the
    trend component for composite kernels.  Its diagonal varies with x,
    so the sparse family (whose VFE residual assumes ``k(x,x) =
    variance``) rejects it."""
    if x1.ndim == 1:
        ls = torch.as_tensor(lengthscale)
        if ls.ndim != 0:
            raise ValueError(
                "1-D inputs take a scalar lengthscale; a vector "
                "lengthscale (ARD) needs (n, d) inputs"
            )
        s1 = (x1 / ls)[:, None]
        s2 = (x2 / ls)[:, None]
    else:
        s1 = x1 / lengthscale
        s2 = x2 / lengthscale
    return variance * pdot(s1, s2.T, policy)


_KERNELS = {
    "sqexp": _sqexp,
    "matern32": _matern32,
    "matern52": _matern52,
    "linear": _linear,
}


def kernel_components(name: str) -> list:
    """Component names of a (possibly composite) kernel spec: ``"a"``,
    ``"a+b[+c...]"`` (sum) or ``"a*b[*c...]"`` (product); mixing ``+``
    and ``*`` in one spec is rejected."""
    if "+" in name and "*" in name:
        raise ValueError(f"kernel spec {name!r} mixes '+' and '*'; use one combinator")
    parts = name.split("+") if "+" in name else name.split("*")
    for p in parts:
        if p not in _KERNELS:
            raise ValueError(
                f"unknown kernel {p!r} in spec {name!r}; choose from {sorted(_KERNELS)}"
            )
    return parts


def kernel_hyper_shape(name: str) -> tuple:
    """Shape of ``log_variance``/``log_lengthscale`` for this spec:
    ``()`` for a single kernel, ``(C,)`` for a C-component composite."""
    c = len(kernel_components(name))
    return () if c == 1 else (c,)


def stationary_prior_diag(name: str, variance):
    """The constant ``k(x, x)`` of a STATIONARY kernel spec: the single
    variance, the sum of slots (sum composite) or their product (product
    composite).  Raises for specs containing "linear"."""
    parts = kernel_components(name)
    if "linear" in parts:
        raise ValueError(
            f"kernel spec {name!r} contains the non-stationary 'linear' "
            "component: k(x,x) is not constant"
        )
    v = torch.broadcast_to(torch.as_tensor(variance), (len(parts),))
    return torch.sum(v) if ("+" in name or len(parts) == 1) else _prod_positive(v)


def get_kernel(name: str, policy: Optional[str] = None):
    """Kernel by spec — single name or "+"/"*" composite.

    Composite kernels take VECTOR hyperparameters: ``variance`` and
    ``lengthscale`` of shape ``(C,)``, component ``i`` consuming slot
    ``i`` (scalars broadcast to all components).  ``policy`` binds a
    float32 contraction policy into the kernels' cross-term products;
    the returned callable keeps the 4-argument kernel signature.
    """
    parts = kernel_components(name)
    if len(parts) == 1:
        kern = _KERNELS[name]
        return kern if policy is None else functools.partial(kern, policy=policy)

    members = [
        _KERNELS[p] if policy is None else functools.partial(_KERNELS[p], policy=policy)
        for p in parts
    ]
    is_sum = "+" in name
    n = len(members)

    def composite(x1, x2, variance, lengthscale, **kw):
        v = torch.broadcast_to(torch.as_tensor(variance), (n,))
        ls = torch.broadcast_to(torch.as_tensor(lengthscale), (n,))
        out = None
        for i, member in enumerate(members):
            k_i = member(x1, x2, v[i], ls[i], **kw)
            if out is None:
                out = k_i
            elif is_sum:
                out = out + k_i
            else:
                out = out * k_i
        return out

    return composite


def _prior_logp(params):
    """Weak N(0, 3²) priors on the log-hyperparameters (summed, so a
    vector ``log_lengthscale`` reduces to a scalar too)."""
    return sum(
        torch.sum(-0.5 * (params[k] / 3.0) ** 2)
        for k in ("log_variance", "log_lengthscale", "log_noise")
    )


def _init_params(kernel: str, like: torch.Tensor) -> dict:
    shape = kernel_hyper_shape(kernel)
    return {
        "log_variance": torch.zeros(shape, dtype=like.dtype, device=like.device),
        "log_lengthscale": torch.zeros(shape, dtype=like.dtype, device=like.device),
        "log_noise": torch.tensor(-1.0, dtype=like.dtype, device=like.device),
    }


class FederatedSparseGP:
    """Collapsed sparse-GP (VFE) marginal likelihood over federated shards.

    ``data`` is a packed ``((x, y), mask)`` shard tree
    (:func:`..parallel.packing.pack_shards`); ``inducing`` are the M
    global inducing inputs, placed on the data's device in its dtype.
    The per-shard statistic is one ``(M, n_i) @ (n_i, M)`` product per
    shard, and the only cross-shard reduction is a sum of ``M² + M + 3``
    numbers per evaluation, whatever the number of observations.
    """

    def __init__(
        self,
        data: ShardedData,
        inducing: Any,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = SHARDS_AXIS,
        kernel: str = "sqexp",
        f32_policy: Optional[str] = None,
    ):
        # None consults PFTPU_F32_POLICY exactly once, here.
        policy = resolve_policy(f32_policy)
        self.f32_policy = policy
        like = data.data[0]
        self.inducing = torch.as_tensor(inducing, dtype=like.dtype, device=like.device)
        self.m = int(self.inducing.shape[0])
        self.mesh = mesh
        m = self.m
        self.kernel = kernel
        # The VFE trace residual needs a constant prior diagonal — raises
        # here for "linear"-containing specs.
        stationary_prior_diag(kernel, 1.0)
        kern = get_kernel(kernel, policy=policy)

        def per_shard_stats(params, shard):
            """Whitened statistics, float32-stable by construction: with
            ``L = chol(K_zz)`` and ``V = L^{-1} K_zf``, ``a = V V'``,
            ``b = V y``, and the VFE trace residual ``Σ_j (k_jj - q_jj)``
            accumulated pointwise (each summand small and positive)."""
            (x, y), mask = shard
            z = self.inducing.to(x.device)  # a mesh slot's device
            variance, lengthscale, _ = _unpack(params)
            kzz = kern(z, z, variance, lengthscale) + _JITTER * _jitter_scale(variance) * _eye(m, z)
            l_kzz = cholesky_or_nan(kzz)
            # Masked (padding) columns are zeroed, so the products below
            # exclude them without any gather.
            kzf = kern(z, x, variance, lengthscale) * mask[None, :]
            v = torch.linalg.solve_triangular(l_kzz, kzf, upper=False)
            a = pdot(v, v.T, policy)
            b = pdot(v, y * mask, policy)
            q_diag = torch.sum(v**2, dim=0)  # Nyström diag, per point
            kxx = stationary_prior_diag(kernel, variance)
            resid = torch.sum(mask * (kxx - q_diag))
            y2 = torch.sum((y * mask) ** 2)
            n = torch.sum(mask)
            return {"a": a, "b": b, "resid": resid, "y2": y2, "n": n}

        stats_fn = sharded_compute(per_shard_stats, data.tree(), mesh=mesh, axis=axis)
        # Kept for the posterior, which reuses the likelihood's statistics.
        self._stats_fn = stats_fn
        self._kern = kern

        def logp(params):
            stats = stats_fn(params)
            a = torch.sum(stats["a"], dim=0)
            b = torch.sum(stats["b"], dim=0)
            resid = torch.sum(stats["resid"], dim=0)
            y2 = torch.sum(stats["y2"], dim=0)
            n = torch.sum(stats["n"], dim=0)

            _, _, noise = _unpack(params)
            s2 = noise**2
            # Whitened inner matrix: B' = I + a/σ² has eigenvalues >= 1,
            # so its Cholesky and logdet are float32-safe, and
            # log|B| - log|K_zz| = log|B'| exactly.
            bprime = _eye(m, a) + a / s2
            l_b = cholesky_or_nan(bprime)
            # Woodbury quadratic: y'Σ^{-1}y = (y'y - b' B'^{-1} b / σ²)/σ²
            quad = (y2 - pdot(b, _cho_solve(l_b, b), policy) / s2) / s2
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(l_b)))
            trace_term = resid / s2
            return -0.5 * (n * (LOG_2PI + torch.log(s2)) + quad + logdet + trace_term) + _prior_logp(
                params
            )

        # "highest"/"strict": TF32 off around the whole evaluation,
        # Cholesky and triangular-solve internals included.
        self._logp = wrap_policy(logp, policy)
        self._like = like

    _prior_logp = staticmethod(_prior_logp)

    def init_params(self) -> dict:
        """Zeros for the log-variance and log-lengthscale, -1 for the
        log-noise, on the data's device in its dtype."""
        return _init_params(self.kernel, self._like)

    def logp(self, params: Any) -> torch.Tensor:
        return self._logp(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self._logp, params)

    __call__ = logp

    def posterior(self, params: Any, x_star, *, return_cov: bool = False):
        """GLOBAL sparse-GP posterior at ``x_star`` (collapsed SGPR
        predictive): every shard's data informs ONE latent function
        through the shared inducing statistics.

        With ``L = chol(K_zz)``, ``B' = I + a/σ²``, ``L_B = chol(B')``:

            μ* = K_*z L^{-T} B'^{-1} b / σ²
            Σ* = K** − V'V + W'W,  V = L^{-1}K_z*, W = L_B^{-1}V

        Returns ``(mean, var)`` with diagonal variance, or ``(mean,
        cov)`` with the full predictive covariance when
        ``return_cov=True``.
        """
        with matmul_precision_ctx(self.f32_policy):
            variance, lengthscale, noise = _unpack(params)
            s2 = noise**2
            stats = self._stats_fn(params)
            a = torch.sum(stats["a"], dim=0)
            b = torch.sum(stats["b"], dim=0)
            z = self.inducing
            m = self.m
            kzz = self._kern(z, z, variance, lengthscale) + _JITTER * _jitter_scale(
                variance) * _eye(m, z)
            l = cholesky_or_nan(kzz)
            l_b = cholesky_or_nan(_eye(m, a) + a / s2)
            c = _cho_solve(l_b, b)
            beta = torch.linalg.solve_triangular(l.T, c[:, None], upper=True)[:, 0]
            xs = torch.as_tensor(x_star, dtype=z.dtype, device=z.device)
            ks = self._kern(z, xs, variance, lengthscale)  # (M, n_star)
            mean = pdot(ks.T, beta, self.f32_policy) / s2
            v = torch.linalg.solve_triangular(l, ks, upper=False)
            w = torch.linalg.solve_triangular(l_b, v, upper=False)
            if return_cov:
                kss = self._kern(xs, xs, variance, lengthscale)
                cov = kss - pdot(v.T, v, self.f32_policy) + pdot(w.T, w, self.f32_policy)
                return mean, cov
            kss = stationary_prior_diag(self.kernel, variance)
            var = kss - torch.sum(v**2, dim=0) + torch.sum(w**2, dim=0)
            return mean, var

    def posterior_sample(self, params: Any, generator: torch.Generator, x_star, *,
                         num_draws: int = 1) -> torch.Tensor:
        """Coherent joint draws ``(num_draws, n_star)`` from the global
        sparse-GP posterior over the latent function at ``x_star``
        (jitter-stabilized Cholesky of the full predictive covariance)."""
        mean, cov = self.posterior(params, x_star, return_cov=True)
        variance, _, _ = _unpack(params)
        chol = _posterior_chol(cov, _JITTER * _jitter_scale(variance), self.f32_policy)
        eps = torch.randn((num_draws, cov.shape[0]), generator=generator, dtype=mean.dtype,
                          device=mean.device)
        return mean[None, :] + pdot(eps, chol.T, self.f32_policy)


def dense_vfe_logp(params, x, y, inducing, kernel: str = "sqexp"):
    """Single-device dense VFE bound — golden-model ground truth.

    The textbook expression ``N(y | 0, Q + σ²I)`` with ``Q = K_fz
    K_zz^{-1} K_zf`` plus the ``-tr(K - Q)/(2σ²)`` VFE correction, in
    full n x n algebra, in the dtype of ``params``."""
    kern = get_kernel(kernel)
    variance, lengthscale, noise = _unpack(params)
    dtype, dev = noise.dtype, noise.device
    x = torch.as_tensor(x, dtype=dtype, device=dev)
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    z = torch.as_tensor(inducing, dtype=dtype, device=dev)
    n = x.shape[0]
    m = z.shape[0]
    s2 = noise**2
    kzz = kern(z, z, variance, lengthscale) + _JITTER * _jitter_scale(variance) * _eye(m, z)
    kzf = kern(z, x, variance, lengthscale)
    q = kzf.T @ solve_or_nan(kzz, kzf)
    cov = q + s2 * _eye(n, q)
    l = cholesky_or_nan(cov)
    alpha = _cho_solve(l, y)
    marginal = -0.5 * (y @ alpha + 2.0 * torch.sum(torch.log(torch.diagonal(l))) + n * LOG_2PI)
    kxx = stationary_prior_diag(kernel, variance)
    trace_corr = -0.5 * (n * kxx - torch.trace(q)) / s2
    return marginal + trace_corr + _prior_logp(params)


class FederatedExactGP:
    """Exact GP marginal likelihood per shard, shared hyperparameters.

    Multi-site GP regression: each federated shard owns an independent
    GP over its private ``(x, y)`` with the SAME kernel (any
    :func:`get_kernel` spec, ``linear`` included) and hyperparameters.
    Per-shard compute is one ``(n, n)`` Cholesky and a Cholesky solve,
    batched over shards by :class:`..parallel.sharded.FederatedLogp`
    (``model.fed.remat = True`` recomputes them in the backward pass
    instead of holding the covariances and factors).

    Padding: masked rows/columns of the covariance are replaced by
    identity rows and padded targets are 0, so each padded slot
    contributes exactly ``logN(0 | 0, 1) = -0.5 log 2π``, added back
    analytically — the masked evaluation equals the exact marginal
    likelihood of the real points.
    """

    def __init__(
        self,
        data: ShardedData,
        *,
        mesh: Optional[Mesh] = None,
        axis: str = SHARDS_AXIS,
        kernel: str = "sqexp",
        f32_policy: Optional[str] = None,
    ):
        # One env consultation at construction; see FederatedSparseGP.
        policy = resolve_policy(f32_policy)
        self.f32_policy = policy
        self.mesh = mesh
        self.kernel = kernel
        self._kern = get_kernel(kernel, policy=policy)
        kern = self._kern

        def per_shard_logp(params, shard):
            (x, y), mask = shard
            variance, lengthscale, noise = _unpack(params)
            n = x.shape[0]
            k = _masked_cov(x, mask, variance, lengthscale, noise, kern)
            ym = y * mask
            l = cholesky_or_nan(k)
            alpha = _cho_solve(l, ym)
            ll = -0.5 * (
                pdot(ym, alpha, policy)
                + 2.0 * torch.sum(torch.log(torch.diagonal(l)))
                + n * LOG_2PI
            )
            # remove the padded slots' logN(0|0,1) contributions
            return ll + 0.5 * LOG_2PI * torch.sum(1.0 - mask)

        self.fed = FederatedLogp(
            wrap_policy(per_shard_logp, policy), data.tree(), mesh=mesh, axis=axis
        )
        self.data = data

    def logp(self, params: Any) -> torch.Tensor:
        return self.fed.logp(params) + _prior_logp(params)

    def logp_and_grad(self, params: Any):
        return value_and_grad(self.logp, params)

    def init_params(self) -> dict:
        """Zeros for the log-variance and log-lengthscale, -1 for the
        log-noise, on the data's device in its dtype."""
        return _init_params(self.kernel, self.data.data[0])

    def find_map(self, **kwargs):
        from ..samplers import find_map

        return find_map(self.logp, self.init_params(), **kwargs)

    def posterior(self, params: Any, x_star, *, return_cov: bool = False):
        """Per-shard posterior at ``x_star`` (``(n_star,)`` or, for
        ``(n, d)`` inputs, ``(n_star, d)``).  Returns ``(mean, var)``
        each ``(n_shards, n_star)``, or with ``return_cov=True`` ``(mean,
        cov)`` with the full per-shard predictive covariance ``(n_shards,
        n_star, n_star)``."""
        (x, y), mask = self.data.tree()
        variance, lengthscale, noise = _unpack(params)
        xs = torch.as_tensor(x_star, dtype=x.dtype, device=x.device)
        kern, policy = self._kern, self.f32_policy

        # k(x*, x*), valid for every kernel spec (composites and the
        # non-stationary linear included).
        if return_cov:
            kss = kern(xs, xs, variance, lengthscale)
        else:
            kss = torch.func.vmap(
                lambda q: torch.squeeze(kern(q[None], q[None], variance, lengthscale))
            )(xs)

        def one(x_i, y_i, m_i):
            k = _masked_cov(x_i, m_i, variance, lengthscale, noise, kern)
            ks = kern(x_i, xs, variance, lengthscale) * m_i[:, None]
            l = cholesky_or_nan(k)
            alpha = _cho_solve(l, y_i * m_i)
            mean = pdot(ks.T, alpha, policy)
            v = torch.linalg.solve_triangular(l, ks, upper=False)
            if return_cov:
                return mean, kss - pdot(v.T, v, policy)
            return mean, kss - torch.sum(v**2, dim=0)

        return torch.func.vmap(wrap_policy(one, policy))(x, y, mask)

    def posterior_sample(self, params: Any, generator: torch.Generator, x_star, *,
                         num_draws: int = 1) -> torch.Tensor:
        """Coherent joint draws ``(num_draws, n_shards, n_star)`` from each
        shard's latent-function posterior at ``x_star``
        (jitter-stabilized)."""
        mean, cov = self.posterior(params, x_star, return_cov=True)
        variance, _, _ = _unpack(params)
        chol = _posterior_chol(cov, _JITTER * _jitter_scale(variance), self.f32_policy)
        eps = torch.randn((num_draws, *mean.shape), generator=generator, dtype=mean.dtype,
                          device=mean.device)
        return mean[None] + torch.einsum("dsn,smn->dsm", eps, chol)
