"""FLOP accounting: per-evaluation counts and model FLOP utilization.

Port of the JAX package's ``flopcount.py``.  There the count is read from
XLA's cost model of the compiled program; PyTorch has no compiled
program to ask, so :func:`flops_per_eval` runs the call once under
``torch.utils.flop_counter.FlopCounterMode``, which sees every aten
operation that reaches the dispatcher, forward and backward alike.

The convention is XLA's: a fused multiply-add is 2 FLOPs, and
transcendentals (exp, log, sqrt) are not counted.  ``FlopCounterMode``
counts matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``) and
convolutions and nothing else; :data:`LINALG_FLOP_FORMULAS` adds the
matrix-vector products and the factorizations and solves that the
Gaussian process and the Kalman filter spend their time in, with these
formulas (``n`` the matrix order, ``k`` the right-hand sides, each per
matrix of a batch):

- ``mv``, ``dot``: ``2 m n`` and ``2 n``;
- ``linalg_cholesky_ex``: ``n³/3`` (``n³/6`` multiply-adds);
- ``linalg_solve_triangular``: ``n² k``;
- ``cholesky_solve``: ``2 n² k`` (two triangular solves);
- ``linalg_lu_factor_ex``: ``2 n³/3``;
- ``linalg_lu_solve``: ``2 n² k``;
- ``_linalg_solve_ex`` (``linalg.solve``): ``2 n³/3 + 2 n² k``.

Elementwise arithmetic is not counted, so a count is a lower bound of
XLA's by the elementwise part (``O(n²)`` against the ``O(n³)`` of a
factorization; for a function made of matrix products alone the two
agree exactly).
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch

__all__ = [
    "LINALG_FLOP_FORMULAS",
    "flops_per_eval",
    "measured_matmul_peak",
    "mfu",
    "peak_flops",
    "CUDA_F32_PEAK_FLOPS",
]

#: Dense float32 rate outside the tensor cores (FLOP/s) by device-name
#: substring, from NVIDIA's data sheets; the PCIe part is checked first.
CUDA_F32_PEAK_FLOPS = {"H100 PCIe": 51e12, "H100": 67e12}

aten = torch.ops.aten


def _batch(shape, core: int) -> int:
    """Product of the leading (batch) dimensions of ``shape``."""
    out = 1
    for s in shape[: len(shape) - core]:
        out *= s
    return out


def _mv_flop(a_shape, x_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


def _cholesky_flop(a_shape, *args, out_shape=None, **kwargs) -> int:
    n = a_shape[-1]
    return _batch(a_shape, 2) * n**3 // 3


def _solve_triangular_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    n = a_shape[-1]
    return max(_batch(a_shape, 2), _batch(b_shape, 2)) * n * n * b_shape[-1]


def _cholesky_solve_flop(b_shape, l_shape, *args, out_shape=None, **kwargs) -> int:
    n = l_shape[-1]
    return max(_batch(l_shape, 2), _batch(b_shape, 2)) * 2 * n * n * b_shape[-1]


def _lu_factor_flop(a_shape, *args, out_shape=None, **kwargs) -> int:
    n = a_shape[-1]
    return _batch(a_shape, 2) * 2 * n**3 // 3


def _lu_solve_flop(lu_shape, pivots_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    n = lu_shape[-1]
    return max(_batch(lu_shape, 2), _batch(b_shape, 2)) * 2 * n * n * b_shape[-1]


def _solve_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    n = a_shape[-1]
    # torch.linalg.solve's rule: b is a vector when it is 1-D or a's
    # batch of vectors.
    vector = len(b_shape) == 1 or tuple(b_shape) == tuple(a_shape[:-1])
    k = 1 if vector else b_shape[-1]
    batch = max(_batch(a_shape, 2), _batch(b_shape, 1 if vector else 2))
    return batch * (2 * n**3 // 3 + 2 * n * n * k)


#: The formulas :func:`flops_per_eval` adds to ``FlopCounterMode``'s own.
LINALG_FLOP_FORMULAS = {
    aten.mv: _mv_flop,
    aten.dot: _dot_flop,
    aten.linalg_cholesky_ex: _cholesky_flop,
    aten.linalg_solve_triangular: _solve_triangular_flop,
    aten.cholesky_solve: _cholesky_solve_flop,
    aten.linalg_lu_factor_ex: _lu_factor_flop,
    aten.linalg_lu_solve: _lu_solve_flop,
    aten._linalg_solve_ex: _solve_flop,
}


def flops_per_eval(fn, *args) -> Optional[float]:
    """FLOPs of one ``fn(*args)`` call: matrix products, convolutions and
    the :data:`LINALG_FLOP_FORMULAS`, forward and backward together when
    ``fn`` computes a gradient.

    The call really runs (on the device of ``args``); count on a warm
    call, and not inside a timed region.  Returns None when the counter
    cannot run rather than guessing.
    """
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False, custom_mapping=LINALG_FLOP_FORMULAS)
        with counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:  # pragma: no cover - runtime-dependent
        return None


_MEASURED_PEAK_CACHE: dict = {}


def measured_matmul_peak(device: Any = None, n: int = 4096) -> float:
    """Practical dense-matmul rate of ``device`` in FLOP/s: the best of a
    few ``n x n`` float32 products, TF32 off on CUDA (true float32, the
    precision the models run in).  Cached per device and ``n``."""
    from .precision import matmul_precision_ctx
    from .utils import resolve_device

    dev = resolve_device(device)
    key = (str(dev), n)
    if key in _MEASURED_PEAK_CACHE:
        return _MEASURED_PEAK_CACHE[key]
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    best = float("inf")
    with matmul_precision_ctx("highest"):
        a @ a  # warm
        sync()
        for _ in range(5):
            t0 = time.perf_counter()
            a @ a
            sync()
            best = min(best, time.perf_counter() - t0)
    peak = 2.0 * n**3 / best
    _MEASURED_PEAK_CACHE[key] = peak
    return peak


def peak_flops(device: Any = None) -> tuple[float, str]:
    """``(peak_flops, basis)`` for ``device``.

    CUDA: the vendor float32 dense peak (outside the tensor cores) of the
    card, looked up by name, with the measured float32 matmul rate
    stated beside it in ``basis``.  A card not in the table, and the CPU:
    the measured rate, labelled as such.
    """
    from .utils import resolve_device

    dev = resolve_device(device)
    measured = measured_matmul_peak(dev)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        for part, peak in CUDA_F32_PEAK_FLOPS.items():
            if part in name:
                return peak, (
                    f"{name} float32 dense peak {peak:.3g} FLOP/s (data sheet, "
                    f"{part}); measured float32 matmul rate {measured:.3g} FLOP/s"
                )
    return measured, f"measured float32 matmul rate on {dev} ({measured:.3g} FLOP/s)"


def mfu(
    flops_per_eval: Optional[float],
    evals_per_sec: float,
    device: Any = None,
) -> dict[str, Any]:
    """Record fields: achieved FLOP/s and model FLOP utilization, with the
    basis string that says what "peak" meant.

    Returns ``{"flops_per_eval", "flops_per_sec", "mfu", "mfu_basis"}``,
    with Nones when the FLOP count is unavailable.
    """
    if flops_per_eval is None:
        return {
            "flops_per_eval": None,
            "flops_per_sec": None,
            "mfu": None,
            "mfu_basis": "flop count unavailable",
        }
    peak, basis = peak_flops(device)
    achieved = flops_per_eval * evals_per_sec
    return {
        "flops_per_eval": round(flops_per_eval),
        "flops_per_sec": round(achieved),
        "mfu": round(achieved / peak, 6),
        "mfu_basis": basis,
    }
