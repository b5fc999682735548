"""Hand-written Hopper kernels and their plain PyTorch versions, and the
ops that embed host (remote, blackbox) logp+grad functions into autograd
graphs."""

from .blackbox import blackbox_compute, blackbox_logp_grad
from .fanout import ParallelLogpGrad, fuse, parallel_host_call
from .linreg_kernel import linreg_logp_grad_fn, linreg_reductions, linreg_reductions_ref
from .ops import (
    ArraysToArraysOp,
    AsyncArraysToArraysOp,
    AsyncLogpGradOp,
    AsyncLogpOp,
    LogpGradOp,
    LogpOp,
    from_logp_fn,
)

__all__ = [
    "ArraysToArraysOp",
    "AsyncArraysToArraysOp",
    "AsyncLogpGradOp",
    "AsyncLogpOp",
    "LogpGradOp",
    "LogpOp",
    "ParallelLogpGrad",
    "blackbox_compute",
    "blackbox_logp_grad",
    "from_logp_fn",
    "fuse",
    "linreg_logp_grad_fn",
    "linreg_reductions",
    "parallel_host_call",
    # Port only: the kernel's plain PyTorch version.
    "linreg_reductions_ref",
]
