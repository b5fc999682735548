"""Hand-written Hopper kernels and their plain PyTorch versions."""

from .linreg_kernel import linreg_logp_grad_fn, linreg_reductions, linreg_reductions_ref
