"""pytensor-federated-torch: the PyTorch/CUDA port of pytensor-federated-tpu.

The flagship path of the JAX package, rewritten in PyTorch: heterogeneous
shards packed with a mask, the federated linear-regression posterior,
its fused logp+grad reduction as a hand-written Hopper kernel, and NUTS
with warmup adaptation and convergence diagnostics.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  This package imports
neither JAX nor the JAX package.
"""

from . import samplers
from .convert import params_from_jax, sharded_data_from_jax
from .models.linear import FederatedLinearRegression, generate_node_data, linreg_suffstats
from .ops.linreg_kernel import linreg_logp_grad_fn, linreg_reductions, linreg_reductions_ref
from .parallel.packing import ShardedData, pack_shards
from .parallel.sharded import FederatedLogp
from .utils import LOG_2PI, resolve_device

__all__ = [
    "LOG_2PI",
    "FederatedLinearRegression",
    "FederatedLogp",
    "ShardedData",
    "generate_node_data",
    "linreg_logp_grad_fn",
    "linreg_reductions",
    "linreg_reductions_ref",
    "linreg_suffstats",
    "pack_shards",
    "params_from_jax",
    "resolve_device",
    "samplers",
    "sharded_data_from_jax",
]
