"""pytensor-federated-torch: the PyTorch/CUDA port of pytensor-federated-tpu.

The flagship path of the JAX package, rewritten in PyTorch: heterogeneous
shards packed with a mask, the federated linear-regression posterior,
its fused logp+grad reduction as a hand-written Hopper kernel, and NUTS
with warmup adaptation and convergence diagnostics.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

The federation wire: a node serves its logp+grad over npwire frames on
TCP (:mod:`.service`), byte for byte the JAX package's frames, and a
driver fans out to its nodes with :class:`ParallelLogpGrad`.  This
package imports neither JAX, nor the JAX package, nor gRPC.
"""

from . import samplers
from .convert import params_from_jax, sharded_data_from_jax
from .models.linear import (
    FederatedLinearRegression,
    generate_node_data,
    linreg_prior_logp,
    linreg_suffstats,
)
from .ops import (
    ArraysToArraysOp,
    LogpGradOp,
    LogpOp,
    ParallelLogpGrad,
    blackbox_logp_grad,
    parallel_host_call,
)
from .ops.linreg_kernel import linreg_logp_grad_fn, linreg_reductions, linreg_reductions_ref
from .parallel.packing import ShardedData, pack_shards
from .parallel.sharded import FederatedLogp
from .signatures import ShapeDtypeStruct, spec_of
from .utils import LOG_2PI, resolve_device
from .wrappers import logp_grad_from_logp, wrap_logp_fn, wrap_logp_grad_fn

__all__ = [
    "LOG_2PI",
    "ArraysToArraysOp",
    "FederatedLinearRegression",
    "FederatedLogp",
    "LogpGradOp",
    "LogpOp",
    "ParallelLogpGrad",
    "ShapeDtypeStruct",
    "ShardedData",
    "blackbox_logp_grad",
    "generate_node_data",
    "linreg_logp_grad_fn",
    "linreg_prior_logp",
    "linreg_reductions",
    "linreg_reductions_ref",
    "linreg_suffstats",
    "logp_grad_from_logp",
    "pack_shards",
    "parallel_host_call",
    "params_from_jax",
    "resolve_device",
    "samplers",
    "sharded_data_from_jax",
    "spec_of",
    "wrap_logp_fn",
    "wrap_logp_grad_fn",
]
