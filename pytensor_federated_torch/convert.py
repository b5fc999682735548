"""Hand the JAX package's parameters and packed data to this package.

Both take plain numpy arrays (``np.asarray`` of the JAX arrays), so this
package never imports JAX; the tests use them to feed both packages the
same inputs.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .parallel.packing import ShardedData
from .utils import resolve_device, tree_map


def params_from_jax(params_np: Dict[str, np.ndarray], device: Any = None) -> Dict[str, torch.Tensor]:
    """A params dict of numpy arrays as tensors on ``device``, dtype kept."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in params_np.items()}


def array_from_jax(a: np.ndarray, device: Any = None) -> torch.Tensor:
    """One array (e.g. the LV model's observations) as a tensor on ``device``."""
    return torch.as_tensor(np.array(a), device=resolve_device(device))


def sharded_data_from_jax(data: Any, mask: np.ndarray, device: Any = None) -> ShardedData:
    """The JAX package's ``ShardedData`` fields (as numpy trees) as this
    package's ``ShardedData`` on ``device``."""
    dev = resolve_device(device)
    to_tensor = lambda a: array_from_jax(a, dev)
    return ShardedData(data=tree_map(to_tensor, data), mask=to_tensor(mask))
