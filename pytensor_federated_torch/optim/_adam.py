"""optax-shaped Adam for a sharded-optimizer node.

The JAX package's node takes any ``optax`` transformation; the port has
no optax and ports Adam only, as :mod:`..ppl.elbo` does.  The arithmetic
is :func:`..ppl.elbo.adam_updates` (optax's update order).  The state is
:class:`AdamState` ``(count, mu, nu)``: its leaves flatten in the order
of ``jax.tree_util.tree_leaves(optax.adam(lr).init(p))`` (``count`` an
int32 scalar, then ``mu``, then ``nu``), so the JAX package's
``_restore_opt_state`` and :func:`..sharded._restore_opt_state` read
each other's shard checkpoints.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..ppl.elbo import adam_updates


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (int32 scalar) and
    the two moment vectors."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


class Adam(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state) -> (updates,
    state)`` over one flat tensor, as ``optax.adam(learning_rate)``."""

    learning_rate: float

    def init(self, params: torch.Tensor) -> AdamState:
        zeros = torch.zeros_like(params)
        return AdamState(torch.zeros((), dtype=torch.int32), zeros, zeros.clone())

    def update(self, grads: torch.Tensor, state: AdamState) -> Tuple[torch.Tensor, AdamState]:
        count = int(state.count) + 1
        (updates,), (mu,), (nu,) = adam_updates(
            [grads], [state.mu], [state.nu], count, self.learning_rate
        )
        return updates, AdamState(torch.tensor(count, dtype=torch.int32), mu, nu)

    @staticmethod
    def leaves(state: AdamState) -> List[np.ndarray]:
        """The state's leaves as numpy arrays, in optax's order."""
        return [t.detach().cpu().numpy() for t in state]

    def restore(self, leaves: List[np.ndarray]) -> AdamState:
        """The state from checkpointed leaves (see :meth:`leaves`)."""
        count, mu, nu = (torch.from_numpy(np.array(leaf)) for leaf in leaves)
        return AdamState(count.to(torch.int32), mu, nu)


def adam(learning_rate: float) -> Adam:
    """``optax.adam(learning_rate)`` with its default b1, b2, eps."""
    return Adam(float(learning_rate))
