"""Modeling-signature client adapters over the generic transport client.

Port of the JAX package's ``service/clients.py``; parity with the
reference's L3 client adapters (reference: common.py:52-161): reshape
the flat arrays reply into the logp / (logp, grads) signatures, sync and
async.  These are what plugs into
:func:`pytensor_federated_torch.blackbox_logp_grad` /
:class:`~pytensor_federated_torch.ParallelLogpGrad` to make a *remote*
federated node differentiable inside a torch graph.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .client import ArraysToArraysServiceClient, HostPort


class LogpServiceClient:
    """Remote node returning a scalar logp (reference: common.py:52-102)."""

    def __init__(self, *args, **kwargs):
        self._client = ArraysToArraysServiceClient(*args, **kwargs)

    @staticmethod
    def _check_reply(outputs) -> np.ndarray:
        """The node's shape contract, single-sourced for the sync and
        batch paths."""
        if len(outputs) != 1:
            raise RuntimeError(
                f"logp node must return exactly one array, got {len(outputs)}"
            )
        logp = outputs[0]
        if np.shape(logp) != ():
            raise RuntimeError(f"logp must be scalar, got shape {np.shape(logp)}")
        return logp

    async def evaluate_async(self, *inputs: np.ndarray) -> np.ndarray:
        return self._check_reply(
            await self._client.evaluate_async(*inputs)
        )

    def evaluate(self, *inputs: np.ndarray) -> np.ndarray:
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(self.evaluate_async(*inputs))

    async def evaluate_many_async(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[np.ndarray]:
        """Pipelined batch of logp evaluations (one scalar each) —
        :meth:`ArraysToArraysServiceClient.evaluate_many_async` with
        this adapter's shape contract applied per reply.  The batch
        shape fits vectorized consumers (SMC particle weights, ensemble
        proposals) that score many points against one node.  ``batch``
        forwards to the transport client: "auto" coalesces the window
        into wire batch frames when the server advertises support."""
        batches = await self._client.evaluate_many_async(
            requests, window=window, batch=batch
        )
        return [self._check_reply(outputs) for outputs in batches]

    def evaluate_many(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[np.ndarray]:
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(
            self.evaluate_many_async(requests, window=window, batch=batch)
        )

    __call__ = evaluate


class LogpGradServiceClient:
    """Remote node returning (logp, grads) (reference: common.py:105-161)."""

    def __init__(self, *args, **kwargs):
        self._client = ArraysToArraysServiceClient(*args, **kwargs)

    @staticmethod
    def _check_reply(outputs, n_inputs) -> Tuple[np.ndarray, List[np.ndarray]]:
        """The node's shape contract, single-sourced for the sync and
        batch paths."""
        if len(outputs) != 1 + n_inputs:
            raise RuntimeError(
                f"logp+grad node must return 1 + {n_inputs} arrays, "
                f"got {len(outputs)}"
            )
        logp, *grads = outputs
        if np.shape(logp) != ():
            raise RuntimeError(f"logp must be scalar, got shape {np.shape(logp)}")
        return logp, grads

    async def evaluate_async(
        self, *inputs: np.ndarray
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        return self._check_reply(
            await self._client.evaluate_async(*inputs), len(inputs)
        )

    def evaluate(self, *inputs):
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(self.evaluate_async(*inputs))

    async def evaluate_many_async(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[Tuple[np.ndarray, List[np.ndarray]]]:
        """Pipelined batch of (logp, grads) evaluations — see
        :meth:`LogpServiceClient.evaluate_many_async`."""
        # Materialize BEFORE forwarding: a one-shot iterable would be
        # consumed by the inner client's encode pass and the zip below
        # would silently drop every result.
        requests = list(requests)
        batches = await self._client.evaluate_many_async(
            requests, window=window, batch=batch
        )
        return [
            self._check_reply(outputs, len(args))
            for args, outputs in zip(requests, batches)
        ]

    def evaluate_many(
        self,
        requests: Sequence[Sequence[np.ndarray]],
        *,
        window: int = 8,
        batch: object = "auto",
    ) -> List[Tuple[np.ndarray, List[np.ndarray]]]:
        from ..utils import get_event_loop

        return get_event_loop().run_until_complete(
            self.evaluate_many_async(requests, window=window, batch=batch)
        )

    __call__ = evaluate
