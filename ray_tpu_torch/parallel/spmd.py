"""A training step on one device (port of the single-device part of
``ray_tpu/parallel/spmd.py``: ``TrainState`` and ``compile_train_step``).

The reference jits the whole step into one program over a mesh.  Here
nothing is compiled: ``step`` runs the loss, its backward and the optimizer
eagerly on the parameters' device.  The mesh, sharding, ``sharded_init``,
``shard_batch`` and buffer donation wait for the multi-GPU port.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class TrainState(NamedTuple):
    """``step``: updates taken so far; ``params``: the model, an
    ``nn.Module``.  The optimizer's state lives in the optimizer that
    :func:`compile_train_step` was given, which updates ``params`` in place
    (the reference donates its old state, so neither keeps it)."""

    step: int
    params: torch.nn.Module


def adamw(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw`` as ``torch.optim.AdamW``, with optax's defaults.

    Both decay every parameter (no mask here) by ``learning_rate *
    weight_decay`` of its value before the step and add eps outside the
    square root of the bias-corrected second moment, so one update is the
    same arithmetic.  torch's own default weight decay is 1e-2; optax's,
    kept here, is 1e-4.
    """
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay
    )


def global_norm(tensors) -> torch.Tensor:
    """L2 norm of all elements of ``tensors`` together, in f32, as
    ``optax.global_norm`` takes it."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def compile_train_step(
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
    optimizer: torch.optim.Optimizer,
):
    """Build ``step(state, batch) -> (state, {"loss", "grad_norm"})``.

    ``loss_fn(params, batch)`` returns a scalar loss; ``optimizer`` holds
    the parameters of ``params``.  One step takes the gradients of the loss,
    their global norm and one optimizer update.  The metrics are 0-d tensors
    on the device, so a caller reads them without forcing a synchronisation
    until it needs the value.
    """

    def step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch)
        loss.backward()
        grads = [p.grad for p in state.params.parameters() if p.grad is not None]
        gnorm = global_norm(grads)
        optimizer.step()
        return (
            TrainState(state.step + 1, state.params),
            {"loss": loss.detach(), "grad_norm": gnorm},
        )

    return step
