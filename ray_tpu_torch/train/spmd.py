"""Port of ``ray_tpu/train/spmd.py`` on one device: the train state, the
train step and batch placement.

The reference jits the whole step and shards state and batch over a
mesh; here one card (or the CPU, when asked) runs the step eagerly:
forward, ``backward``, the global gradient norm, then the optimizer's
update. The update is IN PLACE — the parameters and the optimizer's
moments are updated where they live, as ``torch.optim`` does (the
reference donates the state to the jitted step instead). Nothing in
the step waits for the device: the returned metrics are device
tensors, read when the caller reads them.

``shard_state``, ``state_shardings`` and ``batch_shardings`` wait for
DDP/FSDP (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._device import resolve_device


def adamw(learning_rate: float, weight_decay: float = 1e-4,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
          ) -> Callable[..., torch.optim.AdamW]:
    """The counterpart of ``optax.adamw(learning_rate, b1, b2, eps,
    eps_root=0, weight_decay)`` with no mask: decoupled weight decay on
    EVERY parameter, biases and norms included. A factory that
    ``TrainState.create`` calls on the parameters; ``torch.optim.AdamW``
    computes optax's update, ``p - lr * (m_hat / (sqrt(v_hat) + eps) +
    weight_decay * p)``."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer holding its moments,
    and the number of steps taken."""
    params: nn.Module
    opt_state: torch.optim.Optimizer
    step: int

    @classmethod
    def create(cls, params: nn.Module, optimizer) -> "TrainState":
        return cls(params=params, opt_state=optimizer(params.parameters()),
                   step=0)


def make_train_step(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                    optimizer):
    """loss_fn(params, batch) -> scalar loss. Returns ``(state, batch)
    -> (state, {"loss", "grad_norm", "step"})``; ``grad_norm`` is the
    global L2 norm of the gradients, taken before the update.
    ``optimizer`` is the factory the state was created with: a state
    whose optimizer it did not make is refused."""

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if not isinstance(state.opt_state, optimizer.func):
            raise TypeError(f"state holds a {type(state.opt_state).__name__}"
                            f", this step updates with "
                            f"{optimizer.func.__name__}")
        state.opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch)
        loss.backward()
        grads = [p.grad for p in state.params.parameters()
                 if p.grad is not None]
        gnorm = torch.nn.utils.get_total_norm(grads)
        state.opt_state.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    return step_fn


def put_batch(batch, device=None):
    """Place a batch (a tensor or array, or a dict/list/tuple of them) on
    ``device``: the card by default, the CPU when asked; raises
    ``NoCudaError`` without a card."""
    device = resolve_device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.asarray(x)).to(device)

    return put(batch)
