"""Port of ``ray_tpu/rllib/impala.py``: ``vtrace_returns`` only, the
off-policy correction that external learners (``ray_tpu_torch.rl``)
apply to token-level batches. The IMPALA algorithm rides the
task/actor runtime and comes with it (ROADMAP.md, queue 1, item 13)."""
from __future__ import annotations

from typing import Tuple

import torch


def vtrace_returns(values: torch.Tensor, last_value, rewards: torch.Tensor,
                   dones: torch.Tensor, rhos: torch.Tensor, *,
                   gamma: float, rho_bar: float = 1.0, c_bar: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace targets by a reverse recursion over time (Espeholt et
    al. '18, eq. 1): vs = V(s) + sum_k (gamma^k * prod(c) * delta_k).

    Time is the last axis: ``values``, ``rewards``, ``dones`` and
    ``rhos`` are ``[T]`` or ``[B, T]`` (one row per sequence, where the
    reference maps a ``[T]`` call over rows), ``last_value`` a scalar
    or ``[B]``. The reference's reverse ``lax.scan`` is a reverse loop
    over T. Returns ``(vs, pg_adv)``, both detached (the reference's
    are stop-gradiented)."""
    values = values.float()
    discounts = gamma * (1.0 - dones.float())
    last = torch.as_tensor(last_value, dtype=values.dtype,
                           device=values.device)
    last = last.expand(values.shape[:-1]).unsqueeze(-1)
    next_values = torch.cat([values[..., 1:], last], dim=-1)
    clipped_rho = torch.clamp(rhos, max=rho_bar)
    clipped_c = torch.clamp(rhos, max=c_bar)
    deltas = clipped_rho * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(values[..., 0])
    advs = [None] * values.shape[-1]
    for t in range(values.shape[-1] - 1, -1, -1):
        acc = deltas[..., t] + discounts[..., t] * clipped_c[..., t] * acc
        advs[t] = acc
    vs = values + torch.stack(advs, dim=-1)
    next_vs = torch.cat([vs[..., 1:], last], dim=-1)
    pg_adv = clipped_rho * (rewards + discounts * next_vs - values)
    return vs.detach(), pg_adv.detach()
