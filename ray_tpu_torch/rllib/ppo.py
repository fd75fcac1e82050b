"""Port of ``ray_tpu/rllib/ppo.py``: ``clipped_surrogate_loss`` only,
the loss piece that external learners (``ray_tpu_torch.rl``) reuse on
token-level batches. The PPO algorithm (rollout-worker actors, the
minibatch learner) rides the task/actor runtime and comes with it
(ROADMAP.md, queue 1, item 13)."""
from __future__ import annotations

import torch


def clipped_surrogate_loss(logp: torch.Tensor, behavior_logp: torch.Tensor,
                           adv: torch.Tensor, clip_eps: float
                           ) -> torch.Tensor:
    """Clipped-PPO policy-gradient loss.

    ``logp`` is the current policy's log-prob of the taken action,
    ``behavior_logp`` the log-prob under the policy that generated the
    data. All three share a leading axis; returns a scalar: the mean
    over every entry, padding included (padding carries ``adv = 0``, so
    it adds zero loss but counts in the denominator, as in the
    reference)."""
    ratio = torch.exp(logp - behavior_logp)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    return -torch.mean(torch.minimum(unclipped, clipped))
