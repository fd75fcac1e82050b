"""RL library of the port (counterpart: ``ray_tpu/rllib``): the loss
pieces the RLHF learner reuses, ``ppo.clipped_surrogate_loss`` and
``impala.vtrace_returns``. The algorithms themselves ride the
task/actor runtime and come with it (ROADMAP.md, queue 1, item 13)."""
from ray_tpu_torch.rllib.impala import vtrace_returns
from ray_tpu_torch.rllib.ppo import clipped_surrogate_loss

__all__ = ["clipped_surrogate_loss", "vtrace_returns"]
