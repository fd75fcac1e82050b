"""RLHF of the port (counterpart: ``ray_tpu/rl``): the serving engine
as an RL generation actor.

The split follows Podracer's sebulba architecture (arXiv 2104.06272):
a generation side (``RolloutGenerator`` over ``LLMEngine`` /
``EnginePool``, submitting on ``LANE_BATCH`` so co-located online
traffic keeps its SLO) and a learner side (``RolloutLearner``, reusing
the rllib loss pieces), glued by ``RLHFLoop`` which overlaps round
N+1's decode with round N's learner step under the engine's monotonic
weight-generation fence and a bounded-staleness knob.
"""
from ray_tpu_torch.rl.rollout import (GeneratorKilled, RolloutBatch,
                                      RolloutGenerator)
from ray_tpu_torch.rl.learner import RolloutLearner
from ray_tpu_torch.rl.loop import (DuplicateRollout, RLHFLoop,
                                   StalenessViolation)

__all__ = [
    "RolloutBatch", "RolloutGenerator", "RolloutLearner", "RLHFLoop",
    "GeneratorKilled", "DuplicateRollout", "StalenessViolation",
]
