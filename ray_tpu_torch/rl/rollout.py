"""Port of ``ray_tpu/rl/rollout.py``: rollout generation, prompt ->
completion batches off the serving engine, stamped with the weight
payload that produced them.

The generator is deliberately dumb about training: it submits on
``LANE_BATCH`` (online traffic admits first, preempts rollouts first,
and rollout TTFT never reaches the online SLO stats), collects
per-token sampling logprobs (the learner's behavior policy; the engine
must be built with ``capture_logprobs=True``), and stamps every batch
with the engine's ``weights_id``/``generation`` at submit time so the
loop can detect — and bound — staleness.

Weight sync happens ONLY at round boundaries (``sync_weights``): a
preempt-mode swap mid-round would recompute in-flight completions
under the new payload and silently mix policies inside the captured
logprobs. The loop enforces the boundary; the generator just exposes
the sync. A payload is a state dict of the port's Llama, the form
``LLMEngine.swap_weights`` takes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch


class GeneratorKilled(RuntimeError):
    """Raised by a chaos mid-round hook: the generator died after
    submitting a round but before handing the batch to the learner."""


@dataclasses.dataclass
class RolloutBatch:
    """One round of rollouts, self-describing enough for exactly-once
    accounting: ``batch_id`` is the ledger key, ``weights_id`` /
    ``generation`` name the payload that sampled it, ``logprobs`` are
    the behavior-policy log-probs index-aligned with ``completions``.
    ``rewards`` is stamped later by the loop's scoring stage."""
    batch_id: str
    round_idx: int
    prompts: List[List[int]]
    completions: List[List[int]]
    logprobs: List[List[float]]
    weights_id: str
    generation: int
    rewards: Optional[List[float]] = None
    gen_wall_s: float = 0.0

    def num_samples(self) -> int:
        return len(self.prompts)

    def num_tokens(self) -> int:
        return sum(len(c) for c in self.completions)


class RolloutGenerator:
    """Batched rollout generation over an ``LLMEngine`` or
    ``EnginePool`` (anything with ``submit_rollout_batch``)."""

    def __init__(self, engine, *, max_new_tokens: int = 16):
        self.engine = engine
        self.max_new_tokens = int(max_new_tokens)
        self.rounds_generated = 0

    # ------------------------------------------------------------ stamps

    def weights_stamp(self) -> tuple:
        """(generation, weights_id) currently serving. For a pool this
        is replica 0's stamp — the loop swaps the whole fleet through
        ``sync_weights`` so replicas agree between rounds."""
        eng = self.engine
        if hasattr(eng, "engines"):
            eng = eng.engines()[0]
        return (int(getattr(eng, "weight_generation", 0)),
                str(getattr(eng, "weights_id", "g0")))

    # ------------------------------------------------------------- sync

    def sync_weights(self, params: Dict[str, torch.Tensor], *,
                     weights_id: str, mode: str = "preempt") -> int:
        """Round-boundary weight sync under the monotonic fence: the
        target generation is always current+1 (the fence never cares
        which update count a payload came from, only that it advances).
        ``params`` is a state dict of the port's Llama. Call with no
        rollouts in flight. Returns the new generation."""
        eng = self.engine
        if hasattr(eng, "swap_replica_weights"):
            gen = self.weights_stamp()[0] + 1
            eng.set_weight_source(params, weights_id=weights_id,
                                  generation=gen)
            for i in range(len(eng.engines())):
                eng.swap_replica_weights(i, params,
                                         weights_id=weights_id,
                                         generation=gen, mode=mode)
            return gen
        return eng.swap_weights(
            params, generation=eng.weight_generation + 1,
            weights_id=weights_id, mode=mode)

    # --------------------------------------------------------- generate

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 round_idx: int, batch_id: Optional[str] = None,
                 mid_round_hook: Optional[Callable[[int], Any]] = None
                 ) -> RolloutBatch:
        """Generate one round on ``LANE_BATCH``. The weights stamp is
        read at submit time; the loop guarantees no sync intervenes
        mid-round. ``mid_round_hook`` is the chaos seam — it runs after
        submission, before collection, and may raise to simulate the
        generator dying mid-round (in-flight requests are cancelled so
        the engine does not keep decoding for a dead consumer)."""
        gen, wid = self.weights_stamp()
        bid = batch_id if batch_id is not None else f"round-{round_idx}"
        t0 = time.monotonic()
        handles = self.engine.submit_rollout_batch(
            prompts, max_new_tokens=self.max_new_tokens, trace_id=bid)
        try:
            if mid_round_hook is not None:
                mid_round_hook(round_idx)
            completions = [h.result() for h in handles]
        except BaseException:
            for h in handles:
                try:
                    h.cancel()
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass
            raise
        logprobs = [list(h.logprobs or []) for h in handles]
        self.rounds_generated += 1
        return RolloutBatch(
            batch_id=bid, round_idx=round_idx,
            prompts=[list(p) for p in prompts],
            completions=completions, logprobs=logprobs,
            weights_id=wid, generation=gen,
            gen_wall_s=time.monotonic() - t0)
