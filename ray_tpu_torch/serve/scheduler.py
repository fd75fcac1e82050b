"""Own copy of the pure step planner of ``ray_tpu/serve/scheduler.py``
(``SlotView``, ``PrefillGrant``, ``StepPlan``, ``plan_step``), without
its speculative-decoding lane, priority lanes, replica roles and
stale-frontier cap, which the port's engine does not have yet
(ROADMAP.md, queue 1).

One scheduling round of the continuous-batching engine
(serve/engine.py) is planned here, device-free: given a host-side
snapshot of the slots, decide (a) which mid-prefill slots advance and
by how many prompt tokens, under a shared per-round token budget
(``prefill_budget``, the ``prefill_chunk`` knob), and (b) how many
decode steps to dispatch in the SAME round. The engine dispatches the
prefill chunk first and the decode chunk right behind it, so the
device interleaves ``P D P D ...`` and in-flight decode never stalls
for a whole prompt.

Policy, in order:

- Prefill grants: mid-prefill slots in admission order (FIFO) each
  receive ``min(prompt_remaining, budget_left)`` tokens until the
  round's token budget or the prefill batch width runs out.
- Decode steps: if any seeded slot exists, decode rides every round.
  While admission work is pending (a free slot, an unseeded slot, a
  prefill grant this round) the cadence stays at ``decode_chunk`` so
  new arrivals join promptly; with a full, fully-seeded batch the plan
  runs ahead to the next completion event (min owed over riders). With
  an eos the run-ahead is bounded — tokens past an unpredicted eos are
  wasted.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# The planner may import nothing beyond this list — never torch, numpy
# or anything that could read a device count — so one StepPlan drives
# any engine identically (tests/test_torch_guard.py checks it).
ALLOWED_IMPORTS = frozenset({"__future__", "dataclasses", "typing"})


@dataclasses.dataclass(frozen=True)
class SlotView:
    """Host snapshot of one occupied slot, as the planner sees it."""
    sid: int                 # slot index
    admit_seq: int           # admission order (FIFO fairness)
    prompt_remaining: int    # prompt tokens not yet prefilled
    owed: int                # decode steps still owed (seeded slots)
    seeded: bool             # riding decode dispatches already

    @property
    def prefilling(self) -> bool:
        return self.prompt_remaining > 0


@dataclasses.dataclass(frozen=True)
class PrefillGrant:
    sid: int
    tokens: int


@dataclasses.dataclass(frozen=True)
class StepPlan:
    prefill: Tuple[PrefillGrant, ...]
    decode_steps: int

    @property
    def idle(self) -> bool:
        return not self.prefill and self.decode_steps == 0


def plan_step(slots: Sequence[SlotView], *, total_slots: int,
              prefill_budget: int, decode_chunk: int,
              max_run_ahead: int, prefill_batch: int,
              eos_bounded: bool) -> StepPlan:
    """Plan one scheduling round. Pure: no device, no clock, no
    engine state — everything it needs is in the arguments.

    slots: occupied slots only (free slots are ``total_slots`` minus
    ``len(slots)``). Returns the prefill grants (FIFO, budget-packed)
    and the decode step count (0 = no decode dispatch).
    """
    if prefill_budget < 1:
        raise ValueError("prefill_budget must be >= 1")
    if decode_chunk < 1:
        raise ValueError("decode_chunk must be >= 1")

    grants = []
    budget = prefill_budget
    for v in sorted((v for v in slots if v.prefilling),
                    key=lambda v: v.admit_seq):
        if budget <= 0 or len(grants) >= prefill_batch:
            break
        take = min(v.prompt_remaining, budget)
        grants.append(PrefillGrant(v.sid, take))
        budget -= take

    seeded = sorted((v for v in slots if v.seeded),
                    key=lambda v: v.admit_seq)
    if not seeded:
        return StepPlan(tuple(grants), 0)

    # an eos-mode rider's owed can arrive negative (decoded past its
    # budget while emission trails) and must not drag min(rem) below
    # the 1-step floor
    rem = [max(0, v.owed) for v in seeded]
    quick = (len(slots) < total_slots
             or any(not v.seeded for v in slots)
             or bool(grants))
    steps = decode_chunk if quick else max(decode_chunk, min(rem))
    if eos_bounded:
        steps = min(steps, 2 * decode_chunk)
    return StepPlan(tuple(grants), max(1, min(steps, max_run_ahead)))
