"""Own copy of the pure step planner of ``ray_tpu/serve/scheduler.py``
(``SlotView``, ``PrefillGrant``, ``SpecGrant``, ``StepPlan``,
``plan_step``), with its speculative-decoding lane, stale-frontier
cap, KV-pull phase, priority lanes, replica roles and named scheduler
profiles (``SCHEDULER_PROFILES``, ``scheduler_profile``).

One scheduling round of the continuous-batching engine
(serve/engine.py) is planned here, device-free: given a host-side
snapshot of the slots, decide (a) which mid-prefill slots advance and
by how many prompt tokens, under a shared per-round token budget
(``prefill_budget``, the ``prefill_chunk`` knob), and (b) how many
decode steps to dispatch in the SAME round, or which slots ride one
batched speculative verify instead. The engine dispatches the prefill
chunk first and the decode chunk right behind it, so the device
interleaves ``P D P D ...`` and in-flight decode never stalls for a
whole prompt.

Policy, in order:

- Prefill grants: mid-prefill slots in lane-then-admission order
  (online slots first, FIFO within each lane, ``SlotView.batch``) each
  receive ``min(prompt_remaining, budget_left)`` tokens until the
  round's token budget or the prefill batch width runs out, so a deep
  batch backlog never takes the budget an online prompt needs. Decode
  is lane-blind: a seeded batch slot rides every dispatch. A PULLING
  slot (``SlotView.pulling``: its prefix KV is crossing the wire from
  a peer, serve/kv_migration.py) gets no grant and, unseeded, rides no
  decode.
- Spec lane (``spec_enabled``, serve/spec_decode.py): when any seeded
  slot carries draft tokens this round, ONE batched verify replaces the
  decode chunk — every seeded slot rides it (a slot with zero drafts
  is a plain one-token row). Drafts are clamped so a verify never
  emits past a slot's remaining budget (``owed - 1``: the bonus token
  is guaranteed) nor past ``max_run_ahead - 1``. The prefill lane is
  planned first either way.
- Decode steps: if any seeded slot exists, decode rides every round.
  While admission work is pending (a free slot, an unseeded slot, a
  prefill grant this round) the cadence stays at ``decode_chunk`` so
  new arrivals join promptly; with a full, fully-seeded batch the plan
  runs ahead to the next completion event (min owed over riders) — but
  not in spec mode, where running ahead would decode past every future
  proposal window. With an eos the run-ahead is bounded — tokens past
  an unpredicted eos are wasted — and under the engine's OVERLAPPED
  loop, where the views may trail the device (``SlotView.stale``), any
  stale rider caps it at one ``decode_chunk``: the most a late-revealed
  eos ever discards per slot.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# The planner may import nothing beyond this list — never torch, numpy
# or anything that could read a device count — so one StepPlan drives
# any engine identically (tests/test_torch_guard.py checks it).
ALLOWED_IMPORTS = frozenset({"__future__", "dataclasses", "typing"})

# Priority lanes: ONLINE is the latency-critical default; BATCH marks
# preemptible offline work that admits behind every waiting online
# request and is the first preemption victim.
LANE_ONLINE = "online"
LANE_BATCH = "batch"

# Replica roles for prefill/decode disaggregation. The role changes
# nothing in ``plan_step`` itself: it selects the knob clamps of
# ``role_plan_caps``, which the engine applies to what it passes in.
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_UNIFIED = "unified"
REPLICA_ROLES = frozenset({ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED})


def role_plan_caps(role, *, page_size, decode_chunk, prefill_budget,
                   max_run_ahead):
    """Role-adjusted planner knobs, pure data in and out.

    - ``prefill``: run-ahead clamped to one decode chunk, so a prefill
      replica never commits long decode dispatches ahead of the next
      waiting prompt.
    - ``decode``: the per-round prefill budget shrinks to one page plus
      one token, enough for a handoff's residual tail, and enough to
      crawl through a plain prefill when a fallback lands here.
    - ``unified``: the knobs pass through.

    An unknown role raises: a mistyped role planning as unified would
    erase the split it was meant to configure."""
    if role not in REPLICA_ROLES:
        raise ValueError(
            f"unknown replica role {role!r}; expected one of "
            f"{sorted(REPLICA_ROLES)}")
    caps = {"prefill_budget": prefill_budget,
            "max_run_ahead": max_run_ahead}
    if role == ROLE_PREFILL:
        caps["max_run_ahead"] = max(1, min(max_run_ahead, decode_chunk))
    elif role == ROLE_DECODE:
        caps["prefill_budget"] = max(1, min(prefill_budget,
                                            page_size + 1))
    return caps


# Named knob presets for the two serving regimes. Pure data (the
# import guard above applies): the engine/deployment layer maps these
# onto its constructor knobs (serve/batch_tier.py
# ``engine_kwargs_for_profile``); the planner itself reads nothing here.
#
# - ``latency``: the defaults the online path has always run —
#   short decode cadence, bounded admission queue, moderate prefill
#   chunks so TTFT stays flat under interleave.
# - ``throughput``: offline batch inference with no TTFT SLO — deep
#   (unbounded) admission queue, large prefill chunks so prompt
#   processing amortizes dispatch overhead, longer decode run-ahead.
#   ``max_queued=None`` is deliberate: the batch driver bounds its own
#   in-flight window (serve/batch_tier.py), so the engine queue depth
#   is the driver's concurrency knob, not a shed boundary.
SCHEDULER_PROFILES = {
    "latency": {
        "decode_chunk": 4,
        "prefill_chunk": 256,
        "max_run_ahead": 256,
        "max_queued": 2,
    },
    "throughput": {
        "decode_chunk": 16,
        "prefill_chunk": 512,
        "max_run_ahead": 512,
        "max_queued": None,
    },
}


def scheduler_profile(name):
    """Knob preset for ``name`` ('latency' | 'throughput'): a fresh
    dict the caller may mutate. Unknown names raise — a silently
    defaulted profile would hide a typo'd deployment config."""
    try:
        return dict(SCHEDULER_PROFILES[name])
    except KeyError:
        raise ValueError(
            f"unknown scheduler profile {name!r}; expected one of "
            f"{sorted(SCHEDULER_PROFILES)}") from None


@dataclasses.dataclass(frozen=True)
class SlotView:
    """Host snapshot of one occupied slot, as the planner sees it."""
    sid: int                 # slot index
    admit_seq: int           # admission order (FIFO fairness)
    prompt_remaining: int    # prompt tokens not yet prefilled
    owed: int                # decode steps still owed (seeded slots)
    seeded: bool             # riding decode dispatches already
    spec_drafts: int = 0     # draft tokens proposed this round
    stale: int = 0           # decode steps dispatched but not yet read
                             # back (overlapped loop; 0 in lockstep)
    pulling: bool = False    # KV-pull phase: the slot holds its place
                             # in admission order but receives NO
                             # prefill grant — its prompt either lands
                             # from the pull or requeues for plain
                             # prefill; unseeded, so the quick cadence
                             # treats it as pending admission work
    batch: bool = False      # BATCH lane: prefill grants after every
                             # online slot's

    @property
    def prefilling(self) -> bool:
        return self.prompt_remaining > 0 and not self.pulling


@dataclasses.dataclass(frozen=True)
class PrefillGrant:
    sid: int
    tokens: int


@dataclasses.dataclass(frozen=True)
class SpecGrant:
    """One slot's ride on this round's batched verify: ``drafts``
    proposed tokens to verify (0: a plain one-token row)."""
    sid: int
    drafts: int


@dataclasses.dataclass(frozen=True)
class StepPlan:
    prefill: Tuple[PrefillGrant, ...]
    decode_steps: int
    spec: Tuple[SpecGrant, ...] = ()

    @property
    def idle(self) -> bool:
        return (not self.prefill and self.decode_steps == 0
                and not self.spec)


def plan_step(slots: Sequence[SlotView], *, total_slots: int,
              prefill_budget: int, decode_chunk: int,
              max_run_ahead: int, prefill_batch: int,
              eos_bounded: bool, spec_enabled: bool = False) -> StepPlan:
    """Plan one scheduling round. Pure: no device, no clock, no
    engine state — everything it needs is in the arguments.

    slots: occupied slots only (free slots are ``total_slots`` minus
    ``len(slots)``). Returns the prefill grants (online lane first,
    FIFO within a lane, budget-packed)
    and either the decode step count (0 = no decode dispatch) or, when
    ``spec_enabled`` and any seeded slot proposed drafts, the spec
    grants of one batched verify (the lanes are exclusive per round).
    """
    if prefill_budget < 1:
        raise ValueError("prefill_budget must be >= 1")
    if decode_chunk < 1:
        raise ValueError("decode_chunk must be >= 1")

    grants = []
    budget = prefill_budget
    # bool sorts False < True: every online slot before every batch one
    for v in sorted((v for v in slots if v.prefilling),
                    key=lambda v: (v.batch, v.admit_seq)):
        if budget <= 0 or len(grants) >= prefill_batch:
            break
        take = min(v.prompt_remaining, budget)
        grants.append(PrefillGrant(v.sid, take))
        budget -= take

    seeded = sorted((v for v in slots if v.seeded),
                    key=lambda v: v.admit_seq)
    if not seeded:
        return StepPlan(tuple(grants), 0)

    if spec_enabled and any(v.spec_drafts > 0 for v in seeded):
        spec = tuple(
            SpecGrant(v.sid, max(0, min(v.spec_drafts, v.owed - 1,
                                        max_run_ahead - 1)))
            for v in seeded)
        return StepPlan(tuple(grants), 0, spec)

    # an eos-mode rider's owed can arrive negative (decoded past its
    # budget while emission trails) and must not drag min(rem) below
    # the 1-step floor
    rem = [max(0, v.owed) for v in seeded]
    quick = (len(slots) < total_slots
             or any(not v.seeded for v in slots)
             or bool(grants))
    steps = (decode_chunk if quick or spec_enabled
             else max(decode_chunk, min(rem)))
    if eos_bounded:
        steps = min(steps, 2 * decode_chunk)
        if any(v.stale > 0 for v in seeded):
            steps = min(steps, decode_chunk)
    return StepPlan(tuple(grants), max(1, min(steps, max_run_ahead)))
