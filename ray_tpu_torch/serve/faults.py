"""Own copy of ``ray_tpu/serve/faults.py``: deterministic fault injection
and the quiescence invariants of the LLM engine (the port imports
nothing from ``ray_tpu``).

The engine's containment contract (serve/engine.py) is worth something
only if it can be shown: after any mix of cancels, deadlines and
injected faults, only the targeted requests fail, survivors stay
token-identical to greedy decode, and every resource (allocator pages,
prefix-cache refcounts, slots, queues) is back at baseline.

- ``FaultInjector``: a test seam the engine consults at named sites.
  Plans match on (site, round, sid) and fire a bounded number of times,
  so "raise a readback error for slot 1 on round 3" happens exactly so
  (FIFO admission and the round counter make rounds reproducible).
- ``EngineFault``: the attribution envelope. ``culprit_sid`` and
  ``culprit_rid`` name the one request the fault belongs to; ``sids``
  lists every slot of the failed dispatch, so containment can requeue
  the innocent rest under the retry policy.
- ``check_quiesced``: asserts a drained engine is back at baseline;
  ``check_pool_quiesced`` asserts it of every engine of a pool.

Sites the engine consults (no-ops without an injector):

========================  ==================================================
site                      fires
========================  ==================================================
``alloc``                 before every ``BlockAllocator.alloc``: a matching
                          ``exhaust`` plan makes it return None (the dry
                          pool's evict/preempt/wait paths)
``dispatch_prefill``      per prefill row, before the batched call
``dispatch_decode``       per decode rider, before the batched call
``dispatch_spec``         per spec row, before the batched verify
``readback``              per rider, as its tokens are emitted host-side
``step``                  top of every scheduling round (global faults)
========================  ==================================================
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional


class ReplicaKilled(Exception):
    """An injected whole-replica death (a device loss or process kill).
    Raised at the ``step`` site with no sid in scope, it escapes the
    scheduler loop's containment into ``_fail_all``: the engine stops
    and every request fails, as in a real replica crash."""


class EngineFault(Exception):
    """A fault attributable to at most one request.

    ``culprit_sid``/``culprit_rid``: the slot and request the fault
    belongs to (None: nobody in particular). ``sids``: every slot of the
    failed dispatch; containment fails the culprit and requeues the rest
    under the bounded retry policy. ``original`` is the error delivered
    to the failed request's consumer."""

    def __init__(self, original: BaseException,
                 culprit_sid: Optional[int] = None,
                 culprit_rid: Optional[int] = None,
                 sids: Optional[List[int]] = None):
        super().__init__(str(original))
        self.original = original
        self.culprit_sid = culprit_sid
        self.culprit_rid = culprit_rid
        self.sids = list(sids) if sids is not None else (
            [culprit_sid] if culprit_sid is not None else [])


@dataclasses.dataclass
class FaultPlan:
    """One planned fault. ``round``: the engine's scheduling-round
    counter from which it fires (None: any round); ``sid`` restricts
    per-row sites to one slot (None: any row); ``times`` bounds how
    often it fires, so recovery is observable."""
    site: str
    kind: str = "raise"    # "raise" | "exhaust" | "sleep" | "hang"
    exc: Optional[BaseException] = None
    round: Optional[int] = None
    sid: Optional[int] = None
    times: int = 1
    sleep_s: float = 0.0
    fired: int = 0
    # a "hang" plan parks the firing thread on this event until
    # release_all() sets it: unlike "sleep", the wedge can be released
    event: Optional[threading.Event] = None

    def matches(self, site: str, rnd: int, sid: Optional[int]) -> bool:
        if self.fired >= self.times or site != self.site:
            return False
        if self.round is not None and rnd < self.round:
            return False
        if self.sid is not None and sid != self.sid:
            return False
        return True


class FaultInjector:
    """Deterministic fault seam: plan faults, hand it to
    ``LLMEngine(fault_injector=...)``, read ``log`` afterwards
    (``(site, round, sid, kind)`` per firing)."""

    def __init__(self):
        self.plans: List[FaultPlan] = []
        self.log: List[tuple] = []

    def _plan(self, plan: FaultPlan) -> FaultPlan:
        self.plans.append(plan)
        return plan

    def inject(self, site: str, *, exc: Optional[BaseException] = None,
               round: Optional[int] = None, sid: Optional[int] = None,
               times: int = 1) -> FaultPlan:
        """Raise ``exc`` (default ``RuntimeError``) when ``site``
        fires."""
        return self._plan(FaultPlan(
            site=site, kind="raise",
            exc=exc or RuntimeError(f"injected fault at {site}"),
            round=round, sid=sid, times=times))

    def exhaust_alloc(self, *, round: Optional[int] = None,
                      times: int = 1) -> FaultPlan:
        """The next ``times`` allocator calls report a dry pool."""
        return self._plan(FaultPlan(site="alloc", kind="exhaust",
                                    round=round, times=times))

    def kill_replica(self, *, round: Optional[int] = None) -> FaultPlan:
        """A whole-replica death at round ``round`` (None: the next):
        ``ReplicaKilled`` at the global ``step`` site, past per-slot
        containment, takes the engine down through ``_fail_all``."""
        return self._plan(FaultPlan(
            site="step", kind="raise",
            exc=ReplicaKilled("injected replica death"), round=round,
            times=1))

    def slow(self, site: str, sleep_s: float, *,
             round: Optional[int] = None, sid: Optional[int] = None,
             times: int = 1) -> FaultPlan:
        """Sleep ``sleep_s`` at ``site`` (deadline and timeout cases)."""
        return self._plan(FaultPlan(site=site, kind="sleep",
                                    sleep_s=sleep_s, round=round, sid=sid,
                                    times=times))

    def hang(self, site: str, *, round: Optional[int] = None,
             sid: Optional[int] = None, times: int = 1) -> FaultPlan:
        """Wedge the firing thread at ``site`` until ``release_all()``
        (or ``plan.event.set()``). The released thread resumes inside
        ``step()``: the zombie that ``force_kill``'s fence must hold."""
        return self._plan(FaultPlan(site=site, kind="hang", round=round,
                                    sid=sid, times=times,
                                    event=threading.Event()))

    def release_all(self) -> int:
        """Release every hang plan, fired or not; call it on every
        teardown path. Returns how many were newly released."""
        n = 0
        for plan in self.plans:
            if plan.kind == "hang" and not plan.event.is_set():
                plan.event.set()
                n += 1
        return n

    def fire(self, site: str, rnd: int, sid: Optional[int] = None,
             rid: Optional[int] = None) -> None:
        """Called by the engine at per-row and global sites: raises the
        planned exception (wrapped in ``EngineFault`` with the row's
        attribution when a sid is in scope), sleeps, parks, or does
        nothing."""
        for plan in self.plans:
            if plan.kind == "exhaust" or not plan.matches(site, rnd, sid):
                continue
            plan.fired += 1
            # logged before a hang's wait, so a test sees the wedge
            self.log.append((site, rnd, sid, plan.kind))
            if plan.kind == "sleep":
                time.sleep(plan.sleep_s)
                continue
            if plan.kind == "hang":
                plan.event.wait()
                continue
            if sid is not None:
                raise EngineFault(plan.exc, culprit_sid=sid,
                                  culprit_rid=rid)
            raise plan.exc

    def exhausted(self, rnd: int) -> bool:
        """Allocator seam: True to report the pool dry for this call."""
        for plan in self.plans:
            if plan.kind == "exhaust" and plan.matches("alloc", rnd, None):
                plan.fired += 1
                self.log.append(("alloc", rnd, None, "exhaust"))
                return True
        return False


def check_quiesced(eng, expect_cached_pages: Optional[int] = None) -> None:
    """Assert a drained port engine is back at baseline (every handle
    resolved): no occupied slot, empty admission and readback queues,
    allocator occupancy equal to the prefix tree's residency, every
    cached page at refcount 0, no page a weight swap fenced still pinned,
    and the tree's own invariants."""
    live = [i for i, s in enumerate(eng.slots) if s is not None]
    assert not live, f"orphaned slots after drain: {live}"
    assert not eng._wait, \
        f"admission queue not drained: {len(eng._wait)} waiting"
    assert not eng._fetchq and not eng._pending_prefill, \
        "readback queues not drained"
    pc = eng.prefix_cache
    cached = pc.cached_pages if pc is not None else 0
    occ = eng.alloc.occupancy()
    assert occ == cached, (
        f"allocator occupancy {occ} != prefix-cache residency {cached}: "
        f"leaked pages {sorted(eng.alloc.leak_report())[:16]}")
    if expect_cached_pages is not None:
        assert cached == expect_cached_pages, (cached, expect_cached_pages)
    if pc is not None:
        for page in list(pc._nodes):
            r = pc.ref_of(page)
            assert r == 0, f"cached page {page} still has refcount {r}"
        assert not pc._fenced, f"fenced pages still pinned: {pc._fenced}"
        pc.check_invariants()


def check_pool_quiesced(pool) -> None:
    """Pool-wide quiescence: every replica engine — healthy, draining,
    or dead — must individually pass ``check_quiesced``. A dead
    replica's ``_fail_all`` frees slot pages and drops prefix refs,
    so even a crash leaves allocator occupancy == cache residency;
    anything else is a leak the pool masked instead of contained."""
    for eng in pool.engines():
        check_quiesced(eng)
