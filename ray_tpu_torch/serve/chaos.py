"""Port of ``ray_tpu/serve/chaos.py``: seeded fault schedules for the
serving stack, and the injector of the cross-process fleet campaign
(``tools/torch_chaos_serve.py --fleet``).

Schedule kinds of the in-process pool campaign (``KINDS``; ``make_schedule``
plans at least one of each): ``kill`` (whole-replica death),
``hang`` (a scheduler wedged inside a round, which only the watchdog's
progress deadline catches), ``slow`` (a bounded delay the watchdog must
NOT fire on), ``readback`` (a per-rider readback fault the engine
contains), ``stockout`` (the capacity provider denies requests for a
window) and ``kill_during_drain`` (a replica killed while a scale-down
drain is in flight on it).

Events are keyed to campaign wall time; the SCHEDULE (order, kinds,
windows) is deterministic from the seed and equals the reference's for
the same seed, which is what a campaign's artifact stamps.

The in-process campaign's injector (``ChaosInjector``), its stockout
provider (``StockoutCapacityProvider``) and ``release_all_hangs`` wait
for the fleet's fourth slice (ROADMAP.md, queue 1, item 9): each raises
``NotImplementedError`` naming it.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

KINDS = ("kill", "hang", "slow", "readback", "stockout",
         "kill_during_drain")

# Cross-process campaign (tools/torch_chaos_serve.py --fleet): replicas are
# real OS processes behind the fleet control plane (serve/fleet/).
#
# ==================   =================================================
# ``kill_agent``       SIGKILL one replica-agent PROCESS — the router
#                      must suspect, get the death directory-confirmed
#                      (lease expiry), and resubmit token-identically
# ``partition``        one agent's network drops both ways (inbound
#                      gate + outbound renew skip) — it must SELF-FENCE
#                      when its lease lapses so it can never
#                      double-serve a request the router resubmitted
# ``directory_restart``  SIGKILL the current primary and restart it
#                      on the same port + data dir — membership
#                      recovers from the WAL/snapshot (not from agent
#                      re-advertisement); clients must not notice
# ``primary_kill``     SIGKILL the primary PERMANENTLY — the hot
#                      standby must promote (epoch bump folded into
#                      the fence counter so no token regresses) and a
#                      post-failover canary must complete
#                      token-identically through the promoted
#                      directory
# ``torn_wal_restart``  SIGKILL the current primary, append a TORN
#                      half-record to its WAL (the crash-mid-write
#                      case), restart — the tail must be detected and
#                      truncated, never replayed, and membership must
#                      still recover
# ``autoscale_churn``  a FleetCapacityProvider spawns a real agent
#                      process mid-campaign (spawn -> register ->
#                      warm), the router harvests it, then drains +
#                      retires it while load continues
# ==================   =================================================
FLEET_KINDS = ("kill_agent", "partition", "directory_restart",
               "primary_kill", "torn_wal_restart", "autoscale_churn")


@dataclasses.dataclass
class ChaosEvent:
    """One planned fault. Fires when the campaign clock reaches
    ``at_s`` (seconds since ``ChaosInjector.start``)."""
    kind: str
    at_s: float
    duration_s: float = 0.5        # slow: delay; stockout: window
    fired: bool = False
    fired_at_s: Optional[float] = None
    target_idx: Optional[int] = None   # replica hit (filled at fire)

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "at_s": round(self.at_s, 4),
                "duration_s": self.duration_s, "fired": self.fired,
                "fired_at_s": (round(self.fired_at_s, 4)
                               if self.fired_at_s is not None
                               else None),
                "target_idx": self.target_idx}


def make_schedule(seed: int, duration_s: float, kinds=KINDS,
                  extra: int = 0, slow_s: float = 0.2,
                  stockout_s: float = 0.5) -> List[ChaosEvent]:
    """Deterministic schedule: >= 1 event of every kind in ``kinds``
    plus ``extra`` more, spread over (0.1, 0.8) * ``duration_s`` so
    nothing fires before the load warms up or too late to observe
    recovery before the campaign ends. Same seed => identical
    schedule."""
    n = len(kinds) + extra
    lo, hi = 0.1 * duration_s, 0.8 * duration_s
    span = (hi - lo) / n
    if span <= 0:
        raise ValueError(
            f"duration_s={duration_s} too small for {n} events")
    rng = random.Random(seed)
    ordered = list(kinds) + [rng.choice(list(kinds))
                             for _ in range(extra)]
    rng.shuffle(ordered)
    events = []
    for i, kind in enumerate(ordered):
        at = lo + i * span + rng.random() * span * 0.5
        dur = slow_s if kind == "slow" else stockout_s
        events.append(ChaosEvent(kind=kind, at_s=at, duration_s=dur))
    return events


def make_fleet_schedule(seed: int, duration_s: float,
                        kinds=FLEET_KINDS, extra: int = 0,
                        partition_s: float = 1.0
                        ) -> List[ChaosEvent]:
    """Deterministic cross-process schedule: same contract as
    ``make_schedule`` (>= 1 of each kind, seeded order and timing)
    with ``partition_s`` as the partition window."""
    base = make_schedule(seed, duration_s, kinds=kinds, extra=extra)
    for ev in base:
        if ev.kind == "partition":
            ev.duration_s = partition_s
    return base


class FleetChaosInjector:
    """Watcher thread firing a fleet schedule through harness-owned
    fault operations. The harness owns the OS processes, so injection
    is delegated: ``ops[kind](event, rng) -> target-or-None`` performs
    the fault and returns a target label (recorded in the log) or
    None when it can't fire yet (the event retries next tick, same as
    ``ChaosInjector``)."""

    def __init__(self, schedule: List[ChaosEvent],
                 ops: Dict[str, Callable[[ChaosEvent, random.Random],
                                         Optional[str]]], *,
                 seed: int = 0, poll_s: float = 0.02,
                 time_fn: Callable[[], float] = time.monotonic):
        self.schedule = sorted(schedule, key=lambda e: e.at_s)
        self.ops = ops
        self.poll_s = poll_s
        self._time = time_fn
        self._rng = random.Random(seed)
        self.log: List[Dict[str, Any]] = []
        self._t0: Optional[float] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-chaos",
                                        daemon=True)

    def start(self) -> "FleetChaosInjector":
        self._t0 = self._time()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def done(self) -> bool:
        return all(e.fired for e in self.schedule)

    def injected_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.schedule:
            if e.fired:
                out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def _run(self) -> None:
        while not self._stop.is_set():
            elapsed = self._time() - self._t0
            for ev in self.schedule:
                if ev.fired or elapsed < ev.at_s:
                    continue
                op = self.ops.get(ev.kind)
                try:
                    target = op(ev, self._rng) if op else None
                except Exception as e:  # noqa: BLE001 - keep firing
                    logger.warning("fleet chaos %s failed: %s",
                                   ev.kind, e)
                    target = None
                if target is not None:
                    ev.fired = True
                    ev.fired_at_s = elapsed
                    d = ev.as_dict()
                    d["target"] = target
                    self.log.append(d)
                break
            if self.done():
                return
            time.sleep(self.poll_s)


_SLICE_4 = ("waits for the fleet's fourth slice, the in-process pool "
            "campaign (ROADMAP.md, queue 1, item 9)")


class StockoutCapacityProvider:
    """The in-process campaign's capacity provider with a stockout
    window (the reference's ``serve/chaos.py``); not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"StockoutCapacityProvider {_SLICE_4}")


class ChaosInjector:
    """The in-process campaign's injector against a live engine pool
    (the reference's ``serve/chaos.py``); not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ChaosInjector {_SLICE_4}")


def release_all_hangs(pool) -> int:
    """Release every releasable hang of a pool's injectors (the
    reference's ``serve/chaos.py``); not ported yet."""
    raise NotImplementedError(f"release_all_hangs {_SLICE_4}")
