"""Port of ``ray_tpu/serve/pool_autoscaler.py``: SLO-driven closed-loop
autoscaling of the engine pool (serve/engine_pool.py).

The pool exposes what a controller needs: ``load_report()`` sums queue
depth and shed totals and carries the free slots and the worst
replica's TTFT and inter-token EWMAs; ``add_replica`` grows it;
``scale_down`` retires replicas through the drain path. The autoscaler
closes the loop against a declarative ``SLOPolicy``.

The control loop (``tick()``, normally on a background thread):

1. **Harvest**: every provisioning ticket the provider reports ready
   becomes a live replica (``pool.add_replica()``).
2. **Sense**: read ``pool.load_report()``; the shed RATE comes from the
   monotone shed counter; queue per healthy replica and the free-slot
   fraction from the counts.
3. **Decide** (``_decide``): UP when any pressure signal fires (queue
   per replica over ``queue_high``, any shedding, the TTFT or ITL EWMA
   over its SLO, or scarce free slots with a queue); DOWN only after
   the pool has been completely quiet (no queue, no sheds, ample free
   slots) for ``idle_stable_s`` without a break; else HOLD. The band
   between ``queue_low`` and ``queue_high`` plus the idle window is the
   hysteresis that keeps a noisy load from flapping the pool.
4. **Act**, clamped by the bounds and per-direction cooldowns: UP
   requests capacity from a ``ReplicaCapacityProvider``
   (autoscaler/node_provider.py; the replica joins on a later tick);
   DOWN retires the least-loaded replicas with ``pool.scale_down``,
   the drain path, so in-flight requests finish and nothing is lost.

While capacity is provisioning, ``capacity_eta_s`` is the pool's
``capacity_hint_fn``: an all-shed ``EngineOverloaded`` carries a hint
covering the remaining provisioning time. Replica deaths are the
pool's (auto-restart with backoff); the autoscaler sees only the
capacity dip through the same signals.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    CapacityUnavailable, ImmediateCapacityProvider, ReplicaCapacityProvider)
from ray_tpu_torch.util import metrics

SCALE_UP = "serve_pool_scale_up_total"
SCALE_DOWN = "serve_pool_scale_down_total"
SCALE_HOLD = "serve_pool_scale_hold_total"
TARGET_REPLICAS = "serve_pool_target_replicas"

_METRICS: Optional[dict] = None


def _metrics() -> dict:
    """Lazy metric singletons, re-created if a ``clear_registry()``
    dropped them (the engine's and the pool's pattern)."""
    global _METRICS
    if (_METRICS is None
            or metrics.registry().get(SCALE_UP) is not _METRICS["scale_up"]):
        _METRICS = {
            "scale_up": metrics.Counter(
                SCALE_UP, "Autoscaler scale-up decisions (replicas "
                "requested)"),
            "scale_down": metrics.Counter(
                SCALE_DOWN, "Autoscaler scale-down decisions "
                "(replicas retired)"),
            "scale_hold": metrics.Counter(
                SCALE_HOLD, "Autoscaler ticks that held the current "
                "size (inside the hysteresis band or cooldown)"),
            "target_replicas": metrics.Gauge(
                TARGET_REPLICAS, "Autoscaler's current target "
                "replica count (live + provisioning)"),
        }
    return _METRICS


@dataclasses.dataclass
class SLOPolicy:
    """What the operator wants: bounds, SLOs, stability.

    Scale-up triggers (any one): ``queue_high`` (admission queue per
    healthy replica), ``shed_rate_high`` (sheds per second; 0.0: any
    shedding), ``ttft_slo_s`` (worst replica's TTFT EWMA; None: no
    term), ``itl_slo_s`` (worst replica's inter-token EWMA; None: no
    term; the decode side of a disaggregated pool scales on this and
    free slots, since its TTFT is the handoff), ``free_slot_frac_low``
    (scarce slots WITH a queue).

    Scale-down needs ALL of: no queue, no sheds, free-slot fraction at
    least ``free_slot_frac_high``, for ``idle_stable_s``. TTFT is not
    part of the idle test: the EWMA lags, and an idle pool must not be
    held at size by the memory of a past slow burst.

    ``cooldown_up_s``/``cooldown_down_s`` are per-direction refractory
    periods (down longer: adding capacity is urgent, removing it only
    thrifty).
    """
    min_replicas: int = 1
    max_replicas: int = 4
    queue_high: float = 2.0
    queue_low: float = 0.5
    shed_rate_high: float = 0.0
    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None
    free_slot_frac_low: float = 0.1
    free_slot_frac_high: float = 0.6
    idle_stable_s: float = 5.0
    cooldown_up_s: float = 2.0
    cooldown_down_s: float = 10.0
    scale_up_step: int = 1
    scale_down_step: int = 1
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.queue_low > self.queue_high:
            raise ValueError("queue_low must be <= queue_high "
                             "(hysteresis band)")


class PoolAutoscaler:
    """Drives ``pool`` (an ``EnginePool`` or a ``RolePoolView``) toward
    its SLO under ``policy`` with capacity from ``provider`` (default
    ``ImmediateCapacityProvider``). ``time_fn`` is the clock (tests pass
    a fake one). Construction attaches the scaler (``pool_stats()``
    gains an ``autoscale`` block, all-shed hints cover provisioning
    ETAs) but does not start the loop: call ``run()`` or drive
    ``tick()``."""

    def __init__(self, pool, policy: Optional[SLOPolicy] = None,
                 provider: Optional[ReplicaCapacityProvider] = None,
                 *, time_fn: Callable[[], float] = time.monotonic):
        self.pool = pool
        self.policy = policy or SLOPolicy()
        self.provider = provider or ImmediateCapacityProvider()
        self._time = time_fn
        self._lock = threading.Lock()
        self._pending: List[str] = []        # provisioning tickets
        self._ticket_by_idx: Dict[int, str] = {}
        self._last_up = -math.inf
        self._last_down = -math.inf
        self._idle_since: Optional[float] = None
        self._last_shed_total: Optional[int] = None
        self._last_tick_t: Optional[float] = None
        self.counts: Dict[str, int] = {
            "ticks": 0, "scale_ups": 0, "scale_downs": 0,
            "holds": 0, "denied": 0, "replicas_added": 0,
            "replicas_retired": 0}
        self.last_decision: str = "none"
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # (t, active, target) at every tick
        self.timeline: List[tuple] = []
        pool._autoscaler = self
        pool.capacity_hint_fn = self.capacity_eta_s

    def capacity_eta_s(self) -> float:
        """Remaining ETA until all provisioning in flight lands (0 when
        none is pending)."""
        with self._lock:
            pending = list(self._pending)
        eta = 0.0
        for t in pending:
            try:
                eta = max(eta, self.provider.eta_s(t))
            except Exception:  # noqa: BLE001
                pass
        return eta

    def target_replicas(self) -> int:
        """Live capacity plus capacity on order."""
        with self._lock:
            pending = len(self._pending)
        return self.pool.active_count() + pending

    def signals(self) -> Dict[str, Any]:
        """One sensed sample: the pool aggregate and derived rates. The
        shed rate differences the monotone ``shed_total`` against the
        previous tick (clamped at 0: a retiring replica takes its
        counter with it)."""
        now = self._time()
        rpt = self.pool.load_report()
        healthy = max(1, rpt.get("healthy_replicas", 1))
        total_slots = rpt.get("total_slots", 0)
        free_frac = (rpt.get("free_slots", 0) / total_slots
                     if total_slots else 1.0)
        shed_total = rpt.get("shed_total", 0)
        dt = (now - self._last_tick_t
              if self._last_tick_t is not None else None)
        if self._last_shed_total is None or not dt or dt <= 0:
            shed_rate = 0.0
        else:
            shed_rate = max(0, shed_total - self._last_shed_total) / dt
        self._last_shed_total = shed_total
        self._last_tick_t = now
        return {
            "now": now,
            "stopped": rpt.get("stopped", False),
            "queue_depth": rpt.get("queue_depth", 0),
            "queue_per_replica": rpt.get("queue_depth", 0) / healthy,
            "shed_rate": shed_rate,
            "free_slot_frac": free_frac,
            "ttft_ewma_s": rpt.get("ttft_ewma_s"),
            "itl_ewma_s": rpt.get("itl_ewma_s"),
            "role": rpt.get("role"),
            "healthy_replicas": rpt.get("healthy_replicas", 0),
        }

    def _decide(self, sig: Dict[str, Any]) -> str:
        """The policy alone: one sample -> "up" | "down" | "hold" (the
        bounds and cooldowns are ``tick``'s)."""
        p = self.policy
        ttft = sig.get("ttft_ewma_s")
        ttft_breach = (p.ttft_slo_s is not None and ttft is not None
                       and ttft > p.ttft_slo_s)
        itl = sig.get("itl_ewma_s")
        itl_breach = (p.itl_slo_s is not None and itl is not None
                      and itl > p.itl_slo_s)
        pressure = (sig["queue_per_replica"] > p.queue_high
                    or sig["shed_rate"] > p.shed_rate_high
                    or ttft_breach
                    or itl_breach
                    or (sig["free_slot_frac"] < p.free_slot_frac_low
                        and sig["queue_depth"] > 0))
        if pressure:
            self._idle_since = None
            return "up"
        idle = (sig["queue_depth"] == 0
                and sig["shed_rate"] == 0
                and sig["free_slot_frac"] >= p.free_slot_frac_high
                and sig["queue_per_replica"] <= p.queue_low)
        if not idle:
            # inside the hysteresis band
            self._idle_since = None
            return "hold"
        if self._idle_since is None:
            self._idle_since = sig["now"]
        if sig["now"] - self._idle_since < p.idle_stable_s:
            return "hold"
        return "down"

    def tick(self) -> str:
        """One control iteration (harvest, sense, decide, act). Returns
        what was done: "up" or "down" when capacity moved or was
        ordered, else "hold"."""
        if getattr(self.pool, "_stopped", False):
            return "hold"
        self._harvest_ready()
        sig = self.signals()
        if sig["stopped"]:
            return "hold"
        p = self.policy
        now = sig["now"]
        decision = self._decide(sig)
        target = self.target_replicas()
        acted = "hold"
        if decision == "up":
            if (now - self._last_up >= p.cooldown_up_s
                    and target < p.max_replicas):
                k = min(p.scale_up_step, p.max_replicas - target)
                requested = self._request_capacity(k)
                if requested:
                    self._last_up = now
                    with self._lock:
                        self.counts["scale_ups"] += requested
                    _metrics()["scale_up"].inc(requested)
                    acted = "up"
        elif decision == "down":
            with self._lock:
                pending = len(self._pending)
            # an order in flight: retiring now would race the incoming
            # replica
            if (pending == 0
                    and now - self._last_down >= p.cooldown_down_s
                    and target > p.min_replicas):
                k = min(p.scale_down_step, target - p.min_replicas)
                retired = self.pool.scale_down(
                    k, timeout_s=p.drain_timeout_s)
                if retired:
                    self._last_down = now
                    self._idle_since = None
                    self._release(retired)
                    with self._lock:
                        self.counts["scale_downs"] += len(retired)
                        self.counts["replicas_retired"] += len(retired)
                    _metrics()["scale_down"].inc(len(retired))
                    acted = "down"
        if acted == "hold":
            with self._lock:
                self.counts["holds"] += 1
            _metrics()["scale_hold"].inc()
        with self._lock:
            self.counts["ticks"] += 1
            self.last_decision = acted
        target = self.target_replicas()
        _metrics()["target_replicas"].set(target)
        self.timeline.append((now, self.pool.active_count(), target))
        if acted != "hold":
            # a move goes on the pool's event log (a hold a tick would
            # drown it)
            log = getattr(self.pool, "events", None)
            if log is not None:
                log.append("autoscale", data={
                    "decision": acted, "target": target,
                    "queue_per_replica":
                        round(sig["queue_per_replica"], 4),
                    "shed_rate": round(sig["shed_rate"], 4),
                    "free_slot_frac": round(sig["free_slot_frac"], 4)})
        return acted

    def _harvest_ready(self) -> None:
        """Every provisioned ticket becomes a live replica."""
        with self._lock:
            pending = list(self._pending)
        for ticket in pending:
            try:
                if not self.provider.ready(ticket):
                    continue
            except Exception:  # noqa: BLE001
                continue
            # a pool that tracks which replica a ticket provisioned
            # takes it here; the EnginePool builds anonymous replicas
            add_for = getattr(self.pool, "add_replica_for_ticket", None)
            idx = (add_for(ticket) if add_for is not None
                   else self.pool.add_replica())
            with self._lock:
                self._pending.remove(ticket)
                self._ticket_by_idx[idx] = ticket
                self.counts["replicas_added"] += 1

    def _request_capacity(self, k: int) -> int:
        """Order ``k`` replicas' capacity; returns how many tickets the
        provider granted."""
        granted = 0
        for _ in range(k):
            try:
                ticket = self.provider.request()
            except CapacityUnavailable:
                with self._lock:
                    self.counts["denied"] += 1
                break
            with self._lock:
                self._pending.append(ticket)
            granted += 1
        return granted

    def _release(self, retired_idxs: List[int]) -> None:
        """Give retired replicas' capacity back to the provider (the
        replicas the pool was built with carry no ticket)."""
        for idx in retired_idxs:
            with self._lock:
                ticket = self._ticket_by_idx.pop(idx, None)
            if ticket is not None:
                try:
                    self.provider.release(ticket)
                except Exception:  # noqa: BLE001
                    pass

    def run(self, interval_s: float = 0.5) -> "PoolAutoscaler":
        """Start the control loop in a daemon thread."""
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.is_set():
                    try:
                        self.tick()
                    except Exception:  # noqa: BLE001 - keep looping
                        pass
                    self._stop.wait(interval_s)

            self._thread = threading.Thread(
                target=loop, name="pool-autoscaler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop (the pool keeps its size)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        """The ``autoscale`` block of ``pool_stats()``."""
        with self._lock:
            out = dict(self.counts)
            out["pending"] = len(self._pending)
            out["last_decision"] = self.last_decision
        out["target_replicas"] = self.target_replicas()
        out["min_replicas"] = self.policy.min_replicas
        out["max_replicas"] = self.policy.max_replicas
        return out
