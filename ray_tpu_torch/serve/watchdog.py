"""Port of ``ray_tpu/serve/watchdog.py``: the progress watchdog of the
engine pool (serve/engine_pool.py), which finds wedged replicas and
escalates a hang to a death.

The pool's recovery (at-most-once resubmit of unstreamed requests)
runs only when a replica RAISES. A replica that wedges silently — a
dispatch that never returns, a stuck copy between host and card —
raises nothing: it stays HEALTHY, keeps drawing prefix-affinity
traffic, and strands its requests until their deadlines fire one by
one. The watchdog infers the wedge from a heartbeat.

Signal: every engine touches a progress heartbeat lock-free at the top
of each scheduling round, when each dispatch completes and at each
readback (``LLMEngine._hb``). ``load_report()`` exposes
``heartbeat_age_s`` and ``has_work`` and answers even while a wedged
scheduler thread holds the engine lock (it tries the lock for 20 ms,
then reads lock-free), so it doubles as the probe: the watchdog judges
PROGRESS (the heartbeat advanced, or the work drained), never
responsiveness.

The ladder, per replica, one step per ``tick()``:

1. HEALTHY, heartbeat older than ``suspect_after_s`` (half the stall
   deadline) WITH work pending -> **SUSPECT** (``pool.mark_suspect``):
   routing, capacity counts and the autoscaler's signals skip it at
   once. An idle engine waits with a stale heartbeat and no work: it
   is never suspected.
2. SUSPECT, the probe shows progress (the heartbeat is younger than
   when suspected, or the work drained) -> **HEALTHY**
   (``pool.clear_suspect``).
3. SUSPECT, still silent at ``stall_deadline_s`` -> **WEDGED**
   (``pool.mark_wedged``): a flight bundle first (lock-free), then the
   engine is force-killed out of band and the pool's death path runs:
   consumers unblock typed, unstreamed requests resubmit to survivors,
   the replica is marked DEAD and rebuilt with its generation + 1. The
   zombie step thread that later wakes is fenced (``_force_killed``):
   it commits no token, dispatches nothing, touches no prefix cache.

``AgentWatchdog`` runs the same ladder on the one engine of a fleet
agent and reports the wedge outward through a callback; the fleet agent
itself waits for ROADMAP.md, queue 1, item 9.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.serve import obs
from ray_tpu_torch.serve.engine_pool import HEALTHY, SUSPECT
from ray_tpu_torch.serve.errors import EngineShutdown


class ReplicaWedged(EngineShutdown):
    """The watchdog declared this request's replica wedged (no
    scheduler progress past ``stall_deadline_s``) and force-killed it.
    An ``EngineShutdown``, so the pool handle treats it as any replica
    death: unstreamed requests resubmit, streamed ones fail typed.

    ``bundle_path`` is the flight-recorder bundle dumped BEFORE the
    kill (None when recording is off or the dump failed)."""

    bundle_path: Optional[str] = None


def _run_loop(tick: Callable[[], Any], interval: float,
              stop: threading.Event, name: str) -> threading.Thread:
    def loop():
        while not stop.is_set():
            try:
                tick()
            except Exception:  # noqa: BLE001 - a bad tick must not end it
                pass
            stop.wait(interval)

    t = threading.Thread(target=loop, name=name, daemon=True)
    t.start()
    return t


def _poll_interval(stall_deadline_s: float,
                   poll_interval_s: Optional[float]) -> float:
    # several probes fit inside the deadline, so detection lands within
    # it
    return (float(poll_interval_s) if poll_interval_s is not None
            else max(0.01, stall_deadline_s / 8))


class PoolWatchdog:
    """Watches an ``EnginePool``'s replicas for scheduler progress and
    escalates silence: SUSPECT after ``suspect_after_s``, WEDGED (force
    kill, then the death path) at ``stall_deadline_s``.

    pool: the pool to watch. Construction attaches the watchdog
        (``pool_stats()`` gains a ``watchdog`` block) but does not start
        the loop: call ``run()`` or drive ``tick()``.
    stall_deadline_s: the silence budget of a replica with work pending.
    suspect_after_s: the quarantine threshold (default: half the
        deadline), in (0, stall_deadline_s].
    poll_interval_s: ``run()``'s tick period (default: an eighth of the
        deadline, at least 10 ms).
    time_fn: the clock of the log's times (tests pass a fake one).
    flight_dir: where a WEDGED escalation dumps its postmortem bundle,
        before the kill (default ``obs.default_flight_dir()``; False:
        no bundle).
    """

    def __init__(self, pool, *, stall_deadline_s: float = 5.0,
                 suspect_after_s: Optional[float] = None,
                 poll_interval_s: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic,
                 flight_dir: Any = None):
        if stall_deadline_s <= 0:
            raise ValueError("stall_deadline_s must be > 0")
        self.pool = pool
        self.stall_deadline_s = float(stall_deadline_s)
        self.suspect_after_s = (float(suspect_after_s)
                                if suspect_after_s is not None
                                else self.stall_deadline_s / 2)
        if not 0 < self.suspect_after_s <= self.stall_deadline_s:
            raise ValueError(
                "suspect_after_s must be in (0, stall_deadline_s]")
        self.poll_interval_s = _poll_interval(self.stall_deadline_s,
                                              poll_interval_s)
        if flight_dir is None:
            flight_dir = obs.default_flight_dir()
        self.flight_dir: Optional[str] = flight_dir or None
        self._time = time_fn
        self._lock = threading.Lock()
        # idx -> (replica, heartbeat age when suspected): the identity
        # pins the suspicion to THIS incarnation; a rebuilt replica at
        # the same index starts clean
        self._suspects: Dict[int, tuple] = {}
        self.counts: Dict[str, int] = {
            "ticks": 0, "suspected": 0, "recovered": 0, "wedged": 0}
        self.log: List[Dict[str, Any]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        pool._watchdog = self

    def tick(self) -> None:
        """One pass over every HEALTHY or SUSPECT replica."""
        with self._lock:
            self.counts["ticks"] += 1
        if getattr(self.pool, "_stopped", False):
            return
        with self.pool._lock:
            reps = [r for r in self.pool._replicas
                    if r.state in (HEALTHY, SUSPECT)]
        live_idxs = set()
        for rep in reps:
            live_idxs.add(rep.idx)
            try:
                rpt = rep.engine.load_report()
            except Exception:  # noqa: BLE001 - the heartbeat judges
                continue
            if rpt.get("stopped"):
                # died idle since the last route: routing's corpse check
                self.pool._note_replica_death(rep)
                self._forget(rep.idx)
                continue
            hb_age = rpt.get("heartbeat_age_s")
            has_work = rpt.get("has_work")
            if hb_age is None or has_work is None:
                continue     # an engine without the heartbeat surface
            if rep.state == HEALTHY:
                if has_work and hb_age >= self.suspect_after_s:
                    if self.pool.mark_suspect(rep):
                        with self._lock:
                            self._suspects[rep.idx] = (rep, hb_age)
                            self.counts["suspected"] += 1
                        self._log("suspect", rep, hb_age)
                continue
            # SUSPECT: progress is a heartbeat younger than when
            # suspected (its age only grows while wedged) or the work
            # drained away
            with self._lock:
                tracked = self._suspects.get(rep.idx)
            if tracked is None or tracked[0] is not rep:
                # suspected by another watchdog, or tracking lost:
                # adopt it now and judge it next tick
                with self._lock:
                    self._suspects[rep.idx] = (rep, hb_age)
                continue
            if not has_work or hb_age < tracked[1]:
                if self.pool.clear_suspect(rep):
                    with self._lock:
                        self.counts["recovered"] += 1
                    self._log("recovered", rep, hb_age)
                self._forget(rep.idx)
                continue
            if hb_age >= self.stall_deadline_s:
                err = ReplicaWedged(
                    f"replica {rep.idx} wedged: no scheduler "
                    f"progress for {hb_age:.2f}s "
                    f"(stall deadline {self.stall_deadline_s}s); "
                    f"force-killed by the watchdog")
                # the flight bundle BEFORE the kill: the engine's event
                # log and counters are intact, and the probe takes no
                # lock the stuck thread holds
                err.bundle_path = self._record_flight(rep, hb_age)
                if self.pool.mark_wedged(rep, err, stalled_for_s=hb_age):
                    with self._lock:
                        self.counts["wedged"] += 1
                    self._log("wedged", rep, hb_age,
                              bundle=err.bundle_path)
                self._forget(rep.idx)
        # drop the tracking of replicas that left HEALTHY/SUSPECT
        # behind the watchdog's back (drained, killed, replaced)
        with self._lock:
            for idx in [i for i in self._suspects if i not in live_idxs]:
                del self._suspects[idx]

    def _forget(self, idx: int) -> None:
        with self._lock:
            self._suspects.pop(idx, None)

    def _record_flight(self, rep, hb_age: float) -> Optional[str]:
        """A postmortem bundle of ``rep`` (best effort: a recorder
        failure never blocks the escalation)."""
        if self.flight_dir is None:
            return None
        try:
            return obs.dump_flight_bundle(
                self.flight_dir, f"wedged-r{rep.idx}",
                engine=rep.engine, pool=self.pool, watchdog=self,
                extra={"replica": rep.idx,
                       "generation": rep.generation,
                       "heartbeat_age_s": round(hb_age, 4),
                       "stall_deadline_s": self.stall_deadline_s})
        except Exception:  # noqa: BLE001
            return None

    def _log(self, event: str, rep, hb_age: float, **extra) -> None:
        entry = {"event": event, "replica": rep.idx,
                 "generation": rep.generation,
                 "heartbeat_age_s": round(hb_age, 4),
                 "t": self._time()}
        entry.update(extra)
        self.log.append(entry)

    def run(self, interval_s: Optional[float] = None) -> "PoolWatchdog":
        """Start the watch loop in a daemon thread."""
        if self._thread is None:
            self._stop.clear()
            self._thread = _run_loop(
                self.tick, float(interval_s) if interval_s is not None
                else self.poll_interval_s, self._stop, "pool-watchdog")
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        """The ``watchdog`` block of ``pool_stats()``."""
        with self._lock:
            out = dict(self.counts)
            out["active_suspects"] = len(self._suspects)
        out["stall_deadline_s"] = self.stall_deadline_s
        out["suspect_after_s"] = self.suspect_after_s
        out["poll_interval_s"] = self.poll_interval_s
        return out


class AgentWatchdog:
    """The ladder of ``PoolWatchdog`` on the ONE engine a fleet agent
    owns (``get_engine()``; None or stopped: nothing to judge). A
    process-separated router cannot probe across the process boundary,
    so the agent watches its own engine: on a wedge it dumps the flight
    bundle, force-kills the engine (out of band, lock-free) and calls
    ``on_wedge(err)``, which reports the wedge outward."""

    def __init__(self, get_engine: Callable[[], Any],
                 on_wedge: Callable[[BaseException], None], *,
                 stall_deadline_s: float = 5.0,
                 poll_interval_s: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic,
                 flight_dir: Any = None):
        if stall_deadline_s <= 0:
            raise ValueError("stall_deadline_s must be > 0")
        self._get_engine = get_engine
        self._on_wedge = on_wedge
        self.stall_deadline_s = float(stall_deadline_s)
        self.poll_interval_s = _poll_interval(self.stall_deadline_s,
                                              poll_interval_s)
        if flight_dir is None:
            flight_dir = obs.default_flight_dir()
        self.flight_dir: Optional[str] = flight_dir or None
        self._time = time_fn
        self.counts: Dict[str, int] = {"ticks": 0, "wedged": 0}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def tick(self) -> Optional[ReplicaWedged]:
        """One probe; returns the escalation when it fires."""
        self.counts["ticks"] += 1
        eng = self._get_engine()
        if eng is None or getattr(eng, "_stopped", False):
            return None
        try:
            rpt = eng.load_report()
        except Exception:  # noqa: BLE001
            return None
        hb_age = rpt.get("heartbeat_age_s")
        if (not rpt.get("has_work") or hb_age is None
                or hb_age < self.stall_deadline_s):
            return None
        err = ReplicaWedged(
            f"agent engine wedged: no scheduler progress for "
            f"{hb_age:.2f}s (stall deadline {self.stall_deadline_s}s); "
            f"force-killed by the agent watchdog")
        if self.flight_dir is not None:
            try:
                err.bundle_path = obs.dump_flight_bundle(
                    self.flight_dir, "wedged-agent", engine=eng,
                    extra={"heartbeat_age_s": round(hb_age, 4),
                           "stall_deadline_s": self.stall_deadline_s})
            except Exception:  # noqa: BLE001
                err.bundle_path = None
        try:
            eng.force_kill(err)
        except Exception:  # noqa: BLE001
            pass
        self.counts["wedged"] += 1
        try:
            self._on_wedge(err)
        except Exception:  # noqa: BLE001
            pass
        return err

    def run(self, interval_s: Optional[float] = None) -> "AgentWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = _run_loop(
                self.tick, float(interval_s) if interval_s is not None
                else self.poll_interval_s, self._stop, "agent-watchdog")
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        out = dict(self.counts)
        out["stall_deadline_s"] = self.stall_deadline_s
        out["poll_interval_s"] = self.poll_interval_s
        return out
