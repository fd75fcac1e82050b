"""Port of ``ray_tpu/serve/fleet/telemetry.py``: the fleet's telemetry
plane, which scrapes every process of a fleet, aligns their clocks,
stitches one request's hops and writes cluster bundles.

Every fleet role serves ``rpc_telemetry`` over its transport: a
snapshot of its Prometheus exposition, a cursored window of its event
log, and a monotonic and wall clock sample. The router-side
``TelemetryCollector`` scrapes every live member periodically and
solves the three problems of a timeline spread over processes:

- **Duplication.** Scrapes resume from a cursor kept per member
  incarnation, so a slow poll never ingests an event twice; a member's
  restart (a new pid or generation) starts a new cursor, since its seq
  space restarted with it. Events the member's ring overwrote before a
  scrape reached them are COUNTED (``dropped``), never skipped silently.
- **Unsynchronized clocks.** Each member stamps its events with its own
  ``time.monotonic()``. For a call sent at ``t0`` and answered at
  ``t3`` (the collector's clock) carrying the member's clock ``t1``,
  ``offset = t1 - (t0 + t3)/2`` within ``(t3 - t0)/2``, whatever the
  asymmetry of the two legs. The sample of least round trip wins, and
  drift is measured across samples. Every merged event carries
  ``local_t = t - offset``: the collector's own timebase.
- **Disjoint request timelines.** ``request_phases()`` groups the
  merged stream by ``trace_id`` into per-process spans stamped with
  role, replica id, pid and generation, so one request's router ->
  agent (-> resubmit agent) hops read as one timeline;
  ``chrome_trace()`` exports it with one process row per incarnation.

The **cluster flight recorder**: on a confirmed death (the router's
hook) or a scraped self-fence, wedge, promotion or recovery, the
collector pulls fresh telemetry from every reachable role and writes
one ``cluster-<reason>-<seq>/`` directory: ``manifest.json`` (trigger,
coverage, the clock-offset table, collector health), one
``member-*.json`` per member and ``events.jsonl``, the merged stream on
the collector's timebase. The layout and the manifest are the
reference's, so either package's ``load_cluster_bundle`` reads the
other's bundles.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve import obs

# event kinds that mean "a fault the operator will ask about": the
# collector reacts to these in freshly scraped streams by pulling a
# cluster bundle (confirmed deaths arrive via the router hook instead,
# so they fire even when the dead member can no longer be scraped)
FAULT_ETYPES = ("self_fence", "wedged", "promote", "recover")

_bundle_seq = itertools.count()


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "-", str(s))[:80] or "bundle"


class ClockOffsetEstimator:
    """NTP-style offset between the collector's monotonic clock and
    ONE member incarnation's monotonic clock.

    ``add_sample(t0, t1, t3)`` ingests one RPC round trip; the best
    (minimum-RTT) sample provides ``offset_s`` with
    ``uncertainty_s = RTT/2`` — an asymmetric network can push the
    true offset anywhere inside that bound, never outside it.
    ``drift_s_per_s`` is the observed offset slope between the first
    and latest samples' local midpoints: nonzero means the two clocks
    tick at measurably different rates (or the member restarted —
    which the collector rules out by keying estimators per
    incarnation)."""

    def __init__(self, max_samples: int = 64,
                 min_drift_window_s: float = 1.0):
        self.max_samples = int(max_samples)
        # drift over a tiny baseline is all RTT-asymmetry noise: the
        # slope only means something once the samples span a window
        # much longer than one round trip
        self.min_drift_window_s = float(min_drift_window_s)
        self._samples: List[tuple] = []   # (local_mid, offset, unc)
        self.offset_s: Optional[float] = None
        self.uncertainty_s: Optional[float] = None
        self.rtt_s: Optional[float] = None
        self.n_samples = 0

    def add_sample(self, t0: float, t1: float, t3: float) -> None:
        if t3 < t0:
            raise ValueError(f"receive time {t3} precedes send "
                             f"time {t0}")
        rtt = t3 - t0
        mid = 0.5 * (t0 + t3)
        offset = t1 - mid
        unc = 0.5 * rtt
        self.n_samples += 1
        self._samples.append((mid, offset, unc))
        if len(self._samples) > self.max_samples:
            self._samples.pop(0)
        if self.uncertainty_s is None or unc <= self.uncertainty_s:
            self.offset_s = offset
            self.uncertainty_s = unc
            self.rtt_s = rtt

    @property
    def drift_s_per_s(self) -> Optional[float]:
        if len(self._samples) < 2:
            return None
        m0, o0, _ = self._samples[0]
        m1, o1, _ = self._samples[-1]
        if m1 - m0 < self.min_drift_window_s:
            return None
        return (o1 - o0) / (m1 - m0)

    def to_local(self, remote_t: float) -> Optional[float]:
        """Map a member-clock timestamp onto the collector's
        monotonic timebase."""
        if self.offset_s is None:
            return None
        return remote_t - self.offset_s

    def as_dict(self) -> Dict[str, Any]:
        rnd = (lambda v: None if v is None else round(v, 9))
        return {"offset_s": rnd(self.offset_s),
                "uncertainty_s": rnd(self.uncertainty_s),
                "rtt_s": rnd(self.rtt_s),
                "drift_s_per_s": rnd(self.drift_s_per_s),
                "n_samples": self.n_samples}


class _MemberState:
    """Collector-side state for one member NAME (replica_id /
    "directory" / "router"); the incarnation key (replica_id, pid,
    generation) resets the cursor and estimator on restart."""

    __slots__ = ("name", "role", "key", "estimator", "cursor",
                 "cursors", "estimators",
                 "metrics_text", "last_scrape_mono", "last_payload",
                 "dropped", "events_total", "up", "last_error",
                 "incarnations", "scrapes")

    def __init__(self, name: str, role: str):
        self.name = name
        self.role = role
        self.key: Optional[tuple] = None
        self.estimator = ClockOffsetEstimator()
        self.cursor = 0
        # per-incarnation read state: one NAME (e.g. "directory")
        # can alternate between processes behind a failover client,
        # and each process restarts its event seqs and its monotonic
        # clock at zero — a shared cursor would either skip a fresh
        # incarnation's whole log or re-ingest an old one's
        self.cursors: Dict[tuple, int] = {}
        self.estimators: Dict[tuple, ClockOffsetEstimator] = {}
        self.metrics_text = ""
        self.last_scrape_mono: Optional[float] = None
        self.last_payload: Optional[Dict[str, Any]] = None
        self.dropped = 0
        self.events_total = 0
        self.up = False
        self.last_error: Optional[str] = None
        self.incarnations = 0
        self.scrapes = 0

    def summary(self, now: float) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "role": self.role,
            "up": self.up,
            "pid": self.key[1] if self.key else None,
            "generation": self.key[2] if self.key else None,
            "incarnations": self.incarnations,
            "scrapes": self.scrapes,
            "scrape_age_s": (
                round(now - self.last_scrape_mono, 6)
                if self.last_scrape_mono is not None else None),
            "dropped": self.dropped,
            "events_total": self.events_total,
            "last_error": self.last_error,
        }
        out.update(self.estimator.as_dict())
        return out


def _fleet_metrics():
    """serve_fleet_* collector gauges (same lazy rebuild-after-
    clear_registry pattern as ``obs.phase_metrics``)."""
    from ray_tpu_torch.util import metrics
    global _METRICS
    reg = metrics.registry()
    if _METRICS is not None and all(
            m.name in reg for m in _METRICS.values()):
        return _METRICS
    _METRICS = {
        "up": metrics.Gauge(
            "serve_fleet_member_up",
            "1 while the member answered its latest scrape",
            tag_keys=("member",)),
        "offset": metrics.Gauge(
            "serve_fleet_clock_offset_s",
            "estimated member-clock minus collector-clock offset",
            tag_keys=("member",)),
        "uncertainty": metrics.Gauge(
            "serve_fleet_clock_uncertainty_s",
            "RTT/2 bound on the offset estimate",
            tag_keys=("member",)),
        "scrape_age": metrics.Gauge(
            "serve_fleet_scrape_age_s",
            "seconds since the member's last successful scrape",
            tag_keys=("member",)),
        "dropped": metrics.Gauge(
            "serve_fleet_dropped_events",
            "events the member ring overwrote before the scrape "
            "caught up",
            tag_keys=("member",)),
        "scrape_errors": metrics.Counter(
            "serve_fleet_scrape_errors_total",
            "failed member scrapes", tag_keys=("member",)),
        "members": metrics.Gauge(
            "serve_fleet_members", "members under scrape"),
        "bundles": metrics.Counter(
            "serve_fleet_cluster_bundles_total",
            "cluster flight bundles written"),
    }
    return _METRICS


_METRICS: Optional[Dict[str, Any]] = None


class TelemetryCollector:
    """Router-side scrape loop + merged cluster event stream.

    The collector rides the router's own seams: ``router._snapshot()``
    for membership, ``router._agent(member)`` for cached typed
    clients, and ``router._directory`` for the control plane — it
    adds no second discovery path that could disagree with routing.
    The router's OWN event log is ingested as a member too (offset 0:
    same process), so the merged stream covers every role.
    """

    def __init__(self, router, *, interval_s: float = 0.25,
                 events_per_scrape: int = 512,
                 cluster_dir: Optional[str] = None,
                 offset_bound_s: Optional[float] = None,
                 max_merged_events: int = 65536):
        self._router = router
        self.interval_s = float(interval_s)
        self.events_per_scrape = int(events_per_scrape)
        self.cluster_dir = cluster_dir
        self.offset_bound_s = offset_bound_s
        self.max_merged_events = int(max_merged_events)
        self._lock = threading.Lock()
        # serializes whole scrape passes (periodic loop vs. the
        # router's confirmed-death hook): two concurrent passes
        # would fetch the same window with the same cursor and
        # ingest it twice. RLock: a fault found mid-scrape pulls a
        # bundle, whose own scrape re-enters on the same thread.
        self._scrape_lock = threading.RLock()
        self._members: Dict[str, _MemberState] = {}
        self._merged: List[Dict[str, Any]] = []
        self._merged_dropped = 0
        self._seen_faults: set = set()
        self.bundles: List[Dict[str, Any]] = []
        self.counters = {"scrapes": 0, "scrape_errors": 0,
                         "events_ingested": 0, "bundles": 0}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------ lifecycle

    def attach(self) -> "TelemetryCollector":
        """Hook the router's confirmed-death path: a death pulls a
        cluster bundle, not just the router's local one."""
        self._router.telemetry_collector = self
        return self

    def run(self, interval_s: Optional[float] = None
            ) -> "TelemetryCollector":
        if interval_s is not None:
            self.interval_s = float(interval_s)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-collector",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:
                pass
            self._stop.wait(self.interval_s)

    # --------------------------------------------------------- scrape

    def _state(self, name: str, role: str) -> _MemberState:
        st = self._members.get(name)
        if st is None:
            st = self._members[name] = _MemberState(name, role)
        return st

    def _ingest(self, st: _MemberState,
                payload: Dict[str, Any],
                t0: float, t3: float) -> List[Dict[str, Any]]:
        """Fold one telemetry response into the member state and the
        merged stream; returns the NEW normalized events."""
        key = (payload.get("replica_id"), payload.get("pid"),
               payload.get("generation"))
        clock = payload.get("clock") or {}
        with self._lock:
            if key != st.key:
                # new (or resumed) incarnation: its monotonic base
                # and its event seqs restarted with the process, so
                # cursor and offset estimate are kept PER key — the
                # previous incarnation's describe another process
                st.key = key
                st.incarnations += 1
                st.cursor = st.cursors.get(key, 0)
                est = st.estimators.get(key)
                if est is None:
                    est = st.estimators[key] = ClockOffsetEstimator()
                    while len(st.estimators) > 32:
                        dead = next(iter(st.estimators))
                        st.estimators.pop(dead, None)
                        st.cursors.pop(dead, None)
                st.estimator = est
            st.estimator.add_sample(t0, float(clock["mono"]), t3)
            est = st.estimator
            fresh = [e for e in payload.get("events", [])
                     if e.get("seq", 0) >= st.cursor]
            st.cursor = int(payload.get("cursor", st.cursor))
            st.cursors[key] = st.cursor
            st.dropped += int(payload.get("dropped", 0))
            st.events_total = int(payload.get("events_total", 0))
            st.metrics_text = payload.get("metrics_text", "")
            st.last_payload = payload
            st.last_scrape_mono = time.monotonic()
            st.up = True
            st.last_error = None
            st.scrapes += 1
            out = []
            for e in fresh:
                ev = {
                    "member": st.name,
                    "role": payload.get("role"),
                    "pid": payload.get("pid"),
                    "generation": payload.get("generation"),
                    "seq": e.get("seq"),
                    "t": e.get("t"),
                    "local_t": (round(est.to_local(e["t"]), 9)
                                if isinstance(e.get("t"),
                                              (int, float))
                                else None),
                    "offset_uncertainty_s": round(
                        est.uncertainty_s, 9),
                    "type": e.get("type"),
                    "rid": e.get("rid"),
                    "data": e.get("data"),
                }
                out.append(ev)
            self._merged.extend(out)
            self.counters["events_ingested"] += len(out)
            if len(self._merged) > self.max_merged_events:
                cut = len(self._merged) - self.max_merged_events
                del self._merged[:cut]
                self._merged_dropped += cut
        return out

    def _router_payload(self) -> Dict[str, Any]:
        """The router's local log in the same shape the RPC returns
        (offset trivially 0: same process, same clock)."""
        from ray_tpu_torch.util import metrics
        r = self._router
        window, next_cursor, dropped = obs.event_window(
            r.events.snapshot(), r.events.total,
            self._state("router", "router").cursor,
            self.events_per_scrape)
        return {
            "role": "router", "replica_id": "router",
            "generation": 0, "fence": None, "pid": os.getpid(),
            "clock": {"mono": time.monotonic(),
                      "wall": time.time()},
            "metrics_text": metrics.prometheus_text(),
            "events": obs.as_dicts(window),
            "cursor": next_cursor,
            "events_total": r.events.total,
            "dropped": dropped,
        }

    def _scrape_remote(self, st: _MemberState,
                       fetch) -> List[Dict[str, Any]]:
        """Fetch one member's telemetry with the cursor that belongs
        to whichever incarnation actually answers.

        The first fetch necessarily uses the LAST incarnation's
        cursor; if the payload names a different (replica_id, pid,
        generation) — a restart, or a failover client switching
        endpoints — that window was filtered with a cursor from
        another process's seq space and may have dropped the new
        incarnation's entire log (its seqs restarted at 0). Refetch
        with the answering incarnation's own cursor before ingesting.
        """
        with self._lock:
            cursor = st.cursor
        t0 = time.monotonic()
        payload = fetch(cursor)
        t3 = time.monotonic()
        key = (payload.get("replica_id"), payload.get("pid"),
               payload.get("generation"))
        with self._lock:
            own = cursor if key == st.key \
                else st.cursors.get(key, 0)
        if own != cursor:
            t0 = time.monotonic()
            payload = fetch(own)
            t3 = time.monotonic()
        return self._ingest(st, payload, t0, t3)

    def scrape_once(self) -> Dict[str, Any]:
        """One pass over router + directory + every live agent.
        Returns {member_name: n_new_events_or_None}."""
        with self._scrape_lock:
            return self._scrape_all()

    def _scrape_all(self) -> Dict[str, Any]:
        results: Dict[str, Any] = {}
        fresh: List[Dict[str, Any]] = []

        st = self._state("router", "router")
        payload = self._router_payload()
        # same process, same clock: the "round trip" is a function
        # call, so the sample is exact (offset 0, uncertainty 0)
        t_self = payload["clock"]["mono"]
        fresh += self._ingest(st, payload, t_self, t_self)
        results["router"] = len(fresh)

        # a FailoverDirectoryClient fronts several directory
        # PROCESSES (primary + standbys); scrape each endpoint
        # directly, or the active-endpoint indirection would hide a
        # restarted primary's early events (its "recover") whenever
        # the client happens to be parked on the standby
        dirc = self._router._directory
        endpoints = getattr(dirc, "_clients", None) or [dirc]
        for i, cl in enumerate(endpoints):
            nm = "directory" if len(endpoints) == 1 \
                else f"directory-{i}"
            st = self._state(nm, "directory")
            try:
                new = self._scrape_remote(
                    st, lambda c, _cl=cl: _cl.telemetry(
                        cursor=c, limit=self.events_per_scrape))
                fresh += new
                results[nm] = len(new)
            except Exception as e:   # noqa: BLE001
                self._mark_down(st, e)
                results[nm] = None

        try:
            members = self._router._snapshot()
        except Exception:
            members = {}
        for rid, member in sorted(members.items()):
            st = self._state(rid, "agent")
            try:
                client = self._router._agent(member)
                new = self._scrape_remote(
                    st, lambda c, _cl=client: _cl.telemetry(
                        cursor=c, limit=self.events_per_scrape))
                fresh += new
                results[rid] = len(new)
            except Exception as e:   # noqa: BLE001
                self._mark_down(st, e)
                results[rid] = None

        with self._lock:
            self.counters["scrapes"] += 1
        self._export_gauges()
        self._scan_for_faults(fresh)
        return results

    def _mark_down(self, st: _MemberState, err: BaseException) -> None:
        with self._lock:
            st.up = False
            st.last_error = type(err).__name__
            self.counters["scrape_errors"] += 1
        try:
            _fleet_metrics()["scrape_errors"].inc(
                tags={"member": st.name})
        except Exception:
            pass

    def _export_gauges(self) -> None:
        try:
            m = _fleet_metrics()
            now = time.monotonic()
            with self._lock:
                states = list(self._members.values())
            m["members"].set(len(states))
            for st in states:
                tags = {"member": st.name}
                m["up"].set(1.0 if st.up else 0.0, tags=tags)
                m["dropped"].set(st.dropped, tags=tags)
                if st.last_scrape_mono is not None:
                    m["scrape_age"].set(
                        now - st.last_scrape_mono, tags=tags)
                if st.estimator.offset_s is not None:
                    m["offset"].set(st.estimator.offset_s,
                                    tags=tags)
                    m["uncertainty"].set(
                        st.estimator.uncertainty_s, tags=tags)
        except Exception:
            pass

    # ---------------------------------------------- fault -> bundle

    def _scan_for_faults(self, fresh: List[Dict[str, Any]]) -> None:
        for ev in fresh:
            if ev.get("type") not in FAULT_ETYPES:
                continue
            tag = (ev.get("member"), ev.get("pid"), ev.get("seq"),
                   ev.get("type"))
            with self._lock:
                if tag in self._seen_faults:
                    continue
                self._seen_faults.add(tag)
            self.on_fault(
                f"{ev['type']}-{ev.get('member')}",
                trigger={"kind": ev["type"],
                         "member": ev.get("member"),
                         "role": ev.get("role"),
                         "pid": ev.get("pid"),
                         "generation": ev.get("generation"),
                         "seq": ev.get("seq"),
                         "data": ev.get("data")})

    def on_fault(self, reason: str,
                 trigger: Optional[Dict[str, Any]] = None
                 ) -> Optional[str]:
        """Confirmed death / fence / wedge / failover: pull fresh
        telemetry from every reachable role and write ONE bundle
        that explains the fault cluster-wide."""
        if self.cluster_dir is None:
            return None
        try:
            self.scrape_once()
        except Exception:
            pass
        return self.dump_cluster_bundle(reason, trigger=trigger)

    def dump_cluster_bundle(self, reason: str,
                            trigger: Optional[Dict[str, Any]] = None
                            ) -> Optional[str]:
        """Write ``<cluster_dir>/cluster-<reason>-<seq>/``:
        ``manifest.json`` (trigger, member coverage, offset table,
        collector health), one ``member-*.json`` per member with its
        retained telemetry, and ``events.jsonl`` — the merged
        offset-corrected stream, one event per line, sorted on the
        collector's timebase. Never raises: a recorder that faults
        during a fault is worse than none."""
        root = self.cluster_dir
        if root is None:
            return None
        bdir = os.path.join(root, "cluster-%s-%06d" % (
            _slug(reason), next(_bundle_seq)))
        try:
            with self._lock:
                states = {n: st for n, st in self._members.items()}
                merged = list(self._merged)
            now = time.monotonic()
            manifest = {
                "reason": str(reason),
                "trigger": trigger,
                "t_wall": time.time(),
                "t_mono": now,
                "collector_pid": os.getpid(),
                "members": {n: st.summary(now)
                            for n, st in states.items()},
                "offset_table": {n: st.estimator.as_dict()
                                 for n, st in states.items()},
                "coverage": {
                    "scraped": sorted(n for n, st in states.items()
                                      if st.up),
                    "unreachable": sorted(
                        n for n, st in states.items() if not st.up),
                },
                "health": self.health(),
                "merged_events": len(merged),
            }
            os.makedirs(bdir, exist_ok=True)
            with open(os.path.join(bdir, "manifest.json"),
                      "w") as f:
                json.dump(manifest, f, indent=2, default=repr)
            for n, st in states.items():
                if st.last_payload is None:
                    continue
                fname = "member-%s-p%s-g%s.json" % (
                    _slug(n), (st.key or (None, "x", None))[1],
                    (st.key or (None, None, "x"))[2])
                with open(os.path.join(bdir, fname), "w") as f:
                    json.dump(st.last_payload, f, indent=2,
                              default=repr)
            with open(os.path.join(bdir, "events.jsonl"),
                      "w") as f:
                for ev in sorted(
                        merged,
                        key=lambda e: (e.get("local_t")
                                       if e.get("local_t")
                                       is not None else 0.0)):
                    f.write(json.dumps(ev, default=repr) + "\n")
        except OSError:
            return None
        row = {"path": bdir, "reason": str(reason),
               "trigger": trigger}
        with self._lock:
            self.bundles.append(row)
            self.counters["bundles"] += 1
        try:
            _fleet_metrics()["bundles"].inc()
        except Exception:
            pass
        return bdir

    # ------------------------------------------------------ read side

    def members(self) -> Dict[str, Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return {n: st.summary(now)
                    for n, st in self._members.items()}

    def merged_events(self) -> List[Dict[str, Any]]:
        """The offset-corrected cluster stream, sorted on the
        collector's timebase."""
        with self._lock:
            merged = list(self._merged)
        return sorted(merged,
                      key=lambda e: (e.get("local_t")
                                     if e.get("local_t") is not None
                                     else 0.0))

    def health(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            states = list(self._members.values())
            counters = dict(self.counters)
            merged_n = len(self._merged)
            merged_dropped = self._merged_dropped
        ages = [now - st.last_scrape_mono for st in states
                if st.last_scrape_mono is not None]
        uncs = [st.estimator.uncertainty_s for st in states
                if st.estimator.uncertainty_s is not None]
        drifts = [abs(st.estimator.drift_s_per_s) for st in states
                  if st.estimator.drift_s_per_s is not None]
        return {
            "members": len(states),
            "members_up": sum(1 for st in states if st.up),
            "counters": counters,
            "max_scrape_age_s": (round(max(ages), 6)
                                 if ages else None),
            "max_offset_uncertainty_s": (round(max(uncs), 9)
                                         if uncs else None),
            "max_abs_drift_s_per_s": (round(max(drifts), 9)
                                      if drifts else None),
            "dropped_events": sum(st.dropped for st in states),
            "merged_events": merged_n,
            "merged_dropped": merged_dropped,
            "offset_bound_s": self.offset_bound_s,
            "offset_within_bound": (
                None if self.offset_bound_s is None or not uncs
                else bool(max(uncs) <= self.offset_bound_s)),
        }

    def request_phases(self) -> Dict[str, Dict[str, Any]]:
        """Cross-process request stitching, keyed by trace_id.

        For every trace_id in the merged stream: the per-member spans
        (first to last event that member logged for the trace, each
        stamped role/replica_id/pid/generation and placed on the
        aligned timebase), the set of OS processes touched, and
        whether the trace STITCHED (>= 2 distinct pids — the whole
        point of the aligned timebase)."""
        by_trace: Dict[str, List[Dict[str, Any]]] = {}
        for ev in self.merged_events():
            data = ev.get("data")
            tid = data.get("trace_id") if isinstance(data, dict) \
                else None
            if tid:
                by_trace.setdefault(str(tid), []).append(ev)
        out: Dict[str, Dict[str, Any]] = {}
        for tid, evs in by_trace.items():
            spans = []
            by_member: Dict[tuple, List[Dict[str, Any]]] = {}
            for ev in evs:
                by_member.setdefault(
                    (ev["member"], ev["pid"], ev["generation"]),
                    []).append(ev)
            for (member, pid, gen), mevs in sorted(
                    by_member.items(),
                    key=lambda kv: kv[1][0]["local_t"] or 0.0):
                ts = [e["local_t"] for e in mevs
                      if e["local_t"] is not None]
                if not ts:
                    continue
                spans.append({
                    "role": mevs[0]["role"],
                    "replica_id": member,
                    "pid": pid,
                    "generation": gen,
                    "start_s": round(min(ts), 9),
                    "end_s": round(max(ts), 9),
                    "offset_uncertainty_s": max(
                        e.get("offset_uncertainty_s") or 0.0
                        for e in mevs),
                    "etypes": [e["type"] for e in mevs],
                    "rids": sorted({str(e["rid"]) for e in mevs
                                    if e.get("rid") is not None}),
                })
            pids = sorted({s["pid"] for s in spans
                           if s["pid"] is not None})
            out[tid] = {
                "trace_id": tid,
                "spans": spans,
                "processes": pids,
                "n_processes": len(pids),
                "members": sorted({s["replica_id"]
                                   for s in spans}),
                "stitched": len(pids) >= 2,
                "events": len(evs),
            }
        return out

    def chrome_trace(self) -> List[Dict[str, Any]]:
        """Merged stream as Chrome trace events: one process row per
        member incarnation (real pids), request spans as complete
        ('X') events under their trace_id track, every raw event as
        an instant."""
        out: List[Dict[str, Any]] = []
        seen_procs = set()
        for ev in self.merged_events():
            pid = ev.get("pid")
            if pid is None or ev.get("local_t") is None:
                continue
            if pid not in seen_procs:
                seen_procs.add(pid)
                out.append({
                    "ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0,
                    "args": {"name": "%s:%s:g%s" % (
                        ev.get("role"), ev.get("member"),
                        ev.get("generation"))}})
            out.append({
                "ph": "i", "s": "t", "pid": pid,
                "tid": str(ev.get("rid") or ev.get("member")),
                "name": ev.get("type"),
                "ts": round(ev["local_t"] * 1e6, 3),
                "args": {"seq": ev.get("seq"),
                         "member": ev.get("member"),
                         "data": ev.get("data")}})
        for tid, ph in sorted(self.request_phases().items()):
            for span in ph["spans"]:
                out.append({
                    "ph": "X", "pid": span["pid"],
                    "tid": f"trace:{tid}",
                    "name": "%s %s" % (span["role"],
                                       span["replica_id"]),
                    "ts": round(span["start_s"] * 1e6, 3),
                    "dur": round(max(span["end_s"]
                                     - span["start_s"],
                                     1e-6) * 1e6, 3),
                    "args": {"trace_id": tid,
                             "generation": span["generation"],
                             "offset_uncertainty_s":
                                 span["offset_uncertainty_s"],
                             "etypes": span["etypes"]}})
        return out

    def metrics_text(self) -> str:
        """The aggregated exposition the proxy serves: every member's
        scraped families re-labeled ``member=<name>`` plus the
        collector's own (local-registry) health gauges."""
        self._export_gauges()
        with self._lock:
            texts = {st.name: st.metrics_text
                     for st in self._members.values()
                     if st.metrics_text}
        from ray_tpu_torch.util import metrics
        return merge_prometheus_texts(texts) + metrics.prometheus_text()


def merge_prometheus_texts(texts: Dict[str, str],
                           label: str = "member") -> str:
    """Merge per-member Prometheus expositions into one, injecting
    ``label="<member>"`` into every sample so same-named families
    from N processes stay distinguishable. HELP/TYPE are emitted once
    per family; members and families are sorted, so (given the
    deterministic per-process exposition) the merge is diffable."""
    from ray_tpu_torch.util.metrics import _escape_label
    families: Dict[str, Dict[str, Any]] = {}
    for member in sorted(texts):
        fam = None
        for line in texts[member].splitlines():
            if not line:
                continue
            if line.startswith("# HELP "):
                fam = line.split(" ", 3)[2]
                families.setdefault(fam, {"help": line,
                                          "type": None,
                                          "samples": []})
                continue
            if line.startswith("# TYPE "):
                if fam is not None:
                    families[fam]["type"] = \
                        families[fam]["type"] or line
                continue
            if fam is None:
                continue
            try:
                head, value = line.rsplit(" ", 1)
            except ValueError:
                continue
            inject = f'{label}="{_escape_label(member)}"'
            if head.endswith("}"):
                i = head.index("{")
                head = f"{head[:i]}{{{inject},{head[i + 1:]}"
            else:
                head = f"{head}{{{inject}}}"
            families[fam]["samples"].append(f"{head} {value}")
    lines: List[str] = []
    for fam in sorted(families):
        f = families[fam]
        lines.append(f["help"])
        if f["type"]:
            lines.append(f["type"])
        lines.extend(f["samples"])
    return ("\n".join(lines) + "\n") if lines else ""


def load_cluster_bundle(bdir: str) -> Dict[str, Any]:
    """Read a cluster bundle back: the manifest plus its merged
    event stream (``events.jsonl`` parsed with the same torn-tail
    tolerance as ``obs.load_flight_bundle``) and the per-member
    payload files."""
    with open(os.path.join(bdir, "manifest.json")) as f:
        manifest = json.load(f)
    events: List[Dict[str, Any]] = []
    epath = os.path.join(bdir, "events.jsonl")
    torn = 0
    if os.path.exists(epath):
        with open(epath) as f:
            raw = f.read()
        lines = raw.split("\n")
        complete, fragment = lines[:-1], lines[-1]
        for i, line in enumerate(complete):
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                if i != len(complete) - 1 or fragment:
                    raise
                torn += 1
                break
        if fragment:
            torn += 1
    members: Dict[str, Any] = {}
    for fname in sorted(os.listdir(bdir)):
        if fname.startswith("member-") and fname.endswith(".json"):
            with open(os.path.join(bdir, fname)) as f:
                members[fname[len("member-"):-len(".json")]] = \
                    json.load(f)
    manifest["events"] = events
    manifest["events_torn_truncated"] = torn
    manifest["member_payloads"] = members
    return manifest
