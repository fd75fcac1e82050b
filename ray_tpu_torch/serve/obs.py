"""Port of ``ray_tpu/serve/obs.py``: serving observability — the typed
event log, its trace export and the flight recorder.

- ``EventLog`` — a bounded ring of ``(seq, t, etype, rid, sid, data)``
  tuples with a LOCK-FREE append: the hot path pays one
  ``time.monotonic()`` call, one tuple allocation and two GIL-atomic
  stores. Readers (``snapshot``/``tail``) tolerate concurrent appends:
  a torn read loses ring slots, never corrupts them. ``event_window``
  is its cursored read.
- ``SchedTraceView`` — the engine's ``sched_trace``: renders the four
  legacy scheduler kinds (``prefill``/``decode``/``spec``/``cache_hit``)
  in their exact historical tuple shapes; no other kind leaks through.
- ``request_phases`` — per-request lifecycle (queue wait, prefill,
  decode, TTFT) rebuilt from the raw events; ``chrome_trace`` merges
  event streams into Chrome/Perfetto trace-event JSON with those
  phases as spans; ``emit_request_spans`` turns them into spans of
  ``util/tracing.py``.
- ``dump_flight_bundle`` / ``load_flight_bundle`` — the flight
  recorder: a postmortem bundle (event tails, ``load_report``,
  lifecycle, prefix and spec stats, allocator occupancy) the engine
  writes on a contained ``EngineFault`` and on ``_fail_all``. Every
  probe is lock-free and best-effort, and an I/O failure returns None.
- ``phase_metrics`` — the eight lazy ``serve_phase_*`` histograms in
  ``util/metrics.py``.

The engine (serve/engine.py) and the replica pool
(serve/engine_pool.py) append under the reference's kinds and data
fields. One difference: the default flight directory lies under the
system temp directory (``TMPDIR``) where the reference names ``/tmp``.
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional

# Event tuple layout: (seq, t, etype, rid, sid, data)
#   seq   — per-log monotonically increasing index (total order)
#   t     — time.monotonic() at append
#   etype — event kind string ("admit", "decode", "route", ...)
#   rid   — request id, tuple of rids for batched events, or None
#   sid   — slot / replica index or None
#   data  — kind-specific payload (legacy-shape tuples for the four
#           sched_trace kinds; dicts elsewhere)
SEQ, T, ETYPE, RID, SID, DATA = range(6)

# The four kinds SchedTraceView renders back to legacy tuples.
LEGACY_KINDS = ("prefill", "decode", "spec", "cache_hit")


class EventLog:
    """Bounded ring of typed events with lock-free append.

    ``append`` never takes a lock: the ring slots are preallocated and
    the (index read, slot store, index store) sequence is GIL-atomic
    per operation — a concurrent reader may miss the newest entry or
    see an overwritten oldest one, never a torn record. ``enabled``
    False turns append into a single attribute test (the A/B arm).
    """

    __slots__ = ("name", "capacity", "enabled", "_ring", "_idx")

    def __init__(self, capacity: int = 4096, *, name: str = "engine",
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._idx = 0

    def append(self, etype: str, rid: Any = None, sid: Any = None,
               data: Any = None, t: Optional[float] = None) -> None:
        if not self.enabled:
            return
        i = self._idx
        self._ring[i % self.capacity] = (
            i, time.monotonic() if t is None else t, etype, rid, sid,
            data)
        self._idx = i + 1

    @property
    def total(self) -> int:
        """Events ever appended (>= len once the ring has wrapped)."""
        return self._idx

    def __len__(self) -> int:
        idx = self._idx
        return self.capacity if idx > self.capacity else idx

    def snapshot(self) -> List[tuple]:
        """Ordered (oldest -> newest) copy of the retained events."""
        idx, cap = self._idx, self.capacity
        if idx <= cap:
            evs = [e for e in self._ring[:idx] if e is not None]
        else:
            cut = idx % cap
            evs = [e for e in self._ring[cut:] + self._ring[:cut]
                   if e is not None]
        # concurrent appends can reorder across the wrap point
        evs.sort(key=lambda e: e[SEQ])
        return evs

    def tail(self, n: int = 256) -> List[tuple]:
        return self.snapshot()[-int(n):]

    def clear(self) -> None:
        self._ring = [None] * self.capacity
        self._idx = 0


def as_dicts(events: Iterable[tuple]) -> List[Dict[str, Any]]:
    """Event tuples -> JSON-friendly dicts (artifact / bundle form)."""
    return [{"seq": e[SEQ], "t": e[T], "type": e[ETYPE],
             "rid": list(e[RID]) if isinstance(e[RID], tuple)
             else e[RID],
             "sid": e[SID], "data": _jsonable(e[DATA])}
            for e in events]


def event_window(events: List[tuple], total: int, cursor: int,
                 limit: int) -> tuple:
    """Cursored read over a bounded ring snapshot: the scrape seam.

    Returns ``(window, next_cursor, dropped)`` where ``window`` is
    the (<= limit) events with ``seq >= cursor``, ``next_cursor``
    resumes exactly after the last event handed out, and ``dropped``
    counts events the ring already overwrote past the cursor — the
    collector surfaces that as data loss instead of silently skipping.
    """
    cursor = max(0, int(cursor))
    limit = max(1, int(limit))
    oldest = events[0][SEQ] if events else total
    dropped = max(0, oldest - cursor)
    window = [e for e in events if e[SEQ] >= cursor][:limit]
    next_cursor = (window[-1][SEQ] + 1) if window \
        else max(cursor, total)
    return window, next_cursor, dropped


def _jsonable(x: Any) -> Any:
    if isinstance(x, tuple):
        return [_jsonable(v) for v in x]
    if isinstance(x, list):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return repr(x)


class SchedTraceView:
    """Legacy ``sched_trace`` facade over an :class:`EventLog`.

    Renders ONLY the four historical kinds, each with its exact legacy
    shape — callers unpack ``(kind, payload)`` 2-tuples over the whole
    list (and 4-tuples for ``spec``), so nothing else may leak through:

    - ``("prefill", ((ix, take), ...))``
    - ``("decode", steps)``
    - ``("spec", sid, proposed, accepted)``
    - ``("cache_hit", (slot, skipped_tokens))``
    """

    __slots__ = ("_log",)

    def __init__(self, log: EventLog):
        self._log = log

    def _tuples(self):
        for e in self._log.snapshot():
            etype = e[ETYPE]
            if etype == "prefill":
                yield ("prefill", e[DATA])
            elif etype == "decode":
                yield ("decode", e[DATA])
            elif etype == "spec":
                yield ("spec", e[SID], e[DATA][0], e[DATA][1])
            elif etype == "cache_hit":
                yield ("cache_hit", (e[SID], e[DATA]))

    def __iter__(self):
        return self._tuples()

    def __len__(self) -> int:
        return sum(1 for _ in self._tuples())

    def __contains__(self, item) -> bool:
        return any(t == item for t in self._tuples())

    def __bool__(self) -> bool:
        return any(True for _ in self._tuples())

    def append(self, item: tuple) -> None:
        """Compat escape hatch: accept a legacy tuple and record it as
        the corresponding typed event (external writers only — the
        engine appends typed events directly)."""
        kind = item[0]
        if kind == "spec":
            self._log.append("spec", sid=item[1],
                             data=(item[2], item[3]))
        elif kind == "cache_hit":
            self._log.append("cache_hit", sid=item[1][0],
                             data=item[1][1])
        elif kind in ("prefill", "decode"):
            self._log.append(kind, data=item[1])
        else:
            raise ValueError(f"unknown sched_trace kind {kind!r}")


# --------------------------------------------------------------- phases

# Point-event kinds that mark request-lifecycle boundaries.
_TERMINAL = ("retire", "cancelled", "deadline_exceeded",
             "fault_failed", "retry_exhausted", "shed", "failed")


def request_phases(events: Iterable[tuple]) -> Dict[Any, Dict[str, Any]]:
    """Reconstruct per-request phase timings from an event list.

    Returns ``{rid: phases}`` where phases carries the raw marks
    (``submit``/``admit``/``first_token``/``end`` monotonic stamps),
    the derived durations (``queue_wait_s``, ``prefill_s``,
    ``decode_s``, ``ttft_s``, ``total_s`` — None when a mark is
    missing), the terminal outcome, emit/decode-round counts, and the
    request's ``trace_id`` when a submit event carried one.
    """
    out: Dict[Any, Dict[str, Any]] = {}

    def rec(rid):
        return out.setdefault(rid, {
            "submit": None, "admit": None, "first_token": None,
            "end": None, "outcome": None, "trace_id": None,
            "n_emits": 0, "n_tokens": 0, "sid": None,
        })

    for e in events:
        etype, rid = e[ETYPE], e[RID]
        if rid is None or isinstance(rid, tuple):
            continue
        r = rec(rid)
        t = e[T]
        if etype == "submit":
            r["submit"] = t
            if isinstance(e[DATA], dict):
                r["trace_id"] = e[DATA].get("trace_id")
        elif etype == "admit":
            # resubmit-after-preemption re-admits: keep the first
            if r["admit"] is None:
                r["admit"] = t
            r["sid"] = e[SID]
        elif etype == "first_token":
            r["first_token"] = t
        elif etype == "emit":
            r["n_emits"] += 1
            if isinstance(e[DATA], dict):
                r["n_tokens"] += int(e[DATA].get("n", 0))
            r["end"] = t if r["end"] is None else max(r["end"], t)
        elif etype in _TERMINAL:
            r["outcome"] = etype
            r["end"] = t if r["end"] is None else max(r["end"], t)
    for r in out.values():
        sub, adm = r["submit"], r["admit"]
        ft, end = r["first_token"], r["end"]
        r["queue_wait_s"] = (adm - sub) if sub is not None \
            and adm is not None else None
        r["prefill_s"] = (ft - adm) if adm is not None \
            and ft is not None else None
        r["decode_s"] = (end - ft) if ft is not None \
            and end is not None else None
        r["ttft_s"] = (ft - sub) if sub is not None \
            and ft is not None else None
        r["total_s"] = (end - sub) if sub is not None \
            and end is not None else None
    return out


# --------------------------------------------------------- chrome trace

def chrome_trace(streams: Dict[str, Iterable[tuple]],
                 t0: Optional[float] = None) -> List[Dict[str, Any]]:
    """Merge event streams into Chrome trace-event JSON (Perfetto).

    ``streams`` maps a stream name ("engine-0", "pool", "watchdog") to
    its event tuples. Each stream becomes one process row (instant
    events, tid = sid); per-request phase spans derived from the merged
    stream land on a synthetic "requests" process with one thread row
    per request. Timestamps are microseconds relative to the earliest
    event, so the result is self-contained and monotone.
    """
    named = [(name, list(evs)) for name, evs in sorted(streams.items())]
    all_evs = [e for _n, evs in named for e in evs]
    if t0 is None:
        t0 = min((e[T] for e in all_evs), default=0.0)
    trace: List[Dict[str, Any]] = []
    pid = 0
    for name, evs in named:
        pid += 1
        trace.append({"name": "process_name", "ph": "M", "pid": pid,
                      "tid": 0, "args": {"name": name}})
        for e in evs:
            sid = e[SID]
            trace.append({
                "name": e[ETYPE], "ph": "i", "s": "t",
                "ts": round((e[T] - t0) * 1e6, 3),
                "pid": pid, "tid": sid if isinstance(sid, int) else 0,
                "args": {"rid": _jsonable(e[RID]), "seq": e[SEQ],
                         "data": _jsonable(e[DATA])},
            })
    # Derived per-request phase spans on their own process row.
    req_pid = pid + 1
    trace.append({"name": "process_name", "ph": "M", "pid": req_pid,
                  "tid": 0, "args": {"name": "requests"}})
    for rid, ph in sorted(request_phases(all_evs).items(),
                          key=lambda kv: str(kv[0])):
        tid = rid if isinstance(rid, int) else 0
        trace.append({"name": "thread_name", "ph": "M", "pid": req_pid,
                      "tid": tid, "args": {"name": f"req {rid}"}})

        def _span(name, a, b):
            if a is None or b is None or b < a:
                return
            trace.append({
                "name": name, "ph": "X",
                "ts": round((a - t0) * 1e6, 3),
                "dur": round((b - a) * 1e6, 3),
                "pid": req_pid, "tid": tid,
                "args": {"rid": _jsonable(rid),
                         "trace_id": ph.get("trace_id")},
            })
        _span("request", ph["submit"], ph["end"])
        _span("queue_wait", ph["submit"], ph["admit"])
        _span("prefill", ph["admit"], ph["first_token"])
        _span("decode", ph["first_token"], ph["end"])
    return trace


# -------------------------------------------------------- tracing bridge

def emit_request_spans(events: Iterable[tuple]) -> List[Dict[str, Any]]:
    """Bridge engine events into ``util/tracing``'s span model.

    Each reconstructed request becomes a root ``serve.request`` span
    (trace id = the one the request was submitted with, when present) with
    ``queue_wait``/``prefill``/``decode`` children. Spans are returned
    always and additionally emitted through the tracing pipeline when
    tracing is enabled, so they merge with the process's other spans
    in ``get_spans()``.
    """
    from ray_tpu_torch.util import tracing
    # map the event log's monotonic stamps onto the wall clock tracing
    # uses; one offset sampled here keeps relative phase math exact
    off = time.time() - time.monotonic()
    spans: List[Dict[str, Any]] = []
    for rid, ph in sorted(request_phases(events).items(),
                          key=lambda kv: str(kv[0])):
        if ph["submit"] is None or ph["end"] is None:
            continue
        trace_id = ph.get("trace_id") or tracing._new_id()
        root_id = tracing._new_id()

        def mk(name, a, b, parent, span_id=None):
            return {
                "name": name, "kind": "serve.phase",
                "trace_id": trace_id,
                "span_id": span_id or tracing._new_id(),
                "parent_id": parent,
                "start_time": off + a, "end_time": off + b,
                "status": "ok" if ph["outcome"] in (None, "retire")
                else "error",
                "attributes": {"rid": _jsonable(rid),
                               "outcome": ph["outcome"]},
            }
        spans.append(mk("serve.request", ph["submit"], ph["end"],
                        None, span_id=root_id))
        if ph["admit"] is not None:
            spans.append(mk("serve.queue_wait", ph["submit"],
                            ph["admit"], root_id))
        if ph["admit"] is not None and ph["first_token"] is not None:
            spans.append(mk("serve.prefill", ph["admit"],
                            ph["first_token"], root_id))
        if ph["first_token"] is not None:
            spans.append(mk("serve.decode", ph["first_token"],
                            ph["end"], root_id))
    if tracing.is_enabled():
        for s in spans:
            tracing._emit(s)
    return spans


# ------------------------------------------------------- flight recorder

_FLIGHT_DIR_ENV = "RAY_TPU_FLIGHT_DIR"
_bundle_seq = itertools.count()


def default_flight_dir() -> str:
    return os.environ.get(_FLIGHT_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "ray_tpu", "flight", f"p{os.getpid()}")


def _slug(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in str(s))[:48] or "bundle"


def _probe(out: Dict[str, Any], key: str, fn) -> None:
    try:
        out[key] = fn()
    except Exception as e:  # noqa: BLE001 — postmortems never raise
        out[key + "_error"] = repr(e)


_LIFECYCLE_KEYS = ("submitted", "admitted", "completed", "shed",
                   "cancelled", "deadline_exceeded",
                   "contained_faults", "retries", "retry_exhausted",
                   "fault_failed", "preemptions", "force_killed")


def _probe_engine(eng, tail: int) -> Dict[str, Any]:
    """LOCK-FREE engine probe. The dump typically runs while a wedged
    scheduler thread holds the engine lock (that is the point of a
    flight recorder), so nothing here may wait on it: attribute reads
    are GIL-atomic, ``load_report()`` bounds its lock acquire and
    falls back to lock-free reads, and the lifecycle/spec sections
    are derived from a stats snapshot instead of calling the locked
    ``lifecycle_stats``/``spec_stats`` accessors."""
    out: Dict[str, Any] = {}
    log = getattr(eng, "events", None)
    if isinstance(log, EventLog):
        evs = log.tail(tail)
        out["events"] = as_dicts(evs)
        out["events_total"] = log.total
        if evs:
            out["last_event_t"] = evs[-1][T]
            out["event_gap_s"] = round(
                max(0.0, time.monotonic() - evs[-1][T]), 6)
    if callable(getattr(eng, "load_report", None)):
        _probe(out, "load_report", lambda: dict(eng.load_report()))
    rpt = out.get("load_report") or {}
    hb = rpt.get("heartbeat_age_s")
    gaps = [g for g in (hb, out.get("event_gap_s")) if g is not None]
    if gaps:
        # the postmortem headline: how long the scheduler was silent
        out["heartbeat_gap_s"] = round(max(gaps), 6)
    stats = getattr(eng, "stats", None)
    if stats is not None:
        _probe(out, "stats", lambda: dict(stats))
        s = out.get("stats") or {}
        out["lifecycle"] = {k: s.get(k, 0) for k in _LIFECYCLE_KEYS}
        spec = {k: v for k, v in s.items()
                if isinstance(k, str) and k.startswith("spec_")}
        if spec:
            out["spec"] = spec
    pc = getattr(eng, "prefix_cache", None)
    if pc is not None and callable(getattr(pc, "stats", None)):
        _probe(out, "prefix", pc.stats)
    kvm = getattr(eng, "kv_migration_stats", None)
    if kvm:
        # cross-replica KV pull counters: a migration fault's
        # postmortem must show whether pages moved, aborted, or fell
        # back to recompute
        _probe(out, "kv_migration", lambda: dict(kvm))
    alloc = getattr(eng, "alloc", None)
    if alloc is not None:
        _probe(out, "allocator", lambda: {
            "n_pages": alloc.n_pages, "n_free": alloc.n_free,
            "occupancy": alloc.occupancy(),
            # dtype-aware bytes view (None on pre-bytes allocators)
            "page_bytes": getattr(alloc, "page_bytes", None),
            "bytes_in_use": alloc.bytes_in_use()
            if callable(getattr(alloc, "bytes_in_use", None)) else None,
            "bytes_total": alloc.bytes_total()
            if callable(getattr(alloc, "bytes_total", None)) else None})
    return out


def _probe_pool(pool, tail: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    log = getattr(pool, "events", None)
    if isinstance(log, EventLog):
        out["events"] = as_dicts(log.tail(tail))
    if callable(getattr(pool, "pool_stats", None)):
        _probe(out, "pool_stats", pool.pool_stats)
    return out


def dump_flight_bundle(dirpath: Optional[str], reason: str, *,
                       engine=None, pool=None, watchdog=None,
                       extra: Optional[Dict[str, Any]] = None,
                       tail: int = 512) -> Optional[str]:
    """Write a postmortem bundle; returns its directory (None on total
    IO failure — the recorder must never turn a postmortem into a new
    fault). Layout: ``<dir>/<reason>-<seq>-p<pid>/bundle.json`` plus
    ``events.jsonl`` (engine then pool event tails, one per line).
    """
    root = dirpath or default_flight_dir()
    bdir = os.path.join(root, "%s-%06d-p%d" % (
        _slug(reason), next(_bundle_seq), os.getpid()))
    bundle: Dict[str, Any] = {
        "reason": str(reason),
        "t_wall": time.time(),
        "t_mono": time.monotonic(),
        "pid": os.getpid(),
    }
    if engine is not None:
        bundle["engine"] = _probe_engine(engine, tail)
    if pool is not None:
        bundle["pool"] = _probe_pool(pool, tail)
    if watchdog is not None:
        wd: Dict[str, Any] = {}
        if callable(getattr(watchdog, "stats", None)):
            _probe(wd, "stats", watchdog.stats)
        wlog = getattr(watchdog, "log", None)
        if isinstance(wlog, list):
            wd["log"] = [dict(e) for e in wlog[-tail:]]
        bundle["watchdog"] = wd
    if extra:
        bundle["extra"] = _jsonable(extra)
    try:
        os.makedirs(bdir, exist_ok=True)
        with open(os.path.join(bdir, "bundle.json"), "w") as f:
            json.dump(bundle, f, indent=2, default=repr)
        with open(os.path.join(bdir, "events.jsonl"), "w") as f:
            for section in ("engine", "pool"):
                for ev in bundle.get(section, {}).get("events", []):
                    f.write(json.dumps(
                        dict(ev, stream=section), default=repr) + "\n")
    except OSError:
        return None
    return bdir


def load_flight_bundle(bdir: str) -> Dict[str, Any]:
    """Load a bundle for postmortem reading.

    ``events.jsonl`` is parsed with the write-ahead log's torn-tail
    discipline: the dumper may have died mid-append, so a
    final line that does not parse — or a tail with no terminating
    newline — marks a torn tail. It is truncated in place with a
    warning and everything before it is returned; a postmortem reader
    must never raise over the very crash it is documenting. A torn
    line ANYWHERE but the tail is real corruption and still raises.
    """
    with open(os.path.join(bdir, "bundle.json")) as f:
        bundle = json.load(f)
    epath = os.path.join(bdir, "events.jsonl")
    if os.path.exists(epath):
        events: List[Dict[str, Any]] = []
        torn = 0
        with open(epath, "r+") as f:
            good_end = 0
            raw = f.read()
            lines = raw.split("\n")
            # a non-empty final element means the last write lost its
            # newline mid-append — that fragment is torn by definition
            complete, fragment = lines[:-1], lines[-1]
            for i, line in enumerate(complete):
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    if i != len(complete) - 1 or fragment:
                        raise
                    torn += 1
                    break
                good_end += len(line.encode("utf-8")) + 1
            if fragment:
                torn += 1
            if torn:
                warnings.warn(
                    f"flight bundle {bdir}: events.jsonl has a torn "
                    f"final line ({torn} record(s) truncated, "
                    f"{len(events)} retained) — the dumper likely "
                    f"died mid-append", RuntimeWarning,
                    stacklevel=2)
                f.seek(good_end)
                f.truncate(good_end)
        bundle["events_jsonl"] = events
        bundle["events_torn_truncated"] = torn
    return bundle


# --------------------------------------------------------- phase metrics

QUEUE_WAIT = "serve_phase_queue_wait_s"
PLAN = "serve_phase_plan_s"
DISPATCH = "serve_phase_dispatch_s"
READBACK = "serve_phase_readback_s"
ROUND_WALL = "serve_phase_round_wall_s"
TTFT = "serve_phase_ttft_s"
INTER_TOKEN = "serve_phase_inter_token_s"
HOST_GAP = "serve_phase_host_gap_s"

_PHASE_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

_METRICS: Optional[Dict[str, Any]] = None


def phase_metrics() -> Dict[str, Any]:
    """Lazy serve_phase_* Histogram singletons, re-created if a
    ``clear_registry()`` dropped them (the engine's and the pool's
    pattern)."""
    global _METRICS
    from ray_tpu_torch.util import metrics
    if _METRICS is None or metrics.registry().get(QUEUE_WAIT) is not \
            _METRICS["queue_wait"]:
        _METRICS = {
            "queue_wait": metrics.Histogram(
                QUEUE_WAIT, "Submit-to-admit wait per request",
                boundaries=_PHASE_BOUNDS),
            "plan": metrics.Histogram(
                PLAN, "Pure-planner time per scheduling round",
                boundaries=_PHASE_BOUNDS),
            "dispatch": metrics.Histogram(
                DISPATCH, "Device dispatch time per scheduling round",
                boundaries=_PHASE_BOUNDS),
            "readback": metrics.Histogram(
                READBACK, "Host readback (device_get) time per drain",
                boundaries=_PHASE_BOUNDS),
            "round_wall": metrics.Histogram(
                ROUND_WALL, "Wall time per scheduling round",
                boundaries=_PHASE_BOUNDS),
            "ttft": metrics.Histogram(
                TTFT, "Time to first token per request",
                boundaries=_PHASE_BOUNDS),
            "inter_token": metrics.Histogram(
                INTER_TOKEN, "Mean gap between emitted tokens "
                "(per readback batch)",
                boundaries=_PHASE_BOUNDS),
            "host_gap": metrics.Histogram(
                HOST_GAP, "Host time gating dispatch per round "
                "(pre-plan readback drain + planner): the device "
                "idles for this span under the lockstep loop, and "
                "for ~none of it under the overlapped loop",
                boundaries=_PHASE_BOUNDS),
        }
    return _METRICS


def mint_trace_id() -> str:
    """A fresh 16-hex trace id (same shape util/tracing mints)."""
    from ray_tpu_torch.util import tracing
    return tracing._new_id()
