"""Own copy of part of ``ray_tpu/serve/obs.py``: the typed, timestamped
event log (``EventLog``) and its JSON form (``as_dicts``).

- ``EventLog`` — a bounded ring of ``(seq, t, etype, rid, sid, data)``
  tuples with a LOCK-FREE append: the hot path pays one
  ``time.monotonic()`` call, one tuple allocation and two GIL-atomic
  stores. Readers (``snapshot``/``tail``) tolerate concurrent appends:
  a torn read loses ring slots, never corrupts them.

The engine (serve/engine.py) keeps one as ``LLMEngine.events`` and so
far appends only the events of the KV pull and the weight swap, with
the reference's kinds and data fields: ``pull_start``, ``pull_land``,
``pull_fallback``, ``weight_swap_pending`` and ``weight_swap``. The
reference's other event sites (submit, admit, prefill, decode, ...)
and the rest of its module — ``SchedTraceView``, ``chrome_trace``,
``request_phases``, ``emit_request_spans``, ``dump_flight_bundle`` and
``phase_metrics`` — wait for ROADMAP.md queue 1, item 5.4.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional

# Event tuple layout: (seq, t, etype, rid, sid, data)
#   seq   — per-log monotonically increasing index (total order)
#   t     — time.monotonic() at append
#   etype — event kind string ("pull_start", "weight_swap", ...)
#   rid   — request id, tuple of rids for batched events, or None
#   sid   — slot / replica index or None
#   data  — kind-specific payload (a dict for the kinds above)
SEQ, T, ETYPE, RID, SID, DATA = range(6)


class EventLog:
    """Bounded ring of typed events with lock-free append.

    ``append`` never takes a lock: the ring slots are preallocated and
    the (index read, slot store, index store) sequence is GIL-atomic
    per operation — a concurrent reader may miss the newest entry or
    see an overwritten oldest one, never a torn record. ``enabled``
    False turns append into a single attribute test.
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
