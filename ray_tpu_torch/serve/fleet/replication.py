"""Port of ``ray_tpu/serve/fleet/replication.py``: the directory's hot
standby. Three pieces over the ``Transport`` seam:

- ``Replicator`` (primary side): an asynchronous publisher streaming
  every membership delta (``repl_apply``) to one or more standbys, with
  a full-state ``repl_sync`` whenever a standby was unreachable or
  behind. Publishing never blocks the mutating RPC: the primary answers
  from its own WAL; replication is the availability layer, not the
  durability layer.
- ``StandbyMonitor`` (standby side): pings the primary and promotes the
  local standby after ``promote_after_s`` of continuous silence, but
  only once it has seen the primary alive, so a standby started before
  its primary does not take over at startup. ``FleetDirectory.
  rpc_promote`` folds an epoch bump into the fence counter, so no
  fencing token regresses across a failover even if the last deltas
  never arrived.
- ``FailoverDirectoryClient``: the ordered-endpoint client routers and
  agents hold. Each call starts at the last endpoint that answered; a
  ``TransportError`` or a typed ``NotPrimary`` advances to the next
  endpoint, every OTHER typed error propagates (a ``StaleFencingToken``
  from the real primary is an answer, not an outage).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.serve.fleet.directory import (FENCE_EPOCH_STRIDE,
                                                 PRIMARY, DirectoryClient)
from ray_tpu_torch.serve.fleet.transport import Transport, TransportError
from ray_tpu_torch.serve.fleet.wire import NotPrimary

__all__ = ["Replicator", "StandbyMonitor", "FailoverDirectoryClient",
           "FENCE_EPOCH_STRIDE"]


class Replicator:
    """The primary's delta stream to an ordered set of standbys."""

    def __init__(self, transports: List[Transport], *,
                 timeout_s: float = 1.5, maxlen: int = 8192):
        self._standbys = [{"t": t, "needs_sync": True, "superseded": False}
                          for t in transports]
        self._timeout_s = timeout_s
        self._dir = None
        self._cv = threading.Condition(threading.Lock())
        self._queue: collections.deque = collections.deque(maxlen=maxlen)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"published": 0, "applied": 0, "syncs": 0,
                      "errors": 0, "superseded": 0}

    def attach(self, directory) -> "Replicator":
        self._dir = directory
        return self

    def start(self) -> "Replicator":
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-replicator", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def publish(self, epoch: int, record: Dict[str, Any]) -> None:
        """Enqueue one delta (non-blocking; called under the directory's
        lock)."""
        with self._cv:
            self._seq += 1
            self._queue.append((self._seq, int(epoch), dict(record)))
            self.stats["published"] += 1
            self._cv.notify()

    def _state(self):
        d = self._dir
        with d._lock:
            return d.epoch, d._durable_payload()

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self._cv.wait(timeout=0.25)
                if self._stop.is_set():
                    return
                seq, epoch, record = self._queue.popleft()
            for sb in self._standbys:
                if sb["superseded"]:
                    continue
                try:
                    if sb["needs_sync"]:
                        cur_epoch, state = self._state()
                        sb["t"].call("repl_sync",
                                     {"epoch": cur_epoch, "seq": seq - 1,
                                      "state": state},
                                     timeout_s=self._timeout_s)
                        sb["needs_sync"] = False
                        self.stats["syncs"] += 1
                    sb["t"].call("repl_apply",
                                 {"epoch": epoch, "seq": seq,
                                  "record": record},
                                 timeout_s=self._timeout_s)
                    self.stats["applied"] += 1
                except TransportError:
                    # an unreachable standby is repaired by a full sync
                    # on the next contact, not by replaying a gap
                    sb["needs_sync"] = True
                    self.stats["errors"] += 1
                except Exception:   # noqa: BLE001 - a typed refusal
                    # a standby claiming a higher epoch was promoted:
                    # this primary is the zombie, stop streaming to it
                    sb["superseded"] = True
                    self.stats["superseded"] += 1


class StandbyMonitor:
    """The standby's failure detector: promote the local standby once
    the primary has been unreachable for ``promote_after_s`` without a
    break, after having been seen alive at least once."""

    def __init__(self, directory, primary: Transport, *,
                 promote_after_s: float = 3.0, poll_s: float = 0.15,
                 time_fn: Callable[[], float] = time.monotonic):
        self._dir = directory
        self._primary = primary
        self.promote_after_s = float(promote_after_s)
        self.poll_s = poll_s
        self._now = time_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="standby-monitor", daemon=True)
        self.stats = {"pings_ok": 0, "pings_failed": 0, "promoted": 0}

    def start(self) -> "StandbyMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        seen_alive = False
        last_ok: Optional[float] = None
        while not self._stop.is_set():
            if self._dir.role == PRIMARY:
                return              # promoted, by this monitor or by hand
            try:
                self._primary.call("ping", {}, timeout_s=0.5)
                self.stats["pings_ok"] += 1
                seen_alive = True
                last_ok = self._now()
            except Exception:   # noqa: BLE001 - any failure counts
                self.stats["pings_failed"] += 1
                down_for = self._now() - last_ok if last_ok is not None \
                    else 0.0
                if seen_alive and down_for >= self.promote_after_s:
                    self._dir.rpc_promote(
                        reason=f"primary unreachable for {down_for:.2f}s")
                    self.stats["promoted"] += 1
                    return
            self._stop.wait(self.poll_s)


class FailoverDirectoryClient:
    """``DirectoryClient`` over an ORDERED endpoint list. Calls start at
    the last endpoint that answered; transport failures and a typed
    ``NotPrimary`` advance to the next endpoint, every other typed error
    propagates (it IS the primary's answer)."""

    _METHODS = frozenset((
        "ping", "register", "renew", "deregister", "confirm_dead",
        "snapshot", "stats", "events", "role", "promote", "telemetry"))

    def __init__(self, transports: List[Transport], timeout_s: float = 2.0):
        if not transports:
            raise ValueError("need at least one directory endpoint")
        self._clients = [DirectoryClient(t, timeout_s) for t in transports]
        self._lock = threading.Lock()
        self._active = 0
        self.counters = {"calls": 0, "failovers": 0,
                         "not_primary_skips": 0, "transport_skips": 0}

    @property
    def active_index(self) -> int:
        with self._lock:
            return self._active

    def __getattr__(self, name: str):
        if name not in FailoverDirectoryClient._METHODS:
            raise AttributeError(name)

        def _call(*args, **kwargs):
            return self._failover_call(name, args, kwargs)
        _call.__name__ = name
        return _call

    def _failover_call(self, name: str, args, kwargs):
        with self._lock:
            self.counters["calls"] += 1
            start = self._active
        n = len(self._clients)
        last_err: Optional[BaseException] = None
        for i in range(n):
            idx = (start + i) % n
            try:
                out = getattr(self._clients[idx], name)(*args, **kwargs)
            except NotPrimary as e:
                last_err = e
                with self._lock:
                    self.counters["not_primary_skips"] += 1
                continue
            except TransportError as e:
                last_err = e
                with self._lock:
                    self.counters["transport_skips"] += 1
                continue
            with self._lock:
                if idx != self._active:
                    self._active = idx
                    self.counters["failovers"] += 1
            return out
        raise last_err
