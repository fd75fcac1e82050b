"""Port of ``ray_tpu/serve/fleet/directory.py``: ``FleetDirectory``,
lease-fenced membership for the serving fleet.

A small service owning WHO is in the fleet, nothing else. State per
member, keyed by replica id:

- **generation**: the agent's incarnation counter (bumped every time
  the agent rebuilds its engine or re-registers after being fenced). A
  register from an OLDER generation than the directory has ever seen
  for that id is a zombie and is rejected.
- **fencing token**: strictly monotonic across the WHOLE directory (one
  counter), (re)issued at registration. Every later write (renew,
  deregister) must quote it; a stale token is rejected typed
  ``StaleFencingToken``. Agents pass their last token back as
  ``min_fence`` when re-registering, so monotonicity survives even a
  directory that lost its table.
- **lease**: liveness is a time-bounded claim, renewed by heartbeat. An
  expired lease makes the member a DEATH CANDIDATE; it is only removed
  when someone (the router) asks ``confirm_dead``: the directory never
  guesses, and a late renewal before confirmation revives the lease.
- **advertisements**: each renewal piggybacks the agent's prefix digest
  and load report, which is what the router routes on; the digests also
  feed the prefix index behind ``prefix_holders``.

Durability and availability are layered on without changing that
contract:

- ``data_dir=`` arms a **write-ahead log and snapshot** (``wal.py``):
  membership, generations, tombstones and the fencing-token high-water
  mark are logged before the mutating RPC answers, so a restarted
  directory recovers its authority at once. Torn WAL tails are
  truncated, never replayed. Recovered leases get a full TTL: a
  deadline stamped on a dead process's monotonic clock proves nothing.
- ``role="standby"`` (with a ``replication.Replicator`` on the primary
  and a ``StandbyMonitor`` beside the standby) keeps a **hot standby**:
  it applies the primary's deltas (``repl_apply``, ``repl_sync``) and
  refuses every adjudicating RPC typed ``NotPrimary``, so two
  directories never both arbitrate. ``rpc_promote`` makes it primary
  with an epoch bump FOLDED INTO the fence counter (``+
  FENCE_EPOCH_STRIDE``): no token the new primary issues can fall below
  one the dying primary issued unreplicated.

``rpc_telemetry`` is the directory's side of the telemetry plane
(fleet/telemetry.py). Run as a process:

    python -m ray_tpu_torch.serve.fleet.directory [--port N]
        [--lease-ttl-s S] [--data-dir D] [--snapshot-every K]
        [--role standby --peer H:P [--promote-after-s S]]
        [--standby H:P ...]

prints ``READY <port>`` once listening.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.fleet.transport import Transport
from ray_tpu_torch.serve.fleet.wire import (NotPrimary, StaleFencingToken,
                                            UnknownMember)

# The fence counter's jump at a standby's promotion: a bound on the
# tokens an asynchronously replicating primary could have issued without
# their deltas reaching the standby before it died (one delta a
# register, so the true gap is the replication queue's depth).
FENCE_EPOCH_STRIDE = 1024

PRIMARY = "primary"
STANDBY = "standby"


class _Member:
    __slots__ = ("replica_id", "addr", "generation", "fence",
                 "lease_expires", "digest", "load", "page_size",
                 "wedged", "registered_at", "role")

    def __init__(self, replica_id: str, addr: List[Any],
                 generation: int, fence: int, lease_expires: float,
                 page_size: int, registered_at: float,
                 role: str = "unified"):
        self.replica_id = replica_id
        self.addr = addr
        self.generation = generation
        self.fence = fence
        self.lease_expires = lease_expires
        self.digest: List[int] = []
        self.load: Dict[str, Any] = {}
        self.page_size = page_size
        self.wedged = False
        self.registered_at = registered_at
        # scheduling role ("prefill"/"decode"/"unified"), unrelated to
        # the directory's own PRIMARY/STANDBY role
        self.role = role


class FleetDirectory:
    """Membership table + fencing authority. Thread-safe; ``handle`` is
    the transport handler. ``time_fn`` is the lease clock (a fake one in
    tests)."""

    def __init__(self, lease_ttl_s: float = 1.0,
                 time_fn=time.monotonic, *,
                 data_dir: Optional[str] = None,
                 snapshot_every: int = 64,
                 role: str = PRIMARY,
                 replicator=None):
        self.lease_ttl_s = float(lease_ttl_s)
        self._now = time_fn
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {}
        # page-path-hash -> replica ids advertising it: soft state,
        # repainted by every renewal and dropped with the member row
        # (deregister, reap, supersession), so a dead incarnation's
        # holdings never outlive its lease
        self._prefix_index: Dict[int, set] = {}
        # replica_id -> highest generation ever confirmed dead or
        # retired; zombie registrations at or below it are rejected
        self._tombstones: Dict[str, int] = {}
        self._fence_counter = 0
        self.role = role
        self.epoch = 0
        self._repl_last_seq = 0
        self._replicator = replicator
        self.events: collections.deque = collections.deque(maxlen=4096)
        self._event_seq = 0
        self.counters = {"registers": 0, "renews": 0,
                         "stale_fence_rejects": 0,
                         "unknown_member_rejects": 0,
                         "zombie_register_rejects": 0,
                         "late_renewals": 0, "confirmed_dead": 0,
                         "deregisters": 0, "wedges_reported": 0,
                         "not_primary_rejects": 0,
                         "recovered_members": 0,
                         "wal_torn_truncated": 0,
                         "repl_applied": 0, "repl_syncs": 0,
                         "repl_gaps": 0,
                         "repl_stale_epoch_rejects": 0,
                         "promotions": 0,
                         "prefix_queries": 0, "prefix_hits": 0}
        self._wal = None
        if data_dir is not None:
            from ray_tpu_torch.serve.fleet.wal import DirectoryWAL
            self._wal = DirectoryWAL(data_dir, snapshot_every=snapshot_every)
            self._recover()

    # ------------------------------------------------- durable state

    def _event(self, kind: str, **fields) -> None:
        ev = {"seq": self._event_seq, "t": round(self._now(), 4),
              "kind": kind, "epoch": self.epoch}
        self._event_seq += 1
        ev.update(fields)
        self.events.append(ev)

    def _durable_payload(self) -> Dict[str, Any]:
        return {"members": [{"replica_id": m.replica_id, "addr": m.addr,
                             "generation": m.generation, "fence": m.fence,
                             "page_size": m.page_size, "role": m.role}
                            for m in self._members.values()],
                "tombstones": dict(self._tombstones),
                "fence_counter": self._fence_counter,
                "epoch": self.epoch, "role": self.role}

    def _persist(self, record: Dict[str, Any]) -> None:
        if self._wal is not None and self._wal.append(record):
            self._wal.snapshot(self._durable_payload())

    def _log(self, record: Dict[str, Any]) -> None:
        """Persist one mutation and, on a primary, stream it to the
        standbys. Caller holds the lock."""
        self._persist(record)
        if self._replicator is not None and self.role == PRIMARY:
            self._replicator.publish(self.epoch, record)

    def _apply_record(self, rec: Dict[str, Any], now: float) -> None:
        """Apply one WAL or replication record (idempotent under replay).
        Caller holds the lock."""
        op = rec.get("op")
        if op == "member":
            rid = rec["replica_id"]
            fence = int(rec["fence"])
            self._drop_prefix_holdings(self._members.get(rid))
            self._members[rid] = _Member(
                rid, list(rec["addr"]), int(rec["generation"]), fence,
                now + self.lease_ttl_s, int(rec.get("page_size", 0)), now,
                role=rec.get("role", "unified"))
            self._fence_counter = max(self._fence_counter, fence)
        elif op == "tombstone":
            rid = rec["replica_id"]
            gen = int(rec["generation"])
            self._tombstones[rid] = max(self._tombstones.get(rid, -1), gen)
            m = self._members.get(rid)
            if m is not None and m.generation <= gen:
                self._drop_prefix_holdings(m)
                del self._members[rid]
        elif op == "promote":
            self.epoch = max(self.epoch, int(rec["epoch"]))
            self._fence_counter = max(self._fence_counter,
                                      int(rec["fence_counter"]))
            self.role = rec.get("role", self.role)

    def _apply_state(self, state: Dict[str, Any], now: float) -> None:
        """Fold a snapshot payload (or a ``repl_sync`` state) into the
        table. Caller holds the lock."""
        for row in state.get("members", ()):
            self._apply_record(dict(row, op="member"), now)
        for rid, gen in (state.get("tombstones") or {}).items():
            self._tombstones[rid] = max(self._tombstones.get(rid, -1),
                                        int(gen))
        self._fence_counter = max(self._fence_counter,
                                  int(state.get("fence_counter", 0)))

    def _recover(self) -> None:
        snap, records = self._wal.load()
        now = self._now()
        with self._lock:
            if snap is not None:
                self._apply_state(snap, now)
                self.epoch = max(self.epoch, int(snap.get("epoch", 0)))
                self.role = snap.get("role", self.role)
            for rec in records:
                self._apply_record(rec, now)
            # tombstones beat membership whatever order they landed in
            for rid, gen in self._tombstones.items():
                m = self._members.get(rid)
                if m is not None and m.generation <= gen:
                    self._drop_prefix_holdings(m)
                    del self._members[rid]
            self.counters["recovered_members"] = len(self._members)
            self.counters["wal_torn_truncated"] = \
                self._wal.stats["torn_records_truncated"]
            if self._members or snap is not None or records:
                self._event("recover", members=len(self._members),
                            fence_counter=self._fence_counter,
                            torn_truncated=self.counters[
                                "wal_torn_truncated"])

    def _require_primary(self, op: str) -> None:
        if self.role != PRIMARY:
            self.counters["not_primary_rejects"] += 1
            raise NotPrimary(f"{op} refused: this directory is a standby "
                             f"(epoch {self.epoch}); ask the primary")

    # --------------------------------------------- prefix directory

    def _repaint_prefix_index(self, m: _Member,
                              digest: List[int]) -> None:
        """Replace ``m``'s advertised holdings with ``digest``. Caller
        holds the lock."""
        new = {int(h) for h in digest}
        old = set(m.digest)
        for h in old - new:
            holders = self._prefix_index.get(h)
            if holders is not None:
                holders.discard(m.replica_id)
                if not holders:
                    del self._prefix_index[h]
        for h in new - old:
            self._prefix_index.setdefault(h, set()).add(m.replica_id)
        m.digest = sorted(new)

    def _drop_prefix_holdings(self, m: Optional[_Member]) -> None:
        if m is not None:
            self._repaint_prefix_index(m, [])

    def _tombstone(self, m: _Member) -> None:
        """Retire ``m``'s generation for good, durably. Caller holds the
        lock."""
        self._drop_prefix_holdings(m)
        del self._members[m.replica_id]
        self._tombstones[m.replica_id] = max(
            self._tombstones.get(m.replica_id, -1), m.generation)
        self._log({"op": "tombstone", "replica_id": m.replica_id,
                   "generation": m.generation})

    # ----------------------------------------------------- RPC surface

    def handle(self, method: str, args: Dict[str, Any],
               trace_id: Optional[str] = None) -> Any:
        fn = getattr(self, "rpc_" + method, None)
        if fn is None:
            raise UnknownMember(f"directory has no method {method}")
        return fn(**args)

    def rpc_ping(self) -> Dict[str, Any]:
        return {"ok": True, "members": len(self._members),
                "role": self.role, "epoch": self.epoch}

    def rpc_register(self, replica_id: str, addr: List[Any],
                     generation: int, page_size: int = 0,
                     min_fence: int = 0,
                     role: str = "unified") -> Dict[str, Any]:
        with self._lock:
            self._require_primary("register")
            if role not in ("prefill", "decode", "unified"):
                raise ValueError(f"unknown replica role {role!r}; "
                                 f"expected prefill/decode/unified")
            tomb = self._tombstones.get(replica_id)
            if tomb is not None and generation <= tomb:
                self.counters["zombie_register_rejects"] += 1
                raise StaleFencingToken(
                    f"register of {replica_id} gen {generation} "
                    f"rejected: generation <= {tomb} was already "
                    f"confirmed dead")
            cur = self._members.get(replica_id)
            if cur is not None and generation < cur.generation:
                self.counters["zombie_register_rejects"] += 1
                raise StaleFencingToken(
                    f"register of {replica_id} gen {generation} "
                    f"rejected: gen {cur.generation} is current")
            self._fence_counter = max(self._fence_counter,
                                      int(min_fence)) + 1
            fence = self._fence_counter
            now = self._now()
            self._drop_prefix_holdings(cur)
            self._members[replica_id] = _Member(
                replica_id, list(addr), int(generation), fence,
                now + self.lease_ttl_s, int(page_size), now, role=role)
            self.counters["registers"] += 1
            self._log({"op": "member", "replica_id": replica_id,
                       "addr": list(addr), "generation": int(generation),
                       "fence": fence, "page_size": int(page_size),
                       "role": role})
            self._event("fence_issued", replica_id=replica_id,
                        generation=int(generation), fence=fence)
            return {"fence": fence, "generation": int(generation),
                    "lease_ttl_s": self.lease_ttl_s}

    def rpc_renew(self, replica_id: str, fence: int,
                  digest: Optional[List[int]] = None,
                  load: Optional[Dict[str, Any]] = None,
                  wedged: bool = False) -> Dict[str, Any]:
        with self._lock:
            self._require_primary("renew")
            m = self._members.get(replica_id)
            if m is None:
                self.counters["unknown_member_rejects"] += 1
                raise UnknownMember(
                    f"renew from unregistered {replica_id} (directory "
                    f"restart or confirmed death); re-register")
            if int(fence) != m.fence:
                self.counters["stale_fence_rejects"] += 1
                raise StaleFencingToken(
                    f"renew of {replica_id} with fence {fence} "
                    f"rejected: current fence is {m.fence}")
            now = self._now()
            if now > m.lease_expires:
                self.counters["late_renewals"] += 1
            m.lease_expires = now + self.lease_ttl_s
            if digest is not None:
                self._repaint_prefix_index(m, list(digest))
            if load is not None:
                m.load = dict(load)
            if wedged and not m.wedged:
                self.counters["wedges_reported"] += 1
            m.wedged = bool(wedged)
            self.counters["renews"] += 1
            # renewals are not persisted: recovery re-arms leases fresh,
            # and the digest and load are soft state the next renewal
            # repaints
            return {"lease_ttl_s": self.lease_ttl_s}

    def rpc_deregister(self, replica_id: str,
                       fence: int) -> Dict[str, Any]:
        with self._lock:
            self._require_primary("deregister")
            m = self._members.get(replica_id)
            if m is None:
                raise UnknownMember(f"{replica_id} not registered")
            if int(fence) != m.fence:
                self.counters["stale_fence_rejects"] += 1
                raise StaleFencingToken(
                    f"deregister of {replica_id} with fence {fence} "
                    f"rejected: current fence is {m.fence}")
            self._tombstone(m)
            self.counters["deregisters"] += 1
            return {"ok": True}

    def rpc_confirm_dead(self, replica_id: str,
                         fence: int) -> Dict[str, Any]:
        """Adjudicate a router's suspicion. Dead means: unknown id, a
        superseded fence (the incarnation the router talked to is gone),
        or an expired lease (which this call then reaps). A member with
        a live lease is NOT dead, however the transport to it looked
        from the router's side."""
        with self._lock:
            self._require_primary("confirm_dead")
            m = self._members.get(replica_id)
            if m is None:
                return {"dead": True, "reason": "unknown"}
            if int(fence) != m.fence:
                return {"dead": True, "reason": "superseded",
                        "current_fence": m.fence}
            now = self._now()
            if now <= m.lease_expires:
                return {"dead": False,
                        "lease_remaining_s": m.lease_expires - now}
            self._tombstone(m)
            self.counters["confirmed_dead"] += 1
            return {"dead": True, "reason": "lease_expired",
                    "expired_for_s": now - m.lease_expires}

    def rpc_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            # routing reads are adjudication too: a standby's view may be
            # behind the primary's, so it refuses rather than serve stale
            # authority
            self._require_primary("snapshot")
            now = self._now()
            members = [{
                "replica_id": m.replica_id, "addr": m.addr,
                "generation": m.generation, "fence": m.fence,
                "lease_remaining_s": m.lease_expires - now,
                "expired": now > m.lease_expires,
                "wedged": m.wedged, "digest": m.digest,
                "load": m.load, "page_size": m.page_size,
                "role": m.role,
            } for m in self._members.values()]
            return {"members": members,
                    "fence_counter": self._fence_counter,
                    "lease_ttl_s": self.lease_ttl_s,
                    "epoch": self.epoch}

    def rpc_prefix_holders(self, hashes: List[int],
                           limit: int = 4) -> Dict[str, Any]:
        """Who can donate this prefix? ``hashes`` is the requester's
        rolling page-path-hash chain (``prefix_cache.path_hashes`` order:
        hash k covers pages 0..k). Holders are ranked by matched
        CONTIGUOUS prefix length, longest first; members with lapsed
        leases or a reported wedge never appear. Primary only, as
        ``snapshot``."""
        with self._lock:
            self._require_primary("prefix_holders")
            self.counters["prefix_queries"] += 1
            chain = [int(h) for h in hashes]
            out: List[Dict[str, Any]] = []
            if chain:
                now = self._now()
                for rid in self._prefix_index.get(chain[0], ()):
                    m = self._members.get(rid)
                    if m is None or now > m.lease_expires or m.wedged:
                        continue
                    n = 0
                    for h in chain:
                        if rid not in self._prefix_index.get(h, ()):
                            break
                        n += 1
                    out.append({"replica_id": rid,
                                "generation": m.generation,
                                "fence": m.fence,
                                "addr": list(m.addr),
                                "n_matched": n})
                out.sort(key=lambda r: (-r["n_matched"], r["replica_id"]))
                out = out[:max(1, int(limit))]
            if out:
                self.counters["prefix_hits"] += 1
            return {"holders": out}

    def rpc_stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"members": len(self._members),
                    "prefix_index_hashes": len(self._prefix_index),
                    "fence_counter": self._fence_counter,
                    "tombstones": dict(self._tombstones),
                    "counters": dict(self.counters),
                    "role": self.role, "epoch": self.epoch}
            if self._wal is not None:
                out["wal"] = dict(self._wal.stats)
            return out

    def rpc_events(self) -> Dict[str, Any]:
        with self._lock:
            return {"events": list(self.events)}

    def rpc_role(self) -> Dict[str, Any]:
        with self._lock:
            return {"role": self.role, "epoch": self.epoch,
                    "fence_counter": self._fence_counter,
                    "members": len(self._members)}

    def rpc_telemetry(self, cursor: int = 0,
                      limit: int = 256) -> Dict[str, Any]:
        """The scrape seam of the telemetry plane, control-plane side.
        Served by primaries and standbys alike (an operator needs the
        standby's view during a failover most of all). The directory's
        dict events go out in the common shape (seq/t/type/rid/data),
        so the collector merges them with the agents' and the router's
        event logs untranslated."""
        from ray_tpu_torch.util import metrics
        cursor = max(0, int(cursor))
        limit = max(1, int(limit))
        with self._lock:
            evs = list(self.events)
            total = self._event_seq
            role = self.role
            epoch = self.epoch
            fence = self._fence_counter
        oldest = evs[0]["seq"] if evs else total
        dropped = max(0, oldest - cursor)
        window = [e for e in evs if e["seq"] >= cursor][:limit]
        next_cursor = (window[-1]["seq"] + 1) if window \
            else max(cursor, total)
        events = [{"seq": e["seq"], "t": e["t"], "type": e["kind"],
                   "rid": e.get("replica_id"), "sid": None,
                   "data": {k: v for k, v in e.items()
                            if k not in ("seq", "t", "kind", "replica_id")}}
                  for e in window]
        return {
            "role": "directory",
            "replica_id": f"directory-{role}",
            "generation": epoch,
            "fence": fence,
            "state": role,
            "pid": os.getpid(),
            "clock": {"mono": time.monotonic(), "wall": time.time()},
            "metrics_text": metrics.prometheus_text(),
            "events": events,
            "cursor": next_cursor,
            "events_total": total,
            "dropped": dropped,
        }

    # ------------------------------------------------- replication

    def rpc_repl_sync(self, epoch: int, seq: int,
                      state: Dict[str, Any]) -> Dict[str, Any]:
        """Full-state bootstrap from the primary: replaces the standby's
        membership wholesale (the primary's table IS the truth while it
        lives)."""
        with self._lock:
            self._refuse_stale_epoch("repl_sync", epoch)
            self._members.clear()
            self._prefix_index.clear()
            self._apply_state(state, self._now())
            self.epoch = max(self.epoch, int(epoch))
            self._repl_last_seq = int(seq)
            self.counters["repl_syncs"] += 1
            if self._wal is not None:
                self._wal.snapshot(self._durable_payload())
            self._event("repl_sync", members=len(self._members),
                        fence_counter=self._fence_counter)
            return {"ok": True, "members": len(self._members)}

    def rpc_repl_apply(self, epoch: int, seq: int,
                       record: Dict[str, Any]) -> Dict[str, Any]:
        """Apply one membership delta streamed by the primary."""
        with self._lock:
            self._refuse_stale_epoch("repl_apply", epoch)
            if int(seq) != self._repl_last_seq + 1:
                self.counters["repl_gaps"] += 1
            self._repl_last_seq = int(seq)
            self._apply_record(record, self._now())
            self._persist(record)
            self.counters["repl_applied"] += 1
            if record.get("op") == "member":
                self._event("repl_member", replica_id=record.get("replica_id"),
                            fence=int(record.get("fence", 0)))
            return {"ok": True, "seq": self._repl_last_seq}

    def _refuse_stale_epoch(self, op: str, epoch: int) -> None:
        """A primary, or a standby already past ``epoch``, takes no
        replication: the sender is a superseded primary. Caller holds
        the lock."""
        if self.role == PRIMARY or int(epoch) < self.epoch:
            self.counters["repl_stale_epoch_rejects"] += 1
            raise StaleFencingToken(
                f"{op} at epoch {epoch} rejected: this directory is "
                f"{self.role} at epoch {self.epoch}")

    def rpc_promote(self, reason: str = "",
                    min_fence: int = 0) -> Dict[str, Any]:
        """Make a standby the primary. The epoch bump is FOLDED INTO the
        fence counter: the new primary's first token clears every token
        the old primary could have issued unreplicated. Idempotent:
        promoting a primary is an answer, not an error."""
        with self._lock:
            if self.role == PRIMARY:
                return {"promoted": False, "role": self.role,
                        "epoch": self.epoch,
                        "fence_counter": self._fence_counter}
            fence_before = self._fence_counter
            self.epoch += 1
            self._fence_counter = (max(self._fence_counter, int(min_fence))
                                   + FENCE_EPOCH_STRIDE)
            self.role = PRIMARY
            now = self._now()
            for m in self._members.values():
                # the replicated members' agents renewed with the DEAD
                # primary: each gets a whole TTL to find this one
                m.lease_expires = now + self.lease_ttl_s
            self.counters["promotions"] += 1
            self._persist({"op": "promote", "epoch": self.epoch,
                           "fence_counter": self._fence_counter,
                           "role": PRIMARY})
            if self._wal is not None:
                self._wal.snapshot(self._durable_payload())
            self._event("promote", reason=reason, fence_before=fence_before,
                        fence_after=self._fence_counter,
                        members=len(self._members))
            return {"promoted": True, "role": self.role, "epoch": self.epoch,
                    "fence_counter": self._fence_counter,
                    "fence_before": fence_before,
                    "members": len(self._members)}


class DirectoryClient:
    """Typed client wrapper over any transport to a directory."""

    def __init__(self, transport: Transport, timeout_s: float = 2.0):
        self._t = transport
        self._timeout_s = timeout_s

    def _call(self, method: str, args: Dict[str, Any]) -> Any:
        return self._t.call(method, args, timeout_s=self._timeout_s)

    def ping(self) -> Dict[str, Any]:
        return self._call("ping", {})

    def register(self, replica_id: str, addr: List[Any],
                 generation: int, page_size: int = 0,
                 min_fence: int = 0,
                 role: str = "unified") -> Dict[str, Any]:
        return self._call("register", {
            "replica_id": replica_id, "addr": addr,
            "generation": generation, "page_size": page_size,
            "min_fence": min_fence, "role": role})

    def renew(self, replica_id: str, fence: int,
              digest: Optional[List[int]] = None,
              load: Optional[Dict[str, Any]] = None,
              wedged: bool = False) -> Dict[str, Any]:
        return self._call("renew", {
            "replica_id": replica_id, "fence": fence, "digest": digest,
            "load": load, "wedged": wedged})

    def deregister(self, replica_id: str, fence: int) -> Dict[str, Any]:
        return self._call("deregister",
                          {"replica_id": replica_id, "fence": fence})

    def confirm_dead(self, replica_id: str,
                     fence: int) -> Dict[str, Any]:
        return self._call("confirm_dead",
                          {"replica_id": replica_id, "fence": fence})

    def snapshot(self) -> Dict[str, Any]:
        return self._call("snapshot", {})

    def prefix_holders(self, hashes: List[int],
                       limit: int = 4) -> Dict[str, Any]:
        return self._call("prefix_holders",
                          {"hashes": list(hashes), "limit": limit})

    def stats(self) -> Dict[str, Any]:
        return self._call("stats", {})

    def events(self) -> Dict[str, Any]:
        return self._call("events", {})

    def role(self) -> Dict[str, Any]:
        return self._call("role", {})

    def telemetry(self, cursor: int = 0, limit: int = 256) -> Dict[str, Any]:
        return self._call("telemetry", {"cursor": cursor, "limit": limit})

    def promote(self, reason: str = "",
                min_fence: int = 0) -> Dict[str, Any]:
        return self._call("promote", {"reason": reason,
                                      "min_fence": min_fence})


def _host_port(spec: str) -> tuple:
    host, _, port = spec.rpartition(":")
    return host or "127.0.0.1", int(port)


def main(argv: Optional[List[str]] = None) -> None:
    """Process entry (see the module docstring). Prints ``READY <port>``
    once listening, then serves until killed."""
    import argparse

    from ray_tpu_torch.serve.fleet.transport import (SocketServer,
                                                     SocketTransport)

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--lease-ttl-s", type=float, default=1.0)
    ap.add_argument("--data-dir", default=None,
                    help="arm the WAL and snapshot here")
    ap.add_argument("--snapshot-every", type=int, default=64)
    ap.add_argument("--role", choices=(PRIMARY, STANDBY), default=PRIMARY)
    ap.add_argument("--standby", action="append", default=[],
                    metavar="HOST:PORT",
                    help="a standby to replicate to (primary side; "
                         "repeatable)")
    ap.add_argument("--peer", default=None, metavar="HOST:PORT",
                    help="the primary to watch (standby side)")
    ap.add_argument("--promote-after-s", type=float, default=3.0)
    args = ap.parse_args(argv)

    replicator = None
    if args.standby:
        from ray_tpu_torch.serve.fleet.replication import Replicator
        replicator = Replicator([SocketTransport(_host_port(s))
                                 for s in args.standby])
    directory = FleetDirectory(lease_ttl_s=args.lease_ttl_s,
                               data_dir=args.data_dir,
                               snapshot_every=args.snapshot_every,
                               role=args.role, replicator=replicator)
    if replicator is not None:
        replicator.attach(directory).start()
    monitor = None
    if args.role == STANDBY and args.peer:
        from ray_tpu_torch.serve.fleet.replication import StandbyMonitor
        monitor = StandbyMonitor(directory,
                                 SocketTransport(_host_port(args.peer)),
                                 promote_after_s=args.promote_after_s).start()
    server = SocketServer(directory.handle, host=args.host, port=args.port)
    print(f"READY {server.addr[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if monitor is not None:
            monitor.stop()
        if replicator is not None:
            replicator.stop()
        server.stop()


if __name__ == "__main__":
    main()
