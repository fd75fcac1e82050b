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

The reference's durability and hot standby (``data_dir``, ``replicator``,
``role="standby"``, the ``repl_*`` and ``promote`` RPCs) and its
telemetry scrape wait for the second and third fleet slices
(ROADMAP.md, queue 1, item 9); each raises ``NotImplementedError``
naming its slice. Run as a process:

    python -m ray_tpu_torch.serve.fleet.directory [--port N]
        [--lease-ttl-s S]

prints ``READY <port>`` once listening.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.fleet.transport import Transport
from ray_tpu_torch.serve.fleet.wire import StaleFencingToken, UnknownMember

PRIMARY = "primary"

_SLICE_2 = ("waits for the fleet's second slice (the WAL and the hot "
            "standby; ROADMAP.md, queue 1, item 9)")
_SLICE_3 = ("waits for the fleet's third slice (telemetry; ROADMAP.md, "
            "queue 1, item 9)")


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
        if data_dir is not None:
            raise NotImplementedError(f"FleetDirectory(data_dir=) "
                                      f"{_SLICE_2}")
        if replicator is not None or role != PRIMARY:
            raise NotImplementedError(
                f"FleetDirectory(replicator=, role={role!r}) {_SLICE_2}")
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
        # a slice-1 directory is always the primary of epoch 0; the
        # standby's role and the epochs of a failover come with slice 2
        self.role = role
        self.epoch = 0
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

    def _event(self, kind: str, **fields) -> None:
        ev = {"seq": self._event_seq, "t": round(self._now(), 4),
              "kind": kind, "epoch": self.epoch}
        self._event_seq += 1
        ev.update(fields)
        self.events.append(ev)

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
        """Retire ``m``'s generation for good. Caller holds the lock."""
        self._drop_prefix_holdings(m)
        del self._members[m.replica_id]
        self._tombstones[m.replica_id] = max(
            self._tombstones.get(m.replica_id, -1), m.generation)

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
            self._event("fence_issued", replica_id=replica_id,
                        generation=int(generation), fence=fence)
            return {"fence": fence, "generation": int(generation),
                    "lease_ttl_s": self.lease_ttl_s}

    def rpc_renew(self, replica_id: str, fence: int,
                  digest: Optional[List[int]] = None,
                  load: Optional[Dict[str, Any]] = None,
                  wedged: bool = False) -> Dict[str, Any]:
        with self._lock:
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
            return {"lease_ttl_s": self.lease_ttl_s}

    def rpc_deregister(self, replica_id: str,
                       fence: int) -> Dict[str, Any]:
        with self._lock:
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
        leases or a reported wedge never appear."""
        with self._lock:
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
            return {"members": len(self._members),
                    "prefix_index_hashes": len(self._prefix_index),
                    "fence_counter": self._fence_counter,
                    "tombstones": dict(self._tombstones),
                    "counters": dict(self.counters),
                    "role": self.role, "epoch": self.epoch}

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
        raise NotImplementedError(f"the directory's telemetry {_SLICE_3}")

    def rpc_repl_sync(self, epoch: int, seq: int,
                      state: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError(f"repl_sync {_SLICE_2}")

    def rpc_repl_apply(self, epoch: int, seq: int,
                       record: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError(f"repl_apply {_SLICE_2}")

    def rpc_promote(self, reason: str = "",
                    min_fence: int = 0) -> Dict[str, Any]:
        raise NotImplementedError(f"promote {_SLICE_2}")


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


def main(argv: Optional[List[str]] = None) -> None:
    """Process entry: ``python -m ray_tpu_torch.serve.fleet.directory
    [--host H] [--port N] [--lease-ttl-s S]``. Prints ``READY <port>``
    once listening, then serves until killed."""
    import argparse

    from ray_tpu_torch.serve.fleet.transport import SocketServer

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--lease-ttl-s", type=float, default=1.0)
    args = ap.parse_args(argv)
    directory = FleetDirectory(lease_ttl_s=args.lease_ttl_s)
    server = SocketServer(directory.handle, host=args.host,
                          port=args.port)
    print(f"READY {server.addr[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
