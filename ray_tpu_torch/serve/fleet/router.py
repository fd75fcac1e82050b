"""Port of ``ray_tpu/serve/fleet/router.py``: ``FleetRouter``, the
engine pool's routing over a transport.

The router owns NO engines. It reads the directory's membership
snapshot (lease-fenced members advertising prefix digests and load
reports), runs the SAME selection policy as ``EnginePool``
(``fleet.routing.select_candidate``: sticky, then affinity or spill,
then P2C) and speaks to the chosen ``ReplicaAgent`` through a transport
with per-call timeouts and exponential-backoff retries.

- A **transport error** is only a DEATH CANDIDATE: the router asks the
  directory (``confirm_dead``), which answers from lease state. Alive:
  keep polling the same request. Dead: the at-most-once path, a request
  with zero tokens delivered resubmits token-identically to another
  agent, anything else fails typed ``EngineShutdown``.
- **Streams are cursor-polled**: submit returns a request id,
  ``poll(rid, cursor)`` the tokens past the cursor. A duplicated poll
  re-reads, and a duplicated submit is deduplicated agent-side by the
  router-minted request key.
- Every **confirmed death** is an event and, with ``flight_dir``, a
  flight bundle (router events and the directory's verdict); with a
  ``telemetry_collector`` attached (fleet/telemetry.py) also a cluster
  bundle of every reachable member.
- **A lapsed lease in a snapshot is adjudicated at once**
  (``confirm_dead``), so a member that died with no request of this
  router on it is tombstoned too; the reference only skips it.
- **Routes since an advertisement count as load.** An agent's load
  report is as old as its last renewal (up to a third of the lease
  TTL), so the router adds the tokens (prompt + budget) of the
  requests it routed to a member after that renewal to the member's
  advertised ``outstanding_tokens``. The reference reads the report
  alone and so sends every request of a burst to the member that
  looked idlest at its last renewal; with fresh advertisements both
  pick the same routes.

The autoscaler drives a router as it drives an ``EnginePool``:
``add_replica_for_ticket`` adopts an agent a capacity provider started
(``provider.py``), ``scale_down`` drains and retires only such agents,
and ``capacity_hint_fn`` (the autoscaler's provisioning ETA) joins the
Retry-After hints of both refusals.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch.serve import obs
from ray_tpu_torch.serve.errors import (DeadlineExceeded, EngineDraining,
                                        EngineOverloaded, EngineShutdown,
                                        RequestCancelled)
from ray_tpu_torch.serve.fleet import wire
from ray_tpu_torch.serve.fleet.agent import AgentClient
from ray_tpu_torch.serve.fleet.directory import DirectoryClient
from ray_tpu_torch.serve.fleet.routing import (Candidate, ResubmitPolicy,
                                               select_candidate)
from ray_tpu_torch.serve.fleet.transport import Transport, TransportError
from ray_tpu_torch.serve.prefix_cache import path_hashes


class _Member:
    """Router-side view of one directory member (one incarnation:
    replica id + fence)."""

    __slots__ = ("replica_id", "addr", "generation", "fence",
                 "page_size", "report", "advertised_at")

    def __init__(self, m: Dict[str, Any], advertised_at: float = 0.0):
        self.replica_id = m["replica_id"]
        self.addr = tuple(m["addr"])
        self.generation = int(m["generation"])
        self.fence = int(m["fence"])
        self.page_size = int(m.get("page_size") or 0)
        rpt = dict(m.get("load") or {})
        rpt["prefix_digest"] = frozenset(m.get("digest") or ())
        rpt.setdefault("outstanding_tokens", 0)
        rpt.setdefault("queue_depth", 0)
        rpt.setdefault("max_queued", None)
        rpt.setdefault("shed_retry_after_s", 0.05)
        # a member that has never renewed routes with the role it
        # registered under
        rpt.setdefault("role", m.get("role", "unified"))
        self.report = rpt
        # when (router clock) the agent renewed the advertised report
        self.advertised_at = advertised_at

    @property
    def role(self) -> str:
        return self.report.get("role") or "unified"


class FleetRequestHandle(ResubmitPolicy):
    """The pool handle's surface (stream/result/cancel/done/error/
    ttft_s) implemented by polling the serving agent, with the shared
    at-most-once resubmit core."""

    def __init__(self, router: "FleetRouter", prompt: List[int],
                 max_new_tokens: int, deadline_s: Optional[float],
                 session_id: Optional[str], trace_id: Optional[str]):
        super().__init__(prompt, max_new_tokens, deadline_s, session_id,
                         trace_id, max_resubmits=router.max_resubmits)
        self._router = router
        self._member: Optional[_Member] = None
        self._rid: Optional[str] = None
        self._cursor = 0

    def stream(self):
        r = self._router
        while True:
            death_cause: Optional[BaseException] = None
            patience = r.transport_patience_s
            t_trouble: Optional[float] = None
            try:
                while True:
                    try:
                        resp = r._agent(self._member).poll(
                            self._rid, cursor=self._cursor,
                            trace_id=self._trace_id,
                            timeout_s=r.call_timeout_s)
                    except TransportError as e:
                        # death candidate: the directory adjudicates
                        if r._confirm_dead(self._member, e) is True:
                            raise
                        now = time.monotonic()
                        if t_trouble is None:
                            t_trouble = now
                        if now - t_trouble > patience:
                            raise EngineShutdown(
                                f"agent {self._member.replica_id} "
                                f"unreachable for {patience:.1f}s and the "
                                f"directory cannot confirm its death"
                            ) from e
                        # alive or inconclusive: the agent may still be
                        # serving this request, so re-poll
                        time.sleep(r.retry_backoff_s)
                        continue
                    t_trouble = None
                    if resp.get("error") is not None:
                        # tokens riding a failed response were never
                        # delivered: a zero-delivery request stays
                        # eligible for resubmission
                        wire.raise_error(resp["error"])
                    for tok in resp["tokens"]:
                        self._cursor += 1
                        self._note_token(tok)
                        yield tok
                    if resp.get("done"):
                        self._finished = True
                        return
                    time.sleep(r.poll_interval_s)
            except GeneratorExit:
                raise
            except (RequestCancelled, DeadlineExceeded) as e:
                self._fail(e)
                raise
            except (TransportError, EngineShutdown, EngineDraining,
                    wire.WireError) as e:
                # the serving incarnation is gone: confirmed dead over
                # the transport, fenced (AgentFenced is an
                # EngineDraining), force-killed (its raw error crosses as
                # a WireError) or rebuilt (unknown rid)
                death_cause = e
            except EngineOverloaded as e:
                self._fail(e)
                raise
            r._note_request_death(self._member, death_cause,
                                  trace_id=self._trace_id)
            if self._generated or self._cancelled:
                raise self._partial_stream_error(
                    self._member.replica_id, death_cause) from death_cause
            self._resubmit(death_cause)

    def cancel(self) -> bool:
        self._cancelled = True
        member, rid = self._member, self._rid
        if member is None or rid is None:
            return False
        try:
            return bool(self._router._agent(member).cancel(rid)
                        .get("cancelled"))
        except Exception:   # noqa: BLE001
            return False

    @property
    def replica_idx(self) -> Optional[str]:
        return self._member.replica_id if self._member is not None else None

    @property
    def replica_tag(self) -> Optional[str]:
        """``<replica_id>:<generation>`` of the serving agent."""
        if self._member is None:
            return None
        return f"{self._member.replica_id}:{self._member.generation}"

    def _resubmit(self, cause: BaseException) -> None:
        deadline = self._check_resubmit(cause)
        self._router._count_requeue(trace_id=self._trace_id)
        try:
            self._member, self._rid = self._router._submit_once(
                self._prompt, self._mnt, deadline, self._session_id,
                self._trace_id, exclude={self._member.replica_id})
            self._cursor = 0
        except BaseException as e:
            self._fail(e)
            raise

    def _attach(self, member: _Member, rid: str) -> None:
        self._member, self._rid = member, rid
        self._cursor = 0


class FleetRouter:
    """Routes requests to ReplicaAgents by the FleetDirectory's
    advertised state, behind ``EnginePool``'s submit surface.

    directory: a ``DirectoryClient`` over any transport, or a
        ``replication.FailoverDirectoryClient`` over an ordered endpoint
        list (the primary first, then its standbys), which fails over
        client-side UNDER the stale-snapshot fallback here: the router
        falls back to its cache only when every endpoint refused.
    transport_factory: ``f(addr_tuple) -> Transport``, the client leg to
        one agent (a loopback registry or a socket dial); cached per
        address.
    call_timeout_s, submit_retries, retry_backoff_s: per-RPC deadline and
        exponential-backoff retry; a retried submit reuses its request
        key, so the agent admits it at most once.
    max_resubmits: per-request cap on death-triggered resubmissions.
    snapshot_ttl_s: how long a directory snapshot is trusted; a failed
        refresh falls back to the stale cache.
    transport_patience_s: how long a request re-polls an unreachable
        agent the directory will not declare dead before failing typed
        (set it above the lease TTL, or a killed agent's requests fail
        before its death can be confirmed).
    """

    def __init__(self, directory: DirectoryClient,
                 transport_factory: Callable[[Tuple], Transport], *,
                 seed: int = 0, call_timeout_s: float = 2.0,
                 submit_retries: int = 2,
                 retry_backoff_s: float = 0.02,
                 max_resubmits: int = 3,
                 snapshot_ttl_s: float = 0.05,
                 poll_interval_s: float = 0.004,
                 transport_patience_s: float = 10.0,
                 max_sticky_sessions: int = 4096,
                 flight_dir: Any = None):
        self._directory = directory
        self._transport_factory = transport_factory
        self._rng = random.Random(seed)
        self.call_timeout_s = float(call_timeout_s)
        self.submit_retries = int(submit_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_resubmits = int(max_resubmits)
        self.snapshot_ttl_s = float(snapshot_ttl_s)
        self.poll_interval_s = float(poll_interval_s)
        self.transport_patience_s = float(transport_patience_s)
        self._max_sticky = max_sticky_sessions
        self.flight_dir = flight_dir
        self._lock = threading.Lock()
        self._clients: Dict[Tuple, AgentClient] = {}
        self._snapshot_cache: Optional[Dict[str, _Member]] = None
        self._snapshot_t = 0.0
        self._lease_ttl = 1.0
        # replica_id -> [(router time, tokens)] of the routes to it not
        # yet older than its last advertisement
        self._recent: Dict[str, List[Tuple[float, int]]] = {}
        self._sticky: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._dead_seen: set = set()
        self._seq = 0
        # the autoscaler's surface: idx -> replica_id of the members the
        # autoscaler added (the only scale_down candidates), and the
        # provisioning ETA hook PoolAutoscaler installs
        self._scaled: Dict[int, str] = {}
        self._scale_seq = 0
        self.capacity_hint_fn: Optional[Callable[[], float]] = None
        self.events = obs.EventLog(2048, name="router")
        # set by TelemetryCollector.attach(): a confirmed death then
        # writes a cluster bundle too, not only this process's view
        self.telemetry_collector = None
        self.counters = {"routed": 0, "requeues": 0,
                         "deaths_confirmed": 0, "suspects": 0,
                         "confirm_inconclusive": 0,
                         "stale_snapshots": 0, "all_shed": 0,
                         "submit_retries": 0,
                         "snapshot_hits": 0, "snapshot_misses": 0,
                         "member_invalidations": 0,
                         "pull_hints": 0}
        self._stopped = False

    # --------------------------------------------------------- submit

    def submit(self, prompt_ids, max_new_tokens: int = 64,
               deadline_s: Optional[float] = None,
               session_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> FleetRequestHandle:
        if self._stopped:
            raise EngineShutdown("fleet router stopped")
        prompt = [int(t) for t in prompt_ids]
        self.events.append("submit", sid=session_id,
                           data={"trace_id": trace_id,
                                 "n_prompt": len(prompt),
                                 "max_new_tokens": int(max_new_tokens)})
        h = FleetRequestHandle(self, prompt, max_new_tokens, deadline_s,
                               session_id, trace_id)
        member, rid = self._submit_once(prompt, max_new_tokens,
                                        deadline_s, session_id, trace_id,
                                        exclude=set())
        h._attach(member, rid)
        return h

    def _mint_key(self) -> str:
        with self._lock:
            self._seq += 1
            return f"req-{id(self):x}-{self._seq}"

    def _submit_once(self, prompt: List[int], max_new_tokens: int,
                     deadline_s: Optional[float],
                     session_id: Optional[str],
                     trace_id: Optional[str],
                     exclude: set) -> Tuple[_Member, str]:
        """Route + submit until one agent admits; a typed aggregate
        failure when none can (the pool's ``_submit_once`` over a
        transport)."""
        exclude = set(exclude)
        shed: List[EngineOverloaded] = []
        while True:
            members = self._members(exclude)
            sticky_id = (self._sticky.get(session_id)
                         if session_id is not None else None)
            if sticky_id is not None:
                st = members.get(sticky_id)
                if st is not None and st.role == "prefill":
                    # a session never pins to a prefill-only member
                    with self._lock:
                        self._sticky.pop(session_id, None)
                    sticky_id = None
            route = (time.monotonic(), len(prompt) + int(max_new_tokens))
            with self._lock:
                # one critical section from the reports to the record of
                # the pick: concurrent submits see each other's routes
                cands = [Candidate(m.replica_id, self._report_locked(m),
                                   m.page_size)
                         for m in members.values()]
                pick, decision = select_candidate(
                    cands, prompt, sticky_key=sticky_id, rng=self._rng)
                if pick is not None:
                    self._recent.setdefault(pick.key, []).append(route)
            if pick is None:
                raise self._unroutable(decision, shed)
            member = members[pick.key]
            pull = self._pull_hint(prompt, member, members)
            key = self._mint_key()
            try:
                resp = self._call_with_retry(
                    lambda c, m=member, k=key, p=pull: c.submit(
                        k, prompt, max_new_tokens, deadline_s=deadline_s,
                        fence=m.fence, pull=p, trace_id=trace_id,
                        timeout_s=self.call_timeout_s),
                    member)
            except TransportError as e:
                self._unroute(member, route)
                self._suspect(member, e)
                if self._confirm_dead(member, e) is not True:
                    # transient or unconfirmable: evict only the suspect
                    # from the cache
                    self._invalidate_member(member.replica_id)
                exclude.add(member.replica_id)
                continue
            except EngineOverloaded as e:
                self._unroute(member, route)
                shed.append(e)
                exclude.add(member.replica_id)
                continue
            except (EngineShutdown, EngineDraining) as e:
                # fenced / draining / stale fence: evict + reroute
                self._unroute(member, route)
                self._invalidate_member(member.replica_id)
                self._note_request_death(member, e, trace_id=trace_id,
                                         submit_side=True)
                exclude.add(member.replica_id)
                continue
            self._record_route(member, decision, session_id,
                               trace_id=trace_id)
            return member, resp["rid"]

    def _report_locked(self, m: _Member) -> Dict[str, Any]:
        """``m``'s advertised report, its ``outstanding_tokens`` raised by
        the tokens routed to it since it was advertised. Caller holds
        the lock."""
        recent = [r for r in self._recent.get(m.replica_id, ())
                  if r[0] > m.advertised_at]
        self._recent[m.replica_id] = recent
        extra = sum(tokens for _, tokens in recent)
        if not extra:
            return m.report
        return dict(m.report, outstanding_tokens=(
            m.report.get("outstanding_tokens", 0) + extra))

    def _unroute(self, member: _Member, route: Tuple[float, int]) -> None:
        """Forget a route whose submit failed."""
        with self._lock:
            recent = self._recent.get(member.replica_id, [])
            if route in recent:
                recent.remove(route)

    def _unroutable(self, decision: Dict[str, Any],
                    shed: List[EngineOverloaded]) -> BaseException:
        """The typed error of a request no member can admit: every live
        agent shed (``EngineOverloaded`` with the largest retry hint), or
        none is live (``EngineShutdown``, retry after a lease period)."""
        hints = list(decision.get("hints", []))
        hints += [e.retry_after_s for e in shed]
        # while an autoscaler provisions, its ETA joins the hints: no
        # client is invited back before the capacity that would serve it
        # can exist
        eta = self._capacity_eta()
        if hints:
            if eta > 0:
                hints.append(eta)
            self.counters["all_shed"] += 1
            err = EngineOverloaded(
                f"all live agents shed (retry hints "
                f"{sorted(set(round(h, 3) for h in hints))})",
                retry_after_s=max(hints))
            if shed:
                err.__cause__ = shed[-1]
                err.__suppress_context__ = True
            return err
        err2 = EngineShutdown("no live agents in the fleet directory")
        # a lease period from now is the soonest a restarted agent could
        # re-advertise, unless provisioning is pending and further out
        err2.retry_after_s = max(
            self._lease_ttl if self._snapshot_cache is not None else 1.0,
            eta)
        return err2

    def _capacity_eta(self) -> float:
        fn = self.capacity_hint_fn
        if fn is None:
            return 0.0
        try:
            eta = float(fn() or 0.0)
        except Exception:   # noqa: BLE001 - a broken hint is no hint
            return 0.0
        return eta if 0 < eta < float("inf") else 0.0

    def _pull_hint(self, prompt: List[int], member: _Member,
                   members: Dict[str, _Member]
                   ) -> Optional[Dict[str, Any]]:
        """When another live member advertises a strictly longer
        contiguous prefix of this prompt than the chosen target, a pull
        hint naming that donor (from the snapshot's digests, no extra
        round-trip; a stale digest costs a failed pull that degrades to
        plain prefill)."""
        Pg = member.page_size
        if Pg <= 0 or len(prompt) < Pg:
            return None
        chain = path_hashes(prompt, Pg)
        best: Optional[_Member] = None
        best_n = self._digest_cover(chain, member)
        for rid, m in members.items():
            if rid == member.replica_id or m.page_size != Pg:
                continue
            n = self._digest_cover(chain, m)
            if n > best_n:
                best, best_n = m, n
        if best is None:
            return None
        with self._lock:
            self.counters["pull_hints"] += 1
        return {"hashes": chain[:best_n], "addr": list(best.addr),
                "replica_id": best.replica_id,
                "generation": best.generation}

    @staticmethod
    def _digest_cover(chain: List[int], m: _Member) -> int:
        have = m.report.get("prefix_digest") or frozenset()
        n = 0
        for h in chain:
            if h not in have:
                break
            n += 1
        return n

    def _call_with_retry(self, fn: Callable[[AgentClient], Any],
                         member: _Member) -> Any:
        """Per-call timeout + exponential backoff. Only transport errors
        retry (typed refusals are answers); the LAST one propagates."""
        backoff = self.retry_backoff_s
        client = self._agent(member)
        last: Optional[TransportError] = None
        for attempt in range(self.submit_retries + 1):
            try:
                return fn(client)
            except TransportError as e:
                last = e
                if attempt < self.submit_retries:
                    self.counters["submit_retries"] += 1
                    time.sleep(backoff)
                    backoff *= 2
        raise last

    # ------------------------------------------------------ membership

    def _members(self, exclude: set) -> Dict[str, _Member]:
        return {rid: m for rid, m in self._snapshot().items()
                if rid not in exclude}

    def _snapshot(self) -> Dict[str, _Member]:
        now = time.monotonic()
        with self._lock:
            cached = self._snapshot_cache
            if (cached is not None
                    and now - self._snapshot_t < self.snapshot_ttl_s):
                self.counters["snapshot_hits"] += 1
                return cached
            self.counters["snapshot_misses"] += 1
        try:
            raw = self._directory.snapshot()
        except Exception:   # noqa: BLE001
            # directory unreachable: serve from the stale cache
            self.counters["stale_snapshots"] += 1
            with self._lock:
                return dict(self._snapshot_cache or {})
        members: Dict[str, _Member] = {}
        lapsed: List[_Member] = []
        ttl = float(raw.get("lease_ttl_s", 1.0))
        for m in raw.get("members", []):
            if m.get("expired"):
                lapsed.append(_Member(m))
                continue
            if m.get("wedged"):
                continue
            if (m.get("load") or {}).get("state") == "fenced":
                continue
            # the lease was renewed (and the report advertised) a TTL
            # before it runs out: a duration, so no clock is shared
            mm = _Member(m, now - (ttl - float(
                m.get("lease_remaining_s", ttl))))
            if mm.report.get("stopped") or mm.report.get("draining"):
                continue
            members[mm.replica_id] = mm
        self._lease_ttl = ttl
        with self._lock:
            self._snapshot_cache = members
            self._snapshot_t = now
        for m in lapsed:
            # a lapsed lease is a death candidate nobody may route to:
            # have the directory adjudicate it now, not only when a
            # request of it meets a transport error
            self._confirm_dead(m, EngineShutdown(
                f"{m.replica_id}'s lease lapsed in the directory"))
        return members

    def _invalidate_snapshot(self) -> None:
        with self._lock:
            self._snapshot_t = 0.0

    def _invalidate_member(self, replica_id: str) -> None:
        """Evict ONE member from the snapshot cache, leaving the rest
        trusted until the TTL."""
        with self._lock:
            self.counters["member_invalidations"] += 1
            cache = self._snapshot_cache
            if cache is not None and replica_id in cache:
                # copy-on-write: readers may be iterating the old map
                cache = dict(cache)
                del cache[replica_id]
                self._snapshot_cache = cache

    def _agent(self, member: _Member) -> AgentClient:
        with self._lock:
            c = self._clients.get(member.addr)
            if c is None:
                c = AgentClient(self._transport_factory(member.addr),
                                timeout_s=self.call_timeout_s)
                self._clients[member.addr] = c
            return c

    # -------------------------------------------------- death handling

    def _suspect(self, member: _Member, cause: BaseException) -> None:
        self.counters["suspects"] += 1
        self.events.append("suspect", sid=member.replica_id,
                           data={"fence": member.fence,
                                 "cause": type(cause).__name__})

    def _confirm_dead(self, member: _Member,
                      cause: BaseException) -> Optional[bool]:
        """Ask the directory whether this incarnation is dead: True or
        False on a verdict, None when the directory itself is
        unreachable (inconclusive, NEVER grounds for a resubmit)."""
        try:
            v = self._directory.confirm_dead(member.replica_id,
                                             member.fence)
        except Exception:   # noqa: BLE001
            self.counters["confirm_inconclusive"] += 1
            return None
        if not v.get("dead"):
            return False
        self._on_confirmed_death(member, v, cause)
        return True

    def _on_confirmed_death(self, member: _Member,
                            verdict: Dict[str, Any],
                            cause: BaseException) -> None:
        tag = (member.replica_id, member.fence)
        with self._lock:
            if tag in self._dead_seen:
                return
            self._dead_seen.add(tag)
            self.counters["deaths_confirmed"] += 1
            for k in [k for k, v in self._sticky.items()
                      if v == member.replica_id]:
                del self._sticky[k]
        self._invalidate_member(member.replica_id)
        self.events.append("member_dead", sid=member.replica_id,
                           data={"fence": member.fence,
                                 "generation": member.generation,
                                 "reason": verdict.get("reason"),
                                 "cause": type(cause).__name__})
        if self.flight_dir:
            try:
                obs.dump_flight_bundle(
                    self.flight_dir, f"agent-dead-{member.replica_id}",
                    pool=self,
                    extra={"replica_id": member.replica_id,
                           "fence": member.fence,
                           "generation": member.generation,
                           "verdict": verdict, "cause": repr(cause)})
            except Exception:   # noqa: BLE001
                pass
        if self.telemetry_collector is not None:
            try:
                self.telemetry_collector.on_fault(
                    f"agent-dead-{member.replica_id}",
                    trigger={"kind": "confirmed_death",
                             "replica_id": member.replica_id,
                             "generation": member.generation,
                             "fence": member.fence,
                             "cause": type(cause).__name__})
            except Exception:   # noqa: BLE001 - a recorder never breaks
                pass            # the death path

    def _note_request_death(self, member: _Member, cause: BaseException,
                            trace_id: Optional[str] = None,
                            submit_side: bool = False) -> None:
        self.events.append("replica_death", sid=member.replica_id,
                           data={"cause": type(cause).__name__,
                                 "submit_side": submit_side,
                                 "trace_id": trace_id})

    def _count_requeue(self, trace_id: Optional[str] = None) -> None:
        with self._lock:
            self.counters["requeues"] += 1
        self.events.append("resubmit", data={"trace_id": trace_id}
                           if trace_id is not None else None)

    def _record_route(self, member: _Member, decision: Dict[str, Any],
                      session_id: Optional[str],
                      trace_id: Optional[str] = None) -> None:
        self.events.append("route", sid=member.replica_id,
                           data={"kind": decision["kind"],
                                 "pages": decision.get("pages", 0),
                                 "spilled": bool(decision.get("spilled")),
                                 "trace_id": trace_id})
        with self._lock:
            self.counters["routed"] += 1
            if session_id is not None and member.role != "prefill":
                self._sticky[session_id] = member.replica_id
                self._sticky.move_to_end(session_id)
                while len(self._sticky) > self._max_sticky:
                    self._sticky.popitem(last=False)

    # ---------------------------------------------------- aggregation

    @property
    def stats(self) -> Dict[str, int]:
        """The counters, under the engine's ``stats`` name."""
        with self._lock:
            return dict(self.counters)

    def load_report(self) -> Dict[str, Any]:
        """Fleet-aggregate load report (the pool's shape, summed over
        the live members' advertised reports)."""
        members = self._snapshot()
        out: Dict[str, Any] = {
            "replicas": len(members), "healthy_replicas": len(members),
            "free_slots": 0, "total_slots": 0, "queue_depth": 0,
            "outstanding_tokens": 0, "shed_total": 0,
            "ttft_ewma_s": None, "draining": False,
            "stopped": not members}
        for m in members.values():
            for k in ("free_slots", "total_slots", "queue_depth",
                      "outstanding_tokens", "shed_total"):
                v = m.report.get(k)
                if isinstance(v, (int, float)):
                    out[k] += v
            ttft = m.report.get("ttft_ewma_s")
            if isinstance(ttft, (int, float)):
                out["ttft_ewma_s"] = max(out["ttft_ewma_s"] or 0.0,
                                         float(ttft))
        with self._lock:
            out["shed_total"] += self.counters["all_shed"]
        return out

    def active_count(self) -> int:
        """Live (routable) members."""
        return len(self._snapshot())

    def add_replica_for_ticket(self, ticket: str) -> int:
        """The autoscaler's harvest: the agent behind ``ticket`` (its
        replica id) registered itself with the directory, so adding it
        is refreshing the routing view and remembering it as a
        scale-down candidate."""
        with self._lock:
            self._scale_seq += 1
            idx = self._scale_seq
            self._scaled[idx] = str(ticket)
        self._invalidate_snapshot()
        self.events.append("scale_up", sid=str(ticket), data={"idx": idx})
        return idx

    def scale_down(self, k: int = 1, timeout_s: float = 15.0,
                   rids: Optional[Iterable[str]] = None) -> List[int]:
        """Retire ``k`` autoscaler-added agents: a drain that lets their
        requests finish (the agent deregisters, so its generation is
        tombstoned, inside ``rpc_drain``), then eviction from routing.
        The least-loaded scaled members go first; the static floor is
        never touched. ``rids`` restricts the candidates (a caller
        retiring a given agent). Returns the retired idxs, whose
        provider tickets the autoscaler then releases."""
        members = self._snapshot()
        allow = None if rids is None else {str(r) for r in rids}
        with self._lock:
            cands = [(idx, rid) for idx, rid in self._scaled.items()
                     if rid in members and (allow is None or rid in allow)]
        cands.sort(key=lambda pair: (
            members[pair[1]].report.get("outstanding_tokens", 0),
            members[pair[1]].report.get("queue_depth", 0), pair[0]))
        retired: List[int] = []
        for idx, rid in cands[:max(0, int(k))]:
            try:
                self._agent(members[rid]).drain(timeout_s=timeout_s)
            except Exception:   # noqa: BLE001 - a dead agent is retired
                pass            # already; its tombstone wins
            with self._lock:
                self._scaled.pop(idx, None)
            self._invalidate_member(rid)
            self.events.append("scale_down", sid=rid, data={"idx": idx})
            retired.append(idx)
        return retired

    def pool_stats(self) -> Dict[str, Any]:
        """Router-side observability block (named so that
        ``obs.dump_flight_bundle(pool=router)`` records it)."""
        with self._lock:
            out = {"counters": dict(self.counters),
                   "sticky_sessions": len(self._sticky),
                   "dead_seen": len(self._dead_seen)}
        try:
            out["directory"] = self._directory.stats()
        except Exception:   # noqa: BLE001
            out["directory"] = None
        return out

    def member_stats(self) -> Dict[str, Any]:
        """Per-agent stats over the transport."""
        out = {}
        for rid, m in self._snapshot().items():
            try:
                out[rid] = self._agent(m).stats()
            except Exception:   # noqa: BLE001
                out[rid] = None
        return out

    def shutdown(self) -> None:
        self._stopped = True
        with self._lock:
            clients = list(self._clients.values())
        for c in clients:
            try:
                c._t.close()
            except Exception:   # noqa: BLE001
                pass
