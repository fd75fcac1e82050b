"""Port of ``ray_tpu/serve/fleet/agent.py``: ``ReplicaAgent``, one
engine per host, lease-fenced and self-policing.

An agent owns exactly one ``LLMEngine`` (serve/engine.py), registers it
with the ``FleetDirectory`` and keeps the lease alive by renewing every
third of the TTL; each renewal piggybacks the engine's prefix digest and
load report, which is how the router sees this host. Three behaviours
carry the correctness story:

- **Self-fencing.** The agent tracks its own lease deadline on its own
  clock. When renewals stop landing and the deadline passes, it fences
  ITSELF: new submits fail typed ``AgentFenced`` and every in-flight
  request is cancelled, before the directory could confirm it dead, so
  a request resubmitted elsewhere is never double-served. A fenced agent
  re-joins under ``generation + 1`` with a fresh request table.
- **Idempotent admission.** Every submit carries a router-minted request
  key; a duplicate delivery returns the EXISTING request id instead of
  admitting twice. Polls are cursor-based, so a duplicated poll re-reads.
  Together these make the transport's at-least-once retries safe on an
  at-most-once engine.
- **Local watchdog.** ``watchdog.AgentWatchdog`` probes the engine's
  heartbeat; a wedge is force-killed and REPORTED on the next renewal
  before the agent rebuilds its engine under a new generation.

Everything that crosses the wire is JSON of Python scalars: token ids
are ``int``, load reports pass ``_json_safe``.

``ScriptedEngine`` is a deterministic model-free stand-in engine
(``scripted_completion`` is its ground truth). Run as a process:

    python -m ray_tpu_torch.serve.fleet.agent --replica-id r0
        --directory-port N [--model fake|tiny|tinyllama] [--layers L]
        [--seed S] [--device cuda|cpu] [--max-slots ...]

prints ``READY <port>`` once its engine is warm and registered.
``--model tiny`` serves ``llama_tiny`` fp32 and ``tinyllama``
TinyLlama-1.1B's widths at ``--layers`` layers in bf16, both with
``init_params(cfg, seed)`` weights drawn on the agent's own device.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.serve import kv_migration, obs
from ray_tpu_torch.serve.errors import (EngineDraining, EngineShutdown,
                                        RequestCancelled)
from ray_tpu_torch.serve.fleet import wire
from ray_tpu_torch.serve.fleet.directory import DirectoryClient
from ray_tpu_torch.serve.fleet.transport import SocketTransport, Transport
from ray_tpu_torch.serve.fleet.wire import (AgentFenced, KVPullAborted,
                                            StaleFencingToken)

ACTIVE = "active"
FENCED = "fenced"

# the prompt every model agent warms its engine with before it registers
WARMUP_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


def scripted_completion(prompt: List[int],
                        max_new_tokens: int) -> List[int]:
    """Pure deterministic completion: the ScriptedEngine's ground truth,
    computable in any process without the model."""
    x = 0
    for t in prompt:
        x = (x * 31 + int(t) + 7) % 100003
    out = []
    for _ in range(max_new_tokens):
        x = (x * 1103515245 + 12345) % 100003
        out.append(x % 997)
    return out


class _ScriptedHandle:
    def __init__(self, eng: "ScriptedEngine", prompt: List[int], n: int):
        self._eng = eng
        self._tokens = scripted_completion(prompt, n)
        self._cancelled = False

    def stream(self):
        for tok in self._tokens:
            if self._cancelled:
                raise RequestCancelled("request cancelled")
            if self._eng._stopped:
                raise (self._eng._kill_err
                       or EngineShutdown("engine stopped"))
            time.sleep(self._eng.token_delay_s)
            self._eng._hb = time.monotonic()
            yield tok

    def result(self) -> List[int]:
        return list(self.stream())

    def cancel(self) -> bool:
        self._cancelled = True
        return True


class ScriptedEngine:
    """Deterministic, model-free engine with the surface the agent and
    the routing core need: submit/stream, ``load_report`` with heartbeat
    and digest keys, drain/force_kill/shutdown. Token i of a request is
    a pure function of the prompt."""

    def __init__(self, *, page_size: int = 8,
                 token_delay_s: float = 0.002,
                 max_queued: Optional[int] = None):
        self.Pg = page_size
        self.token_delay_s = token_delay_s
        self.max_queued = max_queued
        self._stopped = False
        self._draining = False
        self._kill_err: Optional[BaseException] = None
        self._hb = time.monotonic()
        self._active = 0
        self._lock = threading.Lock()

    def start(self) -> "ScriptedEngine":
        return self

    def submit(self, prompt_ids, max_new_tokens: int = 16,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               pull: Optional[Dict[str, Any]] = None) -> _ScriptedHandle:
        # ``pull`` is accepted for LLMEngine's surface and ignored: no KV
        if self._stopped:
            raise EngineShutdown("engine stopped")
        if self._draining:
            raise EngineDraining("engine draining")
        with self._lock:
            self._active += 1
        self._hb = time.monotonic()
        return _ScriptedHandle(self, list(prompt_ids), max_new_tokens)

    def request_done(self) -> None:
        with self._lock:
            self._active = max(0, self._active - 1)

    def load_report(self) -> Dict[str, Any]:
        with self._lock:
            active = self._active
        return {"free_slots": max(0, 4 - active), "total_slots": 4,
                "free_pages": 64, "queue_depth": active,
                "outstanding_tokens": active * 8,
                "max_queued": self.max_queued,
                "shed_retry_after_s": 0.05, "shed_total": 0,
                "ttft_ewma_s": None, "draining": self._draining,
                "stopped": self._stopped,
                "heartbeat_age_s": time.monotonic() - self._hb,
                "fetchq_depth": 0, "pending_prefills": 0,
                "overlap": False, "has_work": active > 0, "tp": 1,
                "prefix_digest": frozenset()}

    def drain(self, timeout_s: float = 5.0) -> bool:
        self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._active == 0:
                    return True
            time.sleep(0.005)
        with self._lock:
            return self._active == 0

    def force_kill(self, err: Optional[BaseException] = None) -> None:
        self._kill_err = err
        self._stopped = True

    def shutdown(self) -> None:
        self._stopped = True


class ReplicaAgent:
    """One engine + its lease, behind a transport handler.

    engine_factory: ``f(generation) -> engine`` (started by the agent if
        it has ``start``); called again after a wedge.
    directory: a ``DirectoryClient``.
    addr: what the directory advertises for this agent (default
        ``["loopback", replica_id]``; a process sets ``["tcp", host,
        port]``).
    renew_period_s: default a third of the lease TTL.
    stall_deadline_s: arms an ``AgentWatchdog`` (None: off).
    peer_transport_factory: how a KV pull dials its donor (default a
        TCP dial of the hint's ``["tcp", host, port]``).
    time_fn: the lease clock (a fake one in tests).
    """

    def __init__(self, replica_id: str,
                 engine_factory: Callable[[int], Any],
                 directory: DirectoryClient, *,
                 addr: Optional[List[Any]] = None,
                 generation: int = 0,
                 renew_period_s: Optional[float] = None,
                 stall_deadline_s: Optional[float] = None,
                 flight_dir: Any = None,
                 register_patience_s: float = 60.0,
                 peer_transport_factory: Optional[
                     Callable[[Any], Transport]] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.replica_id = replica_id
        self._factory = engine_factory
        self._directory = directory
        self._peer_tf = peer_transport_factory
        self.addr = addr if addr is not None else ["loopback", replica_id]
        self.generation = int(generation)
        self._renew_period_s = renew_period_s
        self._register_patience_s = float(register_patience_s)
        self._stall_deadline_s = stall_deadline_s
        self.flight_dir = flight_dir
        self._now = time_fn
        self._lock = threading.Lock()
        self.engine: Any = None
        self.state = ACTIVE
        self.fence = 0
        self.lease_ttl_s = 0.0
        self._lease_deadline = 0.0
        self._draining = False
        self._partition_until = 0.0
        self._wedge_err: Optional[BaseException] = None
        self._reqs: Dict[str, Dict[str, Any]] = {}
        self._by_key: Dict[str, str] = {}
        self._seq = 0
        self._stop = threading.Event()
        self._renew_thread: Optional[threading.Thread] = None
        self._watchdog = None
        # the donor side of the KV pull, rebuilt with the engine after a
        # wedge so a transfer table never outlives its pool; the env
        # knob stretches each chunk export so a harness can kill a
        # donor mid-pull
        self._kv_donor: Optional[kv_migration.KVDonor] = None
        self._kv_chunk_delay_s = float(
            os.environ.get("RAY_TPU_KV_CHUNK_DELAY_S", "0") or 0)
        self.events = obs.EventLog(1024, name=f"agent-{replica_id}")
        self.counters = {"submits": 0, "dup_submits": 0,
                         "refused_fenced": 0, "refused_stale_fence": 0,
                         "polls": 0, "self_fences": 0,
                         "reregisters": 0, "wedges": 0,
                         "cancelled_on_fence": 0}

    # ------------------------------------------------------- lifecycle

    def start(self) -> "ReplicaAgent":
        if self.engine is None:
            self.engine = self._factory(self.generation)
            if hasattr(self.engine, "start"):
                self.engine.start()
        self._wire_engine_kv()
        # the directory may be unreachable at boot: retry through it for
        # register_patience_s; a typed rejection (tombstoned generation)
        # is permanent and propagates at once
        deadline = self._now() + self._register_patience_s
        while True:
            try:
                self._register(min_fence=0)
                break
            except (StaleFencingToken, AgentFenced):
                raise
            except Exception:   # noqa: BLE001
                if self._now() >= deadline:
                    raise
                self._stop.wait(0.2)
        if self._renew_thread is None:
            self._renew_thread = threading.Thread(
                target=self._renew_loop,
                name=f"agent-renew-{self.replica_id}", daemon=True)
            self._renew_thread.start()
        if self._stall_deadline_s is not None and self._watchdog is None:
            from ray_tpu_torch.serve.watchdog import AgentWatchdog
            self._watchdog = AgentWatchdog(
                lambda: self.engine, self._on_wedge,
                stall_deadline_s=self._stall_deadline_s,
                flight_dir=self.flight_dir).run()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.stop()
        t = self._renew_thread
        if t is not None:
            t.join(timeout=5.0)
            self._renew_thread = None
        if self.engine is not None:
            try:
                self.engine.shutdown()
            except Exception:   # noqa: BLE001
                pass

    # ----------------------------------------------------- lease logic

    def _register(self, min_fence: int) -> None:
        r = self._directory.register(
            self.replica_id, self.addr, self.generation,
            page_size=getattr(self.engine, "Pg", 0),
            min_fence=min_fence,
            role=getattr(self.engine, "role", "unified"))
        with self._lock:
            self.fence = int(r["fence"])
            self.lease_ttl_s = float(r["lease_ttl_s"])
            self._lease_deadline = self._now() + self.lease_ttl_s
            self.state = ACTIVE
        self.events.append("registered",
                           data={"fence": self.fence,
                                 "generation": self.generation})

    def partitioned(self) -> bool:
        return self._now() < self._partition_until

    def reachable(self) -> bool:
        """SocketServer gate: False while partitioned, when inbound
        frames are dropped without a response."""
        return not self.partitioned()

    def _renew_payload(self) -> Dict[str, Any]:
        digest: List[int] = []
        load: Dict[str, Any] = {}
        try:
            rpt = dict(self.engine.load_report())
            digest = sorted(int(h) for h in
                            rpt.pop("prefix_digest", ()) or ())
            load = _json_safe(rpt)
        except Exception:   # noqa: BLE001
            pass
        return {"digest": digest, "load": load}

    def _renew_loop(self) -> None:
        while not self._stop.is_set():
            period = (self._renew_period_s
                      if self._renew_period_s is not None
                      else max(0.02, self.lease_ttl_s / 3.0))
            self._stop.wait(period)
            if self._stop.is_set():
                return
            self.renew_once()

    def renew_once(self) -> bool:
        """One renewal attempt + the self-fencing judgement (split out
        of the loop so tests drive it on a fake clock)."""
        wedge = self._wedge_err
        if not self.partitioned() and self.state == ACTIVE:
            adv = self._renew_payload()
            t_call = self._now()
            try:
                self._directory.renew(
                    self.replica_id, self.fence, digest=adv["digest"],
                    load=adv["load"], wedged=wedge is not None)
                with self._lock:
                    self._lease_deadline = t_call + self.lease_ttl_s
                if wedge is not None:
                    self._rebuild_after_wedge()
                return True
            except (wire.UnknownMember, StaleFencingToken):
                # the directory lost our membership or we were
                # superseded: re-register under the SAME generation (the
                # requests in flight are healthy)
                try:
                    self._reregister(bump_generation=False)
                except Exception:   # noqa: BLE001
                    pass
                return False
            except Exception:   # noqa: BLE001
                pass    # transport trouble: judged below
        if self.state == ACTIVE and self._now() > self._lease_deadline:
            self._self_fence("lease lapsed without renewal")
        if self.state == FENCED and not self.partitioned():
            # fenced agents re-join as a fresh incarnation
            try:
                self._reregister(bump_generation=True)
            except Exception:   # noqa: BLE001
                pass
        return False

    def _reregister(self, bump_generation: bool) -> None:
        old_fence = self.fence
        if bump_generation:
            self.generation += 1
            with self._lock:
                self._reqs.clear()
                self._by_key.clear()
        self._register(min_fence=old_fence)
        self.counters["reregisters"] += 1
        self.events.append("reregistered",
                           data={"fence": self.fence,
                                 "generation": self.generation,
                                 "bumped": bump_generation})

    def _self_fence(self, reason: str) -> None:
        with self._lock:
            if self.state == FENCED:
                return
            self.state = FENCED
            self.counters["self_fences"] += 1
            active = [rec for rec in self._reqs.values()
                      if not rec["done"] and rec["error"] is None]
            for rec in active:
                rec["error"] = wire.err(AgentFenced(
                    f"agent {self.replica_id} self-fenced: "
                    f"{reason}"))["error"]
                self.counters["cancelled_on_fence"] += 1
        # cancel outside the lock: handle.cancel takes engine locks
        for rec in active:
            try:
                rec["handle"].cancel()
            except Exception:   # noqa: BLE001
                pass
        self.events.append("self_fence",
                           data={"reason": reason, "fence": self.fence,
                                 "generation": self.generation,
                                 "cancelled": len(active)})
        if self.flight_dir:
            try:
                obs.dump_flight_bundle(
                    self.flight_dir, f"self-fenced-{self.replica_id}",
                    engine=self.engine, pool=self,
                    extra={"replica_id": self.replica_id,
                           "reason": reason, "fence": self.fence,
                           "generation": self.generation,
                           "lease_overdue_s": round(
                               self._now() - self._lease_deadline, 4),
                           "cancelled_in_flight": len(active)})
            except Exception:   # noqa: BLE001
                pass

    def _on_wedge(self, err: BaseException) -> None:
        self._wedge_err = err
        self.counters["wedges"] += 1
        self.events.append("wedged", data={"err": str(err)})

    def _rebuild_after_wedge(self) -> None:
        """The wedge was reported on a successful renewal: replace the
        engine under a new generation and re-register."""
        self._wedge_err = None
        self.generation += 1
        with self._lock:
            self._reqs.clear()
            self._by_key.clear()
        old = self.engine
        self.engine = self._factory(self.generation)
        if hasattr(self.engine, "start"):
            self.engine.start()
        self._wire_engine_kv()
        try:
            if old is not None:
                old.shutdown()
        except Exception:   # noqa: BLE001
            pass
        try:
            self._register(min_fence=self.fence)
            self.counters["reregisters"] += 1
        except Exception:   # noqa: BLE001
            pass

    # ----------------------------------------------------- RPC surface

    def handle(self, method: str, args: Dict[str, Any],
               trace_id: Optional[str] = None) -> Any:
        fn = getattr(self, "rpc_" + method, None)
        if fn is None:
            raise EngineShutdown(f"agent has no method {method}")
        if method == "submit":
            return fn(trace_id=trace_id, **args)
        return fn(**args)

    def rpc_ping(self) -> Dict[str, Any]:
        return {"ok": True, "replica_id": self.replica_id,
                "generation": self.generation, "state": self.state}

    def rpc_submit(self, key: str, prompt_ids: List[int],
                   max_new_tokens: int,
                   deadline_s: Optional[float] = None,
                   fence: Optional[int] = None,
                   pull: Optional[Dict[str, Any]] = None,
                   trace_id: Optional[str] = None) -> Dict[str, Any]:
        if self.state == FENCED:
            self.counters["refused_fenced"] += 1
            raise AgentFenced(f"agent {self.replica_id} is fenced (lease "
                              f"lapsed); refusing admission")
        if self._draining:
            raise EngineDraining(f"agent {self.replica_id} is draining")
        if fence is not None and int(fence) != self.fence:
            self.counters["refused_stale_fence"] += 1
            raise StaleFencingToken(
                f"submit quoted fence {fence}; agent {self.replica_id} "
                f"holds fence {self.fence}")
        with self._lock:
            rid = self._by_key.get(key)
            if rid is not None:
                # duplicate delivery: hand back the SAME request
                self.counters["dup_submits"] += 1
                return {"rid": rid, "dedup": True,
                        "generation": self.generation}
        kw: Dict[str, Any] = dict(max_new_tokens=int(max_new_tokens),
                                  deadline_s=deadline_s)
        if trace_id is not None:
            kw["trace_id"] = trace_id
        if pull is not None:
            # the router's prefix hint: the engine declines it when its
            # own cache covers the prefix, and a failed pull degrades to
            # plain prefill
            kw["pull"] = pull
        inner = self.engine.submit(list(prompt_ids), **kw)
        with self._lock:
            # a duplicate may have admitted first while this one was in
            # the engine: keep the first admission
            prev = self._by_key.get(key)
            if prev is not None:
                self.counters["dup_submits"] += 1
                rid = prev
                dup_inner = inner
            else:
                self._seq += 1
                rid = f"{self.replica_id}.g{self.generation}.{self._seq}"
                rec = {"rid": rid, "key": key, "tokens": [],
                       "done": False, "error": None, "handle": inner,
                       "trace_id": trace_id}
                self._reqs[rid] = rec
                self._by_key[key] = rid
                dup_inner = None
        if dup_inner is not None:
            try:
                dup_inner.cancel()
            except Exception:   # noqa: BLE001
                pass
            return {"rid": rid, "dedup": True,
                    "generation": self.generation}
        self.counters["submits"] += 1
        self.events.append("submit", rid=rid,
                           data={"trace_id": trace_id, "key": key})
        threading.Thread(target=self._pump, args=(rec,),
                         name=f"agent-pump-{rid}", daemon=True).start()
        return {"rid": rid, "dedup": False, "generation": self.generation}

    def _pump(self, rec: Dict[str, Any]) -> None:
        """Drain the engine stream into the poll buffer."""
        try:
            first = True
            for tok in rec["handle"].stream():
                if first:
                    first = False
                    self.events.append("first_token", rid=rec["rid"],
                                       data={"trace_id": rec["trace_id"]})
                with self._lock:
                    rec["tokens"].append(int(tok))
            with self._lock:
                rec["done"] = True
            self.events.append("retire", rid=rec["rid"],
                               data={"trace_id": rec["trace_id"],
                                     "n_tokens": len(rec["tokens"])})
        except BaseException as e:   # noqa: BLE001
            with self._lock:
                if rec["error"] is None:
                    rec["error"] = wire.err(e)["error"]
            self.events.append("failed", rid=rec["rid"],
                               data={"trace_id": rec["trace_id"],
                                     "error": type(e).__name__})
        finally:
            done_hook = getattr(self.engine, "request_done", None)
            if done_hook is not None:
                try:
                    done_hook()
                except Exception:   # noqa: BLE001
                    pass

    def rpc_poll(self, rid: str, cursor: int = 0) -> Dict[str, Any]:
        self.counters["polls"] += 1
        with self._lock:
            rec = self._reqs.get(rid)
            if rec is None:
                raise EngineShutdown(
                    f"unknown rid {rid}: the agent re-registered under a "
                    f"new generation (its requests were fenced)")
            cursor = max(0, int(cursor))
            return {"tokens": rec["tokens"][cursor:],
                    "done": rec["done"], "error": rec["error"],
                    "generation": self.generation}

    def rpc_cancel(self, rid: str) -> Dict[str, Any]:
        with self._lock:
            rec = self._reqs.get(rid)
        if rec is None:
            return {"cancelled": False}
        try:
            return {"cancelled": bool(rec["handle"].cancel())}
        except Exception:   # noqa: BLE001
            return {"cancelled": False}

    # ------------------------------------------------- KV migration

    def _wire_engine_kv(self) -> None:
        """(Re)build the KV donor for the CURRENT engine and inject the
        requester-side fetcher, at start and after every wedge rebuild:
        a transfer against the old engine then lands on an empty table,
        a typed ``KVPullAborted``, never stale bytes."""
        eng = self.engine
        if eng is None or not hasattr(eng, "kv_migration_stats"):
            self._kv_donor = None
            return
        self._kv_donor = kv_migration.KVDonor(
            eng, chunk_delay_s=self._kv_chunk_delay_s)
        eng.kv_fetcher = self._kv_fetch

    def _kv_donor_or_abort(self) -> kv_migration.KVDonor:
        if self.state == FENCED:
            raise KVPullAborted(f"donor {self.replica_id} is fenced; its "
                                f"pages may be reclaimed at any moment")
        donor = self._kv_donor
        if donor is None:
            raise KVPullAborted(f"agent {self.replica_id} has no KV pool "
                                f"to donate from")
        return donor

    def rpc_kv_pull_begin(self, hashes: List[int]) -> Dict[str, Any]:
        return self._kv_donor_or_abort().begin(list(hashes))

    def rpc_kv_pull_chunk(self, xfer_id: str,
                          chunk_idx: int) -> Dict[str, Any]:
        return self._kv_donor_or_abort().chunk(str(xfer_id),
                                               int(chunk_idx))

    def rpc_kv_pull_end(self, xfer_id: str) -> Dict[str, Any]:
        donor = self._kv_donor
        if donor is None:
            return {"released": False}
        return donor.end(str(xfer_id))

    def _kv_fetch(self, pull: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The engine's fetcher: dial the donor the pull hint names and
        run the chunked pull. None on ANY failure, and the engine then
        falls back to plain prefill."""
        addr = pull.get("addr")
        if self._peer_tf is not None:
            try:
                t = self._peer_tf(tuple(addr or ()))
            except Exception:   # noqa: BLE001
                return None
        elif (isinstance(addr, (list, tuple)) and len(addr) == 3
                and addr[0] == "tcp"):
            t = SocketTransport((addr[1], int(addr[2])))
        else:
            return None
        try:
            return kv_migration.pull_prefix(
                lambda m, a: t.call(m, a), pull.get("hashes") or [],
                stats=getattr(self.engine, "kv_migration_stats", None))
        except Exception:   # noqa: BLE001
            return None
        finally:
            t.close()

    def rpc_load_report(self) -> Dict[str, Any]:
        rpt = dict(self.engine.load_report())
        rpt["prefix_digest"] = sorted(rpt.get("prefix_digest", ()) or ())
        rpt.update(replica_id=self.replica_id,
                   generation=self.generation, fence=self.fence,
                   state=self.state)
        return _json_safe(rpt)

    def rpc_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": dict(self.counters),
                               "state": self.state,
                               "generation": self.generation,
                               "fence": self.fence}
        eng = self.engine
        for name in ("stats", "ttfts_s", "prefix_stats", "spec_stats",
                     "lifecycle_stats", "kv_migration_stats"):
            try:
                v = getattr(eng, name, None)
                v = v() if callable(v) else v
                out[name] = _json_safe(v)
            except Exception:   # noqa: BLE001
                out[name] = None
        if self._watchdog is not None:
            out["watchdog"] = self._watchdog.stats()
        return out

    def rpc_drain(self, timeout_s: float = 5.0) -> Dict[str, Any]:
        """Graceful scale-down: refuse admissions, wait for in-flight
        work, deregister."""
        self._draining = True
        clean = True
        eng = self.engine
        try:
            if hasattr(eng, "wait_idle"):
                # LLMEngine: drain() takes no timeout, wait_idle does
                eng.drain()
                clean = bool(eng.wait_idle(timeout_s))
            elif hasattr(eng, "drain"):
                clean = bool(eng.drain(timeout_s))
        except Exception:   # noqa: BLE001
            clean = False
        deadline = self._now() + max(0.0, timeout_s)
        while self._now() < deadline:
            with self._lock:
                if all(rec["done"] or rec["error"] is not None
                       for rec in self._reqs.values()):
                    break
            time.sleep(0.005)
        try:
            self._directory.deregister(self.replica_id, self.fence)
        except Exception:   # noqa: BLE001
            clean = False
        self.events.append("drained", data={"clean": clean})
        return {"clean": clean}

    def rpc_quiesce(self) -> Dict[str, Any]:
        """Remote quiescence probe: ``faults.check_quiesced`` across the
        process boundary."""
        eng = self.engine
        if hasattr(eng, "alloc"):
            from ray_tpu_torch.serve.faults import check_quiesced
            try:
                check_quiesced(eng)
                return {"ok": True}
            except AssertionError as e:
                return {"ok": False, "error": str(e)}
        with self._lock:
            pending = [r for r, rec in self._reqs.items()
                       if not rec["done"] and rec["error"] is None]
        return {"ok": not pending,
                "error": (f"{len(pending)} requests still in flight"
                          if pending else None)}

    def rpc_fence(self, reason: str = "forced by operator"
                  ) -> Dict[str, Any]:
        self._self_fence(reason)
        return {"state": self.state}

    def rpc_inject_partition(self, duration_s: float) -> Dict[str, Any]:
        """Chaos seam: cut this agent off both ways (inbound frames drop
        at the ``reachable`` gate, renewals stop) for ``duration_s``."""
        self._partition_until = self._now() + float(duration_s)
        self.events.append("partitioned",
                           data={"duration_s": duration_s})
        return {"until_s": duration_s}

    def rpc_telemetry(self, cursor: int = 0,
                      limit: int = 256) -> Dict[str, Any]:
        raise NotImplementedError(
            "the agent's telemetry waits for the fleet's third slice "
            "(ROADMAP.md, queue 1, item 9)")

    def rpc_shutdown(self) -> Dict[str, Any]:
        threading.Thread(target=self.shutdown, daemon=True).start()
        return {"ok": True}

    # ---------------------------------------------------- obs plumbing

    def pool_stats(self) -> Dict[str, Any]:
        """Lets ``obs.dump_flight_bundle(pool=agent)`` record the agent
        the way it records a pool."""
        return {"replica_id": self.replica_id, "state": self.state,
                "generation": self.generation, "fence": self.fence,
                "counters": dict(self.counters)}


def _json_safe(v: Any) -> Any:
    """``v`` as JSON of Python scalars: a numpy or torch scalar (or a
    one-element tensor) becomes its Python number, anything else
    unknown its ``str``."""
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in v]
    if v is None or isinstance(v, (str, bool)):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return float(v)
    shape = getattr(v, "shape", None)
    if shape is not None and tuple(shape) in ((), (1,)):
        return _json_safe(v.item())
    return str(v)


class AgentClient:
    """Typed client wrapper over any transport to an agent."""

    def __init__(self, transport: Transport, timeout_s: float = 5.0):
        self._t = transport
        self._timeout_s = timeout_s

    def _call(self, method: str, args: Dict[str, Any],
              timeout_s: Optional[float] = None,
              trace_id: Optional[str] = None) -> Any:
        return self._t.call(
            method, args,
            timeout_s=timeout_s if timeout_s is not None
            else self._timeout_s, trace_id=trace_id)

    def ping(self) -> Dict[str, Any]:
        return self._call("ping", {})

    def submit(self, key: str, prompt_ids: List[int],
               max_new_tokens: int,
               deadline_s: Optional[float] = None,
               fence: Optional[int] = None,
               pull: Optional[Dict[str, Any]] = None,
               trace_id: Optional[str] = None,
               timeout_s: Optional[float] = None) -> Dict[str, Any]:
        args = {"key": key, "prompt_ids": [int(t) for t in prompt_ids],
                "max_new_tokens": int(max_new_tokens),
                "deadline_s": deadline_s, "fence": fence}
        if pull is not None:
            args["pull"] = pull
        return self._call("submit", args, timeout_s, trace_id)

    def kv_pull_begin(self, hashes: List[int]) -> Dict[str, Any]:
        return self._call("kv_pull_begin", {"hashes": list(hashes)})

    def kv_pull_chunk(self, xfer_id: str,
                      chunk_idx: int) -> Dict[str, Any]:
        return self._call("kv_pull_chunk",
                          {"xfer_id": xfer_id, "chunk_idx": chunk_idx})

    def kv_pull_end(self, xfer_id: str) -> Dict[str, Any]:
        return self._call("kv_pull_end", {"xfer_id": xfer_id})

    def poll(self, rid: str, cursor: int = 0,
             trace_id: Optional[str] = None,
             timeout_s: Optional[float] = None) -> Dict[str, Any]:
        return self._call("poll", {"rid": rid, "cursor": cursor},
                          timeout_s, trace_id)

    def cancel(self, rid: str) -> Dict[str, Any]:
        return self._call("cancel", {"rid": rid})

    def load_report(self) -> Dict[str, Any]:
        return self._call("load_report", {})

    def stats(self) -> Dict[str, Any]:
        return self._call("stats", {})

    def drain(self, timeout_s: float = 5.0) -> Dict[str, Any]:
        return self._call("drain", {"timeout_s": timeout_s},
                          timeout_s + 2.0)

    def quiesce(self) -> Dict[str, Any]:
        return self._call("quiesce", {})

    def fence(self, reason: str = "forced") -> Dict[str, Any]:
        return self._call("fence", {"reason": reason})

    def inject_partition(self, duration_s: float) -> Dict[str, Any]:
        return self._call("inject_partition", {"duration_s": duration_s})

    def shutdown(self) -> Dict[str, Any]:
        return self._call("shutdown", {})


def model_engine_factory(model: str, *, layers: int = 22, seed: int = 0,
                         device=None, max_slots: int = 2,
                         page_size: int = 8, n_pages: int = 64,
                         chunk: int = 4,
                         flight_dir: Optional[str] = None
                         ) -> Callable[[int], Any]:
    """The engine factory of a model agent: ``model`` ``"tiny"``
    (``llama_tiny`` fp32) or ``"tinyllama"`` (TinyLlama-1.1B's widths at
    ``layers`` layers, bf16), built once on ``device`` (the card unless
    ``"cpu"``) from ``init_params(cfg, seed)``, so every agent of one
    seed holds the same weights. Each engine is greedy, holds the prefix
    cache, and is warmed on ``WARMUP_PROMPT`` before it is returned (a
    cold first dispatch looks like a wedge). On the card it never compiles
    a kernel: the parent builds them before it starts agents, and this
    raises ``FileNotFoundError`` if K1's library is not built (a process
    beside others on one card must not run nvcc)."""
    import torch

    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.engine import LLMEngine

    device = resolve_device(device)
    if model == "tiny":
        cfg = llama.llama_tiny(dtype=torch.float32)
    elif model == "tinyllama":
        cfg = llama.tinyllama_1_1b(n_layers=layers)
    else:
        raise ValueError(f"unknown model {model!r}; expected tiny or "
                         f"tinyllama")
    if device.type == "cuda":
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import paged_attention as pa
        lib = _build.library_path(pa._SOURCE)
        if not lib.is_file():
            raise FileNotFoundError(
                f"{lib} is not built; build the kernels before starting "
                f"agents")
    weights = llama.build_model(
        cfg, llama.init_params(cfg, seed=seed, device=device), device)

    def factory(generation: int) -> LLMEngine:
        eng = LLMEngine(weights, max_slots=max_slots, page_size=page_size,
                        n_pages=n_pages, chunk=chunk, temperature=0.0,
                        seed=0, prefix_cache=True, eos_id=-1,
                        flight_dir=flight_dir, device=device)
        eng.start()
        eng.submit(WARMUP_PROMPT, max_new_tokens=4).result()
        eng.reset_latency_stats()
        return eng

    return factory


def main(argv: Optional[List[str]] = None) -> None:
    """Process entry (see the module docstring). Prints ``READY <port>``
    once registered and warm, then serves until killed or shut down."""
    import argparse

    from ray_tpu_torch.serve.fleet.transport import SocketServer

    ap = argparse.ArgumentParser()
    ap.add_argument("--replica-id", required=True)
    ap.add_argument("--generation", type=int, default=0)
    ap.add_argument("--directory-host", default="127.0.0.1")
    ap.add_argument("--directory-port", type=int, default=None)
    ap.add_argument("--directory", action="append", default=None,
                    metavar="HOST:PORT",
                    help="directory endpoint (one; an ordered failover "
                         "list waits for the fleet's second slice)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--model", choices=("fake", "tiny", "tinyllama"),
                    default="fake")
    ap.add_argument("--layers", type=int, default=22,
                    help="tinyllama: layers of TinyLlama-1.1B's widths")
    ap.add_argument("--seed", type=int, default=0,
                    help="init_params seed of the model's weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--max-slots", type=int, default=2)
    ap.add_argument("--n-pages", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--token-delay-s", type=float, default=0.002)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--stall-deadline-s", type=float, default=None)
    ap.add_argument("--flight-dir", default=None)
    args = ap.parse_args(argv)

    if args.model == "fake":
        def factory(generation: int) -> ScriptedEngine:
            return ScriptedEngine(page_size=args.page_size,
                                  token_delay_s=args.token_delay_s)
    else:
        factory = model_engine_factory(
            args.model, layers=args.layers, seed=args.seed,
            device=args.device, max_slots=args.max_slots,
            page_size=args.page_size, n_pages=args.n_pages,
            chunk=args.chunk, flight_dir=args.flight_dir)

    endpoints = []
    for spec in (args.directory or []):
        host, _, port = spec.rpartition(":")
        endpoints.append((host or "127.0.0.1", int(port)))
    if not endpoints:
        if args.directory_port is None:
            ap.error("need --directory or --directory-port")
        endpoints = [(args.directory_host, args.directory_port)]
    if len(endpoints) > 1:
        raise NotImplementedError(
            "several --directory endpoints need FailoverDirectoryClient, "
            "which waits for the fleet's second slice (ROADMAP.md, queue "
            "1, item 9)")
    directory = DirectoryClient(SocketTransport(endpoints[0]))
    agent = ReplicaAgent(args.replica_id, factory, directory,
                         generation=args.generation,
                         stall_deadline_s=args.stall_deadline_s,
                         flight_dir=args.flight_dir)
    server = SocketServer(agent.handle, host=args.host, port=args.port,
                          gate=agent.reachable)
    agent.addr = ["tcp", server.addr[0], server.addr[1]]
    agent.start()
    print(f"READY {server.addr[1]}", flush=True)
    try:
        while not agent._stop.is_set():
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        agent.shutdown()


if __name__ == "__main__":
    main()
