"""Port of ``ray_tpu/serve/engine_pool.py``: ``EnginePool``, N
``LLMEngine`` replicas (serve/engine.py) behaving as ONE logical engine
behind a thin, load-aware router.

Routing policy, in precedence order (``_route``, through
``fleet/routing.py``'s ``select_candidate``):

1. **Session stickiness** — a ``session_id`` keeps hitting the replica
   that served it last (its KV prefix lives there), unless that
   replica is gone or saturated. The sticky map is a bounded LRU.
2. **Longest-prefix affinity** — each replica's ``load_report()``
   carries a digest of its radix prefix cache (rolling path hashes,
   ``prefix_cache.path_hashes``). The prompt is hashed once and the
   replica holding its longest cached prefix wins (ties: least
   outstanding tokens), so a shared system prompt is not re-prefilled
   on every replica it happens to land on.
3. **Spill** — when the affinity target is saturated (bounded queue
   full), the request spills to the power-of-two-choices pick.
4. **Power-of-two-choices** on least outstanding tokens, sampled from
   ``random.Random(seed)``.

A replica's outstanding tokens are its report's plus those of the
routes already chosen for it whose submit has not returned; the
reference reads the reports alone, so concurrent submits that route in
one instant all pick the same replica (``_route``).

BATCH-lane requests (``priority="batch"``, ``submit_rollout_batch``)
skip all four: they go to the replica with the least batch backlog and
never write placement state.

Replica lifecycle, owned by the pool:

- **Draining** (``drain(idx)``): the replica admits nothing new,
  finishes in-flight work, shuts down and is rebuilt from the factory
  with its ``generation`` + 1; ``retire``/``scale_down``/``scale_to``
  take the same drain path and leave a ``RETIRED`` tombstone.
- **Failure recovery** (``_note_replica_death``): when a replica dies
  (``ReplicaKilled``, any global ``_fail_all``), a request that has
  not streamed a single token resubmits to a healthy replica,
  token-identically, with what is left of its deadline, at most
  ``max_resubmits`` times; one that already streamed fails typed
  ``EngineShutdown``. With ``auto_restart`` the dead replica is
  rebuilt after an exponential backoff; past ``max_restarts`` deaths
  it parks ``DEGRADED``, and a pool with no healthy replica left
  raises ``PoolDegraded``.
- **Aggregate shed**: when every healthy replica sheds, the pool
  raises one ``EngineOverloaded`` whose ``retry_after_s`` is the
  largest of the replicas' hints.

``share_prefixes=True`` makes the replicas one prefix cache: each
engine is a ``kv_migration.KVDonor`` to its siblings, and a route
whose target holds less of the prompt than a sibling carries a pull
hint naming that sibling (``_pull_hint``), so the target pulls the
pages over ``loopback_call`` instead of recomputing them — never from
a sibling serving another ``weights_id`` (the cross-replica half of
the weight fence).

Prefill/decode disaggregation (``roles=``, which needs
``share_prefixes``): while a healthy ``prefill`` replica exists, an
online request of more than one token is served in two legs
(``PoolRequestHandle._stream_disagg``). Leg 1 takes ONE bridging token
on the prefill side (prefill or unified replicas); the engine retires
the slot after it, publishing the prompt's full pages into its prefix
cache. Leg 2 resumes the stream at ``prompt + [first]`` on the decode
side with a finished-prefill push hint (``kv_migration.
prefill_push_hint``), so the decode replica pulls the pages instead of
recomputing them. Every way leg 2 can fail before its first token
falls back typed: decode in place on the prefill replica, then any
healthy replica. Batch work and session stickiness never land on a
prefill replica. ``RolePoolView`` gives each side a pool-shaped view
for a per-role autoscaler.

The watchdog's marks (serve/watchdog.py): ``mark_suspect`` takes a
replica out of routing and capacity counts, ``clear_suspect`` gives it
back, ``mark_wedged`` force-kills it and runs the death path. An
attached autoscaler (serve/pool_autoscaler.py) installs
``capacity_hint_fn``; its and the watchdog's ``stats()`` are blocks of
``pool_stats()``.

The pool keeps its own ``obs.EventLog(2048, name="pool")`` (route,
resubmit, drain, restart, replica_death, weight, handoff, suspect,
wedged and autoscale events) and the reference's ``serve_pool_*`` and
``serve_disagg_*`` metrics. The fleet waits for ROADMAP.md, queue 1,
item 9.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_tpu_torch.serve import kv_migration, obs
from ray_tpu_torch.serve.errors import (DeadlineExceeded, EngineDraining,
                                        EngineOverloaded, EngineShutdown,
                                        PoolDegraded, RequestCancelled)
from ray_tpu_torch.serve.fleet.routing import (Candidate, ResubmitPolicy,
                                               select_candidate)
from ray_tpu_torch.serve.prefix_cache import path_hashes
from ray_tpu_torch.serve.scheduler import (LANE_BATCH, LANE_ONLINE,
                                           REPLICA_ROLES, ROLE_DECODE,
                                           ROLE_PREFILL, ROLE_UNIFIED)
from ray_tpu_torch.util import metrics

ROUTED = "serve_pool_routed_total"
AFFINITY_HITS = "serve_pool_affinity_hits_total"
STICKY_HITS = "serve_pool_sticky_hits_total"
SPILLS = "serve_pool_spills_total"
REQUEUES = "serve_pool_requeues_total"
REPLICA_DEATHS = "serve_pool_replica_deaths_total"
DRAINS = "serve_pool_drains_total"
RESTARTS = "serve_pool_restarts_total"
ALL_SHED = "serve_pool_all_shed_total"
FREE_SLOTS = "serve_pool_replica_free_slots"
QUEUE_DEPTH = "serve_pool_replica_queue_depth"
BATCH_QUEUE_DEPTH = "serve_pool_replica_batch_queue_depth"
CAPACITY_HINT_ERRORS = "serve_pool_capacity_hint_errors_total"
SUSPECTS = "serve_pool_suspect_total"
WEDGED = "serve_pool_wedged_total"
WEDGE_LATENCY = "serve_pool_wedge_detect_latency_s"
DISAGG_HANDOFFS = "serve_disagg_handoffs_total"
DISAGG_FALLBACKS = "serve_disagg_handoff_fallbacks_total"

# The role sets the disaggregated router selects over: new prompts land
# on the prefill side, handed-off streams on the decode side. Unified
# replicas serve both, which keeps a half-rolled or degraded
# disaggregated pool available.
_PREFILL_SIDE = (ROLE_PREFILL, ROLE_UNIFIED)
_DECODE_SIDE = (ROLE_DECODE, ROLE_UNIFIED)

_METRICS: Optional[dict] = None


def _metrics() -> dict:
    """Lazy metric singletons, re-created if a ``clear_registry()``
    dropped them (the engine's and the prefix cache's pattern)."""
    global _METRICS
    if (_METRICS is None
            or metrics.registry().get(ROUTED) is not _METRICS["routed"]):
        _METRICS = {
            "routed": metrics.Counter(
                ROUTED, "Requests routed by the engine pool"),
            "affinity_hits": metrics.Counter(
                AFFINITY_HITS, "Routes landing on a replica already "
                "holding a prefix of the prompt"),
            "sticky_hits": metrics.Counter(
                STICKY_HITS, "Routes resolved by session stickiness"),
            "spills": metrics.Counter(
                SPILLS, "Affinity targets saturated; request spilled "
                "to another replica"),
            "requeues": metrics.Counter(
                REQUEUES, "Unstreamed requests resubmitted after a "
                "replica death"),
            "replica_deaths": metrics.Counter(
                REPLICA_DEATHS, "Replica engines observed dead"),
            "drains": metrics.Counter(
                DRAINS, "Replica drains started"),
            "restarts": metrics.Counter(
                RESTARTS, "Replica engines rebuilt from the factory"),
            "all_shed": metrics.Counter(
                ALL_SHED, "Pool-aggregate sheds (every healthy "
                "replica refused admission)"),
            "free_slots": metrics.Gauge(
                FREE_SLOTS, "Free decode slots per replica",
                tag_keys=("replica",)),
            "queue_depth": metrics.Gauge(
                QUEUE_DEPTH, "Admission queue depth per replica "
                "(ONLINE lane — the saturation/autoscaling signal)",
                tag_keys=("replica",)),
            "batch_queue_depth": metrics.Gauge(
                BATCH_QUEUE_DEPTH, "BATCH-lane queue depth per "
                "replica (preemptible backlog; excluded from "
                "saturation and autoscaling signals)",
                tag_keys=("replica",)),
            "capacity_hint_errors": metrics.Counter(
                CAPACITY_HINT_ERRORS, "capacity_hint_fn raised; the "
                "pool fell back to the pending-backoff ETA"),
            "suspects": metrics.Counter(
                SUSPECTS, "Replicas quarantined SUSPECT by the "
                "watchdog (stale heartbeat with work pending)"),
            "wedged": metrics.Counter(
                WEDGED, "Replicas declared WEDGED and force-killed "
                "by the watchdog"),
            "wedge_latency": metrics.Histogram(
                WEDGE_LATENCY, "Seconds from last observed progress "
                "to the WEDGED declaration",
                boundaries=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                            10.0, 30.0)),
            "disagg_handoffs": metrics.Counter(
                DISAGG_HANDOFFS, "Prefill->decode stream handoffs "
                "submitted over the KV-migration path"),
            "disagg_fallbacks": metrics.Counter(
                DISAGG_FALLBACKS, "Handoffs aborted typed and fallen "
                "back to decoding in place"),
        }
    return _METRICS


HEALTHY = "healthy"
DRAINING = "draining"
DEAD = "dead"
# The watchdog's quarantine (serve/watchdog.py): the replica's progress
# heartbeat went stale WITH work pending. Routing, capacity counts and
# the autoscaler's signals all skip it (they filter on HEALTHY); the
# watchdog clears it back to HEALTHY on probed progress or escalates to
# the death path.
SUSPECT = "suspect"
# Scale-down tombstone: drained and shut down ON PURPOSE, never
# rebuilt; a later scale-up may reuse its index. Kept in the table so
# pool-wide quiescence checks still cover its engine.
RETIRED = "retired"
# Crash-loop terminal state: died ``max_restarts`` times; routing skips
# it until ``restart_dead()``.
DEGRADED = "degraded"


class _Replica:
    """One pool slot: a live engine plus its lifecycle state.
    ``generation`` counts factory rebuilds (drain restarts + failure
    restarts), so a caller can see a replica was actually replaced."""

    __slots__ = ("idx", "engine", "state", "deaths", "generation",
                 "role")

    def __init__(self, idx: int, engine, state: str = HEALTHY,
                 deaths: int = 0, generation: int = 0,
                 role: str = ROLE_UNIFIED):
        self.idx = idx
        self.engine = engine
        self.state = state
        self.deaths = deaths
        self.generation = generation
        self.role = role


class PoolRequestHandle(ResubmitPolicy):
    """Client-side view of a pooled request: the engine
    ``RequestHandle``'s surface (stream/result/cancel/done/error/
    ttft_s) plus the recovery loop. Iterating ``stream()`` (or
    ``result()``) resubmits the request to a healthy replica when its
    replica dies BEFORE any token was delivered; after the first
    delivery a replica death fails typed ``EngineShutdown`` — never a
    silent hang, never a duplicated token (``ResubmitPolicy``)."""

    def __init__(self, pool: "EnginePool", prompt: List[int],
                 max_new_tokens: int, deadline_s: Optional[float],
                 session_id: Optional[str],
                 trace_id: Optional[str] = None,
                 priority: str = LANE_ONLINE):
        super().__init__(prompt, max_new_tokens, deadline_s,
                         session_id, trace_id,
                         max_resubmits=pool.max_resubmits)
        self._pool = pool
        self._priority = priority
        self._rep: Optional[_Replica] = None
        self._inner = None
        # two-leg disaggregated service, set by the pool at submit when
        # it split the request: leg 1 streams ONE bridging token from
        # the prefill side, leg 2 the rest from the decode side over
        # the KV handoff
        self._disagg = False

    def stream(self):
        """Yield generated token ids; recover across replica deaths
        while the at-most-once guard allows (zero tokens delivered)."""
        if self._disagg:
            yield from self._stream_disagg()
            return
        while True:
            rep, inner = self._rep, self._inner
            try:
                for tok in inner.stream():
                    self._note_token(tok)
                    yield tok
                self._finished = True
                return
            except GeneratorExit:
                # the consumer closed the stream: not a failure, and
                # not a resubmission trigger
                raise
            except (RequestCancelled, DeadlineExceeded,
                    EngineOverloaded, EngineDraining) as e:
                # request-level outcomes: the pool never second-guesses
                # an explicit cancel, deadline or shed
                self._fail(e)
                raise
            except BaseException as e:
                # EngineShutdown, a contained fault's error, or the raw
                # global error a _fail_all delivered (ReplicaKilled):
                # the engine, not the exception type, says whether the
                # replica died
                if not self._pool._note_replica_death(rep):
                    self._fail(e)
                    raise
                if self._generated or self._cancelled:
                    raise self._partial_stream_error(
                        str(rep.idx), e) from e
                self._resubmit(e)      # raises typed when impossible

    def _stream_disagg(self):
        """The two-leg stream. Leg 1 (submitted by the pool): one
        bridging token on the prefill side; the engine retires the slot
        after it, publishing the prompt's full pages into the donor's
        prefix cache. Leg 2: the rest on the decode side, admitted with
        the finished-prefill push hint, so its KV lands over
        ``kv_migration.pull_prefix`` at full prompt length instead of
        being recomputed. Greedy fp32 decoding is deterministic, so the
        stitched stream equals single-replica service.

        Every way leg 2 can fail BEFORE its first token falls back
        typed (``_hand_off``); after leg 2 streams, a death fails typed
        as in the base loop: at most once per leg."""
        pool = self._pool
        first: Optional[int] = None
        # ---- leg 1: the bridging token from the prefill side
        while True:
            rep, inner = self._rep, self._inner
            try:
                for tok in inner.stream():
                    self._note_token(tok)
                    first = tok
                break
            except GeneratorExit:
                raise
            except (RequestCancelled, DeadlineExceeded,
                    EngineOverloaded, EngineDraining) as e:
                self._fail(e)
                raise
            except BaseException as e:
                if not pool._note_replica_death(rep):
                    self._fail(e)
                    raise
                if first is not None:
                    break     # the token landed; only the donor is gone
                if self._cancelled:
                    raise self._partial_stream_error(
                        str(rep.idx), e) from e
                deadline = self._check_resubmit(e)
                pool._count_requeue(trace_id=self._trace_id)
                try:
                    self._rep, self._inner = pool._submit_leg(
                        self._prompt, 1, deadline, None,
                        trace_id=self._trace_id, roles=_PREFILL_SIDE,
                        fallback_any=True)
                except BaseException as e2:
                    self._fail(e2)
                    raise
        if first is None:
            # the engine's contract: a stream that does not fail emits
            # at least one token
            err = EngineShutdown("prefill leg closed without a token")
            self._fail(err)
            raise err
        yield first
        if self._mnt <= 1 or self._cancelled:
            self._finished = True
            return
        # ---- the handoff: the decode leg resumes at full prompt length
        donor = self._rep
        prompt2 = self._prompt + [first]
        mnt2 = self._mnt - 1
        self._rep = self._inner = None
        self._hand_off(donor, prompt2, mnt2)
        # ---- leg 2: the stream on the decode side
        leg2_tokens = 0
        while True:
            rep, inner = self._rep, self._inner
            try:
                for tok in inner.stream():
                    if leg2_tokens == 0:
                        pool._note_handoff_first_token(
                            rep, trace_id=self._trace_id)
                    leg2_tokens += 1
                    self._note_token(tok)
                    yield tok
                self._finished = True
                return
            except GeneratorExit:
                raise
            except (RequestCancelled, DeadlineExceeded,
                    EngineOverloaded, EngineDraining) as e:
                self._fail(e)
                raise
            except BaseException as e:
                if not pool._note_replica_death(rep):
                    self._fail(e)
                    raise
                if leg2_tokens or self._cancelled:
                    raise self._partial_stream_error(
                        str(rep.idx), e) from e
                self._check_resubmit(e)
                pool._count_requeue(trace_id=self._trace_id)
                self._hand_off(donor, prompt2, mnt2)

    def _hand_off(self, donor: Optional[_Replica], prompt2: List[int],
                  mnt2: int) -> None:
        """Submit the decode leg: a decode-side route with the
        finished-prefill push hint, then the typed-abort fallback
        ladder — decode in place on the donor (its prefix cache holds
        the prompt's pages: a local-hit residual prefill), then any
        healthy replica (plain prefill). Raises typed only when no
        replica at all can take the stream."""
        pool = self._pool
        deadline = (self._remaining_deadline(None)
                    if self._deadline_s is not None else None)
        donor_live = (donor is not None
                      and not getattr(donor.engine, "_stopped", True))
        hint = None
        if donor_live:
            hint = kv_migration.prefill_push_hint(
                self._prompt, getattr(donor.engine, "Pg", 0),
                replica_idx=donor.idx)
        try:
            self._rep, self._inner = pool._submit_leg(
                prompt2, mnt2, deadline, self._session_id,
                trace_id=self._trace_id, roles=_DECODE_SIDE, pull=hint,
                exclude={donor.idx} if donor_live else None)
            pool._note_handoff(donor, self._rep, trace_id=self._trace_id)
            return
        except (RequestCancelled, DeadlineExceeded) as e:
            self._fail(e)
            raise
        except BaseException as e:  # noqa: BLE001 - the ladder below
            cause = e
        pool._note_handoff_fallback(donor, cause, trace_id=self._trace_id)
        if donor_live:
            try:
                self._rep, self._inner = pool._submit_once(
                    prompt2, mnt2, deadline, None,
                    trace_id=self._trace_id, target_idx=donor.idx,
                    record_sticky=False)
                return
            except (RequestCancelled, DeadlineExceeded) as e:
                self._fail(e)
                raise
            except BaseException:  # noqa: BLE001 - the donor died too
                pass
        try:
            self._rep, self._inner = pool._submit_once(
                prompt2, mnt2, deadline, self._session_id,
                trace_id=self._trace_id)
        except BaseException as e:
            self._fail(e)
            raise

    def cancel(self) -> bool:
        self._cancelled = True
        inner = self._inner
        return inner.cancel() if inner is not None else False

    @property
    def replica_idx(self) -> Optional[int]:
        return self._rep.idx if self._rep is not None else None

    @property
    def replica_tag(self) -> Optional[str]:
        """``idx:generation`` of the serving replica incarnation: a
        resubmit onto a rebuilt replica of the same idx shows another
        tag."""
        rep = self._rep
        return (f"{rep.idx}:{rep.generation}"
                if rep is not None else None)

    @property
    def weights_tag(self) -> Optional[str]:
        """``generation:weights_id`` of the serving replica's engine."""
        rep = self._rep
        eng = getattr(rep, "engine", None) if rep is not None else None
        gen = getattr(eng, "weight_generation", None)
        if gen is None:
            return None
        return f"{gen}:{getattr(eng, 'weights_id', None)}"

    @property
    def logprobs(self) -> Optional[List[float]]:
        """Per-token sampling logprobs from the serving replica's
        handle (engines built with ``capture_logprobs=True``; else
        None). A resubmit regenerates from scratch, so the list is
        always one engine's aligned stream."""
        inner = self._inner
        if inner is None:
            return None
        return getattr(inner, "logprobs", None)

    def _resubmit(self, cause: BaseException) -> None:
        deadline = self._check_resubmit(cause)
        self._pool._count_requeue(trace_id=self._trace_id)
        try:
            self._rep, self._inner = self._pool._submit_once(
                self._prompt, self._mnt, deadline, self._session_id,
                trace_id=self._trace_id, priority=self._priority)
        except BaseException as e:
            self._fail(e)
            raise

    def _attach(self, rep: _Replica, inner) -> None:
        self._rep, self._inner = rep, inner


class EnginePool:
    """N ``LLMEngine`` replicas as one logical engine (the module
    docstring has the routing and lifecycle contract).

    Parameters
    ----------
    engine_factory: ``f(replica_idx) -> LLMEngine`` building ONE
        replica (not started; the pool starts it). Called again on
        drain-restart and failure-restart, so config changes in the
        factory roll out through ``rolling_restart``.
    num_replicas: pool width.
    auto_restart: rebuild dead replicas in the background (off by
        default: deterministic pool shapes).
    max_resubmits: per-request cap on death-triggered resubmissions
        (default ``num_replicas``).
    max_sticky_sessions: bound of the session LRU.
    restart_backoff_s / restart_backoff_max_s: exponential backoff
        between auto-restarts of a dying replica (doubles per death,
        capped).
    max_restarts: per-replica death cap; past it the replica parks
        ``DEGRADED``. None = unlimited.
    share_prefixes: the replicas pull each other's cached prefixes
        (``kv_migration``) instead of recomputing them.
    roles: every replica's role (``"prefill"``, ``"decode"`` or
        ``"unified"``, the default); a pool with any other than unified
        is disaggregated and needs ``share_prefixes=True``.
    kv_pull_deadline_s / kv_pull_backoff_s: ``pull_prefix`` knob
        overrides (None: its defaults), validated here.
    seed: the power-of-two-choices sampling seed.
    """

    def __init__(self, engine_factory: Callable[[int], Any],
                 num_replicas: int, *,
                 auto_restart: bool = False,
                 max_resubmits: Optional[int] = None,
                 max_sticky_sessions: int = 4096,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_max_s: float = 5.0,
                 max_restarts: Optional[int] = 5,
                 share_prefixes: bool = False,
                 roles: Optional[Sequence[str]] = None,
                 kv_pull_deadline_s: Optional[float] = None,
                 kv_pull_backoff_s: Optional[float] = None,
                 seed: int = 0):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if roles is None:
            roles = [ROLE_UNIFIED] * num_replicas
        else:
            roles = list(roles)
            if len(roles) != num_replicas:
                raise ValueError(
                    f"roles must name every replica: got "
                    f"{len(roles)} roles for {num_replicas} replicas")
            for role in roles:
                _check_role(role)
            if (any(r != ROLE_UNIFIED for r in roles)
                    and not share_prefixes):
                # the handoff path IS the share_prefixes KV wiring: a
                # disaggregated pool without it would re-prefill every
                # handed-off stream
                raise ValueError(
                    "role-disaggregated pools require "
                    "share_prefixes=True (the KV handoff path)")
        self._factory = engine_factory
        # requester-side pull knob overrides (None: pull_prefix's
        # defaults), validated typed at construction
        self._kv_pull_knobs = kv_migration.validate_pull_knobs(
            kv_pull_deadline_s, kv_pull_backoff_s)
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._auto_restart = auto_restart
        self.max_resubmits = (max_resubmits if max_resubmits
                              is not None else num_replicas)
        self._max_sticky = max_sticky_sessions
        self.restart_backoff_s = max(0.0, float(restart_backoff_s))
        self.restart_backoff_max_s = max(
            self.restart_backoff_s, float(restart_backoff_max_s))
        self.max_restarts = max_restarts
        # the ETA (s) until capacity being provisioned joins the pool,
        # installed by an attached PoolAutoscaler: an all-shed
        # Retry-After never invites a client back before it exists
        self.capacity_hint_fn: Optional[Callable[[], float]] = None
        self._autoscaler = None      # an attached PoolAutoscaler
        self._watchdog = None        # an attached PoolWatchdog
        self._sticky: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        # routing and lifecycle counters (the engines keep their own
        # ``stats``; ``EnginePool.stats`` sums those)
        self.route_stats: Dict[str, int] = collections.Counter()
        # tokens of routes chosen but not yet queued at their replica
        # (``_route``), counted as that replica's outstanding work
        self._routing: Dict[int, int] = collections.Counter()
        self.events = obs.EventLog(2048, name="pool")
        self._stopped = False
        self._share_prefixes = bool(share_prefixes)
        self._kv_donors: Dict[int, kv_migration.KVDonor] = {}
        # role -> RolePoolView, registered by the views: the per-role
        # autoscalers' attachment points and pool_stats blocks
        self._role_views: Dict[str, Any] = {}
        # the payload every rebuilt or added replica is re-stamped to
        # (``set_weight_source``): the factory closes over the
        # original weights
        self._weight_source: Optional[Dict[str, Any]] = None
        self._replicas: List[_Replica] = []
        for i in range(num_replicas):
            eng = engine_factory(i)
            self._stamp_role(eng, roles[i])
            self._stamp_replica_tag(eng, i)
            eng.start()
            rep = _Replica(i, eng, role=roles[i])
            self._replicas.append(rep)
            self._wire_kv(rep)

    @staticmethod
    def _stamp_role(engine, role: str) -> None:
        """Stamp a replica's role onto its engine after the factory
        built it: one ``f(idx)`` factory serves both sides, and the
        role steers only dynamic decisions (the planner caps of
        ``role_plan_caps``, the load report). Engines without the
        attribute (a test's fakes) are left alone."""
        try:
            engine.role = role
        except Exception:  # noqa: BLE001 - best effort
            pass

    @staticmethod
    def _stamp_replica_tag(engine, idx: int) -> None:
        """Stamp the pool index onto the engine so its per-replica
        metrics (the ``serve_weight_generation`` gauge) are
        attributable. Engines without the attribute are left alone."""
        try:
            engine.replica_tag = str(idx)
        except Exception:  # noqa: BLE001 - best effort
            pass

    def _restamp_weights(self, rep: _Replica) -> None:
        """Bring a freshly built replica onto the pool's CURRENT
        weights: the factory closes over the original ones, and a
        replica rebuilt after a rollout must not rejoin on generation
        0. Best effort: a failure is evented and leaves the replica on
        the factory's weights."""
        src = self._weight_source
        eng = rep.engine
        if src is None or not hasattr(eng, "swap_weights"):
            return
        try:
            eng.swap_weights(src["params"],
                             generation=src["generation"],
                             weights_id=src["weights_id"])
            self.events.append("weight_restamp", sid=rep.idx,
                               data={"generation": src["generation"],
                                     "weights_id": src["weights_id"]})
        except Exception as e:  # noqa: BLE001
            self.events.append("weight_restamp_failed", sid=rep.idx,
                               data={"error": repr(e)})

    def set_weight_source(self, params, *, weights_id: str,
                          generation: int) -> None:
        """Record the payload every future rebuild or add re-stamps to
        (call after each completed rollout or rollback)."""
        with self._lock:
            self._weight_source = {"params": params,
                                   "weights_id": weights_id,
                                   "generation": int(generation)}
        self.events.append("weight_source", data={
            "generation": int(generation), "weights_id": weights_id})

    def swap_replica_weights(self, idx: int, params, *,
                             weights_id: Optional[str] = None,
                             generation: Optional[int] = None,
                             mode: str = "preempt") -> int:
        """Hot-swap ONE replica's weights through the engine's
        generation fence (``LLMEngine.swap_weights``). Returns the
        generation now serving on that replica."""
        with self._lock:
            rep = self._replicas[idx]
            if rep.state not in (HEALTHY, SUSPECT):
                raise RuntimeError(
                    f"replica {idx} is {rep.state}; only live "
                    f"replicas can swap weights")
        gen = rep.engine.swap_weights(params, generation=generation,
                                      weights_id=weights_id, mode=mode)
        with self._lock:
            self.route_stats["weight_swaps"] += 1
        self.events.append("weight_swap", sid=idx,
                           data={"generation": gen,
                                 "weights_id": rep.engine.weights_id,
                                 "mode": mode})
        return gen

    # --------------------------------------------------------- public

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    def engines(self) -> List[Any]:
        """Every replica engine, whatever its state (quiescence checks
        cover dead replicas too)."""
        return [r.engine for r in self._replicas]

    def replica(self, idx: int) -> _Replica:
        return self._replicas[idx]

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.state == HEALTHY)

    def active_count(self) -> int:
        """Replicas holding capacity (anything but a tombstone)."""
        with self._lock:
            return sum(1 for r in self._replicas if r.state != RETIRED)

    @property
    def degraded(self) -> bool:
        """True when any replica burned through its restart cap."""
        with self._lock:
            return any(r.state == DEGRADED for r in self._replicas)

    def disaggregated(self) -> bool:
        """True while a healthy prefill replica exists: the condition
        under which an online request splits into two legs. Read per
        submit, so a pool whose last prefill replica died serves
        unified instead of stranding traffic."""
        with self._lock:
            return any(r.role == ROLE_PREFILL and r.state == HEALTHY
                       for r in self._replicas)

    def role_counts(self) -> Dict[str, int]:
        """Active (not retired) replicas per role."""
        out: Dict[str, int] = collections.Counter()
        with self._lock:
            for r in self._replicas:
                if r.state != RETIRED:
                    out[r.role] += 1
        return dict(out)

    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: int = 64,
               deadline_s: Optional[float] = None,
               session_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               priority: str = LANE_ONLINE) -> PoolRequestHandle:
        """Route and queue one request (the engine's ``submit`` plus
        ``session_id`` for stickiness; ``trace_id`` survives
        resubmits). Raises like one engine: ``RequestError`` for a bad
        request at once, a pool-aggregate ``EngineOverloaded`` when
        every healthy replica sheds, ``EngineShutdown`` when none is
        left (``PoolDegraded`` past the restart cap).
        ``priority="batch"`` takes the batch spill route. In a
        disaggregated pool an online request of more than one token
        starts its first leg on the prefill side (module docstring),
        or is served unified when that side cannot admit at all."""
        if self._stopped:
            raise EngineShutdown("engine pool stopped")
        prompt = [int(t) for t in prompt_ids]
        handle = PoolRequestHandle(self, prompt, max_new_tokens,
                                   deadline_s, session_id, trace_id,
                                   priority=priority)
        if (priority == LANE_ONLINE and max_new_tokens > 1
                and self.disaggregated()):
            # leg 1: ONE token on the prefill side; the session is not
            # passed, so no sticky entry ever pins it to a prefill
            # replica
            try:
                rep, inner = self._submit_once(
                    prompt, 1, deadline_s, None, trace_id=trace_id,
                    roles=_PREFILL_SIDE)
                handle._disagg = True
                handle._attach(rep, inner)
                return handle
            except (EngineShutdown, PoolDegraded):
                pass
        rep, inner = self._submit_once(prompt, max_new_tokens,
                                       deadline_s, session_id,
                                       trace_id=trace_id,
                                       priority=priority)
        handle._attach(rep, inner)
        return handle

    def submit_rollout_batch(self, prompts: Sequence[Sequence[int]],
                             max_new_tokens: int = 64,
                             deadline_s: Optional[float] = None,
                             trace_id: Optional[str] = None
                             ) -> List[PoolRequestHandle]:
        """One BATCH-lane request per prompt, in order, each through
        the batch spill route (``LLMEngine.submit_rollout_batch``'s
        surface)."""
        return [self.submit(list(p), max_new_tokens=max_new_tokens,
                            deadline_s=deadline_s,
                            trace_id=(f"{trace_id}:{i}"
                                      if trace_id else None),
                            priority=LANE_BATCH)
                for i, p in enumerate(prompts)]

    def _submit_leg(self, prompt: List[int], max_new_tokens: int,
                    deadline_s: Optional[float],
                    session_id: Optional[str], *,
                    trace_id: Optional[str] = None,
                    roles: Optional[Sequence[str]] = None,
                    pull: Optional[Dict[str, Any]] = None,
                    exclude: Optional[set] = None,
                    fallback_any: bool = False):
        """One leg of a disaggregated request: a role-filtered
        ``_submit_once``, with ``fallback_any`` an unrestricted route
        when the whole side is gone (a dead prefill side must not
        strand a request a decode replica could still serve by plain
        prefill)."""
        try:
            return self._submit_once(prompt, max_new_tokens, deadline_s,
                                     session_id, trace_id=trace_id,
                                     roles=roles, pull=pull,
                                     exclude=exclude)
        except (EngineShutdown, PoolDegraded):
            if not fallback_any:
                raise
            return self._submit_once(prompt, max_new_tokens, deadline_s,
                                     session_id, trace_id=trace_id)

    def _note_handoff(self, donor: Optional[_Replica], target: _Replica,
                      trace_id: Optional[str] = None) -> None:
        with self._lock:
            self.route_stats["disagg_handoffs"] += 1
        self.events.append(
            "handoff", sid=target.idx,
            data={"from": donor.idx if donor is not None else None,
                  "to": target.idx, "trace_id": trace_id})
        _metrics()["disagg_handoffs"].inc()

    def _note_handoff_first_token(self, target: _Replica,
                                  trace_id: Optional[str] = None) -> None:
        """The decode leg's first token: the closing edge of the
        handoff latency, which opens at the ``handoff`` event."""
        self.events.append("handoff_first_token", sid=target.idx,
                           data={"to": target.idx, "trace_id": trace_id})

    def _note_handoff_fallback(self, donor: Optional[_Replica],
                               cause: BaseException,
                               trace_id: Optional[str] = None) -> None:
        with self._lock:
            self.route_stats["disagg_handoff_fallbacks"] += 1
        self.events.append(
            "handoff_fallback",
            sid=donor.idx if donor is not None else None,
            data={"error": repr(cause), "trace_id": trace_id})
        _metrics()["disagg_fallbacks"].inc()

    def shutdown(self) -> None:
        """Stop every replica; queued and in-flight requests fail typed
        ``EngineShutdown``. Idempotent."""
        self._stopped = True
        for rep in self._replicas:
            try:
                rep.engine.shutdown()
            except Exception:  # noqa: BLE001
                pass
            rep.state = DEAD

    # ------------------------------------------------------- lifecycle

    def drain(self, idx: int, timeout_s: float = 30.0) -> bool:
        """Gracefully restart replica ``idx``: stop admitting, let
        in-flight work finish (up to ``timeout_s``), shut down and
        rebuild from the factory. True when nothing was left to fail;
        False when the budget expired (the stragglers fail typed, and
        the unstreamed ones resubmit)."""
        clean = self._drain_out(idx, timeout_s)
        self._rebuild(idx)
        return clean

    def _drain_out(self, idx: int, timeout_s: float) -> bool:
        """Stop admitting, wait for in-flight work (bounded), shut
        down: shared by ``drain`` (which rebuilds after) and ``retire``
        (which doesn't)."""
        with self._lock:
            rep = self._replicas[idx]
            if rep.state != HEALTHY:
                raise RuntimeError(
                    f"replica {idx} is {rep.state}; only a healthy "
                    f"replica can drain")
            rep.state = DRAINING
            self.route_stats["drains"] += 1
            self._drop_sticky_locked(idx)
        self.events.append("drain", sid=idx)
        _metrics()["drains"].inc()
        eng = rep.engine
        eng.drain()
        clean = eng.wait_idle(timeout_s)
        try:
            eng.shutdown()
        except Exception:  # noqa: BLE001
            pass
        return clean

    def add_replica(self, role: str = ROLE_UNIFIED) -> int:
        """Scale up by one from the factory, reusing a retired index
        when there is one (its generation bumps). ``role`` places the
        new replica on a disaggregated pool's prefill or decode side.
        Returns the index."""
        if self._stopped:
            raise EngineShutdown("engine pool stopped")
        _check_role(role)
        with self._lock:
            retired = [r for r in self._replicas if r.state == RETIRED]
            idx = retired[0].idx if retired else len(self._replicas)
            if retired:
                retired[0].role = role    # _rebuild carries it over
        if retired:
            self._rebuild(idx)
        else:
            eng = self._factory(idx)
            self._stamp_role(eng, role)
            self._stamp_replica_tag(eng, idx)
            eng.start()
            rep = _Replica(idx, eng, role=role)
            with self._lock:
                self._replicas.append(rep)
            self._wire_kv(rep)
            self._restamp_weights(rep)
        with self._lock:
            self.route_stats["replicas_added"] += 1
        return idx

    def retire(self, idx: int, timeout_s: float = 30.0) -> bool:
        """Scale down replica ``idx`` through the drain path, leaving a
        ``RETIRED`` tombstone instead of rebuilding. Returns the drain's
        cleanliness."""
        with self._lock:
            healthy = sum(1 for r in self._replicas
                          if r.state == HEALTHY)
            if healthy <= 1 and self._replicas[idx].state == HEALTHY:
                raise RuntimeError(
                    "refusing to retire the last healthy replica")
        clean = self._drain_out(idx, timeout_s)
        with self._lock:
            self._replicas[idx].state = RETIRED
            self.route_stats["replicas_retired"] += 1
        return clean

    def scale_down(self, n: int = 1, timeout_s: float = 30.0,
                   role: Optional[str] = None) -> List[int]:
        """Retire the ``n`` least-loaded healthy replicas (by
        outstanding tokens), never going below one healthy replica — of
        ``role`` when it is given (a per-role autoscaler never retires
        its side's last replica). Returns the retired indices."""
        with self._lock:
            candidates = [r for r in self._replicas if r.state == HEALTHY
                          and (role is None or r.role == role)]
        n = min(n, len(candidates) - 1)
        if n <= 0:
            return []
        load = []
        for r in candidates:
            try:
                rpt = r.engine.load_report()
                load.append((rpt.get("outstanding_tokens", 0), r.idx))
            except Exception:  # noqa: BLE001
                load.append((0, r.idx))
        load.sort()
        out = []
        for _, idx in load[:n]:
            try:
                self.retire(idx, timeout_s)
            except RuntimeError:
                continue       # raced a death; the count moved
            out.append(idx)
        return out

    def scale_to(self, n: int, timeout_s: float = 30.0) -> int:
        """Converge to ``n`` active replicas (adds from the factory,
        removes through ``scale_down``). Returns the active count."""
        if n < 1:
            raise ValueError("scale_to target must be >= 1")
        while self.active_count() < n:
            self.add_replica()
        excess = self.active_count() - n
        if excess > 0:
            self.scale_down(excess, timeout_s)
        return self.active_count()

    def rolling_restart(self, timeout_s: float = 30.0) -> bool:
        """Drain-restart every replica in turn. True iff every drain
        was clean."""
        clean = True
        for idx in range(len(self._replicas)):
            clean = self.drain(idx, timeout_s) and clean
        return clean

    def restart_dead(self) -> int:
        """Rebuild every DEAD (and DEGRADED: the manual override)
        replica now. Returns how many were rebuilt."""
        with self._lock:
            dead = [r.idx for r in self._replicas
                    if r.state in (DEAD, DEGRADED)]
        for idx in dead:
            self._rebuild(idx)
        return len(dead)

    def _rebuild(self, idx: int) -> None:
        old = self._replicas[idx]
        eng = self._factory(idx)
        self._stamp_role(eng, old.role)
        self._stamp_replica_tag(eng, idx)
        eng.start()
        with self._lock:
            self._replicas[idx] = _Replica(
                idx, eng, HEALTHY, deaths=old.deaths,
                generation=old.generation + 1, role=old.role)
            self.route_stats["restarts"] += 1
        self._wire_kv(self._replicas[idx])
        self._restamp_weights(self._replicas[idx])
        self.events.append("restart", sid=idx,
                           data={"generation": old.generation + 1})
        _metrics()["restarts"].inc()

    # -------------------------------------------------- watchdog marks

    def mark_suspect(self, rep: _Replica) -> bool:
        """HEALTHY -> SUSPECT (the watchdog's quarantine): the replica
        stops counting as capacity everywhere at once, since routing,
        ``healthy_count``, scale-down and the autoscaler's signals all
        filter on HEALTHY. False when the replica moved on (died,
        drained, was replaced) since it was observed."""
        with self._lock:
            if (self._replicas[rep.idx] is not rep
                    or rep.state != HEALTHY):
                return False
            rep.state = SUSPECT
            self.route_stats["suspects"] += 1
            self._drop_sticky_locked(rep.idx)
        self.events.append("suspect", sid=rep.idx)
        _metrics()["suspects"].inc()
        return True

    def clear_suspect(self, rep: _Replica) -> bool:
        """SUSPECT -> HEALTHY: the probe saw progress (a long but moving
        dispatch, not a wedge); the replica takes traffic again."""
        with self._lock:
            if (self._replicas[rep.idx] is not rep
                    or rep.state != SUSPECT):
                return False
            rep.state = HEALTHY
        self.events.append("suspect_cleared", sid=rep.idx)
        return True

    def mark_wedged(self, rep: _Replica,
                    err: Optional[BaseException] = None,
                    stalled_for_s: Optional[float] = None) -> bool:
        """Declare a silent replica WEDGED and drive the death path:
        ``force_kill`` the engine out of band (lock-free: the wedged
        scheduler thread holds the engine lock), which fails every
        consumer typed so the unstreamed requests resubmit, then
        ``_note_replica_death`` marks it DEAD and schedules the rebuild.
        Healthy replicas are never touched."""
        with self._lock:
            if (self._replicas[rep.idx] is not rep
                    or rep.state not in (HEALTHY, SUSPECT)):
                return False
            self.route_stats["wedged"] += 1
        self.events.append("wedged", sid=rep.idx,
                           data={"stalled_for_s": stalled_for_s,
                                 "error": repr(err) if err else None})
        m = _metrics()
        m["wedged"].inc()
        if stalled_for_s is not None:
            m["wedge_latency"].observe(stalled_for_s)
        try:
            rep.engine.force_kill(err)
        except Exception:  # noqa: BLE001 - the death path still runs
            pass
        return self._note_replica_death(rep)

    def _note_replica_death(self, rep: _Replica) -> bool:
        """Judge (and record) a replica death: True iff ``rep``'s
        engine has globally stopped — the line between a request-level
        failure (engine alive: not the pool's business) and a replica
        death (recoverable by routing around it)."""
        if not getattr(rep.engine, "_stopped", False):
            return False
        restart = False
        transitioned = False
        with self._lock:
            if (self._replicas[rep.idx] is rep
                    and rep.state not in (DEAD, DEGRADED, RETIRED)):
                rep.state = DEAD
                rep.deaths += 1
                transitioned = True
                self.route_stats["replica_deaths"] += 1
                self._drop_sticky_locked(rep.idx)
                restart = self._auto_restart and not self._stopped
                if (restart and self.max_restarts is not None
                        and rep.deaths > self.max_restarts):
                    # crash loop: stop feeding the factory
                    restart = False
                    rep.state = DEGRADED
                    self.route_stats["crash_loops"] += 1
        if transitioned:
            self.events.append("replica_death", sid=rep.idx,
                               data={"deaths": rep.deaths,
                                     "state": rep.state})
            _metrics()["replica_deaths"].inc()
        # idempotent: unblocks every remaining consumer typed and frees
        # what the dead scheduler left behind
        try:
            rep.engine.shutdown()
        except Exception:  # noqa: BLE001
            pass
        if restart:
            backoff = min(self.restart_backoff_max_s,
                          self.restart_backoff_s
                          * (2 ** (rep.deaths - 1)))
            threading.Thread(target=self._backoff_rebuild,
                             args=(rep, backoff),
                             name=f"pool-restart-{rep.idx}",
                             daemon=True).start()
        return True

    def _backoff_rebuild(self, rep: _Replica, backoff_s: float) -> None:
        if backoff_s > 0:
            time.sleep(backoff_s)
        with self._lock:
            # the world may have moved during the backoff: pool
            # stopped, replica replaced or rebuilt by hand
            if (self._stopped or self._replicas[rep.idx] is not rep
                    or rep.state != DEAD):
                return
        self._rebuild(rep.idx)

    def _restart_eta_s(self) -> float:
        """Retry-After for a pool with no healthy replica: the larger
        of the provisioning ETA (``capacity_hint_fn``) and the longest
        pending auto-restart backoff."""
        eta = 0.0
        if self.capacity_hint_fn is not None:
            try:
                eta = max(eta, float(self.capacity_hint_fn()))
            except Exception:  # noqa: BLE001
                _metrics()["capacity_hint_errors"].inc()
        return max(eta, self._pending_backoff_eta_s())

    def _pending_backoff_eta_s(self) -> float:
        """Longest pending auto-restart backoff."""
        eta = 0.0
        if self._auto_restart:
            with self._lock:
                dead_deaths = [r.deaths for r in self._replicas
                               if r.state == DEAD]
            for deaths in dead_deaths:
                eta = max(eta, min(
                    self.restart_backoff_max_s,
                    self.restart_backoff_s * (2 ** max(0, deaths - 1))))
        return eta

    def _drop_sticky_locked(self, idx: int) -> None:
        for k in [k for k, v in self._sticky.items() if v == idx]:
            del self._sticky[k]

    def _count_requeue(self, trace_id: Optional[str] = None) -> None:
        with self._lock:
            self.route_stats["requeues"] += 1
        self.events.append("resubmit",
                           data={"trace_id": trace_id}
                           if trace_id is not None else None)
        _metrics()["requeues"].inc()

    # ---------------------------------------------- prefix sharing

    def _wire_kv(self, rep: _Replica) -> None:
        """Register ``rep``'s engine as a KV donor and hand it a
        fetcher that pulls from its siblings. Re-run on every rebuild:
        the donor table always points at each slot's LIVE engine (a
        transfer begun against the old incarnation aborts typed)."""
        if not self._share_prefixes:
            return
        eng = rep.engine
        if not hasattr(eng, "kv_migration_stats"):
            return
        with self._lock:
            self._kv_donors[rep.idx] = kv_migration.KVDonor(eng)
        eng.kv_fetcher = lambda pull, e=eng: self._kv_fetch(e, pull)

    def _kv_fetch(self, requester_engine,
                  pull: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        with self._lock:
            donor = self._kv_donors.get(pull.get("replica_idx"))
        if donor is None:
            return None
        try:
            return kv_migration.pull_prefix(
                kv_migration.loopback_call(donor),
                pull.get("hashes") or [],
                stats=requester_engine.kv_migration_stats,
                **self._kv_pull_knobs)
        except Exception:  # noqa: BLE001 - a failed pull is a fallback
            return None

    def _pull_hint(self, prompt: List[int], rep: _Replica,
                   reports: Dict[int, Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
        """When a sibling advertises a strictly longer cached prefix of
        this prompt than the routed target does, name it as the donor:
        the target pulls instead of recomputing. Only a sibling serving
        the target's ``weights_id`` counts: another payload's pages
        were computed under weights the target does not run."""
        Pg = getattr(rep.engine, "Pg", 0)
        if Pg <= 0 or len(prompt) < Pg:
            return None
        chain = path_hashes(prompt, Pg)
        my_wid = reports.get(rep.idx, {}).get("weights_id")

        def cover(idx: int) -> int:
            rpt = reports.get(idx, {})
            if rpt.get("weights_id") != my_wid:
                return 0
            have = rpt.get("prefix_digest") or frozenset()
            n = 0
            for h in chain:
                if h not in have:
                    break
                n += 1
            return n

        best_idx, best_n = None, cover(rep.idx)
        for idx in reports:
            if idx == rep.idx:
                continue
            n = cover(idx)
            if n > best_n:
                best_idx, best_n = idx, n
        if best_idx is None:
            return None
        with self._lock:
            self.route_stats["pull_hints"] += 1
        return {"hashes": chain[:best_n], "replica_idx": best_idx}

    def kv_migration_stats(self) -> Optional[Dict[str, Any]]:
        """Summed cross-replica KV pull counters of the replicas."""
        per = [getattr(r.engine, "kv_migration_stats", None)
               for r in self._replicas]
        return self._agg_numeric(per)

    # --------------------------------------------------------- routing

    def _submit_once(self, prompt: List[int], max_new_tokens: int,
                     deadline_s: Optional[float],
                     session_id: Optional[str],
                     trace_id: Optional[str] = None,
                     priority: str = LANE_ONLINE,
                     roles: Optional[Sequence[str]] = None,
                     pull: Optional[Dict[str, Any]] = None,
                     exclude: Optional[set] = None,
                     target_idx: Optional[int] = None,
                     record_sticky: bool = True):
        """Route and submit until one replica accepts. A replica that
        sheds, dies or drains between the snapshot and the submit is
        excluded and routing retries; when nothing accepts, the
        failure is typed and aggregated. ``roles`` restricts routing to
        those replica roles; ``pull`` overrides the routed pull hint
        (the finished-prefill push hint); ``target_idx`` skips routing
        and submits to that one healthy replica (the decode-in-place
        rung); ``record_sticky=False`` writes no session placement."""
        batch = priority == LANE_BATCH
        exclude = set(exclude) if exclude else set()
        shed: List[EngineOverloaded] = []
        cost = len(prompt) + max_new_tokens
        while True:
            if target_idx is not None:
                rep, decision = self._route_direct(target_idx)
            else:
                rep, decision = self._route(prompt, session_id, exclude,
                                            batch=batch, cost=cost,
                                            roles=roles)
            if rep is not None and pull is not None:
                decision = dict(decision, pull=pull)
            if rep is None:
                hints = decision.get("hints", [])
                hints += [e.retry_after_s for e in shed]
                if hints:
                    with self._lock:
                        self.route_stats["all_shed"] += 1
                    _metrics()["all_shed"].inc()
                    # under provisioning, the hint covers its ETA
                    if self.capacity_hint_fn is not None:
                        try:
                            eta = float(self.capacity_hint_fn())
                        except Exception:  # noqa: BLE001
                            _metrics()["capacity_hint_errors"].inc()
                            eta = self._pending_backoff_eta_s()
                        if eta > 0:
                            hints.append(eta)
                    err = EngineOverloaded(
                        f"all healthy replicas shed (retry hints "
                        f"{sorted(set(round(h, 3) for h in hints))})",
                        retry_after_s=max(hints))
                    if shed:
                        raise err from shed[-1]
                    raise err
                # no healthy replica and nobody shed: carry the restart
                # ETA, so a Retry-After can still be honest
                eta = self._restart_eta_s()
                if self.degraded:
                    raise PoolDegraded(
                        "no healthy replicas: the pool burned through "
                        "its crash-loop restart budget "
                        f"(max_restarts={self.max_restarts})",
                        retry_after_s=eta if eta > 0 else None)
                err = EngineShutdown("no healthy replicas in pool")
                if eta > 0:
                    err.retry_after_s = eta
                raise err
            try:
                kw: Dict[str, Any] = dict(max_new_tokens=max_new_tokens,
                                          deadline_s=deadline_s)
                # the optional arguments only when set: an engine
                # surface without them (a test's fake) still serves
                if trace_id is not None:
                    kw["trace_id"] = trace_id
                if decision.get("pull") is not None:
                    kw["pull"] = decision["pull"]
                if batch:
                    kw["priority"] = priority
                inner = rep.engine.submit(prompt, **kw)
            except EngineOverloaded as e:
                if target_idx is not None:
                    raise
                shed.append(e)
                exclude.add(rep.idx)
                continue
            except (EngineShutdown, EngineDraining):
                # raced a death or a drain after the snapshot
                self._note_replica_death(rep)
                if target_idx is not None:
                    raise
                exclude.add(rep.idx)
                continue
            finally:
                if target_idx is None:
                    with self._lock:
                        self._routing[rep.idx] -= cost
            self._record_route(rep, decision,
                               session_id if record_sticky else None,
                               trace_id=trace_id)
            return rep, inner

    def _route_direct(self, idx: int):
        """Target replica ``idx`` directly: a health check shaped like
        a route decision."""
        with self._lock:
            rep = (self._replicas[idx]
                   if 0 <= idx < len(self._replicas) else None)
            if rep is None or rep.state != HEALTHY:
                rep = None
        if rep is None:
            raise EngineShutdown(f"replica {idx} is not healthy")
        return rep, {"kind": "direct", "pages": 0}

    def _route(self, prompt: List[int], session_id: Optional[str],
               exclude: set, *, batch: bool = False, cost: int = 0,
               roles: Optional[Sequence[str]] = None):
        """Pick a replica, or ``(None, {"hints": [...]})`` when none can
        admit. The replica table is read under the pool lock; the
        ``load_report()`` calls happen outside it (each briefly takes
        its engine's lock). ``batch=True`` takes ``_route_batch``, and
        batch work never lands on a prefill replica (a backlog spills
        only where long decode streams can run). ``roles`` restricts
        the candidates to those roles. A sticky entry naming a prefill
        replica is dropped, not followed.

        The pick and its ``cost`` tokens, added to the picked replica's
        routes in flight (``_submit_once`` takes them off once the
        submit returns), are one step under the pool lock, and the
        policy sees each replica's outstanding tokens plus its routes
        in flight. The reference's policy sees the reports alone, so
        submits racing in one instant read the same reports and all
        pick the same replica (a difference on purpose; the two agree
        whenever no route is in flight)."""
        with self._lock:
            reps = [r for r in self._replicas
                    if r.state == HEALTHY and r.idx not in exclude
                    and (roles is None or r.role in roles)
                    and not (batch and r.role == ROLE_PREFILL)]
            sticky_idx = (self._sticky.get(session_id)
                          if session_id is not None else None)
            if (sticky_idx is not None
                    and sticky_idx < len(self._replicas)
                    and self._replicas[sticky_idx].role == ROLE_PREFILL):
                # e.g. written before the replica was re-roled: a
                # session is never pinned to a prefill replica
                del self._sticky[session_id]
                sticky_idx = None
        if not reps:
            return None, {"hints": []}
        reports = {r.idx: r.engine.load_report() for r in reps}
        m = _metrics()
        for r in reps:
            rpt = reports[r.idx]
            tags = {"replica": str(r.idx)}
            m["free_slots"].set(rpt["free_slots"], tags=tags)
            m["queue_depth"].set(rpt["queue_depth"], tags=tags)
            m["batch_queue_depth"].set(rpt.get("queue_depth_batch", 0),
                                       tags=tags)
        # a replica that died idle has no handle to trip the death
        # path: routing is where the corpse becomes visible
        for r in reps:
            if reports[r.idx]["stopped"]:
                self._note_replica_death(r)
        by_key = {r.idx: r for r in reps}
        live = [r for r in reps
                if not reports[r.idx]["stopped"]
                and not reports[r.idx]["draining"]]
        with self._lock:
            seen = {r.idx: dict(reports[r.idx], outstanding_tokens=(
                reports[r.idx].get("outstanding_tokens", 0)
                + self._routing[r.idx])) for r in live}
            if batch:
                rep, decision = self._route_batch(live, seen)
            else:
                cands = [Candidate(r.idx, seen[r.idx],
                                   getattr(r.engine, "Pg", 0))
                         for r in live]
                pick, decision = select_candidate(
                    cands, prompt, sticky_key=sticky_idx, rng=self._rng)
                rep = by_key[pick.key] if pick is not None else None
            if rep is not None:
                self._routing[rep.idx] += cost
        if rep is None or batch:
            return rep, decision
        if self._share_prefixes:
            hint = self._pull_hint(prompt, rep, reports)
            if hint is not None:
                decision = dict(decision, pull=hint)
        return rep, decision

    def _route_batch(self, live: List[_Replica],
                     reports: Dict[int, Dict[str, Any]]):
        """Batch-lane spill routing: least batch backlog first, ties on
        least outstanding tokens. A replica whose batch lane is at its
        ``max_queued_batch`` bound contributes a retry hint instead.
        Sticky and affinity state are not touched."""
        hints: List[float] = []
        open_reps: List[_Replica] = []
        for r in live:
            rpt = reports[r.idx]
            bound = rpt.get("max_queued_batch")
            if (bound is not None
                    and rpt.get("queue_depth_batch", 0) >= bound):
                hints.append(rpt.get("shed_retry_after_s", 1.0))
                continue
            open_reps.append(r)
        if not open_reps:
            return None, {"hints": hints}
        pick = min(open_reps,
                   key=lambda r: (
                       reports[r.idx].get("queue_depth_batch", 0),
                       reports[r.idx].get("outstanding_tokens", 0),
                       r.idx))
        return pick, {"kind": "batch", "pages": 0, "spilled": False}

    def _record_route(self, rep: _Replica, decision: Dict[str, Any],
                      session_id: Optional[str],
                      trace_id: Optional[str] = None) -> None:
        self.events.append(
            "route", sid=rep.idx,
            data={"kind": decision["kind"],
                  "pages": decision.get("pages", 0),
                  "spilled": bool(decision.get("spilled")),
                  "trace_id": trace_id})
        m = _metrics()
        with self._lock:
            self.route_stats["routed"] += 1
            self.route_stats[f"route_{decision['kind']}"] += 1
            if decision.get("pages", 0) > 0:
                # an affinity HIT: the route landed on a replica already
                # holding >= 1 page of the prompt, whichever rule chose
                self.route_stats["affinity_hits"] += 1
                self.route_stats["affinity_hit_pages"] += \
                    decision["pages"]
            if decision["kind"] == "sticky":
                self.route_stats["sticky_hits"] += 1
            if decision.get("spilled"):
                self.route_stats["spills"] += 1
            if session_id is not None and decision["kind"] != "batch":
                self._sticky[session_id] = rep.idx
                self._sticky.move_to_end(session_id)
                while len(self._sticky) > self._max_sticky:
                    self._sticky.popitem(last=False)
        m["routed"].inc()
        if decision.get("pages", 0) > 0:
            m["affinity_hits"].inc()
        if decision["kind"] == "sticky":
            m["sticky_hits"].inc()
        if decision.get("spilled"):
            m["spills"].inc()

    # ---------------------------------------------------- aggregation

    @property
    def stats(self) -> Dict[str, int]:
        """The replicas' engine counters, summed."""
        total: Dict[str, int] = collections.Counter()
        for rep in self._replicas:
            total.update(rep.engine.stats)
        return total

    @property
    def ttfts_s(self) -> List[float]:
        out: List[float] = []
        for rep in self._replicas:
            out.extend(rep.engine.ttfts_s)
        return out

    def load_reports(self, role: Optional[str] = None
                     ) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            reps = [r for r in self._replicas
                    if r.state in (HEALTHY, DRAINING)
                    and (role is None or r.role == role)]
        return {r.idx: r.engine.load_report() for r in reps}

    def load_report(self, role: Optional[str] = None) -> Dict[str, Any]:
        """Pool-aggregate load snapshot: the engine report's fields
        summed over the live replicas (``shed_retry_after_s``,
        ``ttft_ewma_s`` and ``itl_ewma_s``: the largest), plus replica
        counts and the rollout state. No digest: affinity is the
        pool's own decision. ``role`` restricts it to one side of a
        disaggregated pool: what a per-role autoscaler senses."""
        reports = list(self.load_reports(role).values())
        with self._lock:
            mine = [r for r in self._replicas
                    if role is None or r.role == role]
            n = len(mine)
            active = sum(1 for r in mine if r.state != RETIRED)
            healthy = sum(1 for r in mine if r.state == HEALTHY)
            role_counts: Dict[str, int] = collections.Counter(
                r.role for r in self._replicas if r.state != RETIRED)
        agg = {"free_slots": 0, "free_pages": 0, "queue_depth": 0,
               "queue_depth_batch": 0,
               "outstanding_tokens": 0, "draining": False,
               "stopped": not reports, "max_queued": None,
               "shed_retry_after_s": 1.0,
               "total_slots": 0, "shed_total": 0,
               "ttft_ewma_s": None,
               "itl_ewma_s": None,
               "role": role if role is not None else ROLE_UNIFIED,
               "roles": dict(role_counts),
               "n_replicas": n,
               "active_replicas": active,
               "healthy_replicas": healthy}
        for rpt in reports:
            agg["free_slots"] += rpt["free_slots"]
            agg["free_pages"] += rpt["free_pages"]
            agg["queue_depth"] += rpt["queue_depth"]
            agg["queue_depth_batch"] += rpt.get("queue_depth_batch", 0)
            agg["outstanding_tokens"] += rpt["outstanding_tokens"]
            agg["shed_retry_after_s"] = max(
                agg["shed_retry_after_s"], rpt["shed_retry_after_s"])
            agg["total_slots"] += rpt.get("total_slots", 0)
            agg["shed_total"] += rpt.get("shed_total", 0)
            # the worst replica wins: the SLO is missed if ANY replica's
            # latency drifted
            ewma = rpt.get("ttft_ewma_s")
            if ewma is not None:
                agg["ttft_ewma_s"] = ewma if agg["ttft_ewma_s"] \
                    is None else max(agg["ttft_ewma_s"], ewma)
            itl = rpt.get("itl_ewma_s")
            if itl is not None:
                agg["itl_ewma_s"] = itl if agg["itl_ewma_s"] \
                    is None else max(agg["itl_ewma_s"], itl)
        # rollout visibility: the newest generation serving anywhere,
        # and whether live replicas serve different payloads
        agg["weight_generation"] = max(
            (rpt.get("weight_generation", 0) for rpt in reports),
            default=0)
        wids = {rpt.get("weights_id") for rpt in reports
                if rpt.get("weights_id") is not None}
        agg["weights_mixed"] = len(wids) > 1
        return agg

    def pool_stats(self) -> Dict[str, Any]:
        """Routing and lifecycle counters plus a per-replica snapshot
        (the pool block of ``serve_stats``)."""
        with self._lock:
            counters = dict(self.route_stats)
            reps = [{"idx": r.idx, "state": r.state,
                     "deaths": r.deaths,
                     "generation": r.generation,
                     "role": r.role,
                     # the weight fence (``generation`` above counts
                     # restarts, not rollouts)
                     "weight_generation": getattr(
                         r.engine, "weight_generation", 0),
                     "weights_id": getattr(r.engine, "weights_id", None)}
                    for r in self._replicas]
            role_views = dict(self._role_views)
        routed = counters.get("routed", 0)
        counters["affinity_hit_rate"] = round(
            counters.get("affinity_hits", 0) / routed, 4) \
            if routed else 0.0
        counters["spill_rate"] = round(
            counters.get("spills", 0) / routed, 4) if routed else 0.0
        counters["n_replicas"] = len(reps)
        counters["active_replicas"] = sum(
            1 for r in reps if r["state"] != RETIRED)
        counters["suspect_replicas"] = sum(
            1 for r in reps if r["state"] == SUSPECT)
        counters["degraded"] = any(r["state"] == DEGRADED for r in reps)
        counters["roles"] = dict(collections.Counter(
            r["role"] for r in reps if r["state"] != RETIRED))
        counters["replicas"] = reps
        kv = self.kv_migration_stats()
        if kv is not None:
            counters["kv_migration"] = kv
        if self._autoscaler is not None:
            counters["autoscale"] = self._autoscaler.stats()
        # per-role autoscalers: one block per side
        by_role = {role: view._autoscaler.stats()
                   for role, view in role_views.items()
                   if view._autoscaler is not None}
        if by_role:
            counters["autoscale_by_role"] = by_role
        if self._watchdog is not None:
            counters["watchdog"] = self._watchdog.stats()
        return counters

    def _agg_numeric(self, per_replica: List[Optional[Dict[str, Any]]]
                     ) -> Optional[Dict[str, Any]]:
        dicts = [d for d in per_replica if d]
        if not dicts:
            return None
        out: Dict[str, Any] = {}
        for d in dicts:
            for k, v in d.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    out.setdefault(k, v)
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def prefix_stats(self) -> Optional[Dict[str, Any]]:
        out = self._agg_numeric(
            [r.engine.prefix_stats() for r in self._replicas])
        if out:
            total = out.get("hit_tokens", 0) + out.get("miss_tokens", 0)
            out["hit_rate"] = round(
                out.get("hit_tokens", 0) / total, 4) if total else 0.0
        return out

    def spec_stats(self) -> Optional[Dict[str, Any]]:
        """The replicas' speculation counters summed, and the rates
        recomputed from the sums (the knobs: replica 0's). The
        reference reads keys the engine's ``spec_stats`` does not have
        (``proposed``, ``accepted``, ``dispatches``), so its pool
        reports 0.0 for both rates and sums the knobs; here
        ``accept_rate`` is accepted over proposed tokens and
        ``tokens_per_dispatch`` the summed ``spec_tokens`` over
        ``spec_riders`` of the engines' ``stats``."""
        per = [r.engine.spec_stats() for r in self._replicas]
        out = self._agg_numeric(per)
        if out:
            first = next(d for d in per if d)
            for knob in ("spec_len", "spec_ngram"):
                out[knob] = first.get(knob)
            proposed = out.get("proposed_tokens", 0)
            out["accept_rate"] = round(
                out.get("accepted_tokens", 0) / proposed, 4) \
                if proposed else 0.0
            st = self.stats
            riders = st.get("spec_riders", 0)
            out["tokens_per_dispatch"] = round(
                st.get("spec_tokens", 0) / riders, 4) if riders else 0.0
        return out

    def lifecycle_stats(self) -> Dict[str, Any]:
        per = [r.engine.lifecycle_stats() for r in self._replicas]
        out = self._agg_numeric(per) or {}
        # knobs are per-replica config, not sums: replica 0's
        for knob in ("max_queued", "max_retries", "retry_backoff_s"):
            if per:
                out[knob] = per[0].get(knob)
        return out

    def _role_capacity_eta_s(self) -> float:
        """The largest provisioning ETA over the per-role autoscalers:
        the pool's ``capacity_hint_fn`` once role views are attached
        (either side's new capacity can end an all-shed)."""
        eta = 0.0
        for view in list(self._role_views.values()):
            scaler = view._autoscaler
            if scaler is None:
                continue
            try:
                eta = max(eta, float(scaler.capacity_eta_s()))
            except Exception:  # noqa: BLE001
                _metrics()["capacity_hint_errors"].inc()
        return eta


def _check_role(role: str) -> None:
    if role not in REPLICA_ROLES:
        raise ValueError(f"unknown replica role {role!r}; expected one "
                         f"of {sorted(REPLICA_ROLES)}")


class _RoleEventLog:
    """The event log a ``RolePoolView`` hands its autoscaler: appends
    land in the POOL's log with the view's role added to the data, so
    both sides' scale decisions interleave in one log and stay
    attributable."""

    def __init__(self, log: obs.EventLog, role: str):
        self._log = log
        self._role = role

    def append(self, etype: str, rid: Any = None, sid: Any = None,
               data: Any = None, t: Optional[float] = None) -> None:
        d = dict(data) if isinstance(data, dict) else (
            {"data": data} if data is not None else {})
        d["role"] = self._role
        self._log.append(etype, rid=rid, sid=sid, data=d, t=t)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._log, name)


class RolePoolView:
    """One side of a disaggregated ``EnginePool``, shaped like a pool.

    A ``PoolAutoscaler`` attaches itself to what it is given
    (``_autoscaler``, ``capacity_hint_fn``), so two per-role scalers on
    the same pool would overwrite each other. Each gets a view instead:
    ``load_report`` and the counts filter to the role, ``add_replica``
    and ``scale_down`` scale only this side, events carry the role, and
    the view registers itself on the pool, so ``pool_stats`` shows
    both sides' decisions (``autoscale_by_role``) and the pool's
    capacity hint is the largest of the attached scalers' ETAs."""

    def __init__(self, pool: EnginePool, role: str):
        _check_role(role)
        self._pool = pool
        self.role = role
        # a PoolAutoscaler's attachment points land here, per view
        self._autoscaler = None
        self.capacity_hint_fn: Optional[Callable[[], float]] = None
        self.events = _RoleEventLog(pool.events, role)
        pool._role_views[role] = self
        pool.capacity_hint_fn = pool._role_capacity_eta_s

    # the pool surface the autoscaler senses

    @property
    def _stopped(self) -> bool:
        return self._pool._stopped

    @property
    def add_replica_for_ticket(self):
        # a provider's harvest override, honored pool-wide if installed
        return getattr(self._pool, "add_replica_for_ticket", None)

    def load_report(self) -> Dict[str, Any]:
        return self._pool.load_report(role=self.role)

    def active_count(self) -> int:
        with self._pool._lock:
            return sum(1 for r in self._pool._replicas
                       if r.state != RETIRED and r.role == self.role)

    def healthy_count(self) -> int:
        with self._pool._lock:
            return sum(1 for r in self._pool._replicas
                       if r.state == HEALTHY and r.role == self.role)

    # the pool surface the autoscaler acts on

    def add_replica(self) -> int:
        return self._pool.add_replica(role=self.role)

    def scale_down(self, n: int = 1,
                   timeout_s: float = 30.0) -> List[int]:
        return self._pool.scale_down(n, timeout_s, role=self.role)
