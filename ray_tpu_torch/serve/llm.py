"""Port of ``ray_tpu/serve/llm.py``: ``LlamaDeployment``, a Llama
replica behind one continuous-batching engine (serve/engine.py), or,
with ``use_engine=False``, behind the static-cache ``generate`` and
``generate_stream`` loops of models/llama.py.

Wrap it with a serve deployment at the use site; here it is a plain
class whose ``__call__``/``stream``/``generate_batch`` are the request
entry points. A request is a token-id list or a dict payload
(``prompt_ids`` or ``prompt``, ``max_new_tokens``, ``deadline_s``,
``session_id``, ``trace_id``). The engine's int8 KV pool
(``kv_dtype``) and prefix cache (``prefix_cache``), speculative
decoding (``spec_len``, ``spec_ngram``), the loop (``overlap``) and
the request lifecycle (``deadline_s``, ``max_queued``,
``max_retries``, ``retry_backoff_s``, ``engine_stall_deadline_s``)
pass through. The engine's KV pull and hot weight swap are reached
through ``engine()`` (``kv_fetcher``, ``submit(pull=...)``,
``swap_weights``).

``num_engine_replicas=N`` (N > 1) serves through an ``EnginePool``
(serve/engine_pool.py) of N engines sharing the model's weights:
prefix-affinity and session routing (a payload's ``session_id``), the
resubmit of unstreamed requests across a replica's death, and with
``pool_auto_restart`` the rebuild of a dead replica. With the prefix
cache on, the pool shares prefixes across its replicas
(``share_prefixes``: a cold replica pulls a sibling's cached pages,
under ``kv_pull_deadline_s`` and ``kv_pull_backoff_s``); the reference
turns that on only for its disaggregated pool.

``disaggregate=True`` splits the pool into ``prefill_replicas`` that
take new prompts and ``decode_replicas`` that resume the streams over
the KV handoff (serve/engine_pool.py). ``autoscale=True`` drives the
pool between ``num_engine_replicas`` and ``autoscale_max_replicas``
with a ``PoolAutoscaler`` (serve/pool_autoscaler.py), one per side of
a disaggregated pool over its ``RolePoolView``.
``engine_stall_deadline_s`` on a pool adds a ``PoolWatchdog``
(serve/watchdog.py) that wedges and rebuilds a replica whose scheduler
stops making progress.

``fleet=N`` (N > 0) serves through a loopback fleet instead of a pool
(serve/fleet/): a ``FleetDirectory`` with ``fleet_lease_ttl_s`` leases,
N lease-renewing ``ReplicaAgent``s of one engine each, and a
``FleetRouter`` as the deployment's engine object, the control plane
that ``python -m ray_tpu_torch.serve.fleet.agent`` runs across
processes. A dict payload with ``"echo_replica": true`` names the
replica incarnation that served it (``replica_id:generation`` in a
fleet, ``idx:generation`` in a pool, ``0:0`` for one engine), and
``"echo_generation": true`` the weights that served it
(``generation:weights_id``). With
``autoscale=True`` a fleet grows and shrinks between ``fleet`` and
``autoscale_max_replicas`` agents: a ``PoolAutoscaler`` over the router
provisions loopback agents through a ``LoopbackAgentProvider``
(serve/fleet/provider.py). Tensor parallelism is not ported yet
(ROADMAP.md, queue 1, item 8).
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import (LlamaConfig, build_model, generate,
                                        generate_stream, init_params,
                                        llama_tiny)
from ray_tpu_torch.serve.kv_migration import validate_pull_knobs


class LlamaDeployment:
    """Deployment-ready Llama wrapper: ``__init__`` builds the model on
    the device, the first request builds the engine.

    config: a ``LlamaConfig`` (default ``llama_tiny()``).
    params: a state dict for ``models.llama.Llama`` (e.g. from
        ``init_params`` or ``flax_state_dict``); None draws random
        weights from seed 0.
    max_new_tokens: completion budget per request.
    temperature: 0 = greedy.
    stream_chunk: tokens per device read of ``stream`` without the
        engine, and the engine's default ``decode_chunk`` (default 8).
    use_engine: serve through the continuous-batching engine (default);
        False serves each call through ``generate``/``generate_stream``
        over a static KV cache, ``generate_batch`` one batch per prompt
        length.
    max_slots, page_size, n_pages: the engine's decode width and KV
        pool; ``n_pages=None`` is full residency — every slot can
        reach ``max_seq_len`` without preemption.
    decode_chunk: decode steps per dispatch while admission work is
        pending (default ``stream_chunk``).
    prefill_chunk: prompt tokens per scheduling round (default 256).
    eos_id: token that ends a request early.
    kv_dtype: the KV pool's storage, ``"fp"`` (default) or ``"int8"``
        (``RAY_TPU_KV_DTYPE`` overrides it when the engine is built).
    prefix_cache: share KV pages of identical page-aligned prompt
        prefixes across requests (default off).
    spec_len, spec_ngram: the engine's speculative decoding (up to
        ``spec_len`` prompt-lookup drafts per slot per round, suffix
        n-gram order ``spec_ngram``; 0 = off, the default; greedy only).
    overlap: the engine's overlapped loop; None (default) defers to the
        engine's default (on) and ``RAY_TPU_OVERLAP``.
    deadline_s: the per-request deadline (a dict payload's
        ``deadline_s`` overrides it); None: none.
    max_queued: the engine's online admission bound (sheds with
        ``EngineOverloaded``); None: unbounded.
    max_retries, retry_backoff_s: the engine's retry policy after a
        contained fault.
    engine_stall_deadline_s: becomes the engine's ``admit_timeout_s``
        (a submit that cannot take a stalled engine's lock this long
        sheds instead of parking) and, on a pool, the stall deadline of
        a ``PoolWatchdog``; None: off.
    watchdog_interval_s: the watchdog's poll period (None: an eighth
        of the deadline).
    num_engine_replicas: engines behind one ``EnginePool`` (default 1:
        one engine, no pool); with ``autoscale`` the pool's floor.
    pool_auto_restart: the pool rebuilds a dead replica after its
        backoff (default on).
    autoscale: drive the pool's size with a ``PoolAutoscaler`` between
        ``num_engine_replicas`` and ``autoscale_max_replicas`` (default
        the larger of ``num_engine_replicas`` and 4).
    autoscale_policy: ``SLOPolicy`` fields to override (e.g.
        ``{"ttft_slo_s": 0.2}``); a disaggregated pool also takes
        ``"prefill"`` and ``"decode"`` dicts of per-side overrides.
    autoscale_interval_s: the autoscaler's tick period.
    autoscale_provider: its ``ReplicaCapacityProvider`` (default
        ``ImmediateCapacityProvider``; one shared by both sides).
    fleet: serve through a loopback fleet of this many agents (0: off;
        exclusive with ``num_engine_replicas > 1`` and ``disaggregate``);
        with ``autoscale`` the fleet's floor (it builds its own agent
        provider, so ``autoscale_provider`` is refused).
    fleet_lease_ttl_s: the fleet directory's lease TTL.
    disaggregate: serve through prefill and decode replicas (needs
        ``prefix_cache``); ``prefill_replicas`` and ``decode_replicas``
        (default 1 each) set the split and so the pool's width.
    kv_pull_deadline_s, kv_pull_backoff_s: the pool's ``pull_prefix``
        knobs (None: its defaults), validated here.
    device: ``None``/``"cuda"`` (the card; raises without one) or
        ``"cpu"``.
    """

    def __init__(self, config: Optional[LlamaConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 max_new_tokens: int = 64, temperature: float = 0.0,
                 stream_chunk: int = 8, use_engine: bool = True,
                 max_slots: int = 16, page_size: int = 64,
                 n_pages: Optional[int] = None,
                 decode_chunk: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False, spec_len: int = 0,
                 spec_ngram: int = 3, overlap: Optional[bool] = None,
                 deadline_s: Optional[float] = None,
                 max_queued: Optional[int] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.02,
                 engine_stall_deadline_s: Optional[float] = None,
                 watchdog_interval_s: Optional[float] = None,
                 num_engine_replicas: int = 1,
                 pool_auto_restart: bool = True,
                 autoscale: bool = False,
                 autoscale_max_replicas: Optional[int] = None,
                 autoscale_policy: Optional[Dict[str, Any]] = None,
                 autoscale_interval_s: float = 0.5,
                 autoscale_provider=None,
                 disaggregate: bool = False,
                 prefill_replicas: Optional[int] = None,
                 decode_replicas: Optional[int] = None,
                 kv_pull_deadline_s: Optional[float] = None,
                 kv_pull_backoff_s: Optional[float] = None,
                 fleet: int = 0, fleet_lease_ttl_s: float = 2.0,
                 device=None):
        # every knob is checked here, in the reference's order, before
        # the model is built
        if num_engine_replicas < 1:
            raise ValueError("num_engine_replicas must be >= 1")
        self.autoscale = autoscale
        self.autoscale_max_replicas = (
            autoscale_max_replicas if autoscale_max_replicas is not None
            else max(num_engine_replicas, 4))
        if autoscale and self.autoscale_max_replicas < num_engine_replicas:
            raise ValueError("autoscale_max_replicas must be >= "
                             "num_engine_replicas")
        self.autoscale_policy = dict(autoscale_policy or {})
        self.autoscale_interval_s = autoscale_interval_s
        self.autoscale_provider = autoscale_provider
        if (engine_stall_deadline_s is not None
                and engine_stall_deadline_s <= 0):
            raise ValueError(
                "engine_stall_deadline_s must be > 0 (or None)")
        self.watchdog_interval_s = watchdog_interval_s
        if fleet < 0:
            raise ValueError("fleet must be >= 0")
        if fleet and num_engine_replicas > 1:
            raise ValueError("fleet= and num_engine_replicas>1 are "
                             "exclusive: the fleet IS the replica set")
        if fleet and autoscale:
            if autoscale_provider is not None:
                raise ValueError(
                    "fleet+autoscale builds its own agent provider "
                    "(tickets provision fleet agents); autoscale_provider "
                    "is not accepted")
            if self.autoscale_max_replicas < fleet:
                raise ValueError("autoscale_max_replicas must be >= fleet")
        self.fleet = int(fleet)
        self.fleet_lease_ttl_s = float(fleet_lease_ttl_s)
        self._fleet_agents: Dict[str, Any] = {}
        self._fleet_directory = None
        # junk pull knobs fail here, at construction
        validate_pull_knobs(kv_pull_deadline_s, kv_pull_backoff_s)
        self.kv_pull_deadline_s = kv_pull_deadline_s
        self.kv_pull_backoff_s = kv_pull_backoff_s
        self.disaggregate = bool(disaggregate)
        self.prefill_replicas: Optional[int] = None
        self.decode_replicas: Optional[int] = None
        if not disaggregate and (prefill_replicas is not None
                                 or decode_replicas is not None):
            raise ValueError("prefill_replicas/decode_replicas require "
                             "disaggregate=True")
        if disaggregate:
            if fleet:
                raise ValueError(
                    "disaggregate=True and fleet= are exclusive: fleet "
                    "members carry role metadata but the router serves "
                    "them unified")
            if not prefix_cache:
                raise ValueError(
                    "disaggregate=True requires prefix_cache=True (the "
                    "handoff pulls the prefill replica's published "
                    "pages)")
            n_pre = 1 if prefill_replicas is None else int(prefill_replicas)
            n_dec = 1 if decode_replicas is None else int(decode_replicas)
            if n_pre < 1 or n_dec < 1:
                raise ValueError("prefill_replicas and decode_replicas "
                                 "must be >= 1")
            if num_engine_replicas not in (1, n_pre + n_dec):
                raise ValueError(
                    f"num_engine_replicas={num_engine_replicas} "
                    f"conflicts with prefill_replicas+decode_replicas="
                    f"{n_pre + n_dec}; omit it (the role split "
                    f"determines pool width)")
            num_engine_replicas = n_pre + n_dec
            self.prefill_replicas, self.decode_replicas = n_pre, n_dec
        self.num_engine_replicas = num_engine_replicas
        self.pool_auto_restart = pool_auto_restart
        self._autoscaler = None
        self._watchdog = None
        self.device = resolve_device(device)
        self.cfg = config or llama_tiny()
        if params is None:
            params = init_params(self.cfg, seed=0, device=self.device)
        self.model = build_model(self.cfg, params, self.device)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.stream_chunk = stream_chunk
        self.use_engine = use_engine
        self.deadline_s = deadline_s
        self.engine_stall_deadline_s = engine_stall_deadline_s
        if n_pages is None:
            per_seq = -(-self.cfg.max_seq_len // page_size)
            n_pages = max_slots * per_seq + 1
        self._engine_opts = dict(
            max_slots=max_slots, page_size=page_size, n_pages=n_pages,
            chunk=decode_chunk or stream_chunk, prefill_chunk=prefill_chunk,
            eos_id=eos_id, kv_dtype=kv_dtype, prefix_cache=prefix_cache,
            spec_len=spec_len, spec_ngram=spec_ngram, overlap=overlap,
            max_queued=max_queued, max_retries=max_retries,
            retry_backoff_s=retry_backoff_s,
            admit_timeout_s=engine_stall_deadline_s)
        self._engine = None
        self._engine_lock = threading.Lock()

    def engine(self):
        """The replica's engine (or, with more than one replica,
        ``autoscale`` or ``disaggregate``, its ``EnginePool``; with
        ``fleet``, the fleet's ``FleetRouter``), built and started at
        first use with the pool's autoscalers and watchdog. Locked: two
        first requests racing here must not allocate two pools."""
        with self._engine_lock:
            if self._engine is None:
                from ray_tpu_torch.serve.engine import LLMEngine
                if self.fleet:
                    self._engine = self._build_fleet(LLMEngine)
                elif (self.num_engine_replicas > 1 or self.autoscale
                        or self.disaggregate):
                    self._engine = self._build_pool(LLMEngine)
                else:
                    self._engine = LLMEngine(
                        self.model, temperature=self.temperature,
                        device=self.device, **self._engine_opts).start()
            return self._engine

    def _build_pool(self, engine_cls):
        """The pool of ``num_engine_replicas`` engines, its roles, one
        autoscaler (or one per role over a ``RolePoolView``, sharing
        one provider) and the watchdog."""
        from ray_tpu_torch.serve.engine_pool import EnginePool, RolePoolView
        from ray_tpu_torch.serve.pool_autoscaler import (
            ImmediateCapacityProvider, PoolAutoscaler, SLOPolicy)
        from ray_tpu_torch.serve.scheduler import ROLE_DECODE, ROLE_PREFILL

        def factory(idx):
            return engine_cls(self.model, temperature=self.temperature,
                              seed=idx, device=self.device,
                              **self._engine_opts)

        kw: Dict[str, Any] = dict(
            auto_restart=self.pool_auto_restart,
            share_prefixes=self._engine_opts["prefix_cache"],
            kv_pull_deadline_s=self.kv_pull_deadline_s,
            kv_pull_backoff_s=self.kv_pull_backoff_s)
        if self.disaggregate:
            kw["roles"] = ([ROLE_PREFILL] * self.prefill_replicas
                           + [ROLE_DECODE] * self.decode_replicas)
        pool = EnginePool(factory, self.num_engine_replicas, **kw)
        if self.autoscale and self.disaggregate:
            # the prefill side chases TTFT and its queue, the decode side
            # ITL and free slots: they reach different sizes on one trace
            policy = dict(self.autoscale_policy)
            over = {ROLE_PREFILL: dict(policy.pop("prefill", {})),
                    ROLE_DECODE: dict(policy.pop("decode", {}))}
            provider = (self.autoscale_provider
                        or ImmediateCapacityProvider())
            self._autoscaler = {
                role: PoolAutoscaler(
                    RolePoolView(pool, role),
                    SLOPolicy(min_replicas=floor,
                              max_replicas=self.autoscale_max_replicas,
                              **{**policy, **over[role]}),
                    provider).run(self.autoscale_interval_s)
                for role, floor in ((ROLE_PREFILL, self.prefill_replicas),
                                    (ROLE_DECODE, self.decode_replicas))}
        elif self.autoscale:
            self._autoscaler = PoolAutoscaler(
                pool, SLOPolicy(min_replicas=self.num_engine_replicas,
                                max_replicas=self.autoscale_max_replicas,
                                **self.autoscale_policy),
                self.autoscale_provider).run(self.autoscale_interval_s)
        if self.engine_stall_deadline_s is not None:
            from ray_tpu_torch.serve.watchdog import PoolWatchdog
            self._watchdog = PoolWatchdog(
                pool, stall_deadline_s=self.engine_stall_deadline_s,
                poll_interval_s=self.watchdog_interval_s).run()
        return pool

    def _build_fleet(self, engine_cls):
        """The loopback fleet: a directory, ``fleet`` agents ``r0``,
        ``r1``, ... (one engine each, the one of agent i drawing with
        seed i, as a pool's replica i does), and the router over them."""
        from ray_tpu_torch.serve.fleet.agent import ReplicaAgent
        from ray_tpu_torch.serve.fleet.directory import (DirectoryClient,
                                                         FleetDirectory)
        from ray_tpu_torch.serve.fleet.router import FleetRouter
        from ray_tpu_torch.serve.fleet.transport import LoopbackTransport
        self._fleet_directory = FleetDirectory(
            lease_ttl_s=self.fleet_lease_ttl_s)
        dc = DirectoryClient(LoopbackTransport(
            self._fleet_directory.handle))
        agents = self._fleet_agents

        def tf(addr):
            # a loopback agent advertises ["loopback", replica_id]
            return LoopbackTransport(agents[addr[1]].handle)

        def agent(rid, i):
            def factory(gen):
                return engine_cls(self.model, temperature=self.temperature,
                                  seed=i, device=self.device,
                                  **self._engine_opts)

            # in the transport map BEFORE start(), so the router can
            # route to it the moment the directory advertises it
            agents[rid] = ReplicaAgent(
                rid, factory, dc,
                stall_deadline_s=self.engine_stall_deadline_s)
            return agents[rid].start()

        for i in range(self.fleet):
            agent(f"r{i}", i)
        router = FleetRouter(dc, tf)
        if self.autoscale:
            from ray_tpu_torch.serve.fleet.provider import (
                LoopbackAgentProvider)
            from ray_tpu_torch.serve.pool_autoscaler import (PoolAutoscaler,
                                                             SLOPolicy)
            # provisioning builds a loopback agent here; the n-th agent
            # draws with seed n, as a pool's replica n does
            seq = itertools.count(self.fleet)
            self._autoscaler = PoolAutoscaler(
                router, SLOPolicy(min_replicas=self.fleet,
                                  max_replicas=self.autoscale_max_replicas,
                                  **self.autoscale_policy),
                LoopbackAgentProvider(lambda rid: agent(rid, next(seq)))
            ).run(self.autoscale_interval_s)
        return router

    def autoscaler(self):
        """The attached ``PoolAutoscaler`` (None before the lazy engine
        is built or without ``autoscale``); a disaggregated deployment
        returns ``{"prefill": ..., "decode": ...}``."""
        return self._autoscaler

    def watchdog(self):
        """The attached ``PoolWatchdog`` (None before the lazy engine is
        built, without a pool or without ``engine_stall_deadline_s``)."""
        return self._watchdog

    def shutdown(self) -> None:
        """Stop the autoscalers and the watchdog, then the engine, pool
        or fleet router and the fleet's agents (if built); in-flight
        requests fail typed."""
        with self._engine_lock:
            scalers = self._autoscaler
            if not isinstance(scalers, dict):
                scalers = {None: scalers} if scalers is not None else {}
            for scaler in scalers.values():
                scaler.stop()
            if self._watchdog is not None:
                self._watchdog.stop()
            if self._engine is not None:
                self._engine.shutdown()
            for agent in self._fleet_agents.values():
                agent.shutdown()

    def serve_stats(self) -> dict:
        """Replica metrics: the engine's counters plus live slot and
        page occupancy, without building a lazy engine (``{"engine":
        None}`` before the first request or without the engine). The
        lock is tried for 50 ms; ``consistent`` says whether it was
        taken, else the fields were read lock-free and may be torn."""
        if not self.use_engine or self._engine is None:
            return {"engine": None}
        eng = self._engine
        if self.fleet:
            # the members sit behind the transport: the aggregate of
            # their advertised reports, as a remote router sees them
            out = dict(eng.load_report())
            out.update(consistent=False,
                       max_queued=self._engine_opts["max_queued"],
                       fleet=eng.pool_stats())
            return {"engine": out}
        from ray_tpu_torch.serve.engine_pool import EnginePool
        if isinstance(eng, EnginePool):
            return {"engine": self._pool_stats(eng)}
        locked = eng._lock.acquire(timeout=0.05)
        try:
            live = sum(1 for s in eng.slots if s is not None)
            out = dict(eng.stats)
            free, total = eng.alloc.n_free, eng.alloc.n_pages - 1
            prefix = (eng.prefix_cache.stats()
                      if eng.prefix_cache is not None else None)
        finally:
            if locked:
                eng._lock.release()
        out.update(slots_live=live, slots_total=eng.S, pages_free=free,
                   pages_total=total, consistent=locked,
                   max_queued=eng.max_queued,
                   max_retries=eng.max_retries,
                   retry_backoff_s=eng.retry_backoff_s)
        if prefix is not None:
            out["prefix_cache"] = prefix
        return {"engine": out}

    def _pool_stats(self, pool) -> dict:
        """``serve_stats``' pool branch: the replicas' summed counters,
        slots and pages (each replica's lock tried for 50 ms, so
        ``consistent`` is False), the knobs and ``pool_stats()``."""
        out: dict = dict(pool.stats)
        slots_live = slots_total = pages_free = pages_total = 0
        for eng in pool.engines():
            locked = eng._lock.acquire(timeout=0.05)
            try:
                slots_live += sum(1 for s in eng.slots if s is not None)
                slots_total += eng.S
                pages_free += eng.alloc.n_free
                pages_total += eng.alloc.n_pages - 1
            finally:
                if locked:
                    eng._lock.release()
        opts = self._engine_opts
        out.update(slots_live=slots_live, slots_total=slots_total,
                   pages_free=pages_free, pages_total=pages_total,
                   consistent=False, max_queued=opts["max_queued"],
                   max_retries=opts["max_retries"],
                   retry_backoff_s=opts["retry_backoff_s"],
                   pool=pool.pool_stats())
        ps = pool.prefix_stats()
        if ps:
            out["prefix_cache"] = ps
        return out

    def load_report(self) -> Optional[dict]:
        """The engine's ``load_report`` (or the pool's aggregate)
        without a prefix digest (an affinity signal within a pool); None
        before the lazy engine exists or without the engine."""
        if not self.use_engine or self._engine is None:
            return None
        rpt = dict(self._engine.load_report())
        rpt.pop("prefix_digest", None)
        return rpt

    def _request_args(self, payload):
        """(prompt_ids, max_new_tokens, deadline_s, session_id,
        trace_id) of a request: a token-id list, or a dict with
        ``prompt_ids`` (or ``prompt``) and optional ``max_new_tokens``,
        ``deadline_s``, ``session_id`` and ``trace_id``. One engine
        ignores ``session_id`` (it steers a pool's stickiness);
        ``trace_id`` rides the request."""
        if isinstance(payload, dict):
            prompt_ids = payload.get("prompt_ids", payload.get("prompt"))
            if prompt_ids is None:
                raise ValueError("request dict needs a 'prompt_ids' key")
            mnt = int(payload.get("max_new_tokens", self.max_new_tokens))
            dl = payload.get("deadline_s", self.deadline_s)
            sid = payload.get("session_id")
            tid = payload.get("trace_id")
            return (list(prompt_ids), mnt,
                    float(dl) if dl is not None else None,
                    str(sid) if sid is not None else None,
                    str(tid) if tid is not None else None)
        return (list(payload), self.max_new_tokens, self.deadline_s,
                None, None)

    def _submit(self, payload):
        ids, mnt, dl, sid, tid = self._request_args(payload)
        kw: Dict[str, Any] = dict(max_new_tokens=mnt, deadline_s=dl)
        if sid is not None and (self.num_engine_replicas > 1
                                or self.fleet):
            kw["session_id"] = sid
        if tid is not None:
            kw["trace_id"] = tid
        return ids, self.engine().submit(ids, **kw)

    def __call__(self, prompt_ids):
        """One request: token ids (or, through the engine, a dict
        payload) in, prompt + generated ids out; with ``"echo_replica":
        true`` or ``"echo_generation": true`` in the payload, ``{"ids":
        [...], "replica": tag, "generation": tag}`` (the keys asked
        for)."""
        if not self.use_engine:
            out = generate(self.model, [list(prompt_ids)],
                           self.max_new_tokens, self.temperature)
            return out[0].tolist()
        ids, h = self._submit(prompt_ids)
        out = ids + h.result()
        echo = self._echo(prompt_ids, h)
        if echo:
            return {"ids": out, **echo}
        return out

    def _echo(self, payload, h) -> Dict[str, str]:
        """What a dict payload asked to have echoed about the handle
        ``h``: ``replica`` (``"echo_replica": true``) and ``generation``
        (``"echo_generation": true``)."""
        if not isinstance(payload, dict):
            return {}
        out = {}
        if payload.get("echo_replica"):
            out["replica"] = _replica_tag(h)
        if payload.get("echo_generation"):
            out["generation"] = self._weights_tag(h)
        return out

    def _weights_tag(self, h) -> str:
        """``generation:weights_id`` of whatever served ``h``: the
        handle's own tag (an engine's or a pool's), else the
        deployment's engine's, else the never-swapped ``0:g0`` (a
        fleet's handles carry none, as the reference's)."""
        tag = getattr(h, "weights_tag", None)
        if tag:
            return tag
        eng = self.engine()
        gen = getattr(eng, "weight_generation", None)
        if gen is not None:
            return f"{gen}:{getattr(eng, 'weights_id', None)}"
        return "0:g0"

    def stream(self, prompt_ids):
        """Streaming request (token ids or, through the engine, a dict
        payload): yields each generated token id as it is emitted.
        Closing the generator early cancels the request, so its slot
        and pages free at once. With ``"echo_replica": true`` or
        ``"echo_generation": true`` in the payload the first yield is
        ``{"replica": tag, "generation": tag}`` (the keys asked for).
        Without the engine, tokens arrive in bursts of ``stream_chunk``,
        one device read each."""
        if not self.use_engine:
            for tok in generate_stream(self.model, [list(prompt_ids)],
                                       self.max_new_tokens,
                                       self.temperature,
                                       chunk_size=self.stream_chunk):
                yield int(tok[0])
            return
        _ids, h = self._submit(prompt_ids)
        echo = self._echo(prompt_ids, h)
        if echo:
            yield echo
        try:
            yield from h.stream()
        except GeneratorExit:
            h.cancel()
            raise

    def generate_batch(self, prompts) -> List[List[int]]:
        """Batched generation: every request (token ids or a dict
        payload) is submitted at once and the engine batches them at
        token granularity (any mix of lengths). Without the engine,
        prompts are bucketed by length and each bucket is one
        ``generate`` batch: the model masks only causally, so padding
        would change a completion. Returns the generated ids per
        prompt."""
        if not self.use_engine:
            return self._generate_buckets(prompts)
        hs = [self._submit(p)[1] for p in prompts]
        return [h.result() for h in hs]

    def _generate_buckets(self, prompts: List[List[int]]
                          ) -> List[List[int]]:
        buckets: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            buckets.setdefault(len(p), []).append(i)
        results: List[Optional[List[int]]] = [None] * len(prompts)
        for plen, idxs in buckets.items():
            batch = np.asarray([prompts[i] for i in idxs], np.int32)
            out = generate(self.model, batch, self.max_new_tokens,
                           self.temperature)
            for row, i in zip(out[:, plen:].tolist(), idxs):
                results[i] = row
        return results


def _replica_tag(handle) -> str:
    """The incarnation that served ``handle``: a fleet's
    ``replica_id:generation``, a pool's ``idx:generation``, or ``0:0``
    for one engine."""
    return getattr(handle, "replica_tag", None) or "0:0"
