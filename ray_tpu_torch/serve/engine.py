"""Port of ``ray_tpu/serve/engine.py``: a subset of the
continuous-batching ``LLMEngine`` over the paged KV pool.

Iteration-level scheduling: requests join and leave the decode batch
at token granularity. One engine serves one model replica on one
device (``"cuda"`` by default, ``"cpu"`` when the caller asks).

- KV lives in a paged pool (models/kv_cache.py) that is allocated once
  and updated IN PLACE by every step (ops/paged_attention.py
  ``paged_append``): nothing is copied per step. The host-side
  ``BlockAllocator`` hands pages to sequences as they grow; completion
  or preemption returns them. Inactive slots point at the null page.
- Decode is DEVICE-PACED: the per-slot next-token input (``cur``) and
  write position (``pos``) stay on the device between dispatches;
  admission seeds slot rows with an on-stream scatter. A dispatch of
  ``steps`` decode steps is a Python loop of single-token forwards
  whose tokens land in one device buffer, copied to pinned host
  memory right behind the dispatch: ONE host readback per dispatch,
  and it trails (the host waits only on a dispatch older than the one
  it just queued).
- Prefill is CHUNKED and interleaved with decode (serve/scheduler.py
  plans each round): up to ``prefill_chunk`` prompt tokens per round,
  packed across up to 4 mid-prefill slots in one call; the chunk that
  ends a prompt samples the first token, which is emitted at the next
  readback.
- Preemption is recompute-based: when the pool runs dry the youngest
  slot is evicted, its pages freed, and the request requeued at the
  front with prompt = original prompt + tokens generated so far, so
  clients see an uninterrupted stream.
- The scheduler is the lockstep loop of the reference
  (``overlap=False``): without an eos, completions are dispatch-time
  arithmetic and readbacks trail; with an eos, every round drains
  readbacks before planning.

Not ported yet (ROADMAP.md, queue 1): prefix cache, speculative
decoding, KV pull, ``swap_weights``, fault injection, priority lanes
and replica roles, the overlapped loop, logprob capture, int8 KV,
tensor parallelism, deadlines and the event log.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.kv_cache import (BlockAllocator, init_kv_pool,
                                           kv_layer_view,
                                           kv_pool_page_bytes)
from ray_tpu_torch.models.llama import _pick_token
from ray_tpu_torch.serve.errors import (EngineDraining, EngineOverloaded,
                                        EngineShutdown, RequestCancelled,
                                        RequestError)
from ray_tpu_torch.serve.scheduler import SlotView, StepPlan, plan_step

_DONE = object()


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]            # original prompt (never mutated)
    max_new_tokens: int
    out_q: "queue.Queue[Any]" = dataclasses.field(
        default_factory=queue.Queue)
    generated: List[int] = dataclasses.field(default_factory=list)
    error: Optional[BaseException] = None
    closed: bool = False         # _DONE delivered; drop late tokens
    t_submit: float = 0.0        # monotonic clock at submit()
    t_first: Optional[float] = None   # first token EMITTED to stream
    t_last_emit: Optional[float] = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def recompute_prompt(self) -> List[int]:
        """What to prefill after a preemption: everything the client
        has already seen."""
        return self.prompt + self.generated


class RequestHandle:
    """Client-side view of a submitted request."""

    def __init__(self, req: _Request,
                 engine: Optional["LLMEngine"] = None):
        self._req = req
        self._engine = engine
        self._drained = False

    def cancel(self) -> bool:
        """Abort the request at whatever phase it is in — queued,
        mid-prefill or decoding. Its slot frees, its pages return to
        the allocator, and any ``stream()``/``result()`` consumer
        unblocks with ``RequestCancelled``. False when the request had
        already finished."""
        if self._engine is None:
            return False
        return self._engine._cancel(self._req)

    def stream(self):
        """Yield generated token ids as they are produced."""
        while True:
            item = self._req.out_q.get()
            if item is _DONE:
                if self._req.error is not None:
                    raise self._req.error
                return
            yield item

    def result(self) -> List[int]:
        """Block until completion; return all generated token ids.
        Idempotent: repeat calls return the cached tokens (or re-raise
        the terminal error)."""
        if not self._drained:
            self._drained = True
            for _ in self.stream():
                pass
        if self._req.error is not None:
            raise self._req.error
        return list(self._req.generated)

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-emission latency (the first token put on the
        request stream); None until it is out."""
        if self._req.t_first is None:
            return None
        return self._req.t_first - self._req.t_submit


@dataclasses.dataclass
class _Slot:
    req: _Request
    pages: List[int]             # physical page ids, logical order
    pos: int                     # next KV write position (host mirror;
                                 # the device carries the live value)
    cur: Optional[int]           # None until the slot's seed scatter is
                                 # dispatched; afterwards a sentinel —
                                 # the next-token input lives on the
                                 # device
    admit_seq: int               # LIFO preemption order
    prompt: List[int] = dataclasses.field(default_factory=list)
                                 # recompute-prompt snapshot being
                                 # prefilled (chunk by chunk)
    prefilled: int = 0           # prompt tokens whose KV is in pages
    decoded: int = 0             # decode steps ridden (dispatch-time
                                 # arithmetic, ahead of emission)
    preempted: bool = False      # in-flight tokens must be discarded

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prefilled


class _Readback:
    """A device buffer's copy into pinned host memory, enqueued right
    behind the dispatch that produced it, and the event that marks the
    copy done. On the CPU the buffer is its own copy."""

    def __init__(self, buf: torch.Tensor):
        if buf.device.type == "cuda":
            self.host = torch.empty(buf.shape, dtype=buf.dtype,
                                    pin_memory=True)
            self.host.copy_(buf, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(buf.device))
        else:
            self.host = buf
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class LLMEngine:
    """Continuous-batching decode engine for one model replica.

    Parameters
    ----------
    model: a ``ray_tpu_torch.models.llama.Llama`` on ``device``.
    max_slots: decode batch width.
    page_size: tokens per KV page.
    n_pages: physical pages in the pool (page 0 reserved as null).
    chunk: decode steps per dispatch while admission work is pending;
        with a full batch the engine runs ahead to the next completion.
    prefill_chunk: prompt-token budget per scheduling round, shared
        across the mid-prefill slots scheduled that round (default
        256).
    max_run_ahead: most decode steps one dispatch may take (default
        max(chunk, 128)).
    temperature: 0 = greedy; otherwise sampling from a
        ``torch.Generator`` seeded by ``seed``.
    eos_id: token that ends a request early (None = budget only).
    max_queued: bounded admission — with this many requests already
        waiting, ``submit`` sheds with ``EngineOverloaded``. None
        (default) keeps the queue unbounded.
    device: ``None``/``"cuda"`` (default: the card; raises without
        one) or ``"cpu"``.
    """

    def __init__(self, model, *, max_slots: int = 8,
                 page_size: int = 16, n_pages: int = 256,
                 chunk: int = 4, prefill_chunk: Optional[int] = None,
                 max_run_ahead: Optional[int] = None,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_queued: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(f"model weights are on {p.device}, the "
                                 f"engine runs on {self.device}")
        if max_queued is not None and max_queued < 0:
            raise ValueError("max_queued must be >= 0 or None")
        self.model = model
        self.cfg = model.cfg
        self.S = max_slots
        self.Pg = page_size
        self.K = chunk
        self.PC = max(1, int(prefill_chunk or 256))
        self.temperature = temperature
        self.eos_id = eos_id
        self.KMAX = (max(chunk, 128) if max_run_ahead is None
                     else max(chunk, int(max_run_ahead)))
        # page-table width == the attention window per slot, capped at
        # what the model can address
        self.max_pages = min(n_pages - 1,
                             -(-self.cfg.max_seq_len // page_size))
        self.kv_dtype = "fp"
        self.page_bytes = kv_pool_page_bytes(self.cfg, page_size)
        self.alloc = BlockAllocator(n_pages, page_bytes=self.page_bytes)
        self.pages = init_kv_pool(self.cfg, n_pages, page_size,
                                  device=self.device)
        self.max_queued = max_queued
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self._wait: "collections.deque[_Request]" = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._rid = itertools.count()
        self._admit_seq = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # trailing readbacks: [(_Readback, [(ix, slot, take), ...],
        # steps)] and in-flight prefills: [(_Readback, [(ix, slot,
        # row), ...])]
        self._fetchq: "collections.deque" = collections.deque()
        self._pending_prefill: List = []
        # device-authoritative decode state, chained dispatch to
        # dispatch
        self._dev_cur = torch.zeros(max_slots, dtype=torch.int32,
                                    device=self.device)
        self._dev_pos = torch.zeros(max_slots, dtype=torch.int32,
                                    device=self.device)
        # without an eos the schedule is deterministic: slots retire by
        # arithmetic at dispatch time and readbacks never gate planning
        self._deferred = eos_id is None
        self._stopped = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, int] = collections.Counter()
        self._max_prefill_batch = 4
        # submit->first-emission latencies (seconds), most recent
        self.ttfts_s: "collections.deque" = collections.deque(maxlen=4096)
        self._ttft_ewma: Optional[float] = None
        self._itl_ewma: Optional[float] = None
        self._ewma_alpha = 0.2

    def _h2d(self, x: np.ndarray) -> torch.Tensor:
        """Host->device for dispatch operands (page tables, token
        chunks, positions): staged through pinned memory so the copy
        is enqueued without waiting for the device."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---------------------------------------------------------- public

    def submit(self, prompt_ids: List[int],
               max_new_tokens: int = 64) -> RequestHandle:
        """Queue one request. Raises ``RequestError`` for an empty
        prompt, a non-positive budget, token ids outside the
        vocabulary, or a request the pool or the model cannot hold;
        ``EngineOverloaded`` when ``max_queued`` requests already
        wait; ``EngineShutdown``/``EngineDraining`` when stopped or
        draining."""
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise RequestError("empty prompt")
        if max_new_tokens < 1:
            raise RequestError("max_new_tokens must be >= 1")
        # an out-of-vocabulary id would fault the embedding gather on
        # the device (the reference's XLA gather clamps it silently)
        bad = [t for t in prompt_ids
               if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise RequestError(
                f"token ids {bad[:4]} outside vocab "
                f"[0, {self.cfg.vocab_size})")
        total = len(prompt_ids) + max_new_tokens
        need = -(-total // self.Pg)
        if need > self.alloc.n_pages - 1:
            raise RequestError(
                f"request needs {need} pages but pool has only "
                f"{self.alloc.n_pages - 1} usable pages")
        if total > self.cfg.max_seq_len:
            raise RequestError(
                f"prompt+completion {total} exceeds model "
                f"max_seq_len {self.cfg.max_seq_len}")
        req = _Request(next(self._rid), prompt_ids, max_new_tokens,
                       t_submit=time.monotonic())
        with self._work:
            if self._stopped:
                raise EngineShutdown("engine stopped")
            if self._draining:
                raise EngineDraining(
                    "engine draining: finishing in-flight work, "
                    "admitting nothing new")
            if (self.max_queued is not None
                    and len(self._wait) >= self.max_queued):
                self.stats["shed"] += 1
                raise EngineOverloaded(
                    f"admission queue full ({len(self._wait)} waiting "
                    f">= max_queued={self.max_queued}); request shed")
            self._wait.append(req)
            self.stats["submitted"] += 1
            self._work.notify()
        return RequestHandle(req, self)

    def start(self) -> "LLMEngine":
        """Run the scheduler loop in a daemon thread."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="llm-engine", daemon=True)
            self._thread.start()
        return self

    def drain(self) -> None:
        """Admit nothing new, finish everything queued or in flight.
        Idempotent. Pair with ``wait_idle`` then ``shutdown``."""
        with self._work:
            self._draining = True
            self._work.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining

    def reset_latency_stats(self) -> None:
        """Forget TTFT samples and the EWMAs (after a warm-up request,
        whose TTFT includes one-off setup such as the kernel build)."""
        with self._lock:
            self.ttfts_s.clear()
            self._ttft_ewma = None
            self._itl_ewma = None

    def is_idle(self) -> bool:
        """True when no request is queued, slotted, or trailing in a
        readback."""
        with self._lock:
            return (not self._wait and not any(self.slots)
                    and not self._fetchq and not self._pending_prefill)

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until ``is_idle`` (or timeout); returns the final
        idleness."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while not self.is_idle():
            if time.monotonic() >= deadline:
                return self.is_idle()
            time.sleep(0.005)
        return True

    def load_report(self) -> Dict[str, Any]:
        """Compact load snapshot: free capacity, queue pressure,
        outstanding token work, latency EWMAs (the fields of the
        reference's report that this engine has)."""
        with self._lock:
            outstanding = 0
            for slot in self.slots:
                if slot is not None:
                    outstanding += max(0, slot.prefill_remaining)
                    outstanding += max(0, slot.req.remaining)
            for req in self._wait:
                outstanding += len(req.prompt) + req.max_new_tokens
            return {
                "free_slots": sum(1 for s in self.slots if s is None),
                "total_slots": self.S,
                "free_pages": self.alloc.n_free,
                "kv_dtype": self.kv_dtype,
                "kv_page_bytes": self.page_bytes,
                "kv_bytes_in_use": self.alloc.bytes_in_use(),
                "kv_bytes_total": self.alloc.bytes_total(),
                "queue_depth": len(self._wait),
                "outstanding_tokens": outstanding,
                "max_queued": self.max_queued,
                "shed_total": self.stats.get("shed", 0),
                "ttft_ewma_s": self._ttft_ewma,
                "itl_ewma_s": self._itl_ewma,
                "draining": self._draining,
                "stopped": self._stopped,
                "fetchq_depth": len(self._fetchq),
                "pending_prefills": len(self._pending_prefill),
                "has_work": bool(self._wait or any(self.slots)
                                 or self._fetchq
                                 or self._pending_prefill),
                "device": str(self.device),
            }

    def shutdown(self):
        """Stop the engine and FAIL everything still queued or in
        flight with ``EngineShutdown`` — no consumer is left blocked.
        Tokens already computed are delivered first. Idempotent."""
        err = EngineShutdown("engine stopped")
        with self._work:
            self._stopped = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        with self._work:
            self._drain_fetches_locked()
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    self._teardown_slot_locked(i, err)
            for _rb, riders, _steps in self._fetchq:
                for _i, slot, _t in riders:
                    self._fail_req_locked(slot.req, err)
            for _rb, placements in self._pending_prefill:
                for _ix, slot, _row in placements:
                    self._fail_req_locked(slot.req, err)
            self._fetchq.clear()
            self._pending_prefill.clear()
            while self._wait:
                self._fail_req_locked(self._wait.popleft(), err)

    def _cancel(self, req: _Request,
                error: Optional[BaseException] = None) -> bool:
        """Abort ``req`` at any phase. Queued: removed and failed.
        Slotted: torn down under the lock (freeing pages under an
        in-flight dispatch is safe: device work is stream-ordered and
        trailing readbacks skip the closed request). Returns False iff
        the request had already finished."""
        err = error or RequestCancelled(
            f"request {req.rid} cancelled by client")
        with self._work:
            if req.closed:
                return False
            try:
                self._wait.remove(req)
                self._fail_req_locked(req, err, "cancelled")
                return True
            except ValueError:
                pass
            for i, slot in enumerate(self.slots):
                if slot is not None and slot.req is req:
                    self._teardown_slot_locked(i, err, "cancelled")
                    self._work.notify()
                    return True
            self._fail_req_locked(req, err, "cancelled")
            return True

    def _fail_req_locked(self, req: _Request, err: BaseException,
                         count: Optional[str] = None) -> None:
        """Resolve a request's consumers with a typed error, exactly
        once; ``count`` names the stats counter to bump."""
        if req.closed:
            return
        req.closed = True
        req.error = err
        req.out_q.put(_DONE)
        if count:
            self.stats[count] += 1

    def _teardown_slot_locked(self, ix: int, err: BaseException,
                              count: Optional[str] = None) -> None:
        """Fail a slotted request and free its slot and pages; in-flight
        readback rows for it are discarded (``preempted``)."""
        slot = self.slots[ix]
        self.slots[ix] = None
        slot.preempted = True
        self.alloc.free(slot.pages)
        self._fail_req_locked(slot.req, err, count)

    def step(self) -> bool:
        """One scheduler iteration (lockstep loop):

            drain -> admit -> plan round -> dispatch prefill chunk
                  -> grow/preempt -> dispatch decode chunk
                  -> fetch the previous dispatch's tokens (trailing)

        Without an eos the pre-plan drain only reads buffers already
        copied back (never blocks) and slots retire by arithmetic at
        dispatch; with an eos sampled tokens decide completion, so the
        round drains every readback before planning. Returns False
        when idle."""
        with self._lock:
            if self._stopped:
                return False
            self._drain_fetches_locked(ready_only=self._deferred)
            self._admit_locked()
            if not any(self.slots):
                if self._fetchq or self._pending_prefill:
                    self._drain_fetches_locked(limit=1)
                    return True
                return bool(self._wait)
            plan = self._plan_steps_locked()
            if plan.prefill:
                self._dispatch_prefill_locked(plan.prefill)
            if plan.decode_steps:
                self._grow_or_preempt_locked(plan.decode_steps)
                self._dispatch_chunk_locked(plan.decode_steps)
                if self._deferred:
                    self._retire_planned_locked()
            # block only on a dispatch OLDER than the one just queued
            self._drain_fetches_locked(limit=1, keep=1)
            return True

    def _plan_steps_locked(self) -> StepPlan:
        """Plan this round with the pure planner (serve/scheduler.py)."""
        views = [SlotView(sid=i, admit_seq=s.admit_seq,
                          prompt_remaining=s.prefill_remaining,
                          owed=max(0, self._owed(s))
                          if s.cur is not None else 0,
                          seeded=s.cur is not None)
                 for i, s in enumerate(self.slots) if s is not None]
        return plan_step(views, total_slots=self.S,
                         prefill_budget=self.PC,
                         decode_chunk=self.K,
                         max_run_ahead=self.KMAX,
                         prefill_batch=self._max_prefill_batch,
                         eos_bounded=self.eos_id is not None)

    def _owed(self, slot: _Slot) -> int:
        """Decode steps this slot still needs, by dispatch-time
        arithmetic: the prefill emits token 1 of max_new_tokens, every
        ridden step one more."""
        return slot.req.max_new_tokens - 1 - slot.decoded

    def _retire_planned_locked(self):
        """No-eos mode: free slots whose budget the dispatch just
        consumed — their tokens are still in flight, but the schedule
        is deterministic, so the slot and pages go back now."""
        for i, slot in enumerate(self.slots):
            if (slot is not None and slot.cur is not None
                    and self._owed(slot) <= 0):
                self.slots[i] = None
                self.alloc.free(slot.pages)

    # ------------------------------------------------------- scheduler

    def _loop(self):
        while True:
            with self._work:
                while (not self._stopped and not self._wait
                       and not any(self.slots)
                       and not self._fetchq
                       and not self._pending_prefill):
                    self._work.wait()
                if self._stopped:
                    # deliver every token already computed; shutdown()
                    # fails whatever remains with EngineShutdown
                    self._drain_fetches_locked()
                    return
            try:
                self.step()
            except BaseException as e:   # global: fail every request
                self._fail_all(e)
                return

    def _fail_all(self, e: BaseException):
        """Global failure (device error, scheduler bug): every queued
        and in-flight request fails with the error."""
        with self._lock:
            self.stats["failed_all"] += 1
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    self._teardown_slot_locked(i, e)
            for _rb, riders, _steps in self._fetchq:
                for _i, slot, _t in riders:
                    self._fail_req_locked(slot.req, e)
            for _rb, placements in self._pending_prefill:
                for _ix, slot, _row in placements:
                    self._fail_req_locked(slot.req, e)
            self._fetchq.clear()
            self._pending_prefill.clear()
            while self._wait:
                self._fail_req_locked(self._wait.popleft(), e)
            self._stopped = True

    def _victim_locked(self, exclude_sid: int) -> Optional[int]:
        """Preemption victim: the youngest occupied slot other than the
        one whose growth is hunting."""
        cands = (j for j, s in enumerate(self.slots)
                 if s is not None and j != exclude_sid)
        return max(cands, key=lambda j: self.slots[j].admit_seq,
                   default=None)

    def _admit_locked(self):
        """Chunk-budget admission: the queue head takes a free slot as
        soon as pages for its FIRST prefill chunk exist. FIFO: closed
        requests at the head are dropped, nothing is reordered."""
        while self._wait:
            while self._wait and self._wait[0].closed:
                self._wait.popleft()
            if not self._wait:
                return
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            req = self._wait[0]
            prompt = req.recompute_prompt
            first = max(1, min(len(prompt), self.PC))
            page_ids = self.alloc.alloc(-(-first // self.Pg))
            if page_ids is None:
                return         # pool dry: wait for completions
            self._wait.popleft()
            self.slots[free[0]] = _Slot(
                req=req, pages=page_ids, pos=0, cur=None,
                admit_seq=next(self._admit_seq), prompt=prompt,
                # tokens already delivered count against the budget
                decoded=len(req.generated))
            self.stats["admitted"] += 1

    def _grow_locked(self, ix: int, slot: _Slot, need: int) -> None:
        """Grow ``slot``'s pages to ``need``, preempting the youngest
        OTHER slot while the pool is dry. Stops early if a preemption's
        drain closed this slot. A lone slot always fits: ``submit``
        rejects requests larger than the pool."""
        while len(slot.pages) < need:
            if self.slots[ix] is not slot:
                return
            got = self.alloc.alloc(need - len(slot.pages))
            if got is not None:
                slot.pages.extend(got)
                return
            victim = self._victim_locked(ix)
            if victim is None:
                raise RuntimeError(
                    f"request {slot.req.rid}: page pool exhausted by "
                    f"one slot ({len(slot.pages)} pages held, {need} "
                    f"needed)")
            self._preempt_locked(victim)

    def _dispatch_prefill_locked(self, grants):
        """Grow each granted slot's pages to cover its chunk, then
        dispatch ONE batched chunked-prefill call for every surviving
        grant. Rows carry independent start offsets and lengths."""
        rows = []
        for g in grants:
            slot = self.slots[g.sid]
            if slot is None:
                continue       # evicted by an earlier grant's growth
            take = min(g.tokens, slot.prefill_remaining)
            if take <= 0:
                continue
            self._grow_locked(g.sid, slot,
                              -(-(slot.prefilled + take) // self.Pg))
            if self.slots[g.sid] is slot:
                rows.append((g.sid, slot, take))
        # a LATER grant's growth can evict an EARLIER grant's slot
        rows = [(ix, slot, take) for ix, slot, take in rows
                if self.slots[ix] is slot]
        if rows:
            self._prefill_batch(rows)

    def _grow_or_preempt_locked(self, steps: int):
        """Ensure every riding slot's pages cover this dispatch's
        writes, eldest first; evict the youngest slots if the pool runs
        dry."""
        for i in sorted((i for i, s in enumerate(self.slots)
                         if s is not None),
                        key=lambda i: self.slots[i].admit_seq):
            slot = self.slots[i]
            if slot is None or slot.cur is None:
                continue      # evicted meanwhile, or not riding yet
            eff = min(steps, max(1, self._owed(slot)))
            self._grow_locked(i, slot, -(-(slot.pos + eff) // self.Pg))

    def _preempt_locked(self, ix: int):
        """Evict slot ``ix``: free its pages and requeue its request at
        the front, to recompute from prompt + generated-so-far (the
        trailing readbacks are drained first so that snapshot is
        complete)."""
        victim = self.slots[ix]
        self._drain_fetches_locked()
        if self.slots[ix] is not victim:
            return            # the drain closed it: pages already freed
        self.slots[ix] = None
        victim.preempted = True
        self.alloc.free(victim.pages)
        self.stats["preemptions"] += 1
        self._wait.appendleft(victim.req)

    def _dispatch_chunk_locked(self, steps: int):
        """Launch one decode dispatch of ``steps`` steps. The host ships
        only the page table; per-slot ``pos``/``cur`` chain on the
        device. The token buffer joins the trailing readback queue."""
        pt = np.zeros((self.S, self.max_pages), np.int32)
        riders = []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.cur is None:
                continue
            pt[i, :len(slot.pages)] = slot.pages
            # tokens this slot still owes from THIS dispatch (the tail
            # of an overshooting window is junk)
            take = min(steps, max(0, self._owed(slot)))
            riders.append((i, slot, take))
        if not riders:
            return     # every planned rider was preempted meanwhile
        toks = self._decode_step(pt, steps,
                                 [i for i, _s, _t in riders])
        for _i, slot, _t in riders:
            slot.pos += steps
            slot.decoded += steps
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += steps
        self._fetchq.append((_Readback(toks), riders, steps))

    def _drain_fetches_locked(self, limit: Optional[int] = None,
                              keep: int = 0,
                              ready_only: bool = False):
        """Trailing token readback: fetch up to ``limit`` outstanding
        decode buffers (None = all) plus every in-flight prefill's first
        tokens, and emit to clients. ``keep`` buffers that are still
        being computed stay in flight; ``ready_only`` never blocks."""
        blocking_rounds = 0
        while self._fetchq or self._pending_prefill:
            front_ready = bool(self._fetchq) and self._fetchq[0][0].ready()
            take_buf = bool(self._fetchq) and (
                front_ready or
                (not ready_only and len(self._fetchq) > keep))
            # a rider's prefill is always older than its first decode
            # buffer, so a ready front implies its firsts are ready too
            pre_ready = bool(self._pending_prefill) and (
                not ready_only or all(rb.ready()
                                      for rb, _ in self._pending_prefill))
            if not take_buf and not pre_ready:
                return
            if take_buf and not front_ready:
                if limit is not None and blocking_rounds >= limit:
                    return
                blocking_rounds += 1
            batch = [self._fetchq.popleft()] if take_buf else []
            pend_pre = []
            if pre_ready:
                pend_pre, self._pending_prefill = self._pending_prefill, []
            # prefill firsts FIRST: a slot's seeding prefill precedes
            # its first decode ride, and both can land in one drain
            for rb, placements in pend_pre:
                firsts = rb.get()
                for ix, slot, row in placements:
                    if not slot.preempted:
                        self._emit_to(slot.req, [int(firsts[row])], ix)
            for rb, riders, _steps in batch:
                toks = rb.get()
                for i, slot, take in riders:
                    if not slot.preempted:
                        self._emit_to(slot.req, toks[:take, i].tolist(), i)

    def _emit_to(self, req: _Request, tokens: List[int], ix: int):
        """Deliver tokens to the request; close it at eos or budget. In
        no-eos mode the slot was retired at dispatch time; with an eos,
        closing here frees it."""
        if req.closed:
            return
        done = False
        n_put = 0
        for t in tokens:
            t = int(t)
            if req.t_first is None:
                req.t_first = time.monotonic()
                ttft = req.t_first - req.t_submit
                self.ttfts_s.append(ttft)
                a = self._ewma_alpha
                self._ttft_ewma = ttft if self._ttft_ewma is None \
                    else a * ttft + (1 - a) * self._ttft_ewma
            req.generated.append(t)
            req.out_q.put(t)
            n_put += 1
            if ((self.eos_id is not None and t == self.eos_id)
                    or req.remaining <= 0):
                done = True
                break
        if n_put:
            now = time.monotonic()
            if req.t_last_emit is not None:
                gap = max(0.0, now - req.t_last_emit) / n_put
                a = self._ewma_alpha
                self._itl_ewma = gap if self._itl_ewma is None \
                    else a * gap + (1 - a) * self._itl_ewma
            req.t_last_emit = now
        if done:
            req.closed = True
            slot = self.slots[ix]
            if slot is not None and slot.req is req:
                self.slots[ix] = None
                self.alloc.free(slot.pages)
            self.stats["completed"] += 1
            req.out_q.put(_DONE)

    # ------------------------------------------------- device steps

    def _prefill_batch(self, rows) -> None:
        """Dispatch ONE chunked-prefill call advancing up to
        ``_max_prefill_batch`` slots' prompts by their granted lengths.
        rows: [(slot index, slot, take), ...]. The chunk width is
        bucketed to a power of two (floor page_size, cap
        prefill_chunk); unused rows point at the null page. Rows whose
        chunk ENDS the prompt seed the device decode state with their
        first token (on-stream, no host sync) and ride the next decode
        dispatch."""
        B = self._max_prefill_batch
        mx = max(take for _ix, _s, take in rows)
        T = max(1, min(self.PC, self.Pg))
        while T < mx:
            T *= 2
        T = min(T, self.PC)
        ids = np.zeros((B, T), np.int32)
        start = np.zeros((B,), np.int32)
        last_idx = np.zeros((B,), np.int32)
        pt = np.zeros((B, self.max_pages), np.int32)  # dummies -> null
        for r, (_ix, slot, take) in enumerate(rows):
            ids[r, :take] = slot.prompt[slot.prefilled:
                                        slot.prefilled + take]
            start[r] = slot.prefilled
            last_idx[r] = take - 1
            pt[r, :len(slot.pages)] = slot.pages
        firsts = self._prefill_step(ids, start, last_idx, pt)
        placements = []
        for r, (ix, slot, take) in enumerate(rows):
            slot.prefilled += take
            slot.pos = slot.prefilled
            if slot.prefill_remaining == 0:
                placements.append((ix, slot, r))
        if placements:
            self._seed_step(firsts, placements)
            for _ix, slot, _row in placements:
                slot.cur = -1      # device-seeded: ridable
        # queued even with no finished rows, so drains (and preemption
        # barriers) sync on every in-flight prefill
        self._pending_prefill.append((_Readback(firsts), placements))
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += sum(t for _i, _s, t in rows)

    def _prefill_step(self, ids, start, last_idx, pt) -> torch.Tensor:
        """Device half of ``_prefill_batch`` (the reference's jitted
        ``_build_prefill`` executable): [B, T] ids at per-row start
        offsets append into the rows' pages and attend causally over
        each row's page window; each row's last real position samples
        a candidate first token. Returns int32 [B] on the device."""
        page_table = self._h2d(pt)
        kv = [kv_layer_view(layer, page_table) for layer in self.pages]
        logits = self.model(self._h2d(ids), kv, self._h2d(start))
        rows = torch.arange(ids.shape[0], device=self.device)
        last = logits[rows, self._h2d(last_idx).long()]
        return _pick_token(last, self.temperature, self._gen)

    def _decode_step(self, pt, steps: int, riders: List[int]
                     ) -> torch.Tensor:
        """Device half of ``_dispatch_chunk_locked`` (the reference's
        ``_build_decode``): ``steps`` single-token forwards over every
        slot, chaining ``pos``/``cur`` on the device. Returns the int32
        [steps, S] token buffer. Slots not riding get position 0 first,
        so the decode kernel reads one null-page key for them, not a
        stale window (their outputs are never read)."""
        riding = set(riders)
        idle = [i for i in range(self.S) if i not in riding]
        if idle:
            self._dev_pos[self._h2d(np.asarray(idle, np.int64))] = 0
        page_table = self._h2d(pt)
        kv = [kv_layer_view(layer, page_table) for layer in self.pages]
        pos, cur = self._dev_pos, self._dev_cur
        out = []
        for _ in range(steps):
            logits = self.model(cur[:, None], kv, pos)
            cur = _pick_token(logits[:, -1], self.temperature, self._gen)
            pos = pos + 1
            out.append(cur)
        self._dev_pos, self._dev_cur = pos, cur
        return torch.stack(out)

    def _seed_step(self, firsts: torch.Tensor, placements) -> None:
        """Admission seeding (the reference's ``_build_seed``): scatter
        the finished rows' first tokens and write positions into the
        device decode state, on-stream."""
        ixs = self._h2d(np.asarray([ix for ix, _s, _r in placements],
                                   np.int64))
        rows = self._h2d(np.asarray([r for _ix, _s, r in placements],
                                    np.int64))
        posv = self._h2d(np.asarray([s.pos for _ix, s, _r in placements],
                                    np.int32))
        self._dev_cur[ixs] = firsts[rows]
        self._dev_pos[ixs] = posv
