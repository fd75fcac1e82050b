"""Port of ``ray_tpu/serve/engine.py``: a subset of the
continuous-batching ``LLMEngine`` over the paged KV pool.

Iteration-level scheduling: requests join and leave the decode batch
at token granularity. One engine serves one model replica on one
device (``"cuda"`` by default, ``"cpu"`` when the caller asks).

- KV lives in a paged pool (models/kv_cache.py) that is allocated once
  and updated IN PLACE by every step (ops/paged_attention.py
  ``paged_append``): nothing is copied per step. The pool is fp
  (``cfg.dtype``) or int8 with per-page scales (``kv_dtype``, env
  ``RAY_TPU_KV_DTYPE`` wins), half the bytes per page. The host-side
  ``BlockAllocator`` hands pages to sequences as they grow; completion
  or preemption returns them. Inactive slots point at the null page.
- With ``prefix_cache=True`` a radix tree (serve/prefix_cache.py)
  keeps retired prompts' full pages: admission matches the longest
  cached page-aligned prefix, points the slot's page table at those
  shared pages read-only and prefills only the rest; a fully cached
  prompt copies its boundary page (every tensor of the layer, scales
  included) into a private page first (copy-on-write). Refcount-0
  cached pages are evicted LRU-first before admission waits or a
  growing slot preempts another.
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
- The scheduler runs the reference's OVERLAPPED loop by default
  (``overlap``, env ``RAY_TPU_OVERLAP=0/1``): each round plans from the
  token frontier the host has read back so far, which may trail the
  device by one dispatch (``SlotView.stale``), and the trailing drain
  holds the pipeline at two dispatches. With an eos a slot can decode
  past a late-revealed eos by at most one decode chunk; emission
  truncates where the lockstep loop would. ``overlap=False`` is the
  lockstep loop: with an eos or speculation every round drains the
  readbacks before planning.
- Speculative decoding (``spec_len``, serve/spec_decode.py): the host
  proposes prompt-lookup drafts per slot, ONE batched verify scores
  ``[cur, drafts...]`` rows at each slot's own offset through the
  paged ``T >= 1`` forward, the longest draft prefix matching the
  argmax plus the bonus token is kept, and the KV frontier is clamped
  back to it. Greedy only.
- Logprob capture (``capture_logprobs``): the chosen token's logprob
  under the sampling distribution rides each readback beside the
  tokens (``RequestHandle.logprobs``).
- Cross-replica KV pull (serve/kv_migration.py). Requester: a request
  submitted with a ``pull`` hint admits in the PULLING phase (a slot
  with no pages that rides nothing) while a thread runs the injected
  ``kv_fetcher``; landed pages enter the prefix cache and the request
  requeues at the front to admit as a local hit, or as plain prefill
  when the pull failed (``kv_pull_fallbacks``). Donor: the
  ``kv_pin_prefix``/``kv_export_pages``/``kv_release_pages`` trio a
  ``KVDonor`` drives, each under the engine lock.
- Hot weight swap (``swap_weights``): the new weights are staged as a
  second model off the lock, and the flip lands between rounds behind
  a strictly monotonic generation fence (``weight_generation``,
  ``weights_id``), preempting every slot (``mode="preempt"``) or once
  the engine has settled (``mode="drain"``, admission paused). The
  prefix cache is fenced at the flip (``PrefixCache.fence``).
- Request lifecycle: ``deadline_s`` fails a request with
  ``DeadlineExceeded`` at whatever phase it is in, checked at the top
  of every round; ``max_queued`` (online) and ``max_queued_batch``
  shed with ``EngineOverloaded(retry_after_s=shed_retry_after_s)``;
  with ``admit_timeout_s`` a submit that cannot take the engine lock
  in time (a wedged scheduler holds it) sheds the same way.
- Per-slot containment (serve/faults.py): an ``EngineFault`` out of
  the prefill lane or the decode/spec lane fails only its culprit; the
  lane's other participants requeue at the tail under ``max_retries``
  with exponential backoff (``retry_backoff_s``); a fault while one
  rider's tokens are emitted fails that rider alone. A lone slot that
  cannot grow is such a fault. Containment catches ``EngineFault`` and
  nothing else: any other error (a CUDA error, a kernel's launch
  failure) escapes to ``_fail_all`` and stops the engine. The
  ``FaultInjector`` seam (``fault_injector``) fires at the reference's
  six sites.
- ``force_kill`` fails every consumer without the lock (a wedged
  scheduler thread holds it) and fences the zombie thread: it emits no
  token, dispatches nothing and publishes no page to the prefix cache;
  a second ``shutdown()`` finishes the cleanup. ``load_report`` falls
  back to a lock-free read after 20 ms and carries the progress
  heartbeat's age (``heartbeat_age_s``).
- Priority lanes (``submit(priority="batch")``,
  ``submit_rollout_batch``): batch requests admit behind every waiting
  online one, are the first preemption victims (an online head evicts
  a batch slot to admit), take the prefill budget after online slots,
  and stay out of the TTFT and inter-token signals. ``role`` (unified,
  prefill, decode) clamps the planner's knobs each round
  (``role_plan_caps``).
- Observability (serve/obs.py): ``events`` is an ``EventLog`` that
  records every request phase and scheduler action under the
  reference's kinds and data fields (submit, admit, prefill, decode,
  spec, readback, first_token, emit, retire, preempt, fault, requeue,
  round, ... and the pull and swap events); ``sched_trace`` renders its
  four legacy kinds. Unless ``events=False``, the ``serve_phase_*``
  histograms observe queue wait, planning, dispatch, readback, round
  wall, host gap, TTFT and inter-token gaps. With ``flight_dir`` a
  contained ``EngineFault`` and ``_fail_all`` write a flight bundle
  (``obs.dump_flight_bundle``).

Not ported yet (ROADMAP.md, queue 1): tensor parallelism (item 8).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.kv_cache import (BlockAllocator,
                                           export_pages_bytes,
                                           init_kv_pool, kv_layer_view,
                                           kv_pool_page_bytes,
                                           page_cols_from_bytes)
from ray_tpu_torch.models.llama import _pick_token, build_model
from ray_tpu_torch.serve import kv_migration, obs
from ray_tpu_torch.serve.errors import (DeadlineExceeded, EngineDraining,
                                        EngineOverloaded, EngineShutdown,
                                        RequestCancelled, RequestError)
from ray_tpu_torch.serve.faults import EngineFault
from ray_tpu_torch.serve.prefix_cache import PrefixCache
from ray_tpu_torch.serve.scheduler import (LANE_BATCH, LANE_ONLINE,
                                           REPLICA_ROLES, ROLE_UNIFIED,
                                           SlotView, StepPlan, plan_step,
                                           role_plan_caps)
from ray_tpu_torch.serve.spec_decode import NGramIndex
from ray_tpu_torch.util import metrics
from ray_tpu_torch.util.envknobs import resolve_kv_dtype

_DONE = object()

SHED_TOTAL = "serve_engine_shed_total"
CANCELLED_TOTAL = "serve_engine_cancelled_total"
DEADLINE_TOTAL = "serve_engine_deadline_exceeded_total"
CONTAINED_TOTAL = "serve_engine_contained_faults_total"
RETRIES_TOTAL = "serve_engine_retries_total"
BATCH_TOKENS_TOTAL = "serve_batch_tokens_total"
BATCH_PREEMPTED_TOTAL = "serve_batch_preempted_total"
WEIGHT_SWAP_TOTAL = "serve_weight_swap_total"
WEIGHT_ROLLBACK_TOTAL = "serve_weight_rollback_total"
WEIGHT_GENERATION_GAUGE = "serve_weight_generation"
KV_BYTES_TOTAL = "serve_kv_bytes_total"

_METRICS: Optional[dict] = None


def _metrics() -> dict:
    """Lazy metric singletons of the lifecycle, the lanes, the weight
    swap and its rollback (the reference's names), re-created if a
    ``clear_registry()`` dropped them."""
    global _METRICS
    if (_METRICS is None or metrics.registry().get(SHED_TOTAL)
            is not _METRICS["shed"]):
        _METRICS = {
            "shed": metrics.Counter(
                SHED_TOTAL, "Requests rejected at submit because the "
                "admission queue was at max_queued"),
            "cancelled": metrics.Counter(
                CANCELLED_TOTAL,
                "Requests aborted by the client (cancel/disconnect)"),
            "deadline_exceeded": metrics.Counter(
                DEADLINE_TOTAL,
                "Requests expired by their per-request deadline"),
            "contained_faults": metrics.Counter(
                CONTAINED_TOTAL, "Dispatch/readback faults contained "
                "to one request instead of failing the engine"),
            "retries": metrics.Counter(
                RETRIES_TOTAL, "Innocent requests requeued after a "
                "contained fault (bounded retry policy)"),
            "batch_tokens": metrics.Counter(
                BATCH_TOKENS_TOTAL, "Tokens emitted to BATCH-lane "
                "requests (the capacity the batch tier absorbed)"),
            "batch_preempted": metrics.Counter(
                BATCH_PREEMPTED_TOTAL, "BATCH-lane slots preempted "
                "— yielded to online traffic or page pressure; the "
                "request requeues and recomputes/prefix-resumes"),
            "weight_swaps": metrics.Counter(
                WEIGHT_SWAP_TOTAL, "In-place hot weight swaps applied "
                "(monotonic generation-fence flips between scheduler "
                "rounds)"),
            "weight_rollbacks": metrics.Counter(
                WEIGHT_ROLLBACK_TOTAL, "Fleet rollout rollbacks: a "
                "canaried generation failed its health/parity gates "
                "and the controller re-installed the old payload "
                "under a fresh generation"),
            "weight_generation": metrics.Gauge(
                WEIGHT_GENERATION_GAUGE,
                "Weight generation currently serving on each replica "
                "(the monotonic swap fence; rollback still advances it "
                "— weights_id names the payload)",
                tag_keys=("replica",)),
            "kv_bytes": metrics.Gauge(
                KV_BYTES_TOTAL,
                "Paged KV pool byte budget (all layers, incl. scales)",
                tag_keys=("kv_dtype",)),
        }
    return _METRICS


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
    logprobs: Optional[List[float]] = None
                                 # per-token sampling logprobs, index-
                                 # aligned with ``generated`` (None
                                 # unless ``capture_logprobs``);
                                 # appended by _emit_to in the loop that
                                 # appends the tokens
    pull: Optional[Dict[str, Any]] = None
                                 # cross-replica KV pull hint: {"hashes":
                                 # [...], ...fetcher fields}; consumed
                                 # exactly once at first admission, so a
                                 # preemption requeue never re-pulls
    deadline: Optional[float] = None  # absolute monotonic deadline
    attempts: int = 0            # requeues after contained faults
    t_earliest: float = 0.0      # retry backoff: no re-admission
                                 # before this monotonic instant
    preemptions: int = 0
    trace_id: Optional[str] = None    # request-scope trace id (rides
                                      # the request; events: item 5.4)
    batch: bool = False          # BATCH lane: admits behind online
                                 # requests, first preemption victim,
                                 # outside the TTFT and ITL signals

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

    @property
    def done(self) -> bool:
        """True once the request has finished, failed or been
        cancelled (its stream is closed)."""
        return self._req.closed

    @property
    def error(self) -> Optional[BaseException]:
        """The terminal error (``RequestCancelled``, ``EngineShutdown``,
        ...), or None."""
        return self._req.error

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
    def weights_tag(self) -> Optional[str]:
        """``generation:weights_id`` of the serving engine at read
        time: which weight payload a client mid-rollout was served
        by."""
        eng = self._engine
        if eng is None:
            return None
        return f"{eng.weight_generation}:{eng.weights_id}"

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-emission latency (the first token put on the
        request stream); None until it is out."""
        if self._req.t_first is None:
            return None
        return self._req.t_first - self._req.t_submit

    @property
    def logprobs(self) -> Optional[List[float]]:
        """Per-token sampling logprobs, index-aligned with ``result()``:
        entry i is log p(token_i | prefix) under the distribution that
        picked it (logits / temperature when temperature > 0). None
        unless the engine was built with ``capture_logprobs=True``. Read
        after ``done`` for the complete list."""
        lp = self._req.logprobs
        return None if lp is None else list(lp)


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
    shared: int = 0              # leading pages owned by the prefix
                                 # cache (read-only for this slot)
    spec: Optional[Any] = None   # per-slot proposer (NGramIndex); dies
                                 # with the slot on preemption
    spec_pending: List[int] = dataclasses.field(default_factory=list)
                                 # drafts proposed at plan time, used by
                                 # this round's verify
    pulling: bool = False        # KV-pull phase: a thread is pulling
                                 # this request's prefix from a peer;
                                 # the slot holds no pages, rides no
                                 # dispatch and gets no grant, and the
                                 # pull's end requeues the request

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prefilled


class _Readback:
    """A dispatch's token buffer (and, under logprob capture, its fp32
    logprob buffer) copied into pinned host memory right behind the
    dispatch, and the event that marks the copies done. On the CPU the
    buffers are their own copies."""

    def __init__(self, buf: torch.Tensor,
                 lps: Optional[torch.Tensor] = None):
        bufs = [buf] if lps is None else [buf, lps]
        if buf.device.type == "cuda":
            self.host = []
            for b in bufs:
                h = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                h.copy_(b, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(buf.device))
        else:
            self.host = bufs
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def get(self) -> np.ndarray:
        """The tokens (blocks until the copy is done)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host[0].numpy()

    def logprobs(self) -> Optional[np.ndarray]:
        """The logprobs beside the tokens, None without capture; call
        after ``get``."""
        return self.host[1].numpy() if len(self.host) > 1 else None


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
    max_queued: bounded admission — with this many ONLINE requests
        already waiting, ``submit`` sheds with ``EngineOverloaded``.
        None (default) keeps the queue unbounded.
    max_queued_batch: the BATCH lane's own bound (None, default:
        unbounded).
    max_retries: an innocent participant of a faulted dispatch is
        requeued (recompute, like preemption) at most this many times
        before it fails too (default 2).
    retry_backoff_s: base of the re-admission backoff after a contained
        fault, ``retry_backoff_s * 2**(attempt - 1)`` (default 0.02).
    shed_retry_after_s: the ``retry_after_s`` that ``EngineOverloaded``
        carries (default 1.0).
    admit_timeout_s: how long ``submit`` may wait for the engine lock
        before it sheds ``EngineOverloaded`` (a wedged scheduler holds
        the lock); None (default) waits.
    fault_injector: a ``serve.faults.FaultInjector`` (tests and drills;
        None: every site is a no-op).
    role: ``"unified"`` (default), ``"prefill"`` or ``"decode"``; the
        planner's knobs are clamped per round by ``role_plan_caps``.
    prefix_cache: share the KV pages of identical page-aligned prompt
        prefixes across requests (radix tree + refcounts + LRU
        eviction, serve/prefix_cache.py). Off by default.
    kv_dtype: ``"fp"`` (pages in ``cfg.dtype``, default) or ``"int8"``
        (int8 pages plus one fp32 scale per (kv head, page): half the
        bytes; decode through K2). ``RAY_TPU_KV_DTYPE`` overrides it;
        junk in either raises.
    prefix_digest_max: most path hashes ``load_report``'s
        ``prefix_digest`` advertises (prefix-closed, longest first).
    spec_len: speculative decoding — up to this many prompt-lookup
        draft tokens per slot per round, verified by one batched
        forward; 0 (default) disables. Greedy only: silently off at
        temperature > 0 and under ``capture_logprobs`` (the verify emits
        tokens without their distributions).
    spec_ngram: suffix n-gram order of the prompt-lookup proposer.
    spec_proposer: a zero-argument factory of objects with
        ``NGramIndex``'s ``sync``/``propose``, built once per admitted
        slot (default ``NGramIndex(spec_ngram)``).
    overlap: the overlapped loop (default on): a round plans from the
        frontier read back so far while the previous dispatch may still
        run, and reads its own tokens a round late; ``False`` is the
        lockstep loop. ``RAY_TPU_OVERLAP=0``/``1`` overrides it (any
        other value is ignored).
    capture_logprobs: record each emitted token's logprob under the
        sampling distribution (fp32 logits, divided by the temperature
        when it is > 0), read back with the tokens;
        ``RequestHandle.logprobs``.
    events: record the typed event log and observe the phase
        histograms (default on); ``False`` turns both off (the A/B arm).
    flight_dir: where a contained ``EngineFault`` and ``_fail_all``
        write their flight bundles (None, default: no bundle).
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
                 prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None,
                 prefix_digest_max: int = 512,
                 spec_len: int = 0, spec_ngram: int = 3,
                 spec_proposer=None,
                 overlap: Optional[bool] = None,
                 capture_logprobs: bool = False,
                 max_queued_batch: Optional[int] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.02,
                 shed_retry_after_s: float = 1.0,
                 admit_timeout_s: Optional[float] = None,
                 fault_injector=None, role: str = ROLE_UNIFIED,
                 events: bool = True, flight_dir: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(f"model weights are on {p.device}, the "
                                 f"engine runs on {self.device}")
        if max_queued is not None and max_queued < 0:
            raise ValueError("max_queued must be >= 0 or None")
        if max_queued_batch is not None and max_queued_batch < 0:
            raise ValueError("max_queued_batch must be >= 0 or None")
        if admit_timeout_s is not None and admit_timeout_s <= 0:
            raise ValueError("admit_timeout_s must be > 0 or None")
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"unknown replica role {role!r}; expected one of "
                f"{sorted(REPLICA_ROLES)}")
        if spec_len < 0:
            raise ValueError("spec_len must be >= 0")
        if spec_len and spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        self.model = model
        self.cfg = model.cfg
        self.S = max_slots
        self.Pg = page_size
        self.K = chunk
        self.PC = max(1, int(prefill_chunk or 256))
        self.temperature = temperature
        self.eos_id = eos_id
        self.capture_logprobs = bool(capture_logprobs)
        self.spec_len = (spec_len if temperature <= 0.0
                         and not self.capture_logprobs else 0)
        self.spec_ngram = spec_ngram
        self._proposer_factory = (
            spec_proposer if spec_proposer is not None
            else (lambda: NGramIndex(spec_ngram)))
        self.KMAX = (max(chunk, 128) if max_run_ahead is None
                     else max(chunk, int(max_run_ahead)))
        # page-table width == the attention window per slot, capped at
        # what the model can address
        self.max_pages = min(n_pages - 1,
                             -(-self.cfg.max_seq_len // page_size))
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.page_bytes = kv_pool_page_bytes(self.cfg, page_size,
                                             self.kv_dtype)
        self.alloc = BlockAllocator(n_pages, page_bytes=self.page_bytes)
        self.pages = init_kv_pool(self.cfg, n_pages, page_size,
                                  self.kv_dtype, device=self.device)
        # the whole pool's byte budget, set once: a pool's shape is
        # fixed for the engine's life
        _metrics()["kv_bytes"].set(float(n_pages * self.page_bytes),
                                   tags={"kv_dtype": self.kv_dtype})
        self.prefix_cache = (PrefixCache(self.alloc, page_size)
                             if prefix_cache else None)
        self.prefix_digest_max = max(0, int(prefix_digest_max))
        self.max_queued = max_queued
        self.max_queued_batch = max_queued_batch
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = max(0.0, float(retry_backoff_s))
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.admit_timeout_s = admit_timeout_s
        # mutable: a pool may re-role a replica between requests
        self.role = role
        self._injector = fault_injector
        self._round = 0          # scheduling rounds: the fault seam's clock
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
        env = os.environ.get("RAY_TPU_OVERLAP", "")
        self.overlap = (env == "1" if env in ("0", "1")
                        else overlap is None or bool(overlap))
        self._stopped = False
        self._draining = False
        # progress heartbeat, touched lock-free at the top of each
        # round, when each dispatch completes and at each readback: a
        # wedged dispatch lets it go stale (load_report's
        # heartbeat_age_s)
        self._hb = time.monotonic()
        # zombie fence, set by force_kill(): a wedged step thread that
        # wakes later commits no token and publishes no page
        self._force_killed = False
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, int] = collections.Counter()
        self._max_prefill_batch = 4
        # submit->first-emission latencies (seconds), most recent
        self.ttfts_s: "collections.deque" = collections.deque(maxlen=4096)
        self._ttft_ewma: Optional[float] = None
        self._itl_ewma: Optional[float] = None
        self._ewma_alpha = 0.2
        # Weight-generation fence: strictly monotonic — every
        # ``swap_weights`` advances it, rollbacks included (the OLD
        # payload under a NEW generation); ``weights_id`` names the
        # payload. ``replica_tag`` labels the generation gauge.
        self.weight_generation = 0
        self.weights_id = "g0"
        self.replica_tag = "0"
        self._pending_swap: Optional[Dict[str, Any]] = None
        # Cross-replica KV pull, requester side: ``kv_fetcher`` is a
        # callable(pull hint) -> payload dict or None (e.g.
        # kv_migration.pull_prefix over a donor's call seam), injected
        # by the caller; the stats mirror the process counters.
        self.kv_fetcher: Optional[Any] = None
        self.kv_migration_stats = kv_migration.new_stats()
        # the typed lifecycle event log (lock-free bounded ring) and its
        # legacy four-kind view; ``events=False`` is the A/B arm
        self.events = obs.EventLog(8192, name="engine", enabled=events)
        self._obs_enabled = bool(events)
        self.sched_trace = obs.SchedTraceView(self.events)
        self.flight_dir = flight_dir

    def _h2d(self, x) -> torch.Tensor:
        """Host->device for dispatch operands (page tables, token
        chunks, positions; a numpy array or a CPU tensor) and landed KV
        pages: staged through pinned memory so the copy is enqueued
        without waiting for the device. The caching host allocator
        keeps each pinned block from reuse until its copy is done."""
        t = (x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(x)))
        if self.device.type == "cuda":
            return t.contiguous().pin_memory().to(self.device,
                                                  non_blocking=True)
        return t

    # ---------------------------------------------------------- public

    def submit(self, prompt_ids: List[int],
               max_new_tokens: int = 64,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               pull: Optional[Dict[str, Any]] = None,
               priority: str = LANE_ONLINE) -> RequestHandle:
        """Queue one request. Raises ``RequestError`` for an empty
        prompt, a non-positive budget or deadline, an unknown priority,
        token ids outside the vocabulary, or a request the pool or the
        model cannot hold; ``EngineOverloaded`` when the request's lane
        already holds its bound of waiting requests, or the engine lock
        stayed taken for ``admit_timeout_s``;
        ``EngineShutdown``/``EngineDraining`` when stopped or draining.

        ``deadline_s`` (relative, seconds): the request fails with
        ``DeadlineExceeded`` in the first round after it passes,
        whatever its phase, and its resources free at once.
        ``priority``: ``"online"`` (default) or ``"batch"``, preemptible
        offline work bounded by ``max_queued_batch``. ``trace_id`` rides
        the request.

        ``pull`` is a cross-replica KV pull hint (serve/kv_migration.py):
        a dict with at least ``hashes`` (the prompt's leading rolling
        path hashes a peer holds) plus whatever fields the injected
        ``kv_fetcher`` needs to reach the donor. Admission then enters
        the PULLING phase instead of recomputing the prefix
        (``_try_pull_admit_locked``). Ignored without a fetcher or a
        prefix cache."""
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise RequestError("empty prompt")
        if max_new_tokens < 1:
            raise RequestError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise RequestError("deadline_s must be > 0")
        if priority not in (LANE_ONLINE, LANE_BATCH):
            raise RequestError(
                f"unknown priority {priority!r}; expected "
                f"'{LANE_ONLINE}' or '{LANE_BATCH}'")
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
                       t_submit=time.monotonic(),
                       logprobs=[] if self.capture_logprobs else None,
                       pull=pull, trace_id=trace_id,
                       batch=priority == LANE_BATCH)
        if deadline_s is not None:
            req.deadline = req.t_submit + deadline_s
        self.events.append("submit", rid=req.rid, t=req.t_submit,
                           data={"trace_id": trace_id,
                                 "prompt_len": len(prompt_ids),
                                 "max_new_tokens": max_new_tokens,
                                 "lane": priority})
        # bounded acquire: a wedged scheduler holds the lock for good,
        # and a caller must shed and reroute rather than park on it
        if not self._work.acquire(timeout=-1 if self.admit_timeout_s is None
                                  else self.admit_timeout_s):
            self.stats["admit_timeouts"] += 1
            self.events.append("shed", rid=req.rid,
                               data={"why": "admit_timeout"})
            raise EngineOverloaded(
                f"admission lock unavailable for {self.admit_timeout_s}s "
                f"(scheduler stalled); request shed",
                retry_after_s=self.shed_retry_after_s)
        try:
            if self._stopped:
                raise EngineShutdown("engine stopped")
            if self._draining:
                raise EngineDraining(
                    "engine draining: finishing in-flight work, "
                    "admitting nothing new")
            # each lane sheds against its own bound: a deep batch
            # backlog never sheds online traffic
            bound = self.max_queued_batch if req.batch else self.max_queued
            if bound is not None:
                depth = sum(1 for r in self._wait if r.batch == req.batch)
                if depth >= bound:
                    self.stats["shed"] += 1
                    _metrics()["shed"].inc()
                    self.events.append("shed", rid=req.rid,
                                       data={"why": "queue_full",
                                             "lane": priority})
                    raise EngineOverloaded(
                        f"admission queue full ({depth} {priority} "
                        f"waiting >= max_queued"
                        f"{'_batch' if req.batch else ''}={bound}); "
                        f"request shed",
                        retry_after_s=self.shed_retry_after_s)
            self._wait.append(req)
            self.stats["submitted"] += 1
            self._work.notify()
        finally:
            self._work.release()
        return RequestHandle(req, self)

    def submit_rollout_batch(self, prompts: List[List[int]],
                             max_new_tokens: int = 64,
                             deadline_s: Optional[float] = None,
                             trace_id: Optional[str] = None
                             ) -> List[RequestHandle]:
        """Queue one BATCH-lane request per prompt, in order, and return
        the handles (RL rollouts, the batch tier): they admit behind
        online traffic, are the first preemption victims and stay out of
        the TTFT signals. ``trace_id`` stamps request i as
        ``{trace_id}:{i}``; logprobs ride the handles under
        ``capture_logprobs``."""
        return [self.submit(list(p), max_new_tokens=max_new_tokens,
                            deadline_s=deadline_s,
                            trace_id=(f"{trace_id}:{i}" if trace_id
                                      else None),
                            priority=LANE_BATCH)
                for i, p in enumerate(prompts)]

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

    # ------------------------------------------------ hot weight swap

    def swap_weights(self, params: Dict[str, torch.Tensor], *,
                     generation: Optional[int] = None,
                     weights_id: Optional[str] = None,
                     mode: str = "preempt", wait: bool = True,
                     timeout_s: float = 120.0) -> int:
        """In-place hot weight swap under traffic. ``params`` is a state
        dict of ``models.llama.Llama`` (as ``build_model`` takes it;
        JAX-package weights through ``flax_state_dict``).

        The new weights are staged as a second model on the engine's
        device OFF the engine lock, and their copies finish before the
        flip (the double buffer: the old model keeps serving meanwhile;
        the serving model's tensors are never written, since a queued
        dispatch may still read them). The flip lands between
        scheduler rounds — ``step()`` holds the lock for a whole round,
        so taking it here is the round boundary.

        ``mode="preempt"`` (default) flips now: trailing readbacks are
        drained so every victim's generated-so-far is complete, every
        slot is preempted through the token-identical recompute path (a
        pull in flight included: its payload is dropped when it
        returns), the prefix cache is fenced (no KV computed under the
        old weights is ever matched against the new), and the fence
        advances. ``mode="drain"`` pauses admission and applies the
        same flip once every slot, readback and in-flight prefill has
        settled: requests in flight finish wholly on the old weights.

        The fence is strictly monotonic: a ``generation`` at or below
        the current one raises ``ValueError``; roll back by installing
        the old payload under a NEW generation. Returns the generation
        serving after the swap (with ``wait=False`` in drain mode, the
        one that will serve once the drain settles)."""
        if mode not in ("preempt", "drain"):
            raise ValueError(f"unknown swap mode {mode!r}; expected "
                             f"'preempt' or 'drain'")
        staged = self._stage_weights(params)
        with self._work:
            if self._stopped:
                raise EngineShutdown(
                    "cannot swap weights: engine stopped")
            gen = (self.weight_generation + 1 if generation is None
                   else int(generation))
            if gen <= self.weight_generation:
                raise ValueError(
                    f"weight-generation fence is monotonic: requested "
                    f"generation {gen} <= current "
                    f"{self.weight_generation} (install the old "
                    f"payload under a NEW generation to roll back)")
            wid = weights_id if weights_id is not None else f"g{gen}"
            if mode == "preempt":
                self._apply_swap_locked(staged, gen, wid, mode)
                self._work.notify_all()
                return gen
            if self._pending_swap is not None:
                raise RuntimeError(
                    "a drain-mode weight swap is already pending "
                    f"(generation {self._pending_swap['generation']})")
            pend = {"model": staged, "generation": gen,
                    "weights_id": wid, "applied": False,
                    "event": threading.Event()}
            self._pending_swap = pend
            self.events.append("weight_swap_pending",
                               data={"generation": gen,
                                     "weights_id": wid})
            self._work.notify_all()
        if not wait:
            return gen
        deadline = time.monotonic() + max(0.0, timeout_s)
        while not pend["event"].wait(timeout=0.05):
            if self._stopped:
                raise EngineShutdown(
                    "engine stopped with a weight swap pending")
            if time.monotonic() >= deadline:
                with self._work:
                    if self._pending_swap is pend:
                        self._pending_swap = None
                raise TimeoutError(
                    f"drain-mode weight swap to generation {gen} did "
                    f"not apply within {timeout_s}s")
        if not pend["applied"]:
            raise EngineShutdown(
                "engine stopped with a weight swap pending")
        return gen

    def _stage_weights(self, params: Dict[str, torch.Tensor]):
        """The swap's staging half, off the lock: a new model on the
        engine's device from ``params``, its host-to-device copies
        finished before it is returned."""
        staged = build_model(self.cfg, params, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return staged

    def _maybe_apply_pending_swap_locked(self) -> None:
        """Apply a pending drain-mode swap iff the engine has fully
        settled (no slots, no trailing readbacks, no in-flight
        prefills). Called between rounds by ``step()``."""
        pend = self._pending_swap
        if pend is None:
            return
        if (any(s is not None for s in self.slots) or self._fetchq
                or self._pending_prefill):
            return
        self._pending_swap = None
        self._apply_swap_locked(pend["model"], pend["generation"],
                                pend["weights_id"], "drain")
        pend["applied"] = True
        pend["event"].set()

    def _apply_swap_locked(self, staged, gen: int, wid: str,
                           mode: str) -> None:
        """The inter-round flip. The caller holds the engine lock and
        has validated the fence."""
        # settle trailing readbacks first so every victim's
        # generated-so-far is complete before its recompute prompt
        # freezes (token identity across the swap)
        self._drain_fetches_locked()
        preempted = 0
        for i in range(len(self.slots)):
            victim = self.slots[i]
            if victim is None:
                continue
            self._preempt_locked(i)
            if victim.preempted:
                preempted += 1
        # the fence's cache half: every slot was preempted, so only
        # donor pins hold pages; fence() evicts the rest and detaches
        # the pinned ones, which leave when their last pin drops
        evicted = 0
        if self.prefix_cache is not None:
            evicted = self.prefix_cache.fence()
        self.model = staged
        self.weight_generation = gen
        self.weights_id = wid
        self.stats["weight_swaps"] += 1
        m = _metrics()
        m["weight_swaps"].inc()
        m["weight_generation"].set(float(gen),
                                   tags={"replica": str(self.replica_tag)})
        self.events.append("weight_swap", data={
            "generation": gen, "weights_id": wid, "mode": mode,
            "preempted": preempted, "prefix_pages_evicted": evicted})
        self._hb = time.monotonic()

    def load_report(self) -> Dict[str, Any]:
        """Compact load snapshot: free capacity, per-lane queue
        pressure, outstanding token work, latency EWMAs, the readback
        pipeline, the heartbeat's age (the fields of the reference's
        report that this engine has). Tries the engine lock for 20 ms,
        then reads lock-free: a wedged scheduler holds the lock, and a
        probe must still answer. The scheduler mutates these fields
        under the GIL, so a lock-free read is at worst torn across
        fields; it is retried if a container changed size under it."""
        if self._lock.acquire(timeout=0.02):
            try:
                return self._report_locked()
            finally:
                self._lock.release()
        for _ in range(3):
            try:
                return self._report_locked()
            except RuntimeError:     # a deque mutated mid-iteration
                continue
        return self._report_locked(digest=False)

    def _report_locked(self, digest: bool = True) -> Dict[str, Any]:
        outstanding = 0
        slots = list(self.slots)
        for slot in slots:
            if slot is not None:
                outstanding += max(0, slot.prefill_remaining)
                outstanding += max(0, slot.req.remaining)
        waiting = list(self._wait)
        for req in waiting:
            outstanding += len(req.prompt) + req.max_new_tokens
        q_batch = sum(1 for r in waiting if r.batch)
        return {
            "free_slots": sum(1 for s in slots if s is None),
            "total_slots": self.S,
            "free_pages": self.alloc.n_free,
            "kv_dtype": self.kv_dtype,
            "kv_page_bytes": self.page_bytes,
            "kv_bytes_in_use": self.alloc.bytes_in_use(),
            "kv_bytes_total": self.alloc.bytes_total(),
            # queue_depth is the ONLINE lane: preemptible batch backlog
            # is its own number
            "queue_depth": len(waiting) - q_batch,
            "queue_depth_online": len(waiting) - q_batch,
            "queue_depth_batch": q_batch,
            "outstanding_tokens": outstanding,
            "max_queued": self.max_queued,
            "max_queued_batch": self.max_queued_batch,
            "shed_retry_after_s": self.shed_retry_after_s,
            "shed_total": self.stats.get("shed", 0),
            "ttft_ewma_s": self._ttft_ewma,
            "itl_ewma_s": self._itl_ewma,
            "role": self.role,
            "draining": self._draining,
            "stopped": self._stopped,
            "heartbeat_age_s": time.monotonic() - self._hb,
            # dispatches whose tokens are still in flight: the
            # overlapped loop holds this at <= 2
            "fetchq_depth": len(self._fetchq),
            "pending_prefills": len(self._pending_prefill),
            "overlap": self.overlap,
            "weight_generation": self.weight_generation,
            "weights_id": self.weights_id,
            "prefix_digest": (self.prefix_cache.digest(
                self.prefix_digest_max)
                if self.prefix_cache is not None and digest
                else frozenset()),
            "has_work": bool(waiting or any(slots)
                             or self._fetchq
                             or self._pending_prefill),
            "device": str(self.device),
        }

    def force_kill(self, err: Optional[BaseException] = None) -> None:
        """Out-of-band kill of a WEDGED engine (a watchdog's
        escalation). The wedged scheduler thread is parked inside
        ``step()`` holding the engine lock, so this takes no lock: it
        sets the zombie fence and the stop flag (single assignments)
        and fails every consumer, so blocked ``stream()`` readers
        unblock at once. The slots' pages are freed once the wedge
        releases and the thread unwinds: call ``shutdown()`` again then.

        The fence: a thread that wakes afterwards commits no token (the
        requests are closed, ``_emit_to`` drops), dispatches nothing
        (the ``_stopped`` checks after each fire site abandon the round)
        and publishes no page (retire-path inserts become plain
        frees)."""
        err = err or EngineShutdown(
            "engine force-killed: wedged (no scheduler progress)")
        self.events.append("force_kill", data={"error": repr(err)})
        self._force_killed = True
        self._stopped = True

        def fail(req):
            if not req.closed:
                req.closed = True
                req.error = err
                req.out_q.put(_DONE)

        for slot in list(self.slots):
            if slot is not None:
                fail(slot.req)
        for _rb, riders, _steps in list(self._fetchq):
            for _i, slot, _t in riders:
                fail(slot.req)
        for _rb, placements in list(self._pending_prefill):
            for _ix, slot, _row in placements:
                fail(slot.req)
        for req in list(self._wait):
            fail(req)
        pend, self._pending_swap = self._pending_swap, None
        if pend is not None:
            pend["event"].set()    # the waiter raises EngineShutdown
        self.stats["force_killed"] += 1

    def shutdown(self):
        """Stop the engine and FAIL everything still queued or in
        flight with ``EngineShutdown`` — no consumer is left blocked.
        Tokens already computed are delivered first. Idempotent.

        After ``force_kill`` the scheduler thread may still be wedged
        inside ``step()`` holding the lock: the join is then short, and
        while the thread lives the cleanup waits for a later
        ``shutdown()`` (after the wedge releases)."""
        err = EngineShutdown("engine stopped")
        if self._force_killed:
            # consumers already failed lock-free; the lock may be held
            # by the wedged thread
            if self._thread is not None:
                self._thread.join(timeout=1.0)
                if self._thread.is_alive():
                    return
        else:
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
            pend, self._pending_swap = self._pending_swap, None
            if pend is not None:
                pend["event"].set()    # the waiter raises EngineShutdown

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
                         count: Optional[str] = None,
                         record: bool = True) -> None:
        """Resolve a request's consumers with a typed error, exactly
        once; ``count`` names the stats counter to bump and the event
        recorded (``failed`` without one; none unless ``record``)."""
        if req.closed:
            return
        req.closed = True
        req.error = err
        req.out_q.put(_DONE)
        if record:
            self.events.append(count or "failed", rid=req.rid,
                               data={"error": repr(err)})
        if count:
            self.stats[count] += 1
            m = _metrics().get(count)
            if m is not None:
                m.inc()

    def _teardown_slot_locked(self, ix: int, err: BaseException,
                              count: Optional[str] = None,
                              record: bool = True) -> None:
        """Fail a slotted request and free its slot, its private pages
        and its shared prefix-page references (the tree keeps the KV);
        in-flight readback rows for it are discarded (``preempted``)."""
        slot = self.slots[ix]
        self.slots[ix] = None
        slot.preempted = True
        self._free_slot_pages_locked(slot, retire=False)
        self._fail_req_locked(slot.req, err, count, record)

    def _reap_deadlines_locked(self) -> None:
        """Fail every request whose deadline passed, queued or slotted
        alike, with ``DeadlineExceeded``; runs at the top of every
        round, so a deadline is kept to one round."""
        now = time.monotonic()
        for req in [r for r in self._wait
                    if r.deadline is not None and now >= r.deadline]:
            self._wait.remove(req)
            self._fail_req_locked(req, DeadlineExceeded(
                f"request {req.rid} missed its deadline while queued"),
                "deadline_exceeded")
        for i, slot in enumerate(self.slots):
            if (slot is not None and not slot.req.closed
                    and slot.req.deadline is not None
                    and now >= slot.req.deadline):
                self._teardown_slot_locked(i, DeadlineExceeded(
                    f"request {slot.req.rid} missed its deadline after "
                    f"{len(slot.req.generated)} tokens"),
                    "deadline_exceeded")

    def _fire(self, site: str, sid: Optional[int] = None,
              rid: Optional[int] = None) -> None:
        """Fault-injection site (a no-op without an injector)."""
        if self._injector is not None:
            self._injector.fire(site, self._round, sid, rid)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """``BlockAllocator.alloc`` behind the fault seam: an injected
        exhaustion makes the pool look dry for this one call, which
        steers the caller into its evict, preempt or wait path."""
        if (self._injector is not None
                and self._injector.exhausted(self._round)):
            return None
        return self.alloc.alloc(n)

    def lifecycle_stats(self) -> Dict[str, Any]:
        """The lifecycle knobs and counters (the reference's keys)."""
        with self._lock:
            s = self.stats
            return {
                "max_queued": self.max_queued,
                "max_retries": self.max_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "shed": s["shed"],
                "cancelled": s["cancelled"],
                "deadline_exceeded": s["deadline_exceeded"],
                "contained_faults": s["contained_faults"],
                "retries": s["retries"],
                "retry_exhausted": s["retry_exhausted"],
                "fault_failed": s["fault_failed"],
            }

    def step(self) -> bool:
        """One scheduler iteration:

            drain -> admit -> plan round -> dispatch prefill chunk
                  -> grow/preempt -> dispatch decode chunk (or verify)
                  -> fetch the previous dispatch's tokens (trailing)

        The pre-plan drain takes one of three modes:

        1. overlapped loop (``overlap``): a ready-only sweep that never
           blocks, eos or not. The round is planned from a frontier
           that may trail the device by one dispatch; the eos is then
           revealed at readback, emission truncates there, and the
           planner caps stale riders at one decode chunk.
        2. lockstep loop with an eos or speculation: a full drain —
           sampled tokens decide completion, and the proposer and the
           verify's input token are host state.
        3. lockstep without either: opportunistic, ready buffers only;
           slots retire by arithmetic at dispatch.

        The trailing drain blocks only on a dispatch OLDER than the one
        just queued, so at most two are in flight. Returns False when
        idle.

        Containment: an ``EngineFault`` out of the prefill lane or the
        decode/spec lane is handled here (``_contain_fault_locked``)
        with the lane's participants added to its ``sids``, and the
        engine keeps serving. Any other error escapes to the caller
        (``_loop``'s ``_fail_all``).

        A round that dispatched records a ``round`` event with its host
        gap (the pre-plan drain plus the planner: the host time gating
        this round's dispatches) and its wall time; the phase
        histograms observe plan, dispatch, round wall and host gap."""
        with self._lock:
            if self._stopped:
                return False
            self._round += 1
            self._hb = time.monotonic()
            pm = obs.phase_metrics() if self._obs_enabled else None
            t0 = self._hb
            self._fire("step")     # global site: escapes, like a
                                   # device loss
            if self._stopped:
                # force-killed while wedged at the step site: the
                # fence forbids any further work this round
                return False
            self._reap_deadlines_locked()
            tg = time.monotonic()
            if self.overlap or (self._deferred and not self.spec_len):
                self._drain_fetches_locked(ready_only=True)
            else:
                self._drain_fetches_locked()
            gap = time.monotonic() - tg
            if self._pending_swap is not None:
                # drain-mode weight swap: admission is paused; flip
                # here, between rounds, once everything settled
                self._maybe_apply_pending_swap_locked()
            self._admit_locked()
            if not any(self.slots):
                if self._fetchq or self._pending_prefill:
                    self._drain_fetches_locked(limit=1)
                    return True
                return bool(self._wait)
            if all(s is None or s.pulling for s in self.slots):
                # only PULLING slots: nothing is dispatchable until a
                # transfer lands or aborts; park on the condition (the
                # pull thread notifies) while older readbacks drain
                if self._fetchq or self._pending_prefill:
                    self._drain_fetches_locked(limit=1)
                else:
                    self._work.wait(timeout=0.01)
                return True
            tp = time.monotonic()
            plan = self._plan_steps_locked()
            tpe = time.monotonic()
            gap += tpe - tp
            if pm is not None:
                pm["plan"].observe(tpe - tp)
            td = time.monotonic()
            try:
                if plan.prefill:
                    self._dispatch_prefill_locked(plan.prefill)
            except EngineFault as e:
                e.sids = sorted({g.sid for g in plan.prefill}
                                | set(e.sids))
                self._contain_fault_locked(e)
                return True
            riders = [i for i, s in enumerate(self.slots)
                      if s is not None and s.cur is not None]
            try:
                if plan.spec:
                    self._dispatch_spec_locked(plan.spec)
                elif plan.decode_steps:
                    self._grow_or_preempt_locked(plan.decode_steps)
                    self._dispatch_chunk_locked(plan.decode_steps)
                    if self._deferred:
                        self._retire_planned_locked()
            except EngineFault as e:
                part = ({g.sid for g in plan.spec} if plan.spec
                        else set(riders))
                e.sids = sorted(part | set(e.sids))
                self._contain_fault_locked(e)
                return True
            if pm is not None:
                pm["dispatch"].observe(time.monotonic() - td)
            self._drain_fetches_locked(limit=1, keep=1)
            now = time.monotonic()
            self.events.append("round", data={
                "host_gap_s": round(gap, 6),
                "wall_s": round(now - t0, 6),
                "overlap": self.overlap})
            if pm is not None:
                pm["round_wall"].observe(now - t0)
                pm["host_gap"].observe(gap)
            return True

    def _contain_fault_locked(self, e: EngineFault) -> None:
        """Per-slot containment: fail ONLY the culprit with the
        underlying error; every other slot of the faulted dispatch
        requeues at the tail under the bounded retry policy. A fault
        with no culprit requeues every participant. Trailing readbacks
        are settled first: a requeued request recomputes from prompt +
        generated, which must be complete."""
        self.stats["contained_faults"] += 1
        _metrics()["contained_faults"].inc()
        self.events.append("fault", rid=e.culprit_rid, sid=e.culprit_sid,
                           data={"sids": list(e.sids),
                                 "error": repr(e.original)})
        if self.flight_dir is not None:
            # the postmortem while the fault's context is live (the
            # probes take no lock, so holding the engine lock is fine)
            obs.dump_flight_bundle(self.flight_dir, "engine-fault",
                                   engine=self)
        self._drain_fetches_locked()
        now = time.monotonic()
        for sid in sorted(set(e.sids)):
            slot = self.slots[sid] if 0 <= sid < self.S else None
            if slot is None:
                continue       # the drain closed it, or already gone
            if sid == e.culprit_sid:
                self._teardown_slot_locked(sid, e.original,
                                           "fault_failed")
            else:
                self._requeue_after_fault_locked(sid, e, now)

    def _requeue_after_fault_locked(self, sid: int, e: EngineFault,
                                    now: float) -> None:
        """Requeue an innocent participant of a faulted dispatch at the
        TAIL (a faulting batch must not starve fresh arrivals), behind
        an exponential backoff from ``now``, the fault's one clock
        reading (participants with equal attempts become admissible in
        the same round, whatever the loop's timing); past
        ``max_retries`` attempts it fails too, so a poisoned batch never
        retries forever."""
        slot = self.slots[sid]
        req = slot.req
        req.attempts += 1
        if req.attempts > self.max_retries:
            self._teardown_slot_locked(sid, RequestError(
                f"request {req.rid} failed after {req.attempts - 1} "
                f"retries (last fault: {e.original!r})"),
                "retry_exhausted")
            return
        self.slots[sid] = None
        slot.preempted = True     # in-flight rows are recomputed
        self._free_slot_pages_locked(slot, retire=False)
        req.t_earliest = (now + self.retry_backoff_s
                          * (2 ** (req.attempts - 1)))
        self._wait.append(req)
        self.stats["retries"] += 1
        _metrics()["retries"].inc()
        self.events.append("requeue", rid=req.rid, sid=sid,
                           data={"attempts": req.attempts})

    def _plan_steps_locked(self) -> StepPlan:
        """Plan this round with the pure planner (serve/scheduler.py),
        after refreshing each seeded slot's drafts when speculation is
        on. ``stale`` counts each live slot's dispatched but undrained
        decode steps; the identity check keeps a freed-and-reseated
        slot's old rides from counting as its own."""
        if self.spec_len:
            self._propose_spec_locked()
        stale = [0] * self.S
        for _rb, riders, steps in self._fetchq:
            for i, slot, _take in riders:
                if self.slots[i] is slot:
                    stale[i] += steps
        views = [SlotView(sid=i, admit_seq=s.admit_seq,
                          prompt_remaining=s.prefill_remaining,
                          owed=max(0, self._owed(s))
                          if s.cur is not None else 0,
                          seeded=s.cur is not None,
                          spec_drafts=len(s.spec_pending),
                          stale=stale[i], pulling=s.pulling,
                          batch=s.req.batch)
                 for i, s in enumerate(self.slots) if s is not None]
        # the role's clamps, read each round: a pool may re-role a
        # replica between requests
        caps = role_plan_caps(self.role, page_size=self.Pg,
                              decode_chunk=self.K, prefill_budget=self.PC,
                              max_run_ahead=self.KMAX)
        return plan_step(views, total_slots=self.S,
                         prefill_budget=caps["prefill_budget"],
                         decode_chunk=self.K,
                         max_run_ahead=caps["max_run_ahead"],
                         prefill_batch=self._max_prefill_batch,
                         eos_bounded=self.eos_id is not None,
                         spec_enabled=bool(self.spec_len))

    def _propose_spec_locked(self):
        """Refresh each seeded slot's prompt-lookup drafts. Under the
        lockstep loop this runs after the round's full drain, so
        ``req.generated`` is the device's stream; under the overlapped
        loop it may trail by one round — harmless: a mispositioned
        draft is just rejected by the verify, and ``prompt +
        generated`` only grows. A slot with one token left proposes
        nothing (the bonus token covers it)."""
        for s in self.slots:
            if s is None:
                continue
            s.spec_pending = []
            if (s.cur is None or s.preempted or s.req.closed
                    or not s.req.generated):
                continue
            if s.spec is None:
                s.spec = self._proposer_factory()
            s.spec.sync(s.req.prompt + s.req.generated)
            room = min(self.spec_len, s.req.remaining - 1)
            if room > 0:
                s.spec_pending = [int(t) for t in s.spec.propose(room)]

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
                self._free_slot_pages_locked(slot, retire=True)

    # ------------------------------------------------------- scheduler

    def _loop(self):
        while True:
            with self._work:
                while (not self._stopped and not self._wait
                       and not any(self.slots)
                       and not self._fetchq
                       and not self._pending_prefill
                       and self._pending_swap is None):
                    # a pending drain-mode swap is work: the settled
                    # engine runs one more round so the flip lands
                    self._work.wait()
                if self._stopped:
                    # deliver every token already computed; shutdown()
                    # fails whatever remains with EngineShutdown
                    self._drain_fetches_locked()
                    return
            try:
                self.step()
            except EngineFault as e:
                # attributable, outside a dispatch section (step()
                # contains the ones inside)
                with self._lock:
                    self._contain_fault_locked(e)
            except BaseException as e:   # global: fail every request
                self._fail_all(e)
                return
            # let a client waiting for the lock (cancel, submit, a swap,
            # a donor's pin) take it: a released lock goes to whichever
            # thread asks first, and without this yield the loop asks
            # again at once, round after round
            time.sleep(0)

    def _fail_all(self, e: BaseException):
        """Global failure (device error, scheduler bug): every queued
        and in-flight request fails with the error. With ``flight_dir``
        the flight bundle is written first, before teardown clears the
        queues.

        The engine is marked stopped before any consumer is released: a
        pool judges a replica dead by ``_stopped`` the moment its
        consumer sees the error, and must not read False there (the
        reference sets it last, so its pool can take a replica death
        for a request failure and lose the request)."""
        self.events.append("fail_all", data={"error": repr(e)})
        if self.flight_dir is not None:
            obs.dump_flight_bundle(self.flight_dir, "engine-fail-all",
                                   engine=self, extra={"error": repr(e)})
        with self._lock:
            self._stopped = True
            self.stats["failed_all"] += 1
            # the ``fail_all`` event stands for every request it fails:
            # none gets a ``failed`` event of its own
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    self._teardown_slot_locked(i, e, record=False)
            for _rb, riders, _steps in self._fetchq:
                for _i, slot, _t in riders:
                    self._fail_req_locked(slot.req, e, record=False)
            for _rb, placements in self._pending_prefill:
                for _ix, slot, _row in placements:
                    self._fail_req_locked(slot.req, e, record=False)
            self._fetchq.clear()
            self._pending_prefill.clear()
            while self._wait:
                self._fail_req_locked(self._wait.popleft(), e,
                                      record=False)

    def _next_admit_locked(self) -> Optional[_Request]:
        """The request admission takes next: closed requests at the head
        are dropped, then the first ONLINE request anywhere in the queue
        (FIFO within each lane), else the batch head. The chosen request
        is rotated to the front, so the ``popleft`` of every admission
        path takes it."""
        while self._wait and self._wait[0].closed:
            self._wait.popleft()
        if not self._wait:
            return None
        head = self._wait[0]
        if not head.batch:
            return head
        for k in range(1, len(self._wait)):
            r = self._wait[k]
            if r.closed or r.batch:
                continue
            del self._wait[k]
            self._wait.appendleft(r)
            return r
        return head

    def _victim_locked(self, exclude_sid: Optional[int] = None, *,
                       batch_only: bool = False) -> Optional[int]:
        """Preemption victim: the youngest occupied slot, batch slots
        strictly before online ones (``max`` over ``(batch,
        admit_seq)``), never ``exclude_sid`` (the slot whose growth is
        hunting) and never a PULLING slot (no pages to reclaim, and its
        thread owns it). ``batch_only`` restricts the hunt to batch
        slots: an online head evicts nothing else to admit."""
        cands = (j for j, s in enumerate(self.slots)
                 if s is not None and not s.pulling and j != exclude_sid
                 and (s.req.batch or not batch_only))
        return max(cands, key=lambda j: (self.slots[j].req.batch,
                                         self.slots[j].admit_seq),
                   default=None)

    def _admit_locked(self):
        """Chunk-budget admission: the queue head takes a free slot as
        soon as pages for its FIRST prefill chunk exist. FIFO: closed
        requests at the head are dropped, nothing is reordered.

        With the prefix cache on, admission first matches the longest
        cached page-aligned prefix: the slot's page table points at
        those shared pages read-only, prefill resumes at the matched
        offset, and only the uncached tokens are prefilled. A fully
        cached prompt copies its final matched page into a private page
        (COW: the model still needs the last position's logits, and
        that one-token re-prefill must not write into a shared page).
        When the pool is dry, refcount-0 cached pages are evicted
        LRU-first before admission gives up.

        A request carrying a pull hint (``req.pull``) whose prefix is
        not cached here admits in the PULLING phase instead
        (``_try_pull_admit_locked``); the pull's end requeues it at the
        front, to admit through this path as a local hit or as plain
        prefill. While a drain-mode weight swap is pending, admission
        pauses so the engine settles and the flip can land.

        Lanes: the admitted request is the first ONLINE one in the
        queue; batch requests admit only when none waits. An online
        head facing a full engine preempts the youngest BATCH slot and
        retries (online slots are never evicted to admit). A request
        backing off after a contained fault holds the queue until its
        ``t_earliest``."""
        if self._pending_swap is not None:
            return
        while self._wait:
            req = self._next_admit_locked()
            if req is None:
                return
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                if not req.batch:
                    victim = self._victim_locked(None, batch_only=True)
                    if victim is not None:
                        self._preempt_locked(victim)
                        continue
                return
            if req.t_earliest and time.monotonic() < req.t_earliest:
                return
            prompt = req.recompute_prompt
            if req.pull is not None and self._try_pull_admit_locked(
                    free[0], req, prompt):
                continue       # PULLING slot seated; admit the rest
            shared_pages: List[int] = []
            matched = 0
            copy_src: Optional[int] = None
            if self.prefix_cache is not None:
                shared_pages, matched = self.prefix_cache.match(prompt)
                if matched and matched == len(prompt):
                    # whole prompt cached: re-prefill only the LAST
                    # token, into a private copy of the final page
                    copy_src = shared_pages.pop()
                    matched -= 1
            start = matched
            first = max(1, min(len(prompt) - start, self.PC))
            need = -(-(start + first) // self.Pg) - len(shared_pages)
            page_ids = self._alloc(need)
            if page_ids is None and self.prefix_cache is not None:
                # reclaim LRU refcount-0 cached pages before failing
                if self.prefix_cache.evict(need - self.alloc.n_free) > 0:
                    page_ids = self._alloc(need)
            if page_ids is None:
                # pool dry: hand the matched references back and wait
                if self.prefix_cache is not None:
                    if copy_src is not None:
                        shared_pages = shared_pages + [copy_src]
                    if shared_pages:
                        self.prefix_cache.release(shared_pages)
                return         # wait for completions
            if copy_src is not None:
                # duplicate the boundary page on-stream before any write
                # can target it, then drop the borrowed reference
                self._copy_page(copy_src, page_ids[0])
                self.prefix_cache.release([copy_src])
            self._wait.popleft()
            slot = _Slot(
                req=req, pages=shared_pages + page_ids, pos=start,
                cur=None, admit_seq=next(self._admit_seq), prompt=prompt,
                prefilled=start,
                # tokens already delivered count against the budget
                decoded=len(req.generated), shared=len(shared_pages))
            self.slots[free[0]] = slot
            self.stats["admitted"] += 1
            now = time.monotonic()
            self.events.append("admit", rid=req.rid, sid=free[0], t=now,
                               data={"cached": start,
                                     "pages": len(slot.pages)})
            if (self._obs_enabled and not req.generated
                    and not req.attempts and not req.preemptions):
                # first admission only: a re-admission would count the
                # wait twice
                obs.phase_metrics()["queue_wait"].observe(
                    max(0.0, now - req.t_submit))
            if self.prefix_cache is not None:
                self.prefix_cache.account(start, len(prompt) - start)
                self.stats["cache_hit_tokens"] += start
                self.stats["cache_miss_tokens"] += len(prompt) - start
                if start:
                    self.stats["cache_hit_admissions"] += 1
                    self.events.append("cache_hit", rid=req.rid,
                                       sid=free[0], data=start)

    def _copy_page(self, src: int, dst: int) -> None:
        """The prefix cache's one COW copy: physical page ``src`` into
        ``dst`` for every tensor of every layer — the int8 pool's scale
        columns too, so the copy dequantizes exactly as its source.
        Stream-ordered on the card, like every other pool write."""
        for layer in self.pages:
            for t in layer:
                t[:, dst].copy_(t[:, src])

    def _check_cow_locked(self, slot: _Slot, write_pos: int) -> None:
        """Copy-on-write invariant: the pool is written in place, so a
        write may only target a page the slot owns alone. Shared
        (cache-owned) pages are the slot's leading ``slot.shared`` page
        table entries and must sit strictly behind the write
        frontier."""
        if slot.shared and write_pos < slot.shared * self.Pg:
            raise RuntimeError(
                f"COW violation: slot for rid={slot.req.rid} would "
                f"scatter at pos {write_pos} into shared page index "
                f"{write_pos // self.Pg} (< {slot.shared} cache-owned "
                f"pages)")

    def _free_slot_pages_locked(self, slot: _Slot, *,
                                retire: bool) -> None:
        """Return a slot's pages: every page route goes through here.
        Without the prefix cache this is a plain free. With it, shared
        pages only ever drop a reference (the tree keeps the KV); on
        retirement the finished prompt's full pages are INSERTED into
        the tree instead of freed (private ones donated, shared ones
        deduped), and only the boundary/generated tail is freed."""
        if self.prefix_cache is None:
            self.alloc.free(slot.pages)
            return
        if retire and self._force_killed:
            # the zombie fence: a force-killed engine's late retirement
            # publishes nothing into the prefix cache
            retire = False
        if retire:
            n_full = min(len(slot.prompt) // self.Pg, len(slot.pages))
            self.prefix_cache.insert(slot.prompt, slot.pages[:n_full],
                                     slot.shared)
            tail = slot.pages[n_full:]
        else:
            self.prefix_cache.release(slot.pages[:slot.shared])
            tail = slot.pages[slot.shared:]
        if tail:
            self.alloc.free(tail)

    def prefix_stats(self) -> Optional[Dict[str, Any]]:
        """Prefix-cache counters (None when the cache is off)."""
        if self.prefix_cache is None:
            return None
        with self._lock:
            return self.prefix_cache.stats()

    # -------------------------------------------- KV migration (pull)

    def _try_pull_admit_locked(self, sid: int, req: _Request,
                               prompt: List[int]) -> bool:
        """PULLING admission: seat ``req`` in slot ``sid`` with no pages
        and start the background pull its hint names. The hint is
        consumed exactly once (cleared before any check can bail), so
        no requeue ever re-pulls. Declines, falling through to normal
        admission, when no fetcher or cache is wired, the hint is empty
        or malformed, or the local tree already covers it."""
        pull = req.pull
        req.pull = None          # consumed exactly once
        if (self.kv_fetcher is None or self.prefix_cache is None
                or req.generated or self._stopped or self._draining):
            return False
        try:
            hashes = [int(h) for h in (pull.get("hashes") or ())]
        except (AttributeError, TypeError, ValueError):
            return False         # malformed hint: plain admission
        if not hashes:
            return False
        have, _ = self.prefix_cache.match_hashes(hashes)
        if have:
            self.prefix_cache.release(have)
        if len(have) >= len(hashes):
            return False         # the local cache already covers it
        self._wait.popleft()
        slot = _Slot(req=req, pages=[], pos=0, cur=None,
                     admit_seq=next(self._admit_seq), prompt=prompt,
                     prefilled=0, decoded=len(req.generated),
                     pulling=True)
        self.slots[sid] = slot
        self.stats["kv_pull_admissions"] += 1
        self.events.append("pull_start", rid=req.rid, sid=sid,
                           data={"hashes": len(hashes),
                                 "local": len(have)})
        threading.Thread(target=self._run_pull, args=(sid, slot, pull),
                         daemon=True, name=f"kv-pull-{req.rid}").start()
        return True

    def _run_pull(self, sid: int, slot: _Slot,
                  pull: Dict[str, Any]) -> None:
        """Background transfer of one PULLING slot with NO engine lock
        held: the injected fetcher runs the chunked protocol
        (kv_migration.pull_prefix). Landing and requeue happen back
        under the lock; any exception from the fetcher is an abort,
        never a wedge."""
        payload = None
        try:
            payload = self.kv_fetcher(pull)
        except Exception:
            payload = None
        with self._work:
            self._finish_pull_locked(sid, slot, payload)
            self._work.notify_all()

    def _finish_pull_locked(self, sid: int, slot: _Slot,
                            payload: Optional[Dict[str, Any]]) -> None:
        """Land a finished pull and requeue its request at the FRONT of
        the queue, to admit through the normal path: as a local hit on
        the landed pages, or as plain prefill after a failed pull
        (fallback counted). The slot must still be this one: cancel,
        shutdown or a preemption (a preempt-mode weight swap) may have
        torn it down meanwhile, and then the payload — KV of the old
        weights, after a swap — is dropped."""
        if (self.slots[sid] is not slot or slot.preempted
                or not slot.pulling):
            return
        slot.pulling = False
        self.slots[sid] = None
        req = slot.req
        if req.closed or self._stopped:
            return
        landed = 0
        if payload is not None:
            landed = self._land_pulled_pages_locked(slot.prompt, payload)
        if landed:
            self.stats["kv_pull_landed"] += 1
            self.events.append("pull_land", rid=req.rid, sid=sid,
                               data={"pages": landed,
                                     "wire_bytes":
                                         payload.get("wire_bytes", 0)})
        else:
            kv_migration.count_fallback(self.kv_migration_stats)
            self.stats["kv_pull_fallbacks"] += 1
            self.events.append("pull_fallback", rid=req.rid, sid=sid)
        self._wait.appendleft(req)   # front: admit before new arrivals

    def _land_pulled_pages_locked(self, prompt: List[int],
                                  payload: Dict[str, Any]) -> int:
        """Write pulled pages into freshly allocated pool pages and
        INSERT them into the prefix cache, the insert retirement uses.
        Returns the pages landed; 0 (a mismatched or truncated payload,
        the pool dry) means fall back to plain prefill.

        The payload is decoded and validated before any page is
        allocated. Each layer tensor's columns of all landed pages go
        up in one pinned host-to-device copy and are written into their
        pages in place on the engine's stream (``index_copy_`` along the
        page axis: the bytes of ``t[:, dst].copy_(col)`` per page),
        enqueued before the insert makes the pages visible, so the next
        dispatch reads them."""
        if (payload.get("kv_dtype") != self.kv_dtype
                or int(payload.get("page_size") or 0) != self.Pg
                or int(payload.get("n_layers") or 0)
                != self.cfg.n_layers):
            return 0
        n = min(int(payload.get("n_pages") or 0), len(prompt) // self.Pg)
        if n <= 0:
            return 0
        try:
            cols = [page_cols_from_bytes(self.cfg, self.Pg, self.kv_dtype,
                                         blobs)
                    for blobs in payload["pages"][:n]]
        except (ValueError, KeyError, TypeError):
            return 0
        if len(cols) < n:
            return 0
        page_ids = self._alloc(n)
        if page_ids is None and self.prefix_cache.evict(
                n - self.alloc.n_free) > 0:
            page_ids = self._alloc(n)
        if page_ids is None:
            return 0
        dst = self._h2d(np.asarray(page_ids, np.int64))
        for li, layer in enumerate(self.pages):
            for ti, t in enumerate(layer):
                src = torch.stack([page[li][ti] for page in cols], dim=1)
                t.index_copy_(1, dst, self._h2d(src))
        self.prefix_cache.insert(prompt[:n * self.Pg], page_ids, 0)
        self.stats["kv_pulled_pages"] += n
        return n

    # ------------------------------------------- KV migration (donor)

    def kv_pin_prefix(self, hashes: List[int]) -> List[int]:
        """Donor side of a pull: resolve rolling path hashes to the
        longest resident page run and PIN it (``match_hashes`` raises
        each page's refcount), so eviction can never take a page
        mid-transfer. The caller owes one ``kv_release_pages`` for the
        run. Empty when the prefix is gone or the engine is stopped or
        draining (a ``KVDonor`` turns that into ``KVPullAborted``)."""
        with self._lock:
            if (self.prefix_cache is None or self._stopped
                    or self._draining):
                return []
            pages, _ = self.prefix_cache.match_hashes(hashes)
            return pages

    def kv_export_pages(self, pages: List[int]) -> List[Any]:
        """Raw bytes of pinned pages, per page per layer (int8 scales
        ride along, models/kv_cache.export_page_bytes), under the
        engine lock. A stopped donor refuses with the typed abort, as a
        dead peer process would; so does a page a weight swap fenced
        while it was pinned (its KV belongs to the old weights — a
        deliberate difference from the reference, which ships it).
        The pages go to the host in one batched copy
        (``export_pages_bytes``: ``export_page_bytes``'s bytes, page by
        page), one wait for the device instead of one per page column."""
        with self._lock:
            if self._stopped:
                raise kv_migration.KVPullAborted(
                    "donor engine stopped mid-transfer")
            if self.prefix_cache is not None and any(
                    self.prefix_cache.is_fenced(int(p)) for p in pages):
                raise kv_migration.KVPullAborted(
                    "pages computed under an earlier weight generation")
            if not pages:
                return []
            return export_pages_bytes(self.pages, [int(p) for p in pages])

    def kv_release_pages(self, pages: List[int]) -> None:
        """Unpin a transfer's pages (drop the ``match_hashes``
        references); a page fenced by a swap meanwhile leaves the pool
        with its last pin."""
        with self._lock:
            if self.prefix_cache is not None and pages:
                self.prefix_cache.release(list(pages))

    def _grow_locked(self, ix: int, slot: _Slot, need: int) -> None:
        """Grow ``slot``'s pages to ``need`` while the pool is dry:
        first evict refcount-0 prefix-cache pages, then preempt the
        youngest OTHER slot (batch first). Stops early if a preemption's
        drain closed this slot. A lone slot that still cannot grow (a
        donor's pin, a page fenced while a transfer holds it, an injected
        exhaustion) raises an ``EngineFault`` naming it, which ``step``
        contains: that request fails, the engine keeps serving."""
        while len(slot.pages) < need:
            if self.slots[ix] is not slot:
                return
            got = self._alloc(need - len(slot.pages))
            if got is not None:
                slot.pages.extend(got)
                return
            if (self.prefix_cache is not None
                    and self.prefix_cache.evict(
                        need - len(slot.pages) - self.alloc.n_free) > 0):
                continue        # reclaimed cached pages; retry alloc
            victim = self._victim_locked(ix)
            if victim is None:
                raise EngineFault(RequestError(
                    f"request {slot.req.rid}: page pool exhausted by "
                    f"one slot"), culprit_sid=ix, culprit_rid=slot.req.rid)
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
            self._fire("dispatch_prefill", sid=g.sid, rid=slot.req.rid)
            self._check_cow_locked(slot, slot.prefilled)
            self._grow_locked(g.sid, slot,
                              -(-(slot.prefilled + take) // self.Pg))
            if self.slots[g.sid] is slot:
                rows.append((g.sid, slot, take))
        # a LATER grant's growth can evict an EARLIER grant's slot
        rows = [(ix, slot, take) for ix, slot, take in rows
                if self.slots[ix] is slot]
        if self._stopped:
            return     # force-killed mid-loop: the zombie dispatches
                       # nothing
        if rows:
            self._prefill_batch(rows)

    def _grow_or_preempt_locked(self, steps: int):
        """Ensure every riding slot's pages cover this dispatch's
        writes, eldest first; evict the youngest slots (batch first) if
        the pool runs dry."""
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
        # never frees shared pages: other slots' page tables may point
        # at them; the references drop and the tree keeps the KV
        self._free_slot_pages_locked(victim, retire=False)
        victim.req.preemptions += 1
        self.stats["preemptions"] += 1
        if victim.req.batch:
            self.stats["batch_preemptions"] += 1
            _metrics()["batch_preempted"].inc()
        self.events.append("preempt", rid=victim.req.rid, sid=ix,
                           data={"preemptions": victim.req.preemptions,
                                 "lane": (LANE_BATCH if victim.req.batch
                                          else LANE_ONLINE)})
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
            self._fire("dispatch_decode", sid=i, rid=slot.req.rid)
            self._check_cow_locked(slot, slot.pos)
            pt[i, :len(slot.pages)] = slot.pages
            # tokens this slot still owes from THIS dispatch (the tail
            # of an overshooting window is junk)
            take = min(steps, max(0, self._owed(slot)))
            riders.append((i, slot, take))
        if not riders or self._stopped:
            # every planned rider was preempted meanwhile, or the
            # engine was force-killed mid-loop (the zombie fence)
            return
        toks, lps = self._decode_step(pt, steps,
                                      [i for i, _s, _t in riders])
        for _i, slot, _t in riders:
            slot.pos += steps
            slot.decoded += steps
        self.events.append("decode", data=steps)
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += steps
        self._fetchq.append((_Readback(toks, lps), riders, steps))
        self._hb = time.monotonic()

    def _dispatch_spec_locked(self, grants):
        """One batched draft-and-verify dispatch. Each granted slot's
        row ``[cur, d_1 .. d_k]`` (its last emitted token and up to
        ``spec_len`` drafts) is scored in ONE forward at the slot's own
        offset; the longest draft prefix equal to the argmax is
        accepted, plus the argmax after it: 1 to k+1 tokens, each
        exactly what plain greedy decode gives.

        Rollback clamps ``pos`` (and ``decoded``) to the tokens produced:
        the KV written past it for rejected drafts is overwritten before
        any query reaches it, and the pages stay the slot's. The
        surviving slots' device ``cur``/``pos`` are reseeded with the
        accepted frontier.

        Host-synchronous: acceptance decides the next input, so the
        argmax is read back here. Under the overlapped loop the round
        was planned from a stale frontier, so every readback is settled
        first: the drafts were hints, but the verify's input must be the
        device's latest token."""
        if self.overlap:
            self._drain_fetches_locked()
        T = self.spec_len + 1
        rows = []
        for g in grants:
            slot = self.slots[g.sid]
            if (slot is None or slot.cur is None
                    or not slot.req.generated):
                continue       # closed by the drain, or seeded since
            drafts = slot.spec_pending[:max(0, g.drafts)]
            self._fire("dispatch_spec", sid=g.sid, rid=slot.req.rid)
            self._check_cow_locked(slot, slot.pos)
            # cover every verify write (cur + drafts): prefix-cache
            # eviction first, then youngest-other preemption
            self._grow_locked(g.sid, slot,
                              -(-(slot.pos + len(drafts) + 1) // self.Pg))
            if self.slots[g.sid] is slot:
                rows.append((g.sid, slot, drafts))
        # a later grant's growth can evict an earlier grant's slot
        rows = [(ix, slot, d) for ix, slot, d in rows
                if self.slots[ix] is slot]
        if not rows or self._stopped:
            return     # nothing to verify, or force-killed mid-loop
        ids = np.zeros((self.S, T), np.int32)
        start = np.zeros((self.S,), np.int32)
        pt = np.zeros((self.S, self.max_pages), np.int32)
        for i, slot, drafts in rows:
            ids[i, 0] = slot.req.generated[-1]
            ids[i, 1:1 + len(drafts)] = drafts
            start[i] = slot.pos
            pt[i, :len(slot.pages)] = slot.pages
        out = self._verify_step(ids, start, pt)
        self._hb = time.monotonic()
        self.stats["spec_rounds"] += 1
        seeds = []
        for i, slot, drafts in rows:
            row = out[i]
            a = 0
            while a < len(drafts) and drafts[a] == int(row[a]):
                a += 1
            produced = a + 1
            self.events.append("spec", rid=slot.req.rid, sid=i,
                               data=(len(drafts), a))
            self.stats["spec_riders"] += 1
            self.stats["spec_proposed"] += len(drafts)
            self.stats["spec_accepted"] += a
            self.stats["spec_rejected"] += len(drafts) - a
            self.stats["spec_tokens"] += produced
            slot.spec_pending = []
            slot.pos += produced
            slot.decoded += produced
            self._emit_to(slot.req, row[:produced].tolist(), i)
            if self.slots[i] is slot:        # not closed by the emission
                seeds.append((i, slot, int(row[a])))
        if seeds:
            self._seed_step(
                self._h2d(np.asarray([t for _i, _s, t in seeds], np.int32)),
                [(i, slot, r) for r, (i, slot, _t) in enumerate(seeds)])

    def spec_stats(self) -> Optional[Dict[str, Any]]:
        """Speculative-decoding counters (None when speculation is off).
        ``tokens_per_dispatch`` is emitted tokens per (slot, verify)
        ride: above 1.0 speculation beat one token per forward."""
        if not self.spec_len:
            return None
        with self._lock:
            s = self.stats
            proposed = s["spec_proposed"]
            riders = s["spec_riders"]
            return {
                "spec_len": self.spec_len,
                "spec_ngram": self.spec_ngram,
                "rounds": s["spec_rounds"],
                "proposed_tokens": proposed,
                "accepted_tokens": s["spec_accepted"],
                "rejected_tokens": s["spec_rejected"],
                "accept_rate": round(s["spec_accepted"] / proposed, 4)
                if proposed else 0.0,
                "tokens_per_dispatch":
                    round(s["spec_tokens"] / riders, 4)
                    if riders else 0.0,
            }

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
            # the heartbeat before each blocking get as well as after: a
            # drain through several buffers is progress at each one
            t_rb = self._hb = time.monotonic()
            got_pre = [(rb.get(), rb.logprobs()) for rb, _ in pend_pre]
            got = [(rb.get(), rb.logprobs()) for rb, _r, _s in batch]
            self._hb = time.monotonic()
            self.events.append("readback",
                               data={"bufs": len(batch) + len(pend_pre)})
            if self._obs_enabled:
                obs.phase_metrics()["readback"].observe(self._hb - t_rb)
            # prefill firsts FIRST: a slot's seeding prefill precedes
            # its first decode ride, and both can land in one drain
            for (_rb, placements), (firsts, f_lps) in zip(pend_pre,
                                                          got_pre):
                for ix, slot, row in placements:
                    if self._readback_ok_locked(ix, slot):
                        self._emit_to(slot.req, [int(firsts[row])], ix,
                                      None if f_lps is None
                                      else [float(f_lps[row])])
            for (_rb, riders, _steps), (toks, lps) in zip(batch, got):
                for i, slot, take in riders:
                    if self._readback_ok_locked(i, slot):
                        self._emit_to(slot.req, toks[:take, i].tolist(), i,
                                      None if lps is None
                                      else lps[:take, i].tolist())

    def _readback_ok_locked(self, ix: int, slot: _Slot) -> bool:
        """Whether a rider's read-back tokens are to be emitted: not when
        its slot was preempted (it recomputes), nor when the readback
        site's fault hits it, which fails that rider alone: its slot, if
        still live (no-eos mode retires slots at dispatch), is torn
        down, and every other rider's emission proceeds."""
        if slot.preempted:
            return False
        try:
            self._fire("readback", sid=ix, rid=slot.req.rid)
        except EngineFault as e:
            self.stats["contained_faults"] += 1
            _metrics()["contained_faults"].inc()
            if self.slots[ix] is slot:
                self._teardown_slot_locked(ix, e.original, "fault_failed")
            else:
                self._fail_req_locked(slot.req, e.original, "fault_failed")
            return False
        return True

    def _emit_to(self, req: _Request, tokens: List[int], ix: int,
                 lps: Optional[List[float]] = None):
        """Deliver tokens to the request; close it at eos or budget. In
        no-eos mode the slot was retired at dispatch time; with an eos,
        closing here frees it. ``lps`` (logprob capture) is aligned with
        ``tokens``; exactly the emitted prefix is appended, so
        truncation keeps ``req.logprobs`` aligned with
        ``req.generated``."""
        if req.closed:
            return
        done = False
        n_put = 0
        for t in tokens:
            t = int(t)
            if req.t_first is None:
                req.t_first = time.monotonic()
                ttft = req.t_first - req.t_submit
                if not req.batch:
                    # online SLO signals only: a batch request may wait
                    # queued by design
                    self.ttfts_s.append(ttft)
                    a = self._ewma_alpha
                    self._ttft_ewma = ttft if self._ttft_ewma is None \
                        else a * ttft + (1 - a) * self._ttft_ewma
                self.events.append("first_token", rid=req.rid, sid=ix,
                                   t=req.t_first,
                                   data={"ttft_s": ttft,
                                         "lane": (LANE_BATCH if req.batch
                                                  else LANE_ONLINE)})
                if self._obs_enabled and not req.batch:
                    obs.phase_metrics()["ttft"].observe(ttft)
            req.generated.append(t)
            req.out_q.put(t)
            n_put += 1
            if ((self.eos_id is not None and t == self.eos_id)
                    or req.remaining <= 0):
                done = True
                break
        if n_put and req.logprobs is not None and lps is not None:
            req.logprobs.extend(float(x) for x in lps[:n_put])
        if n_put:
            now = time.monotonic()
            self.events.append("emit", rid=req.rid, sid=ix, t=now,
                               data={"n": n_put})
            if req.batch:
                self.stats["batch_tokens"] += n_put
                _metrics()["batch_tokens"].inc(n_put)
            if req.t_last_emit is not None:
                # mean gap per token over this readback's tokens
                gap = max(0.0, now - req.t_last_emit) / n_put
                if self._obs_enabled:
                    obs.phase_metrics()["inter_token"].observe(gap)
                if not req.batch:
                    # the online lane's EWMA only, as TTFT's
                    a = self._ewma_alpha
                    self._itl_ewma = gap if self._itl_ewma is None \
                        else a * gap + (1 - a) * self._itl_ewma
            req.t_last_emit = now
        if done:
            req.closed = True
            slot = self.slots[ix]
            if slot is not None and slot.req is req:
                self.slots[ix] = None
                self._free_slot_pages_locked(slot, retire=True)
            self.stats["completed"] += 1
            self.events.append("retire", rid=req.rid, sid=ix,
                               data={"generated": len(req.generated)})
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
        firsts, lps = self._prefill_step(ids, start, last_idx, pt)
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
        self._pending_prefill.append((_Readback(firsts, lps), placements))
        self.events.append(
            "prefill", rid=tuple(slot.req.rid for _ix, slot, _t in rows),
            data=tuple((ix, take) for ix, _s, take in rows))
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += sum(t for _i, _s, t in rows)
        self._hb = time.monotonic()

    def _prefill_step(self, ids, start, last_idx, pt):
        """Device half of ``_prefill_batch`` (the reference's jitted
        ``_build_prefill`` executable): [B, T] ids at per-row start
        offsets append into the rows' pages and attend causally over
        each row's page window; each row's last real position samples
        a candidate first token. Returns int32 [B] on the device, and
        its fp32 [B] logprobs under capture (else None)."""
        page_table = self._h2d(pt)
        kv = [kv_layer_view(layer, page_table) for layer in self.pages]
        logits = self.model(self._h2d(ids), kv, self._h2d(start))
        rows = torch.arange(ids.shape[0], device=self.device)
        last = logits[rows, self._h2d(last_idx).long()]
        firsts = _pick_token(last, self.temperature, self._gen)
        return firsts, self._logprob(last, firsts)

    def _decode_step(self, pt, steps: int, riders: List[int]):
        """Device half of ``_dispatch_chunk_locked`` (the reference's
        ``_build_decode``): ``steps`` single-token forwards over every
        slot, chaining ``pos``/``cur`` on the device. Returns the int32
        [steps, S] token buffer, and under capture the fp32 [steps, S]
        logprobs (else None). Slots not riding get position 0 first,
        so the decode kernel reads one null-page key for them, not a
        stale window (their outputs are never read)."""
        riding = set(riders)
        idle = [i for i in range(self.S) if i not in riding]
        if idle:
            self._dev_pos[self._h2d(np.asarray(idle, np.int64))] = 0
        page_table = self._h2d(pt)
        kv = [kv_layer_view(layer, page_table) for layer in self.pages]
        pos, cur = self._dev_pos, self._dev_cur
        out, lps = [], []
        for _ in range(steps):
            logits = self.model(cur[:, None], kv, pos)[:, -1]
            cur = _pick_token(logits, self.temperature, self._gen)
            pos = pos + 1
            out.append(cur)
            if self.capture_logprobs:
                lps.append(self._logprob(logits, cur))
        self._dev_pos, self._dev_cur = pos, cur
        return torch.stack(out), torch.stack(lps) if lps else None

    def _verify_step(self, ids, start, pt) -> np.ndarray:
        """Device half of ``_dispatch_spec_locked`` (the reference's
        ``_build_verify``): [S, T] rows of ``[cur, drafts...]`` append at
        each row's own offset and attend causally over its page window
        — the paged ``T >= 1`` forward chunked prefill runs — and the
        argmax at every position is read back: int32 [S, T] on the
        host."""
        page_table = self._h2d(pt)
        kv = [kv_layer_view(layer, page_table) for layer in self.pages]
        logits = self.model(self._h2d(ids), kv, self._h2d(start))
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _logprob(self, logits: torch.Tensor,
                 tokens: torch.Tensor) -> Optional[torch.Tensor]:
        """Under capture, each row's logprob of ``tokens`` under the
        sampling distribution (fp32 logits, divided by the temperature
        when it is > 0): fp32 [B]. None without capture."""
        if not self.capture_logprobs:
            return None
        scaled = logits.float()
        if self.temperature > 0.0:
            scaled = scaled / self.temperature
        return torch.log_softmax(scaled, dim=-1).gather(
            1, tokens.long()[:, None])[:, 0]

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
