"""Port of ``ray_tpu/serve/fleet/routing.py``: the routing and
resubmit core of the engine pool (serve/engine_pool.py).

1. **Selection** — given load reports for the live replicas, pick
   one: session stickiness → longest-prefix affinity (spill when the
   hot replica is saturated) → power-of-two-choices on least
   outstanding tokens. ``select_candidate`` is that policy as a pure
   function over ``Candidate`` records; the caller owns state
   (replica tables, death noting, sticky maps) and metrics.

2. **Resubmit** — at-most-once recovery across replica deaths: a
   request that streamed ZERO tokens may be resubmitted
   token-identically; one that streamed anything fails typed
   ``EngineShutdown`` (a partial greedy stream cannot be replayed
   exactly-once). ``ResubmitPolicy`` is that guard: cancel check,
   resubmit budget, remaining-deadline carry-over, partial-stream
   refusal. ``PoolRequestHandle`` subclasses it.

The reference shares both with its process-separated fleet router,
which the port does not have yet (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.errors import (DeadlineExceeded, EngineShutdown,
                                        RequestCancelled)
from ray_tpu_torch.serve.prefix_cache import path_hashes


class Candidate:
    """One live, non-draining replica as the selection policy sees
    it: an opaque key (pool slot index or fleet replica id), its load
    report, and its KV page size (prefix digests are page-granular,
    so prompts are hashed per distinct ``page_size``)."""

    __slots__ = ("key", "report", "page_size")

    def __init__(self, key: Any, report: Dict[str, Any],
                 page_size: int):
        self.key = key
        self.report = report
        self.page_size = page_size

    def saturated(self) -> bool:
        rpt = self.report
        return (rpt.get("max_queued") is not None
                and rpt.get("queue_depth", 0) >= rpt["max_queued"])


def select_candidate(cands: List[Candidate], prompt: List[int], *,
                     sticky_key: Any = None, rng,
                     hash_fn: Callable[[List[int], int], List[int]]
                     = path_hashes
                     ) -> Tuple[Optional[Candidate], Dict[str, Any]]:
    """Pick a candidate, or ``(None, {"hints": [...]})`` when nothing
    can admit (hints are the candidates' shed Retry-After values; an
    empty list means there was no live candidate at all)."""
    if not cands:
        return None, {"hints": []}

    open_cands = [c for c in cands if not c.saturated()]
    if not open_cands:
        return None, {"hints": [
            c.report.get("shed_retry_after_s", 0.0) for c in cands]}

    # longest cached prefix per candidate, page-granular
    hashes_by_pg: Dict[int, List[int]] = {}
    match_pages: Dict[Any, int] = {}
    for c in cands:
        digest = c.report.get("prefix_digest") or ()
        if not digest:
            match_pages[c.key] = 0
            continue
        hs = hashes_by_pg.get(c.page_size)
        if hs is None:
            hs = hashes_by_pg[c.page_size] = hash_fn(prompt,
                                                     c.page_size)
        k = 0
        for h in hs:
            if h not in digest:
                break
            k += 1
        match_pages[c.key] = k

    outstanding = {c.key: c.report.get("outstanding_tokens", 0)
                   for c in cands}

    # 1. session stickiness
    if sticky_key is not None:
        for c in open_cands:
            if c.key == sticky_key:
                return c, {"kind": "sticky",
                           "pages": match_pages.get(c.key, 0)}

    # 2. longest-prefix affinity (scored over ALL live candidates: a
    #    saturated best target means spill, not a blind miss)
    best: Optional[Candidate] = None
    best_pages = 0
    for c in cands:
        k = match_pages.get(c.key, 0)
        if k > best_pages or (k == best_pages and k > 0
                              and best is not None
                              and outstanding[c.key]
                              < outstanding[best.key]):
            best, best_pages = c, k
    spilled = False
    if best is not None and best_pages > 0:
        if not best.saturated():
            return best, {"kind": "affinity", "pages": best_pages}
        spilled = True         # hot candidate is full: overflow

    # 3. power-of-two-choices on least outstanding tokens
    if len(open_cands) == 1:
        pick = open_cands[0]
    else:
        a, b = rng.sample(open_cands, 2)
        pick = a if (outstanding[a.key], a.key) <= (
            outstanding[b.key], b.key) else b
    return pick, {"kind": "p2c", "spilled": spilled,
                  "pages": match_pages.get(pick.key, 0)}


class ResubmitPolicy:
    """At-most-once resubmission state shared by the pool's and the
    fleet's request handles: generated-token ledger, resubmit budget,
    deadline carry-over, and the typed failures for every way a
    recovery can be refused. Subclasses own submission (how a request
    reaches a replica) and streaming (how tokens come back)."""

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 deadline_s: Optional[float],
                 session_id: Optional[str],
                 trace_id: Optional[str],
                 max_resubmits: int):
        self._prompt = list(prompt)
        self._mnt = max_new_tokens
        self._deadline_s = deadline_s
        self._session_id = session_id
        self._trace_id = trace_id
        self._max_resubmits = max_resubmits
        self._t0 = time.monotonic()
        self._t_first: Optional[float] = None
        self._generated: List[int] = []
        self._resubmits = 0
        self._error: Optional[BaseException] = None
        self._finished = False
        self._cancelled = False

    # ------------------------------------------------------- consuming

    def result(self) -> List[int]:
        """Block until completion; return all generated token ids."""
        for _ in self.stream():
            pass
        return list(self._generated)

    def stream(self):           # pragma: no cover - abstract
        raise NotImplementedError

    # ------------------------------------------------------ inspection

    @property
    def done(self) -> bool:
        return self._finished or self._error is not None

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token as the CLIENT saw it — spans
        resubmissions, unlike the per-engine stamp."""
        if self._t_first is None:
            return None
        return self._t_first - self._t0

    @property
    def resubmits(self) -> int:
        return self._resubmits

    # -------------------------------------------------------- internal

    def _fail(self, err: BaseException) -> None:
        self._error = err

    def _note_token(self, tok: int) -> None:
        if self._t_first is None:
            self._t_first = time.monotonic()
        self._generated.append(tok)

    def _remaining_deadline(self,
                            cause: BaseException) -> Optional[float]:
        if self._deadline_s is None:
            return None
        left = self._deadline_s - (time.monotonic() - self._t0)
        if left <= 0:
            err = DeadlineExceeded(
                "deadline elapsed while recovering from a replica "
                "death")
            self._fail(err)
            raise err from cause
        return left

    def _partial_stream_error(self, where: str,
                              cause: BaseException) -> EngineShutdown:
        err = EngineShutdown(
            f"replica {where} died after {len(self._generated)} "
            f"streamed tokens; a partial stream cannot be replayed "
            f"at-most-once")
        self._fail(err)
        return err

    def _check_resubmit(self,
                        cause: BaseException) -> Optional[float]:
        """Gate one resubmission attempt: raises typed when recovery
        is impossible (cancelled / budget exhausted / deadline gone),
        otherwise bumps the counter and returns the remaining
        deadline to carry into the retry."""
        if self._cancelled:
            err = RequestCancelled("request cancelled")
            self._fail(err)
            raise err from cause
        if self._resubmits >= self._max_resubmits:
            err = EngineShutdown(
                f"request resubmitted {self._resubmits} times "
                f"without completing; giving up")
            self._fail(err)
            raise err from cause
        deadline = self._remaining_deadline(cause)
        self._resubmits += 1
        return deadline
