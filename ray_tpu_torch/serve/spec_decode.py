"""Port of ``ray_tpu/serve/spec_decode.py``: the model-free
prompt-lookup n-gram proposer of speculative decoding (``NGramIndex``),
without the reference's Prometheus singletons — the engine's
``spec_stats()`` carries the counters.

The HOST proposes the next few tokens of a slot by looking its current
n-gram suffix up in the slot's own prompt+generated history; the engine
(serve/engine.py) scores all ``spec_len + 1`` positions in ONE batched
forward through the paged ``T >= 1`` branch of models/llama.py and keeps
the longest draft prefix matching the greedy argmax, plus the argmax
after it (the bonus token): between 1 and ``spec_len + 1`` tokens per
slot per verify.

Exactness: every emitted token is a greedy argmax of the model's own
logits over the KV plain decode would see — drafts only decide how many
of those argmaxes one dispatch keeps. At temperature 0 the accepted
stream is token-identical to non-speculative decode. Rejected positions
are rolled back by clamping the slot's KV write offset; the KV past the
new frontier is overwritten before any query attends to it.

Pure host bookkeeping (no torch): ``propose`` is O(1) per call, ``sync``
is O(new tokens).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class NGramIndex:
    """Rolling n-gram index over one slot's prompt+generated tokens.

    Maps every ``n``-token window to the position just PAST its most
    recent occurrence, keeping one generation of history per gram so
    the current suffix (always the newest occurrence of itself) can
    still find its previous one. ``propose(k)`` returns the up-to-k
    tokens that followed the suffix's previous occurrence — the
    prompt-lookup draft.

    The engine keeps one per slot and calls ``sync`` with the full
    context each round; only the unseen tail is consumed. Preemption
    discards the slot (and this index) wholesale; re-admission builds a
    fresh one from the recompute prompt.
    """

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError("ngram order must be >= 1")
        self.n = n
        self._tokens: List[int] = []
        # gram -> index just past its latest occurrence, and the one
        # before that (the suffix gram's latest occurrence is itself)
        self._last: Dict[Tuple[int, ...], int] = {}
        self._prev: Dict[Tuple[int, ...], int] = {}

    def __len__(self) -> int:
        return len(self._tokens)

    def sync(self, context: Sequence[int]) -> None:
        """Extend the index with ``context``'s unseen tail. The caller
        passes the slot's full prompt+generated stream; tokens already
        indexed are skipped.

        Under the engine's overlapped loop the context may TRAIL the
        device frontier by one round's undrained decode steps, and two
        consecutive syncs may pass the same context (the tail is then
        empty). It may never SHRINK: ``prompt + generated`` only grows
        for a live slot, so shrinkage means another request's stream
        reached this index — raise."""
        if len(context) < len(self._tokens):
            raise ValueError(
                f"context shrank: indexed {len(self._tokens)} tokens "
                f"but got {len(context)}")
        for t in context[len(self._tokens):]:
            self._tokens.append(int(t))
            if len(self._tokens) >= self.n:
                gram = tuple(self._tokens[-self.n:])
                if gram in self._last:
                    self._prev[gram] = self._last[gram]
                self._last[gram] = len(self._tokens)

    def propose(self, k: int) -> List[int]:
        """Draft up to ``k`` tokens continuing the current suffix from
        its most recent earlier occurrence; [] when the suffix never
        occurred before (or the context is shorter than the gram).
        Drafts are hints only — the verify decides."""
        if k <= 0 or len(self._tokens) < self.n:
            return []
        tail = tuple(self._tokens[-self.n:])
        end = self._last.get(tail)
        if end == len(self._tokens):     # newest occurrence is us
            end = self._prev.get(tail)
        if end is None:
            return []
        return list(self._tokens[end:end + k])
