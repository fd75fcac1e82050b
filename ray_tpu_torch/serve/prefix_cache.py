"""Port of ``ray_tpu/serve/prefix_cache.py``: the radix-tree prefix KV
cache — identical prompt prefixes share KV pages across requests,
ref-counted and LRU-evicted.

- A host-side RADIX TREE keyed on token-id chunks of exactly
  ``page_size`` tokens (page-aligned nodes) maps prompt prefixes to
  physical page ids in the paged KV pool (models/kv_cache.py). One node
  owns one page; a path root->node spells a prefix whose KV is fully
  resident.
- Each cached page carries a REFERENCE COUNT of the live slots whose
  page tables point at it. Pages with refcount > 0 are never returned
  to the free list and never evicted.
- Cache-held pages with refcount == 0 form the LRU EVICTION POOL: when
  the allocator runs dry, ``evict(n)`` frees least-recently-matched
  leaf pages back to the BlockAllocator, so cache residency costs
  nothing under pressure.

Copy-on-write discipline (enforced by the engine): the pool is updated
in place, so a shared page must NEVER be a write target. Matching is
page-granular, which keeps every shared page strictly behind the owning
slot's write frontier; a fully-cached prompt copies its one boundary
page into a private page before re-prefilling the final token.

Int8 pools change nothing here: the tree deals only in page NUMBERS,
and the per-page scales live in device tensors indexed by the same page
id — the engine's COW copy duplicates the scale column with the page,
and a freed page's stale scale is reset on first reuse by
``paged_append``'s reset-on-offset-0 rule.

The weight-swap fence (``fence``) differs from the reference on
purpose. The reference's swap calls ``clear()``, which evicts only
what is evictable: a page pinned by an open donor transfer
(``match_hashes`` raised its refcount) survives the flip, and after
its release it is matched by later requests as if computed under the
new weights. Here ``fence`` detaches every page that survives the
eviction from the tree at once — nothing can match it again — and a
detached page goes back to the allocator when its last pin drops
(``release``); ``is_fenced`` tells the donor's export to refuse it.

Metrics (util/metrics.py, the reference's families): hit and miss
tokens, evictions, resident pages; ``stats()`` carries the same counts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.util import metrics

HIT_TOKENS = "serve_prefix_cache_hit_tokens"
MISS_TOKENS = "serve_prefix_cache_miss_tokens"
EVICTIONS = "serve_prefix_cache_evictions"
CACHED_PAGES = "serve_prefix_cache_pages"

_METRICS: Optional[dict] = None


def _metrics() -> dict:
    """Lazy metric singletons, re-created if a ``clear_registry()``
    dropped them."""
    global _METRICS
    if (_METRICS is None or metrics.registry().get(HIT_TOKENS)
            is not _METRICS["hit_tokens"]):
        _METRICS = {
            "hit_tokens": metrics.Counter(
                HIT_TOKENS,
                "Prompt tokens admitted from cached prefix KV "
                "(prefill skipped)"),
            "miss_tokens": metrics.Counter(
                MISS_TOKENS, "Prompt tokens prefilled from scratch"),
            "evictions": metrics.Counter(
                EVICTIONS, "Cached pages reclaimed under pressure"),
            "cached_pages": metrics.Gauge(
                CACHED_PAGES, "KV pages currently held by the prefix "
                "cache (refcount-0 ones are evictable)"),
        }
    return _METRICS


def _child_hash(parent_hash: int, chunk: Tuple[int, ...]) -> int:
    """Rolling path hash: a node's hash commits to the full token path
    root->node, not just its own chunk. ``hash`` over int tuples is
    deterministic (ints hash to themselves; tuple combining does not
    use PYTHONHASHSEED), so two trees that cached the same prefix
    compute the same value."""
    return hash((parent_hash, chunk))


def path_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """The rolling path hashes a prompt WOULD occupy in a tree with
    this ``page_size`` — one per full page chunk, in prefix order.

    This is the routing-side mirror of the tree's per-node ``phash``:
    an EnginePool hashes an incoming prompt once, then compares
    against each replica's ``digest()`` set to find which replica
    holds the longest cached prefix, without shipping token ids or
    walking a remote tree."""
    h = 0
    out: List[int] = []
    for i in range(0, (len(tokens) // page_size) * page_size,
                   page_size):
        h = _child_hash(h, tuple(int(t) for t in
                                 tokens[i:i + page_size]))
        out.append(h)
    return out


class _Node:
    """One radix-tree node = one full page of tokens = one physical
    page. ``chunk`` is the ``page_size``-tuple of token ids this edge
    spells; ``tick`` is the LRU stamp (monotonic counter, not wall
    clock, so tests are deterministic); ``phash`` is the rolling path
    hash (see ``path_hashes``) used for pool prefix-affinity digests."""

    __slots__ = ("chunk", "page", "parent", "children", "tick",
                 "phash")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: "_Node", tick: int):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.tick = tick
        self.phash = (_child_hash(parent.phash, chunk)
                      if parent is not None else 0)


class PrefixCache:
    """Radix-tree prefix index over the engine's ``BlockAllocator``.

    The cache never allocates pages itself: sequences prefill into
    pages they own, and ``insert`` transfers ownership of finished
    full prompt pages to the tree instead of freeing them. ``match``
    hands those pages back out as shared, read-only prefixes. All
    calls happen under the engine lock (single scheduler thread plus
    ``submit``), so no internal locking.
    """

    def __init__(self, alloc, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.alloc = alloc
        self.Pg = page_size
        self._root = _Node((), 0, None, 0)
        self._nodes: Dict[int, _Node] = {}     # page id -> node
        self._ref: Dict[int, int] = {}         # page id -> live slots
        # pages detached by ``fence`` while pinned: page id -> pins left
        self._fenced: Dict[int, int] = {}
        self._tick = 0
        # per-engine counts (the reference mirrors them into process
        # metrics)
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0

    # ----------------------------------------------------------- read

    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    def ref_of(self, page: int) -> int:
        return self._ref.get(page, self._fenced.get(page, 0))

    def is_fenced(self, page: int) -> bool:
        """True for a page ``fence`` detached while it was pinned: its
        KV was computed under an earlier weight generation."""
        return page in self._fenced

    def evictable_pages(self) -> int:
        """Refcount-0 resident pages (the reclaimable pool)."""
        return sum(1 for p in self._nodes if self._ref.get(p, 0) == 0)

    def digest(self, limit: Optional[int] = None) -> frozenset:
        """Compact content fingerprint of the tree: the set of rolling
        path hashes of resident nodes. An EnginePool intersects a
        prompt's ``path_hashes`` with this set to compute, per replica,
        how many leading pages are already cached — the longest-prefix
        affinity signal. O(nodes); no token ids leave the replica.

        ``limit`` caps the advertisement so fleet load reports stay
        bounded as the cache grows. The truncation is PREFIX-CLOSED:
        affinity matching walks a prompt's path hashes root-first and
        stops at the first absence, so advertising a deep node without
        its ancestors would make the whole path invisible. Whole
        root->node paths are kept, chosen deepest-first (longest
        reusable prefix wins) then hottest-first (LRU tick) among
        equal depths; a path that no longer fits the budget is skipped
        in favor of shorter ones, so the budget is filled with the
        longest/hottest prefixes that fit."""
        if limit is None or len(self._nodes) <= limit:
            return frozenset(n.phash for n in self._nodes.values())
        if limit <= 0:
            return frozenset()
        depth: Dict[int, int] = {}
        for n in self._nodes.values():
            d, node = 0, n
            while node is not self._root:
                node = node.parent
                d += 1
            depth[n.page] = d
        ranked = sorted(self._nodes.values(),
                        key=lambda n: (-depth[n.page], -n.tick))
        keep: set = set()
        for n in ranked:
            if len(keep) >= limit:
                break
            path = []
            node = n
            while node is not self._root and node.phash not in keep:
                path.append(node.phash)
                node = node.parent
            if len(keep) + len(path) > limit:
                continue           # doesn't fit: try shorter paths
            keep.update(path)
        return frozenset(keep)

    def match_hashes(self, hashes: Sequence[int]
                     ) -> Tuple[List[int], int]:
        """Longest resident run of ``hashes`` (rolling path hashes in
        prefix order, see ``path_hashes``), walking the tree WITHOUT
        token ids — the donor side of a cross-replica KV pull resolves
        a requester's advertised-digest match to physical pages with
        only hashes on the wire.

        Returns ``(pages, n_hashes_matched)``. Every returned page's
        refcount is INCREMENTED (this is the transfer-lifetime PIN:
        pinned pages can never be evicted mid-pull); the caller owes
        one ``release`` per page. Matched nodes are LRU-touched."""
        self._tick += 1
        node = self._root
        pages: List[int] = []
        for h in hashes:
            child = None
            for c in node.children.values():
                if c.phash == h:
                    child = c
                    break
            if child is None:
                break
            child.tick = self._tick
            pages.append(child.page)
            node = child
        for p in pages:
            self._ref[p] = self._ref.get(p, 0) + 1
        return pages, len(pages)

    def _chunks(self, tokens: Sequence[int]):
        for i in range(0, (len(tokens) // self.Pg) * self.Pg, self.Pg):
            yield tuple(int(t) for t in tokens[i:i + self.Pg])

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``, page-granular.

        Returns ``(pages, n_tokens)`` with ``n_tokens == len(pages) *
        page_size``. Every returned page's refcount is INCREMENTED —
        the caller owes a ``release`` (directly, or via ``insert`` at
        retirement) for each. Matched nodes are LRU-touched. Stats are
        NOT counted here: the engine may cap the match (fully-cached
        prompt) and reports what it actually skipped via ``account``.
        """
        self._tick += 1
        node = self._root
        pages: List[int] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.tick = self._tick
            pages.append(child.page)
            node = child
        for p in pages:
            self._ref[p] = self._ref.get(p, 0) + 1
        return pages, len(pages) * self.Pg

    def account(self, hit_tokens: int, miss_tokens: int) -> None:
        """Record one admission's hit/miss token split (what the
        engine actually skipped vs computed)."""
        self.hit_tokens += hit_tokens
        self.miss_tokens += miss_tokens
        m = _metrics()
        if hit_tokens:
            m["hit_tokens"].inc(hit_tokens)
        if miss_tokens:
            m["miss_tokens"].inc(miss_tokens)

    # ---------------------------------------------------------- write

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page (slot retired or preempted).
        Pages reaching refcount 0 STAY resident — they just become
        evictable. Never frees to the allocator, except a page ``fence``
        detached: its last release frees it."""
        for p in pages:
            if p in self._fenced:
                left = self._fenced.pop(p) - 1
                if left:
                    self._fenced[p] = left
                else:
                    self.alloc.free([p])
                continue
            if p not in self._nodes:
                raise RuntimeError(
                    f"release of page {p} not held by the prefix "
                    f"cache")
            r = self._ref.get(p, 0)
            if r <= 0:
                raise RuntimeError(
                    f"refcount underflow on cached page {p}")
            self._ref[p] = r - 1

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_shared: int) -> None:
        """Insert a finished sequence's full prompt pages into the
        tree, transferring ownership (the engine must NOT free them).

        tokens: the fully-prefilled prompt; only its
            ``len(tokens) // page_size`` full pages are insertable.
        pages: the physical pages holding those chunks, logical order
            (``len(pages)`` == number of full prompt pages).
        n_shared: leading pages that came from ``match`` at admission
            — for those the tree already holds the SAME page and this
            call releases the sequence's reference. Private pages
            beyond that are donated to the tree, unless an identical
            chunk landed first (two concurrent misses on the same
            prefix): the duplicate page is freed to the allocator and
            the incumbent kept.
        """
        self._tick += 1
        node = self._root
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            page = int(pages[i])
            child = node.children.get(chunk)
            if child is None:
                if i < n_shared:
                    raise RuntimeError(
                        f"shared page {page} vanished from the tree "
                        f"while referenced (chunk {i})")
                child = _Node(chunk, page, node, self._tick)
                node.children[chunk] = child
                self._nodes[page] = child
                self._ref.setdefault(page, 0)
            else:
                child.tick = self._tick
                if child.page == page:
                    # our reference came from match(): hand it back
                    self.release([page])
                else:
                    # duplicate compute of the same prefix: keep the
                    # incumbent (other readers may hold refs on it),
                    # recycle ours
                    self.alloc.free([page])
            node = child
        _metrics()["cached_pages"].set(len(self._nodes))

    def evict(self, n: int) -> int:
        """Free up to ``n`` least-recently-used refcount-0 LEAF pages
        back to the allocator (leaf-first keeps every resident path
        rooted — a parentless child could never be matched). Returns
        how many pages were actually freed."""
        freed = 0
        while freed < n:
            victim = None
            for page, node in self._nodes.items():
                if self._ref.get(page, 0) == 0 and not node.children:
                    if victim is None or node.tick < victim.tick:
                        victim = node
            if victim is None:
                break
            del victim.parent.children[victim.chunk]
            del self._nodes[victim.page]
            self._ref.pop(victim.page, None)
            self.alloc.free([victim.page])
            freed += 1
            self.evictions += 1
        if freed:
            m = _metrics()
            m["evictions"].inc(freed)
            m["cached_pages"].set(len(self._nodes))
        return freed

    def clear(self) -> int:
        """Evict everything evictable (tests/teardown)."""
        return self.evict(len(self._nodes))

    def fence(self) -> int:
        """The weight swap's cache half: after it nothing in the tree
        can be matched. Evicts everything evictable, then detaches
        every page that is left — each is pinned (by an open donor
        transfer; the swap preempted every slot first) or an ancestor
        of one — from the tree: an unpinned one is freed now, a pinned
        one when its last pin drops (``release``). Returns the pages
        evicted or freed now."""
        freed = evicted = self.clear()
        for page in self._nodes:
            pins = self._ref.get(page, 0)
            if pins:
                self._fenced[page] = pins
            else:
                self.alloc.free([page])
                freed += 1
                self.evictions += 1
        self._root.children.clear()
        self._nodes.clear()
        self._ref.clear()
        m = _metrics()
        if freed > evicted:
            m["evictions"].inc(freed - evicted)
        m["cached_pages"].set(0)
        return freed

    # ----------------------------------------------------- diagnostics

    def stats(self) -> dict:
        total = self.hit_tokens + self.miss_tokens
        return {
            "hit_tokens": self.hit_tokens,
            "miss_tokens": self.miss_tokens,
            "hit_rate": round(self.hit_tokens / total, 4) if total
            else 0.0,
            "evictions": self.evictions,
            "cached_pages": self.cached_pages,
            "evictable_pages": self.evictable_pages(),
        }

    def check_invariants(self) -> None:
        """Structural sanity for tests: page<->node bijection, no
        cached page on the allocator free list, refcounts sane, tree
        reachability."""
        for page, node in self._nodes.items():
            assert node.page == page, (node.page, page)
            assert node.parent.children.get(node.chunk) is node
            assert node.phash == _child_hash(node.parent.phash,
                                             node.chunk)
            assert self._ref.get(page, 0) >= 0
            assert page not in getattr(self.alloc, "_free_set", ()), \
                f"cached page {page} is also on the free list"
        for page, pins in self._fenced.items():
            assert pins > 0 and page not in self._nodes, (page, pins)
            assert page not in getattr(self.alloc, "_free_set", ()), \
                f"fenced page {page} is also on the free list"
        stack = [self._root]
        seen = 0
        while stack:
            nd = stack.pop()
            for child in nd.children.values():
                assert self._nodes.get(child.page) is child
                seen += 1
                stack.append(child)
        assert seen == len(self._nodes), (seen, len(self._nodes))
