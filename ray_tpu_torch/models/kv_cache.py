"""Port of ``ray_tpu/models/kv_cache.py``: the paged KV pool and its
host-side page allocator.

- One pool per layer, ``[n_kv_heads, n_pages, page_size, head_dim]``,
  HEAD-MAJOR as in the reference, so one physical page of one kv head
  is a contiguous ``[page_size, head_dim]`` tile — the unit the CUDA
  decode kernel (ops/csrc/paged_decode_attention.cu) stages in shared
  memory.
- Page 0 is the NULL page: inactive decode slots and dummy prefill
  rows point their page table at it and write their dead K/V there.
- Unlike the JAX pool (immutable arrays donated to jitted calls), the
  torch pool is updated IN PLACE (``ops.paged_attention.paged_append``):
  the tensors allocated here live for the engine's lifetime.
- Only ``kv_dtype="fp"`` exists in this slice; int8 pages are the next
  slice of the port (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numbers
from typing import List, NamedTuple, Optional, Sequence

import torch

from ray_tpu_torch._device import resolve_device


class PagedKVLayer(NamedTuple):
    """Per-layer view of the paged KV pool handed to the attention
    module.

    pages_k/pages_v: [n_kv_heads, n_pages, page_size, head_dim]
    page_table:      [n_slots, max_pages] int32 — logical page p of
                     slot s lives in physical page ``page_table[s, p]``
    """
    pages_k: torch.Tensor
    pages_v: torch.Tensor
    page_table: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.pages_k.shape[2]


def kv_layer_view(layer, page_table: torch.Tensor) -> PagedKVLayer:
    """Wrap one engine layer tuple ``(pk, pv)`` as the PagedKVLayer the
    attention module consumes."""
    pk, pv = layer
    return PagedKVLayer(pk, pv, page_table)


def kv_layer_store(cache: PagedKVLayer):
    """Inverse of kv_layer_view: the storage tuple (without the shared
    page table) the engine keeps between steps."""
    return (cache.pages_k, cache.pages_v)


def _check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype == "int8":
        raise NotImplementedError(
            "kv_dtype='int8' is not ported yet (ROADMAP.md queue 1: "
            "int8 KV — paged_append three-scatter + kernel K2)")
    if kv_dtype != "fp":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")


def init_kv_pool(cfg, n_pages: int, page_size: int,
                 kv_dtype: str = "fp",
                 device: Optional[torch.device] = None):
    """One page pool per layer, ``[(pages_k, pages_v), ...]`` in
    ``cfg.dtype``, zero-filled, on ``device`` (the card by default,
    ``"cpu"`` when asked; raises ``NoCudaError`` without a card). Page
    0 is reserved (null)."""
    _check_kv_dtype(kv_dtype)
    device = resolve_device(device)
    shape = (cfg.n_kv_heads, n_pages, page_size, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]


def kv_pool_page_bytes(cfg, page_size: int, kv_dtype: str = "fp") -> int:
    """Bytes ONE physical page costs across all layers (k + v). Same
    count as the reference for fp pools."""
    _check_kv_dtype(kv_dtype)
    payload = cfg.dtype.itemsize
    per_layer = 2 * cfg.n_kv_heads * page_size * cfg.head_dim * payload
    return cfg.n_layers * per_layer


class BlockAllocator:
    """Host-side free-list allocator over the physical page pool.

    Page 0 is never handed out — it is the null page inactive slots
    write into. All-or-nothing alloc so a half-grown sequence never
    holds pages it cannot use.

    ``page_bytes`` (optional) is the all-layer byte cost of one page
    (see kv_pool_page_bytes); when set, occupancy gains a bytes view.
    """

    def __init__(self, n_pages: int, page_bytes: Optional[int] = None):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is null)")
        self.n_pages = n_pages
        self.page_bytes = page_bytes
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._free_set = set(self._free)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def occupancy(self) -> int:
        """Pages currently handed out (the null page never counts).
        At engine quiescence this must be 0 — every other page is a
        leak."""
        return (self.n_pages - 1) - len(self._free)

    def bytes_in_use(self) -> Optional[int]:
        """occupancy() in bytes, or None when page_bytes is unknown."""
        if self.page_bytes is None:
            return None
        return self.occupancy() * self.page_bytes

    def bytes_total(self) -> Optional[int]:
        """Whole-pool byte budget (null page included — it is real
        memory), or None when page_bytes is unknown."""
        if self.page_bytes is None:
            return None
        return self.n_pages * self.page_bytes

    def leak_report(self) -> List[int]:
        """Page ids some owner still holds (not on the free list)."""
        return [p for p in range(1, self.n_pages)
                if p not in self._free_set]

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list. Rejects — atomically, before
        any page is accepted — frees of the null page (0), ids outside
        the pool, non-int ids, pages already free (double free), and
        the same page listed twice in one call. Silent acceptance of
        any of these would later hand one page to two sequences whose
        KV writes then overwrite each other."""
        seen = set()
        for p in pages:
            if isinstance(p, bool) or not isinstance(p, numbers.Integral):
                raise ValueError(f"page id {p!r} is not an int")
            if not 0 < p < self.n_pages:
                raise ValueError(
                    f"bad page id {p} (null page 0 and ids >= "
                    f"{self.n_pages} are never freeable)")
            if p in self._free_set:
                raise ValueError(f"double free of page {p}")
            if p in seen:
                raise ValueError(
                    f"page {p} listed twice in one free() call")
            seen.add(p)
        self._free.extend(pages)
        self._free_set.update(pages)
