"""Port of ``ray_tpu/models/kv_cache.py``: the paged KV pool and its
host-side page allocator.

- One pool per layer, ``[n_kv_heads, n_pages, page_size, head_dim]``,
  HEAD-MAJOR as in the reference, so one physical page of one kv head
  is a contiguous ``[page_size, head_dim]`` tile — the unit the CUDA
  decode kernels (ops/csrc/paged_decode_attention.cuh) stage in shared
  memory.
- Page 0 is the NULL page: inactive decode slots and dummy prefill
  rows point their page table at it and write their dead K/V there.
- Unlike the JAX pool (immutable arrays donated to jitted calls), the
  torch pool is updated IN PLACE (``ops.paged_attention.paged_append``):
  the tensors allocated here live for the engine's lifetime.
- ``kv_dtype="int8"`` halves the page bytes: int8 pages plus one fp32
  absmax scale per (kv head, physical page), ``[n_kv_heads, n_pages,
  1]``. Scales travel with page ids: the allocator and the prefix cache
  deal in page ids only, and whatever moves a page column (the
  engine's copy-on-write copy, the byte export below) moves the
  matching scale column with it. Quantize/dequantize live in
  ops/paged_attention.py.
"""
from __future__ import annotations

import numbers
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device

KV_SCALE_DTYPE = torch.float32


class PagedKVLayer(NamedTuple):
    """Per-layer view of the paged KV pool handed to the attention
    module.

    pages_k/pages_v: [n_kv_heads, n_pages, page_size, head_dim]
    page_table:      [n_slots, max_pages] int32 — logical page p of
                     slot s lives in physical page ``page_table[s, p]``
    scales_k/scales_v: [n_kv_heads, n_pages, 1] fp32 per-page absmax
                     scales when the pool is int8, else None (last, so
                     fp views keep their three fields)
    """
    pages_k: torch.Tensor
    pages_v: torch.Tensor
    page_table: torch.Tensor
    scales_k: Optional[torch.Tensor] = None
    scales_v: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.pages_k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.scales_k is not None


def kv_layer_view(layer, page_table: torch.Tensor) -> PagedKVLayer:
    """Wrap one engine layer tuple — ``(pk, pv)`` fp or ``(pk, pv, sk,
    sv)`` int8 — as the PagedKVLayer the attention module consumes.
    Only this view/store pair knows the arity."""
    if len(layer) == 2:
        pk, pv = layer
        return PagedKVLayer(pk, pv, page_table)
    pk, pv, sk, sv = layer
    return PagedKVLayer(pk, pv, page_table, sk, sv)


def kv_layer_store(cache: PagedKVLayer):
    """Inverse of kv_layer_view: the storage tuple (without the shared
    page table) the engine keeps between steps."""
    if cache.scales_k is None:
        return (cache.pages_k, cache.pages_v)
    return (cache.pages_k, cache.pages_v, cache.scales_k, cache.scales_v)


def _check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype not in ("fp", "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")


def init_kv_pool(cfg, n_pages: int, page_size: int,
                 kv_dtype: str = "fp",
                 device: Optional[torch.device] = None):
    """One page pool per layer, zero-filled, on ``device`` (the card by
    default, ``"cpu"`` when asked; raises ``NoCudaError`` without a
    card). Page 0 is reserved (null).

    fp:   ``[(pages_k, pages_v), ...]`` in ``cfg.dtype``.
    int8: ``[(pages_k, pages_v, scales_k, scales_v), ...]`` — int8
          pages plus fp32 per-(head, page) absmax scales at 0 (a 0
          scale means "page holds nothing"; paged_append's
          reset-on-offset-0 rule keeps that true across reuse without
          any host-side scale bookkeeping).
    """
    _check_kv_dtype(kv_dtype)
    device = resolve_device(device)
    shape = (cfg.n_kv_heads, n_pages, page_size, cfg.head_dim)
    if kv_dtype == "fp":
        return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
                 torch.zeros(shape, dtype=cfg.dtype, device=device))
                for _ in range(cfg.n_layers)]
    sshape = (cfg.n_kv_heads, n_pages, 1)
    return [(torch.zeros(shape, dtype=torch.int8, device=device),
             torch.zeros(shape, dtype=torch.int8, device=device),
             torch.zeros(sshape, dtype=KV_SCALE_DTYPE, device=device),
             torch.zeros(sshape, dtype=KV_SCALE_DTYPE, device=device))
            for _ in range(cfg.n_layers)]


def kv_pool_page_bytes(cfg, page_size: int, kv_dtype: str = "fp") -> int:
    """Bytes ONE physical page costs across all layers (k + v payload
    plus, for int8, its two fp32 scales per kv head). Same count as
    the reference."""
    _check_kv_dtype(kv_dtype)
    if kv_dtype == "int8":
        payload, scale = 1, 2 * cfg.n_kv_heads * 4
    else:
        payload, scale = cfg.dtype.itemsize, 0
    per_layer = 2 * cfg.n_kv_heads * page_size * cfg.head_dim * payload
    return cfg.n_layers * (per_layer + scale)


def export_page_bytes(layers, page: int) -> List[List[bytes]]:
    """Raw bytes of ONE physical page across every layer — the unit a
    cross-replica KV pull ships. Each entry is the layer's column tuple
    in storage order, ``[k, v]`` for fp pools and ``[k, v, sk, sv]`` for
    int8 (a page without its scale is garbage). ``t[:, page]`` is the
    head-major column: k/v blobs are ``[KH, Pg, D]``, scale blobs
    ``[KH, 1]``, each in its dtype's raw bytes (bf16 as its 2 bytes),
    the same bytes as the reference's. Waits for the device."""
    return [[t[:, page].contiguous().cpu().view(torch.uint8).numpy()
             .tobytes() for t in layer]
            for layer in layers]


def export_pages_bytes(layers, pages: Sequence[int]
                       ) -> List[List[List[bytes]]]:
    """``export_page_bytes`` of each page in ``pages``, batched: one
    ``index_select`` of the pages per layer tensor, all of them
    gathered into one byte buffer and copied to the host once (one
    wait for the device instead of one per page column). The bytes are
    ``export_page_bytes``'s, page by page."""
    idx = torch.as_tensor(list(pages), dtype=torch.long,
                          device=layers[0][0].device)
    sel = [t.index_select(1, idx) for layer in layers for t in layer]
    flat = torch.cat([s.view(torch.uint8).reshape(-1) for s in sel]).cpu()
    cols, off = [], 0
    for s in sel:
        n = s.numel() * s.element_size()
        cols.append(flat[off:off + n].reshape(s.shape[0], len(idx), -1))
        off += n
    per = len(layers[0])
    return [[[cols[li * per + ti][:, j].contiguous().numpy().tobytes()
              for ti in range(per)]
             for li in range(len(layers))]
            for j in range(len(idx))]


def page_cols_from_bytes(cfg, page_size: int, kv_dtype: str,
                         blobs: Sequence[Sequence[bytes]]):
    """Inverse of ``export_page_bytes``: one page's per-layer column
    tensors rebuilt from raw bytes, on the CPU, shaped for a
    ``t[:, dst].copy_(col)`` landing — k/v ``[KH, Pg, D]``, scales
    ``[KH, 1]``. Validates arity and byte counts, so a truncated or
    cross-dtype blob fails typed instead of landing garbage KV."""
    shape = (cfg.n_kv_heads, page_size, cfg.head_dim)
    sshape = (cfg.n_kv_heads, 1)
    if kv_dtype == "int8":
        dts = (torch.int8, torch.int8, KV_SCALE_DTYPE, KV_SCALE_DTYPE)
        shapes = (shape, shape, sshape, sshape)
    elif kv_dtype == "fp":
        dts = (cfg.dtype, cfg.dtype)
        shapes = (shape, shape)
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    if len(blobs) != cfg.n_layers:
        raise ValueError(
            f"page payload has {len(blobs)} layers, pool has "
            f"{cfg.n_layers}")
    out = []
    for li, layer_blobs in enumerate(blobs):
        if len(layer_blobs) != len(dts):
            raise ValueError(
                f"layer {li}: {len(layer_blobs)} tensors, "
                f"{kv_dtype} pool stores {len(dts)}")
        cols = []
        for b, dt, sh in zip(layer_blobs, dts, shapes):
            want = int(np.prod(sh)) * dt.itemsize
            if len(b) != want:
                raise ValueError(
                    f"layer {li}: {len(b)}-byte tensor, expected "
                    f"{want} for shape {sh} {str(dt).split('.')[-1]}")
            cols.append(torch.frombuffer(bytearray(b), dtype=dt)
                        .reshape(sh))
        out.append(tuple(cols))
    return out


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
        At engine quiescence this must equal the prefix cache's
        resident page count (0 without the cache) — every other page
        is a leak."""
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
