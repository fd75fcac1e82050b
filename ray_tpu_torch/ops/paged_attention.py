"""Port of ``ray_tpu/ops/paged_attention.py``: the write half
(``paged_append``) and the read half (``paged_decode_attention``) of
the paged KV pool.

Layout contract (matches models/kv_cache.py):
  pages_k/pages_v: [n_kv_heads, n_pages, page_size, head_dim],
                   head-major, so one page of one kv head is one
                   contiguous [page_size, head_dim] tile
  page_table:      [n_slots, max_pages] int32 (0 = null page)
  positions:       [n_slots] int32, the current decode position; the
                   step attends keys 0..pos inclusive
  q:               [n_slots, n_heads, head_dim] (grouped-query: head
                   h uses kv head h // (n_heads // n_kv_heads))

``paged_decode_attention`` launches the hand-written CUDA kernel
(csrc/paged_decode_attention.cu, the Hopper counterpart of the TPU
kernel ``ray_tpu/ops/paged_attention.py::_kernel``) for tensors on a
CUDA device, and runs its plain PyTorch version,
``paged_decode_attention_reference``, for tensors on the CPU. Nothing
else is taken: a CUDA tensor the kernel does not accept raises.

Only fp pages exist in this slice; int8 pages (``paged_append``'s
three-scatter and the kernel ``_kernel_q``) are the next slice
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30

_SOURCE = "paged_decode_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8
# keys per block of the kernel's split-K pass: 16 slots x 4 kv heads at
# ~1k keys fill the 132 SMs with ~500 blocks
_SPLIT_KEYS = 128


class PagedShapeError(ValueError):
    """Typed shape/dtype mismatch between a KV chunk and the page pool.

    Raised by ``paged_append`` before anything is written. The message
    names the operand and both shapes, so a head-count or head-dim
    mismatch (the classic tensor-parallel wiring bug: sharded pool,
    unsharded chunk) reads as what it is.
    """


def _check_append_shapes(pages_k, pages_v, page_table, pos, k, v):
    if pages_k.ndim != 4 or pages_v.ndim != 4:
        raise PagedShapeError(
            f"pages_k/pages_v must be rank-4 [KH, n_pages, Pg, D]; "
            f"got pages_k {tuple(pages_k.shape)}, pages_v "
            f"{tuple(pages_v.shape)}")
    if pages_k.shape != pages_v.shape:
        raise PagedShapeError(
            f"pages_k and pages_v disagree: {tuple(pages_k.shape)} vs "
            f"{tuple(pages_v.shape)}")
    if k.ndim != 4 or v.ndim != 4:
        raise PagedShapeError(
            f"k/v chunks must be rank-4 [B, T, KH, D]; got k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape != v.shape:
        raise PagedShapeError(
            f"k and v chunks disagree: {tuple(k.shape)} vs "
            f"{tuple(v.shape)}")
    KH, _, _, D = pages_k.shape
    if k.shape[2] != KH:
        raise PagedShapeError(
            f"chunk has {k.shape[2]} kv heads but the page pool holds "
            f"{KH} (pool {tuple(pages_k.shape)}, chunk "
            f"{tuple(k.shape)}) — under tensor parallelism both must "
            f"be the per-device count")
    if k.shape[3] != D:
        raise PagedShapeError(
            f"chunk head_dim {k.shape[3]} != pool head_dim {D} "
            f"(pool {tuple(pages_k.shape)}, chunk {tuple(k.shape)})")
    if page_table.ndim != 2:
        raise PagedShapeError(
            f"page_table must be rank-2 [B, max_pages]; got "
            f"{tuple(page_table.shape)}")
    if page_table.shape[0] != k.shape[0]:
        raise PagedShapeError(
            f"page_table has {page_table.shape[0]} rows but the chunk "
            f"has batch {k.shape[0]}")
    if page_table.dtype.is_floating_point or page_table.dtype.is_complex \
            or page_table.dtype == torch.bool:
        raise PagedShapeError(
            f"page_table must be integer, got {page_table.dtype}")
    if tuple(pos.shape) != (k.shape[0],):
        raise PagedShapeError(
            f"pos must be [B]={k.shape[0]}; got shape "
            f"{tuple(pos.shape)}")


def paged_append(pages_k, pages_v, page_table, pos, k, v) -> None:
    """Scatter a [B, T] chunk of new K/V into the head-major page pool
    at each slot's current write offset, IN PLACE: ``pages_k`` and
    ``pages_v`` are modified and nothing is returned (the JAX version
    returns new arrays; this port keeps one pool for the engine's
    lifetime and never copies it).

    pages_k/pages_v: [KH, n_pages, Pg, D]
    page_table:      [B, max_pages] int (0 = null page)
    pos:             [B] int — first token of the chunk lands at
                     logical position ``pos[b]``
    k/v:             [B, T, KH, D] new keys/values

    Token t of row b goes to physical page
    ``page_table[b, (pos[b]+t) // Pg]`` at offset ``(pos[b]+t) % Pg``
    (append at offset: a chunk may start mid-page and span pages).
    Logical positions are clamped to the addressable window
    ``max_pages * Pg - 1`` and positions past the row's allocated
    pages resolve to page-table zeros, so padding tails land on the
    null page and never on another slot's pages. Several tail tokens
    may then hit the same null-page cell; which one wins is
    unspecified there, and only there.

    Raises :class:`PagedShapeError` on any rank / head / head-dim /
    batch mismatch between the chunk and the pool.
    """
    _check_append_shapes(pages_k, pages_v, page_table, pos, k, v)
    B, T = k.shape[:2]
    Pg = pages_k.shape[2]
    max_pages = page_table.shape[1]
    tpos = pos.long()[:, None] + torch.arange(T, device=k.device)[None]
    tpos = tpos.clamp(max=max_pages * Pg - 1)                  # [B, T]
    pidx = torch.gather(page_table.long(), 1, tpos // Pg)      # [B, T]
    flat_p = pidx.reshape(-1)
    flat_o = (tpos % Pg).reshape(-1)
    # [B, T, KH, D] -> [KH, B*T, D] to match the head-major pool.
    kT = k.reshape(B * T, k.shape[2], k.shape[3]).transpose(0, 1)
    vT = v.reshape(B * T, v.shape[2], v.shape[3]).transpose(0, 1)
    pages_k[:, flat_p, flat_o] = kT.to(pages_k.dtype)
    pages_v[:, flat_p, flat_o] = vT.to(pages_v.dtype)


def paged_decode_attention_reference(q, pages_k, pages_v, page_table,
                                     positions):
    """Plain PyTorch version of the decode kernel: gather each slot's
    page window dense, then a masked fp32 softmax, with the kernel's
    guards — keys past ``positions[b]`` are masked, and a row with no
    visible key gives zeros (``m_safe`` and the ``l`` floor of the TPU
    kernel) instead of a uniform average. PV is taken in fp32, as the
    kernel does; the output is cast to ``q.dtype``."""
    B, H, D = q.shape
    KH, _, Pg, _ = pages_k.shape
    rep = H // KH
    max_pages = page_table.shape[1]
    L = max_pages * Pg
    pt = page_table.long()
    kg = pages_k[:, pt].reshape(KH, B, L, D).float()
    vg = pages_v[:, pt].reshape(KH, B, L, D).float()
    qg = q.reshape(B, KH, rep, D).float()
    s = torch.einsum("bkrd,kbsd->bkrs", qg, kg) / math.sqrt(D)
    valid = (torch.arange(L, device=q.device)[None]
             <= positions.long()[:, None])                    # [B, L]
    s = torch.where(valid[:, None, None], s,
                    torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e29)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bkrs,kbsd->bkrd", p, vg) / l
    return o.reshape(B, H, D).to(q.dtype)


def _check_decode_args(q, pages_k, pages_v, page_table, positions):
    """What the CUDA kernel accepts; anything else raises."""
    if q.ndim != 3 or pages_k.ndim != 4:
        raise ValueError(
            f"q must be [B, H, D] and pages [KH, n_pages, Pg, D]; got "
            f"q {tuple(q.shape)}, pages {tuple(pages_k.shape)}")
    B, H, D = q.shape
    KH, _, _, Dk = pages_k.shape
    tensors = {"q": q, "pages_k": pages_k, "pages_v": pages_v,
               "page_table": page_table, "positions": positions}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} unsupported (float32 or "
                         f"bfloat16)")
    if pages_k.dtype != q.dtype or pages_v.dtype != q.dtype:
        raise ValueError(f"pages ({pages_k.dtype}, {pages_v.dtype}) "
                         f"must match q ({q.dtype})")
    if pages_v.shape != pages_k.shape:
        raise ValueError(f"pages_k {tuple(pages_k.shape)} and pages_v "
                         f"{tuple(pages_v.shape)} disagree")
    if D != Dk or D not in _HEAD_DIMS:
        raise ValueError(f"head_dim q={D} pages={Dk}; the kernel takes "
                         f"{_HEAD_DIMS}")
    if H % KH or not 1 <= H // KH <= _MAX_REP:
        raise ValueError(f"n_heads {H} over n_kv_heads {KH}: group size "
                         f"must be an integer in 1..{_MAX_REP}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("page_table and positions must be int32")
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or tuple(positions.shape) != (B,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / positions "
            f"{tuple(positions.shape)} do not match batch {B}")
    for name in ("pages_k", "pages_v", "q"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def load_kernel() -> ctypes.CDLL:
    """The decode kernel's library, compiled with nvcc at first use."""
    from ray_tpu_torch.ops import _build
    return _build.load(_SOURCE, _bind)


def _launch_kernel(q, pages_k, pages_v, page_table, positions,
                   split_keys: int = _SPLIT_KEYS):
    """Launch the kernel; ``split_keys`` (keys per block of the split-K
    pass) is left at its default everywhere but the profiling tool's
    sweep."""
    _check_decode_args(q, pages_k, pages_v, page_table, positions)
    lib = load_kernel()
    B, H, D = q.shape
    KH, n_pages, Pg, _ = pages_k.shape
    max_pages = page_table.shape[1]
    n_splits = -(-max_pages * Pg // split_keys)
    out = torch.empty_like(q)
    # per-split partial results, merged by the kernel's second pass
    part_acc = torch.empty((B, KH, n_splits, H // KH, D),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, B, KH, n_splits, H // KH),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), B, H, KH, D, n_pages, Pg, max_pages,
            split_keys, _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(
            f"paged_decode_attention kernel launch failed: CUDA error "
            f"{err} ({lib.paged_decode_attention_error(err).decode()})")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, pages_k, pages_v, page_table, positions):
    """One decode step of paged attention: q [B, H, D] against each
    slot's pages; returns [B, H, D] in q.dtype.

    On a CUDA tensor this launches the hand-written kernel and adds
    one to ``paged_decode_attention.launches``; it raises if the
    kernel does not take the inputs (dtype, head_dim, group size,
    contiguity) or if the launch fails. On a CPU tensor it runs
    ``paged_decode_attention_reference``.

    The page ids a slot's window reaches (``page_table[b, :pos//Pg+1]``)
    must lie in ``[0, n_pages)``: the kernel reads them on the device
    and does not check them, since checking on the host would cost a
    device sync per call. The engine builds its tables from allocator
    ids only."""
    if q.device.type == "cuda":
        return _launch_kernel(q, pages_k, pages_v, page_table, positions)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pages_k, pages_v, page_table, positions)
    raise ValueError(f"paged_decode_attention: unsupported device "
                     f"{q.device}")


paged_decode_attention.launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    """argtypes/restype of the kernel library's C entries (run once,
    when _build loads the library)."""
    fn = lib.paged_decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_decode_attention_error.argtypes = [ctypes.c_int]
    lib.paged_decode_attention_error.restype = ctypes.c_char_p
