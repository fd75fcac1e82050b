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

``paged_decode_attention`` launches a hand-written CUDA kernel for
tensors on a CUDA device — K1 (csrc/paged_decode_attention.cu), the
Hopper counterpart of the TPU kernel
``ray_tpu/ops/paged_attention.py::_kernel``, for fp pages, and K2
(csrc/paged_decode_attention_int8.cu), the counterpart of
``_kernel_q``, for int8 pages with their scales: bf16 q on the tensor
cores (csrc/paged_decode_attention_sm90.cuh), fp32 q on the scalar
template (csrc/paged_decode_attention.cuh), one launch per call that
also merges the splits — and runs the plain PyTorch version,
``paged_decode_attention_reference``, for tensors on the CPU. Nothing
else is taken: a CUDA tensor the kernel does not accept raises. K1
counts its launches in ``paged_decode_attention.launches``, K2 in
``paged_decode_attention.launches_int8``.

Int8 pages use a symmetric absmax code: value = q * scale / 127 with q
in [-127, 127] (-128 unused), one fp32 scale per (kv head, physical
page), ``[KH, n_pages, 1]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30
_QMAX = 127.0

_SOURCE = "paged_decode_attention.cu"             # K1
_SOURCE_INT8 = "paged_decode_attention_int8.cu"   # K2
# the tensor-core split pass of bf16 K1 and bf16-q K2, included by both
_SOURCE_SM90 = "paged_decode_attention_sm90.cuh"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8
# keys per block of the scalar split-K pass (fp32 K1, fp32-q K2): 16
# slots x 4 kv heads at ~1k keys fill the 132 SMs with ~500 blocks
_SPLIT_KEYS = 128
# the split sizes the tensor-core pass (bf16 K1, bf16-q K2) is built
# for (4 warps of 16, 32 or 64 keys), and the one it runs, the fastest
# for both kernels at the TinyLlama decode shape in
# tools/torch_decode_profile.py's sweep
_BF16_SPLITS = (64, 128, 256)
_SPLIT_KEYS_BF16 = 256


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


def _check_scale_shapes(pages_k, scales_k, scales_v):
    KH, n_pages = pages_k.shape[:2]
    want = (KH, n_pages, 1)
    for name, s in (("scales_k", scales_k), ("scales_v", scales_v)):
        if tuple(s.shape) != want:
            raise PagedShapeError(
                f"{name} must be [KH, n_pages, 1]={want} to pair with "
                f"pool {tuple(pages_k.shape)}; got {tuple(s.shape)}")
    if pages_k.dtype != torch.int8:
        raise PagedShapeError(
            f"per-page scales supplied but the pool is {pages_k.dtype}"
            f", not int8 — scales only pair with quantized pools")


def paged_append(pages_k, pages_v, page_table, pos, k, v,
                 scales_k=None, scales_v=None) -> None:
    """Scatter a [B, T] chunk of new K/V into the head-major page pool
    at each slot's current write offset, IN PLACE: ``pages_k`` and
    ``pages_v`` (and, for int8, ``scales_k``/``scales_v``) are modified
    and nothing is returned (the JAX version returns new arrays; this
    port keeps one pool for the engine's lifetime and never copies it).

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

    Int8 pools pass ``scales_k``/``scales_v`` ([KH, n_pages, 1] fp32
    per-page absmax), and the append does three scatters per tensor,
    in the reference's fp32 operation order (the bytes and scales come
    out identical to the reference's for the same write history):

    1. SCALE RESET: a page whose in-page offset 0 the chunk writes
       starts over — its old scale came from a previous owner (the
       allocator reuses page ids) and counts as 0.
    2. RUNNING ABSMAX: each token's absmax is scatter-maxed into the
       (reset-adjusted) page scales, so a live page's scale only grows.
    3. REQUANTIZE + STORE: every touched page is re-coded from its old
       scale to its new one (``round(q_old * s_old/s_new)``, 0 where
       it was reset), then the chunk's tokens are quantized at the new
       scale (``round(x * 127/s_new)``, clipped to ±127) on top.

    Every old page is gathered (per token, as the reference does: no
    ``unique``, so no host sync) before anything is written; duplicate
    page entries write identical bytes, so scatter order cannot matter.

    Raises :class:`PagedShapeError` on any rank / head / head-dim /
    batch mismatch between the chunk and the pool, when scales are
    given for a pool that is not int8, and when an int8 pool comes
    without them.
    """
    _check_append_shapes(pages_k, pages_v, page_table, pos, k, v)
    quantized = scales_k is not None or scales_v is not None
    if quantized and (scales_k is None or scales_v is None):
        raise PagedShapeError(
            "scales_k and scales_v must be supplied together")
    if not quantized and pages_k.dtype == torch.int8:
        raise PagedShapeError(
            "int8 pool appended without its per-page scales — pass "
            "scales_k/scales_v (kv_dtype='int8' wiring bug)")
    if quantized:
        _check_scale_shapes(pages_k, scales_k, scales_v)
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
    if not quantized:
        pages_k[:, flat_p, flat_o] = kT.to(pages_k.dtype)
        pages_v[:, flat_p, flat_o] = vT.to(pages_v.dtype)
        return
    # (1) pages whose offset-0 cell this chunk writes start over; one
    # mask for K and V
    reset = torch.zeros(pages_k.shape[1], dtype=torch.int32,
                        device=k.device).scatter_reduce_(
        0, flat_p, (flat_o == 0).int(), "amax").bool()     # [n_pages]
    _append_q(pages_k, scales_k, kT, flat_p, flat_o, reset)
    _append_q(pages_v, scales_v, vT, flat_p, flat_o, reset)


def _append_q(pages, scales, xT, flat_p, flat_o, reset) -> None:
    """Steps 2 and 3 of the int8 append for one tensor, in place."""
    xT32 = xT.float()                                      # [KH, BT, D]
    s_base = torch.where(reset[None, :, None], 0.0, scales.float())
    # (2) running absmax, monotone while the page is live
    amax = xT32.abs().amax(dim=2)                          # [KH, BT]
    s_new = s_base[:, :, 0].scatter_reduce(
        1, flat_p[None].expand_as(amax), amax, "amax")[:, :, None]
    # (3a) re-code the touched pages, all gathered before any write
    old_q = pages[:, flat_p].float()                       # [KH, BT, Pg, D]
    sb = s_base[:, flat_p]                                 # [KH, BT, 1]
    sn = s_new[:, flat_p]
    ratio = torch.where(sn > 0.0, sb / sn.clamp(min=1e-30), 0.0)
    pages[:, flat_p] = torch.round(old_q * ratio[..., None]).clamp(
        -_QMAX, _QMAX).to(torch.int8)
    # (3b) the chunk's tokens at the new scale; a zero scale means the
    # token itself is all zero, so the guarded divide is exact
    inv = torch.where(sn > 0.0, _QMAX / sn.clamp(min=1e-30), 0.0)
    pages[:, flat_p, flat_o] = torch.round(xT32 * inv).clamp(
        -_QMAX, _QMAX).to(torch.int8)
    scales.copy_(s_new)


def dequantize_pages(pages, scales):
    """Test helper: the fp32 view of an int8 pool (``q * s / 127``).
    Never used on the serving path — the point of the int8 pool is
    that this tensor never exists there."""
    return pages.float() * (scales.float() / _QMAX)[..., None]


def paged_decode_attention_reference(q, pages_k, pages_v, page_table,
                                     positions, scales_k=None,
                                     scales_v=None):
    """Plain PyTorch version of the decode kernels (K1, and K2 when
    scales are given): gather each slot's page window dense — for int8
    pages dequantized in fp32 as ``q8 * (s * (1/127))`` with the
    gathered per-page scales, the TPU kernel's order — then a masked
    fp32 softmax, with the kernel's guards: keys past ``positions[b]``
    are masked, and a row with no visible key gives zeros (``m_safe``
    and the ``l`` floor of the TPU kernel) instead of a uniform
    average. PV is taken in fp32, as the kernels do; the output is cast
    to ``q.dtype``."""
    B, H, D = q.shape
    KH, _, Pg, _ = pages_k.shape
    rep = H // KH
    max_pages = page_table.shape[1]
    L = max_pages * Pg
    pt = page_table.long()
    kg = pages_k[:, pt].float()                        # [KH, B, MP, Pg, D]
    vg = pages_v[:, pt].float()
    if scales_k is not None:
        kg = kg * (scales_k[:, pt].float() * (1.0 / _QMAX))[..., None]
        vg = vg * (scales_v[:, pt].float() * (1.0 / _QMAX))[..., None]
    kg = kg.reshape(KH, B, L, D)
    vg = vg.reshape(KH, B, L, D)
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


def _check_decode_args(q, pages_k, pages_v, page_table, positions,
                       scales_k=None, scales_v=None):
    """What the CUDA kernels accept (K1: pages in q's dtype; K2: int8
    pages with fp32 scales); anything else raises."""
    if q.ndim != 3 or pages_k.ndim != 4:
        raise ValueError(
            f"q must be [B, H, D] and pages [KH, n_pages, Pg, D]; got "
            f"q {tuple(q.shape)}, pages {tuple(pages_k.shape)}")
    B, H, D = q.shape
    KH, n_pages, _, Dk = pages_k.shape
    tensors = {"q": q, "pages_k": pages_k, "pages_v": pages_v,
               "page_table": page_table, "positions": positions}
    if (scales_k is None) != (scales_v is None):
        raise ValueError("scales_k and scales_v must be given together")
    quantized = scales_k is not None
    if quantized:
        tensors.update(scales_k=scales_k, scales_v=scales_v)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} unsupported (float32 or "
                         f"bfloat16)")
    page_dtype = torch.int8 if quantized else q.dtype
    if pages_k.dtype != page_dtype or pages_v.dtype != page_dtype:
        raise ValueError(f"pages ({pages_k.dtype}, {pages_v.dtype}) "
                         f"must be {page_dtype}"
                         + (" with scales" if quantized else
                            " to match q"))
    if quantized:
        for name in ("scales_k", "scales_v"):
            t = tensors[name]
            if t.dtype != torch.float32 or tuple(t.shape) != (KH, n_pages,
                                                              1):
                raise ValueError(
                    f"{name} must be float32 [KH, n_pages, 1]="
                    f"{(KH, n_pages, 1)}; got {t.dtype} "
                    f"{tuple(t.shape)}")
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


def load_kernel(int8: bool = False) -> ctypes.CDLL:
    """K1's library, or K2's with ``int8``, compiled with nvcc at first
    use."""
    from ray_tpu_torch.ops import _build
    if int8:
        return _build.load(_SOURCE_INT8, _bind_int8)
    return _build.load(_SOURCE, _bind)


def split_keys_for(dtype) -> int:
    """Keys per block of the split-K pass that ``paged_decode_attention``
    runs for q dtype ``dtype``, over fp (K1) or int8 (K2) pages."""
    return _SPLIT_KEYS_BF16 if dtype == torch.bfloat16 else _SPLIT_KEYS


# one int32 counter per (slot, kv head) for each (device, stream): the
# kernel's split blocks draw tickets on it to find the one that merges,
# and that block leaves it at 0 again. Calls on one stream run in order,
# so they share it; two streams must not.
_COUNTERS = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters for ``stream`` on ``device``:
    zeroed once, when allocated or grown, never per call."""
    key = (device, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                         device=device)
    return c


def _launch_kernel(q, pages_k, pages_v, page_table, positions,
                   split_keys=None, scales_k=None, scales_v=None):
    """Launch K1, or K2 when scales are given; ``split_keys`` (keys per
    block of the split-K pass) is left at ``split_keys_for`` everywhere
    but the profiling tool's sweep."""
    _check_decode_args(q, pages_k, pages_v, page_table, positions,
                       scales_k, scales_v)
    quantized = scales_k is not None
    if split_keys is None:
        split_keys = split_keys_for(q.dtype)
    if q.dtype == torch.bfloat16 and split_keys not in _BF16_SPLITS:
        raise ValueError(f"bf16 K1 and K2 take split_keys in "
                         f"{_BF16_SPLITS}, not {split_keys}")
    lib = load_kernel(int8=quantized)
    B, H, D = q.shape
    KH, n_pages, Pg, _ = pages_k.shape
    max_pages = page_table.shape[1]
    n_splits = -(-max_pages * Pg // split_keys)
    out = torch.empty_like(q)
    # per-split partial results, merged by the split block that ends
    # last
    part_acc = torch.empty((B, KH, n_splits, H // KH, D),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, B, KH, n_splits, H // KH),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device, stream, B * KH)
        ptrs = [q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr()]
        if quantized:
            launch = lib.paged_decode_attention_int8_launch
            ptrs += [scales_k.data_ptr(), scales_v.data_ptr()]
        else:
            launch = lib.paged_decode_attention_launch
        err = launch(
            *ptrs, page_table.data_ptr(), positions.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), counters.data_ptr(), B, H, KH, D,
            n_pages, Pg, max_pages, split_keys, _DTYPE_CODES[q.dtype],
            stream)
    kernel = "K2" if quantized else "K1"
    if err:
        raise RuntimeError(
            f"paged_decode_attention {kernel} launch failed: CUDA error "
            f"{err} ({lib.paged_decode_attention_error(err).decode()})")
    if quantized:
        paged_decode_attention.launches_int8 += 1
    else:
        paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, pages_k, pages_v, page_table, positions,
                           scales_k=None, scales_v=None):
    """One decode step of paged attention: q [B, H, D] against each
    slot's pages; returns [B, H, D] in q.dtype. Int8 pools pass
    ``scales_k``/``scales_v`` ([KH, n_pages, 1] fp32).

    On a CUDA tensor this launches K1 (fp pages; adds one to
    ``paged_decode_attention.launches``) or K2 (int8 pages with scales,
    which no fp copy of the pool ever holds; adds one to
    ``paged_decode_attention.launches_int8``); it raises if the kernel
    does not take the inputs (dtype, head_dim, group size, contiguity,
    scale shape) or if the launch fails. On a CPU tensor it runs
    ``paged_decode_attention_reference``.

    The page ids a slot's window reaches (``page_table[b, :pos//Pg+1]``)
    must lie in ``[0, n_pages)``: the kernel reads them on the device
    and does not check them, since checking on the host would cost a
    device sync per call. The engine builds its tables from allocator
    ids only."""
    if scales_k is not None or scales_v is not None:
        if scales_k is None or scales_v is None:
            raise PagedShapeError(
                "scales_k and scales_v must be supplied together")
        _check_scale_shapes(pages_k, scales_k, scales_v)
    if q.device.type == "cuda":
        return _launch_kernel(q, pages_k, pages_v, page_table, positions,
                              scales_k=scales_k, scales_v=scales_v)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pages_k, pages_v, page_table, positions, scales_k,
            scales_v)
    raise ValueError(f"paged_decode_attention: unsupported device "
                     f"{q.device}")


paged_decode_attention.launches = 0          # K1
paged_decode_attention.launches_int8 = 0     # K2


def _bind(lib: ctypes.CDLL) -> None:
    """argtypes/restype of K1's C entries (run once, when _build loads
    the library)."""
    _bind_entries(lib, lib.paged_decode_attention_launch, 10)


def _bind_int8(lib: ctypes.CDLL) -> None:
    """The same for K2's library, whose launch also takes the scales."""
    _bind_entries(lib, lib.paged_decode_attention_int8_launch, 12)


def _bind_entries(lib: ctypes.CDLL, launch, n_ptrs: int) -> None:
    launch.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    lib.paged_decode_attention_error.argtypes = [ctypes.c_int]
    lib.paged_decode_attention_error.restype = ctypes.c_char_p
