"""Port of ``ray_tpu/ops/flash_attention.py``: blockwise (flash)
attention, forward and backward, behind one ``torch.autograd.Function``.

Three kernel wrappers, each a hand-written CUDA kernel on the card
(csrc/flash_attention.cu) and its plain PyTorch version on the CPU:

- ``flash_fwd`` (K3, the counterpart of the TPU kernel ``_fwd_kernel``):
  O and the per-row logsumexp;
- ``flash_bwd_dq`` (K4, ``_bwd_dq_kernel``): dQ from the saved lse, with
  ``delta = rowsum(dO * O)`` formed inside;
- ``flash_bwd_dkv`` (K5, ``_bwd_dkv_kernel``): dK and dV.

The autograd function (the ``jax.custom_vjp`` ``_flash_packed`` of the
reference) saves ``(q, k, v, o, lse)`` and runs K4 then K5 in its
backward, on the card and on the CPU alike, so the CPU tests exercise
the lse-based backward and not autograd through a softmax. Each wrapper
adds one to its ``launches`` count where it launches its kernel, and
nowhere else. On a CUDA tensor a wrapper launches its kernel or raises;
nothing falls back to the plain version.

Kernels and plain versions round at the same points: scores in fp32
from the operand type, masked scores -1e30, ``l`` floored at 1e-30, P
and dS rounded to the operand type before the products that consume
them, delta in fp32, fp32 accumulation, outputs in the operand type.
The lse is ``[B, H, T]`` fp32 (the TPU's lane-padded ``[B, G, T, 128]``
is a layout detail not carried over), and so is head packing: the CUDA
kernels read q, k and v through their strides, which lets them take the
strided column views of a fused qkv projection without a copy. Block
sizes are constants of the CUDA source; there is no block-size knob.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
_SEQ_MULTIPLE = 128               # flash_attention's T contract
_TILE = 64                        # the kernels' q and kv tile
_HEAD_DIMS = (64, 128)
_SOURCE = "flash_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------
# Plain versions (one per kernel)
# --------------------------------------------------------------------

def _probs_inputs(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 scores [B, H, Tq, Tk] from the operand type, scaled after
    the dot product, masked to -1e30 above the diagonal if causal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = s.shape[-2:]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (o [B, Tq, H, D] in q.dtype, lse [B, H, Tq]
    fp32). P is rounded to v.dtype before P·V, ``l`` sums the unrounded
    P and is floored at 1e-30."""
    s = _probs_inputs(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, o, do, lse, causal, scale):
    """P = exp(S - lse) and dS = P (dP - delta), both fp32 [B, H, Tq, Tk],
    with delta = rowsum(dO * O) in fp32."""
    p = torch.exp(_probs_inputs(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, o, do, lse, causal: bool,
                           scale: float) -> torch.Tensor:
    """Plain version of K4: dQ = scale · dS·K, dS rounded to k.dtype."""
    _, ds = _probs_and_ds(q, k, v, o, do, lse, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, o, do, lse, causal: bool,
                            scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: dV = Pᵀ·dO and dK = scale · dSᵀ·Q, P rounded
    to do.dtype and dS to q.dtype."""
    p, ds = _probs_and_ds(q, k, v, o, do, lse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------

def load_kernel() -> ctypes.CDLL:
    """The flash kernels' library, compiled with nvcc at first use."""
    from ray_tpu_torch.ops import _build
    return _build.load(_SOURCE, _bind)


def _check_kernel_args(q, k, v, causal: bool, **more) -> None:
    """What the CUDA kernels accept; anything else raises."""
    tensors = {"q": q, "k": k, "v": v, **more}
    for name, t in tensors.items():
        if t.ndim != 4:
            raise ValueError(f"{name} must be [B, T, H, D]; got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dimension must be "
                             f"contiguous (stride 1)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} unsupported (float32 or "
                         f"bfloat16)")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not agree")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels take {_HEAD_DIMS} "
                         f"(flash_attention pads other D <= 128)")
    if Tq % _TILE or Tk % _TILE:
        raise ValueError(f"sequence lengths {Tq}/{Tk} must be multiples "
                         f"of {_TILE}")
    if causal and Tq != Tk:
        raise ValueError(f"causal needs equal q/kv lengths, got {Tq}/{Tk}")
    for name in ("o", "do"):
        if name in more and more[name].shape != q.shape:
            raise ValueError(f"{name} {tuple(more[name].shape)} != q "
                             f"{tuple(q.shape)}")


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn_name: str, lib, *args) -> None:
    err = getattr(lib, fn_name)(*args)
    if err:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.flash_attention_error(err).decode()})")


def _lse_ok(lse, q) -> None:
    B, Tq, H, _ = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Tq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous fp32 [B, H, T] = "
                         f"{(B, H, Tq)} tensor on {q.device}")


def flash_fwd(q, k, v, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (o [B, Tq, H, D] in q.dtype, lse [B, H, Tq] fp32). Launches
    the kernel on a CUDA tensor (adding one to ``flash_fwd.launches``),
    runs ``flash_fwd_reference`` on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check_kernel_args(q, k, v, causal)
    lib = load_kernel()
    B, Tq, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_fwd_launch", lib, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                _strides(q, k, v, o), B, Tq, k.shape[1], H, D, int(causal),
                scale, _DTYPE_CODES[q.dtype], stream)
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, o, do, lse, causal: bool, scale: float
                 ) -> torch.Tensor:
    """K4: dQ in q.dtype. Kernel on a CUDA tensor (counted in
    ``flash_bwd_dq.launches``), ``flash_bwd_dq_reference`` on the CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, o, do, lse, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    _check_kernel_args(q, k, v, causal, o=o, do=do)
    _lse_ok(lse, q)
    lib = load_kernel()
    B, Tq, H, D = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dq_launch", lib, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), _strides(q, k, v, o, do, dq), B, Tq,
                k.shape[1], H, D, int(causal), scale,
                _DTYPE_CODES[q.dtype], stream)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (dK, dV) in k.dtype. Kernel on a CUDA tensor (counted in
    ``flash_bwd_dkv.launches``), ``flash_bwd_dkv_reference`` on the
    CPU."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, o, do, lse, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    _check_kernel_args(q, k, v, causal, o=o, do=do)
    _lse_ok(lse, q)
    lib = load_kernel()
    B, Tq, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("flash_bwd_dkv_launch", lib, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dk.data_ptr(), dv.data_ptr(),
                _strides(q, k, v, o, do, dk, dv), B, Tq, k.shape[1], H, D,
                int(causal), scale, _DTYPE_CODES[q.dtype], stream)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_packed`` custom_vjp: forward K3, saving
    (q, k, v, o, lse); backward K4 then K5."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq = flash_bwd_dq(q, k, v, o, do, lse, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, o, do, lse, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def unsupported(q, k, causal: bool) -> Optional[str]:
    """Why ``flash_attention`` refuses these shapes, or None when it
    takes them: [B, T, H, D] inputs, T and the kv length multiples of
    128, equal lengths under causal, head_dim at most 128."""
    if q.ndim != 4 or k.ndim != 4:
        return "q, k, v must be [B, T, H, D]"
    T, Tk, D = q.shape[1], k.shape[1], q.shape[3]
    if T % _SEQ_MULTIPLE or Tk % _SEQ_MULTIPLE:
        return (f"flash_attention requires T % {_SEQ_MULTIPLE} == 0, got "
                f"{T}/{Tk}")
    if causal and T != Tk:
        return (f"causal flash_attention requires equal q/kv lengths, got "
                f"{T} vs {Tk}")
    if D > _HEAD_DIMS[-1]:
        return f"flash_attention takes head_dim <= {_HEAD_DIMS[-1]}, got {D}"
    return None


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention. q/k/v: [B, T, H, D]; returns [B, T, H, D] in
    q.dtype. T (and the kv length) must be a multiple of 128; causal
    requires equal q/kv lengths (``unsupported`` says why a shape is
    refused). Differentiable: the backward is K4 and K5 from the saved
    lse.

    The kernels are built for D in {64, 128}; any other D <= 128 is
    zero-padded up to the next of these, which is sound because the
    softmax scale is 1/sqrt of the REAL D, zero padding adds zero to
    every q·k dot, and the padded output dims are sliced away (autograd
    routes gradients through the pad and slice, outside the kernels'
    autograd function). D > 128 raises."""
    why = unsupported(q, k, causal)
    if why:
        raise ValueError(why)
    D = q.shape[3]
    scale = 1.0 / math.sqrt(D)
    Dp = next(d for d in _HEAD_DIMS if d >= D)
    if Dp != D:
        q, k, v = (F.pad(x, (0, Dp - D)) for x in (q, k, v))
    o = _FlashAttention.apply(q, k, v, causal, scale)
    return o[..., :D] if Dp != D else o


def _bind(lib: ctypes.CDLL) -> None:
    """argtypes/restype of the library's C entries (run once, when
    _build loads it)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 6 + [ctypes.c_float, i32, ptr]
    strides = ctypes.POINTER(ctypes.c_longlong)
    for name, n_ptrs in (("flash_fwd_launch", 5),
                         ("flash_bwd_dq_launch", 7),
                         ("flash_bwd_dkv_launch", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptrs + [strides] + tail
        fn.restype = i32
    lib.flash_attention_error.argtypes = [i32]
    lib.flash_attention_error.restype = ctypes.c_char_p
