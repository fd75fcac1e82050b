"""Port of ``ray_tpu/ops/flash_attention.py``: blockwise (flash)
attention, forward and backward, behind one ``torch.autograd.Function``.

Three kernel wrappers, each a hand-written CUDA kernel on the card and
its plain PyTorch version on the CPU:

- ``flash_fwd`` (K3, the counterpart of the TPU kernel ``_fwd_kernel``):
  O and the per-row logsumexp;
- ``flash_bwd_dq`` (K4, ``_bwd_dq_kernel``): dQ from the saved lse and
  ``delta = rowsum(dO * O)``;
- ``flash_bwd_dkv`` (K5, ``_bwd_dkv_kernel``): dK and dV, from the same.

On the card the kernel follows the dtype. bf16 K3, K4 and K5 run on the
tensor cores (csrc/flash_attention_sm90.cu: wgmma products, TMA copies
into a ring of swizzled bf16 tiles), and read delta from one pass,
``flash_bwd_delta``, that writes it once per row. fp32 K3, K4 and K5 run
the scalar fp32-FMA kernels of csrc/flash_attention.cu, which form delta
themselves: tensor cores cannot hold fp32 inputs to 1e-4. Each dtype has
exactly one kernel; none falls back to another.

The autograd function (the ``jax.custom_vjp`` ``_flash_packed`` of the
reference) saves ``(q, k, v, o, lse)`` and runs the delta pass (where
there is one: bf16 on the card, the plain version on the CPU), then K4
and K5 on that delta, on the card and on the CPU alike, so the CPU tests
exercise the lse-based backward and not autograd through a softmax.
``flash_bwd_dq`` and ``flash_bwd_dkv`` called alone (``delta=None``)
run the pass themselves. Each wrapper adds one to its ``launches`` count
where it launches its kernel, and nowhere else. On a CUDA tensor a
wrapper launches its kernel or raises; nothing falls back to the plain
version.

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
_SOURCE = "flash_attention.cu"            # K3, K4, K5 in fp32
_SOURCE_SM90 = "flash_attention_sm90.cu"  # K3, K4, K5 and delta in bf16
_DTYPES = (torch.float32, torch.bfloat16)
# the kernels of _SOURCE_SM90, each built for D 64 and 128
_SM90_KERNELS = ("fwd_sm90", "delta_kernel", "dq_sm90", "dkv_sm90")


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


def flash_bwd_delta_reference(o, do) -> torch.Tensor:
    """Plain version of the delta pass: delta = rowsum(dO * O) in fp32,
    [B, H, Tq]."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, o, do, lse, causal, scale, delta):
    """P = exp(S - lse) and dS = P (dP - delta), both fp32 [B, H, Tq, Tk];
    delta is formed here when it is None."""
    if delta is None:
        delta = flash_bwd_delta_reference(o, do)
    p = torch.exp(_probs_inputs(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, o, do, lse, causal: bool,
                           scale: float, delta=None) -> torch.Tensor:
    """Plain version of K4: dQ = scale · dS·K, dS rounded to k.dtype."""
    _, ds = _probs_and_ds(q, k, v, o, do, lse, causal, scale, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, o, do, lse, causal: bool,
                            scale: float, delta=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: dV = Pᵀ·dO and dK = scale · dSᵀ·Q, P rounded
    to do.dtype and dS to q.dtype."""
    p, ds = _probs_and_ds(q, k, v, o, do, lse, causal, scale, delta)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------

def load_kernel(sm90: bool = False) -> ctypes.CDLL:
    """The scalar kernels' library (fp32), or with ``sm90`` the
    tensor-core kernels' (bf16 K3, K4, K5 and the delta pass), compiled
    with nvcc at first use."""
    from ray_tpu_torch.ops import _build
    if sm90:
        return _build.load(_SOURCE_SM90, _bind_sm90)
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
    if q.dtype not in _DTYPES:
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


def _check_tma(**tensors) -> None:
    """The bf16 kernels copy tiles with TMA: every input needs a 16-byte
    aligned base and batch, row and head strides of whole 16 bytes."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name}: the bf16 kernels need a 16-byte "
                             f"aligned base and strides that are multiples "
                             f"of 8 elements; got strides {t.stride()}")


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn_name: str, lib, *args) -> None:
    err = getattr(lib, fn_name)(*args)
    if err:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.flash_attention_error(err).decode()})")


def _rows_ok(name: str, t, q) -> None:
    """lse and delta: contiguous fp32 [B, H, Tq] beside q."""
    B, Tq, H, _ = q.shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, Tq)
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"{name} must be a contiguous fp32 [B, H, T] = "
                         f"{(B, H, Tq)} tensor on {q.device}")


def _kernel_delta(q, o, do, delta):
    """The delta a bf16 backward kernel reads: ``delta`` checked, or one
    pass of the delta kernel when it is None. The fp32 kernels form
    delta themselves and take none."""
    if q.dtype != torch.bfloat16:
        if delta is not None:
            raise ValueError("the fp32 kernels form delta in-kernel; "
                             "pass delta=None")
        return None
    if delta is None:
        return flash_bwd_delta(o, do)
    _rows_ok("delta", delta, q)
    return delta


def flash_fwd(q, k, v, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (o [B, Tq, H, D] in q.dtype, lse [B, H, Tq] fp32). Launches
    the kernel on a CUDA tensor (adding one to ``flash_fwd.launches``):
    the tensor-core kernel for bf16, the scalar one for fp32. Runs
    ``flash_fwd_reference`` on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check_kernel_args(q, k, v, causal)
    sm90 = q.dtype == torch.bfloat16
    if sm90:
        _check_tma(q=q, k=k, v=v)
    lib = load_kernel(sm90)
    B, Tq, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _strides(q, k, v, o), B, Tq, k.shape[1], H,
                D, int(causal), scale)
        _launch("flash_fwd_sm90_launch" if sm90 else "flash_fwd_launch",
                lib, *args, stream)
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O), [B, H, Tq] fp32: what K4 and K5 of one
    backward share. On a bf16 CUDA tensor one launch of the delta kernel
    (counted in ``flash_bwd_delta.launches``); ``flash_bwd_delta_reference``
    on a CPU tensor. fp32 CUDA tensors have no pass: the scalar kernels
    form delta themselves."""
    if o.device.type == "cpu":
        return flash_bwd_delta_reference(o, do)
    if o.device.type != "cuda":
        raise ValueError(f"flash_bwd_delta: unsupported device {o.device}")
    if o.dtype != torch.bfloat16:
        raise ValueError(f"flash_bwd_delta: the delta kernel takes "
                         f"bfloat16, got {o.dtype} (the fp32 kernels form "
                         f"delta in-kernel)")
    _check_kernel_args(o, o, o, False, do=do)  # o stands in for q, k, v
    _check_tma(o=o, do=do)
    lib = load_kernel(sm90=True)
    B, T, H, D = o.shape
    delta = torch.empty((B, H, T), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        _launch("flash_bwd_delta_sm90_launch", lib, o.data_ptr(),
                do.data_ptr(), delta.data_ptr(), _strides(o, do), B, T, H, D,
                stream)
    flash_bwd_delta.launches += 1
    return delta


def flash_bwd_dq(q, k, v, o, do, lse, causal: bool, scale: float,
                 delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: dQ in q.dtype. Kernel on a CUDA tensor (counted in
    ``flash_bwd_dq.launches``): for bf16 the tensor-core kernel, reading
    ``delta`` (from ``flash_bwd_delta``; run here when None); for fp32 the
    scalar kernel, which forms delta itself (``delta`` must be None).
    ``flash_bwd_dq_reference`` on the CPU, with ``delta`` if given."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, o, do, lse, causal, scale,
                                      delta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    _check_kernel_args(q, k, v, causal, o=o, do=do)
    _rows_ok("lse", lse, q)
    sm90 = q.dtype == torch.bfloat16
    if sm90:
        _check_tma(q=q, k=k, v=v, o=o, do=do)
    delta = _kernel_delta(q, o, do, delta)
    lib = load_kernel(sm90)
    B, Tq, H, D = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tail = (B, Tq, k.shape[1], H, D, int(causal), scale, stream)
        if sm90:
            _launch("flash_bwd_dq_sm90_launch", lib, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    _strides(q, k, v, do, dq), *tail)
        else:
            _launch("flash_bwd_dq_launch", lib, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dq.data_ptr(),
                    _strides(q, k, v, o, do, dq), *tail)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, causal: bool, scale: float,
                  delta: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (dK, dV) in k.dtype. Kernel on a CUDA tensor (counted in
    ``flash_bwd_dkv.launches``): for bf16 the tensor-core kernel, reading
    ``delta`` as ``flash_bwd_dq`` does; for fp32 the scalar kernel.
    ``flash_bwd_dkv_reference`` on the CPU, with ``delta`` if given."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, o, do, lse, causal, scale,
                                       delta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    _check_kernel_args(q, k, v, causal, o=o, do=do)
    _rows_ok("lse", lse, q)
    sm90 = q.dtype == torch.bfloat16
    if sm90:
        _check_tma(q=q, k=k, v=v, o=o, do=do)
    delta = _kernel_delta(q, o, do, delta)
    lib = load_kernel(sm90)
    B, Tq, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tail = (B, Tq, k.shape[1], H, D, int(causal), scale, stream)
        if sm90:
            _launch("flash_bwd_dkv_sm90_launch", lib, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), _strides(q, k, v, do, dk, dv), *tail)
        else:
            _launch("flash_bwd_dkv_launch", lib, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    _strides(q, k, v, o, do, dk, dv), *tail)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_delta.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def _has_delta_pass(q) -> bool:
    """Whether a backward on q forms delta once for K4 and K5: the CPU's
    plain versions and the bf16 kernels do; the fp32 kernels form it
    themselves."""
    return q.device.type == "cpu" or q.dtype == torch.bfloat16


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_packed`` custom_vjp: forward K3, saving
    (q, k, v, o, lse); backward one delta pass, then K4 and K5 on it."""

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
        delta = flash_bwd_delta(o, do) if _has_delta_pass(q) else None
        dq = flash_bwd_dq(q, k, v, o, do, lse, ctx.causal, ctx.scale,
                          delta)
        dk, dv = flash_bwd_dkv(q, k, v, o, do, lse, ctx.causal, ctx.scale,
                               delta)
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


# after the strides: B, T_q, T_k, H, D, causal, the scale, the stream
_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def _declare(lib: ctypes.CDLL, entries) -> None:
    """argtypes/restype of a flash library's C entries: (name, number of
    device pointers, the arguments after the strides array) each."""
    strides = ctypes.POINTER(ctypes.c_longlong)
    for name, n_ptrs, tail in entries:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [strides] + tail
        fn.restype = ctypes.c_int
    lib.flash_attention_error.argtypes = [ctypes.c_int]
    lib.flash_attention_error.restype = ctypes.c_char_p


def _bind(lib: ctypes.CDLL) -> None:
    """The scalar library's entries (run once, when _build loads it)."""
    _declare(lib, (("flash_fwd_launch", 5, _TAIL),
                   ("flash_bwd_dq_launch", 7, _TAIL),
                   ("flash_bwd_dkv_launch", 8, _TAIL)))


def _bind_sm90(lib: ctypes.CDLL) -> None:
    """The tensor-core library's entries; the delta pass takes B, T, H,
    D and the stream after the strides."""
    _declare(lib, (("flash_fwd_sm90_launch", 5, _TAIL),
                   ("flash_bwd_delta_sm90_launch", 3,
                    [ctypes.c_int] * 4 + [ctypes.c_void_p]),
                   ("flash_bwd_dq_sm90_launch", 7, _TAIL),
                   ("flash_bwd_dkv_sm90_launch", 8, _TAIL)))
