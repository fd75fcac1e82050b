"""ray_tpu_torch.ops.flash_attention against ray_tpu.ops.flash_attention
on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` does; the port runs its plain
versions (one per CUDA kernel) through the same ``autograd.Function``
that launches the kernels on the card, so the lse-based backward (K4
then K5) is what is held here. Same numpy inputs on both sides; fp32;
tolerance 1e-4 abs and rel (the two sum in different orders).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.attention import (dense_attention,
                                         multi_head_attention, padding_bias)

TOL = dict(rtol=1e-4, atol=1e-4)
# XLA's backend optimizations cost most of the JAX side's compile time
# here and buy nothing at these sizes
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _inputs(seed, B, T, H, D, Tk=None):
    g = np.random.default_rng(seed)
    shapes = [(B, T, H, D), (B, Tk or T, H, D), (B, Tk or T, H, D),
              (B, T, H, D)]
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _jax_fwd_bwd(q, k, v, do):
    o, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=True),
                     q, k, v)
    return o, vjp(do)


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _jax_fwd_bwd_full(q, k, v, do):
    o, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=False),
                     q, k, v)
    return o, vjp(do)


def _torch_fwd_bwd(q, k, v, do, causal):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    return o.detach(), grads


@pytest.mark.parametrize("B,T,H,D,causal", [
    (1, 256, 2, 64, True),      # two q tiles of the kernels, causal
    (1, 256, 2, 64, False),
    (1, 512, 1, 64, True),      # several kv tiles per q tile
    (2, 128, 1, 128, False),    # D 128 as built, batch 2
    (1, 256, 4, 64, True),      # the reference's packed-group shape
    (1, 256, 3, 64, True),      # odd H (the reference pads H)
    (1, 256, 2, 96, True),      # D padded to 128
    (1, 128, 2, 16, True),      # D padded to 64
])
def test_flash_fwd_and_grads_match_jax(B, T, H, D, causal):
    q, k, v, do = _inputs(B * T + H * D, B, T, H, D)
    jfn = _jax_fwd_bwd if causal else _jax_fwd_bwd_full
    jo, jgrads = jfn(*(jnp.asarray(x) for x in (q, k, v, do)))
    to, tgrads = _torch_fwd_bwd(q, k, v, do, causal)
    assert to.shape == (B, T, H, D)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL,
                                   err_msg=f"d{name}")


def test_cross_length_non_causal_matches_jax():
    q, k, v, do = _inputs(7, 1, 128, 2, 64, Tk=256)
    jo, jgrads = _jax_fwd_bwd_full(*(jnp.asarray(x)
                                     for x in (q, k, v, do)))
    to, tgrads = _torch_fwd_bwd(q, k, v, do, causal=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_strided_qkv_views_match_contiguous():
    """q, k, v as the column views of one fused [B, T, 3C] projection
    (row stride 3C), as GPT-2 passes them, give what contiguous copies
    give."""
    g = np.random.default_rng(3)
    B, T, H, D = 2, 128, 2, 64
    qkv = torch.tensor(g.standard_normal((B, T, 3 * H * D)).astype(
        np.float32), requires_grad=True)
    views = [t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1)]
    assert views[0].stride() == (T * 3 * H * D, 3 * H * D, D, 1)
    o = fa.flash_attention(*views)
    (o ** 2).sum().backward()
    ref_in = [t.detach().contiguous().requires_grad_() for t in views]
    o2 = fa.flash_attention(*ref_in)
    (o2 ** 2).sum().backward()
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    ref_grad = torch.cat([t.grad.reshape(B, T, H * D) for t in ref_in], -1)
    torch.testing.assert_close(qkv.grad, ref_grad, rtol=0, atol=0)


def test_plain_versions_round_like_the_kernels_bf16():
    """In bf16 the plain forward rounds P to bf16 before P·V but sums
    the unrounded P into l: the output differs from an fp32 softmax by
    about one bf16 ulp, and the lse is fp32."""
    q, k, v, _ = _inputs(11, 1, 128, 2, 64)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    o, lse = fa.flash_fwd_reference(tq, tk, tv, True, 0.125)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (1, 2, 128)
    exact = dense_attention(tq.float(), tk.float(), tv.float(), True,
                            precision="highest")
    torch.testing.assert_close(o.float(), exact, rtol=2 ** -6, atol=1e-2)


@pytest.mark.parametrize("bad", ["unaligned", "cross_causal", "wide_head"])
def test_flash_rejects_what_it_does_not_take(bad):
    shapes = {"unaligned": ((1, 100, 2, 64), (1, 100, 2, 64)),
              "cross_causal": ((1, 256, 1, 64), (1, 128, 1, 64)),
              "wide_head": ((1, 128, 2, 256), (1, 128, 2, 256))}[bad]
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, causal=True)


def test_cpu_wrappers_count_no_launches():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 1, 128, 1, 64))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    fa.flash_bwd_dq(q, k, v, o, do, lse, True, 0.125)
    fa.flash_bwd_dkv(q, k, v, o, do, lse, True, 0.125)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before


def test_attention_dispatch_on_cpu():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(9, 1, 128, 2, 32))
    dense = multi_head_attention(q, k, v, impl="dense")
    # auto is dense on the CPU: the kernels run only on the card
    torch.testing.assert_close(multi_head_attention(q, k, v), dense,
                               rtol=0, atol=0)
    torch.testing.assert_close(multi_head_attention(q, k, v, impl="flash"),
                               dense, **TOL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        multi_head_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError):
        multi_head_attention(q, k, v, impl="flash",
                             bias=torch.zeros(1, 1, 1, 128))
    mask = torch.tensor([[1] * 100 + [0] * 28])
    bias = padding_bias(mask)
    assert bias.shape == (1, 1, 1, 128) and bias.dtype == torch.float32
    out = multi_head_attention(q, k, v, causal=False, bias=bias)
    torch.testing.assert_close(
        out, dense_attention(q, k[:, :100], v[:, :100], causal=False),
        **TOL)


@pytest.mark.parametrize("dtype,precision", [
    ("float32", "default"), ("bfloat16", "default"),
    ("bfloat16", "highest")])
def test_dense_attention_matches_xla_attention(dtype, precision):
    """The dense counterpart keeps xla_attention's precision rule: bf16
    scores under "default", fp32 under "highest". bf16 outputs agree to
    one bf16 ulp (2^-7 of the value) plus 1e-2: both round the scores
    and the probabilities to bf16, in different summation orders."""
    from ray_tpu.ops.attention import xla_attention
    q, k, v, _ = _inputs(13, 2, 64, 2, 32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo = jax.jit(functools.partial(xla_attention, causal=True,
                                   precision=precision),
                 compiler_options=FAST_COMPILE)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    to = dense_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                         causal=True, precision=precision)
    assert to.dtype == tdt
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), **tol)
