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
import re

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
    before = (fa.flash_fwd.launches, fa.flash_bwd_delta.launches,
              fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    delta = fa.flash_bwd_delta(o, do)
    fa.flash_bwd_dq(q, k, v, o, do, lse, True, 0.125, delta)
    fa.flash_bwd_dkv(q, k, v, o, do, lse, True, 0.125)
    assert (fa.flash_fwd.launches, fa.flash_bwd_delta.launches,
            fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("B,T,H,D,causal", [
    (1, 256, 2, 64, True), (2, 128, 3, 128, False)])
def test_delta_reference_is_rowsum_of_jax_output(B, T, H, D, causal):
    """The delta pass's plain version is rowsum(dO * O) over the head
    dimension, [B, H, T] fp32, on JAX's forward output; the CPU wrapper
    returns the same."""
    q, k, v, do = _inputs(B + T + D, B, T, H, D)
    jfn = _jax_fwd_bwd if causal else _jax_fwd_bwd_full
    jo = np.array(jfn(*(jnp.asarray(x) for x in (q, k, v, do)))[0])
    want = (do.astype(np.float64) * jo).sum(-1).transpose(0, 2, 1)
    to, tdo = torch.from_numpy(jo), torch.from_numpy(do)
    delta = fa.flash_bwd_delta_reference(to, tdo)
    assert delta.shape == (B, H, T) and delta.dtype == torch.float32
    assert delta.is_contiguous()
    np.testing.assert_allclose(delta.numpy(), want, **TOL)
    torch.testing.assert_close(fa.flash_bwd_delta(to, tdo), delta, rtol=0,
                               atol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_on_a_passed_delta_matches_alone_and_jax(causal):
    """K4 and K5's wrappers given one delta (as the backward shares it)
    give exactly what they give forming it themselves, and JAX's
    gradients."""
    q, k, v, do = _inputs(21, 1, 256, 2, 64)
    jfn = _jax_fwd_bwd if causal else _jax_fwd_bwd_full
    _, jgrads = jfn(*(jnp.asarray(x) for x in (q, k, v, do)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_fwd(tq, tk, tv, causal, 0.125)
    delta = fa.flash_bwd_delta(o, tdo)
    shared = (fa.flash_bwd_dq(tq, tk, tv, o, tdo, lse, causal, 0.125,
                              delta=delta),
              *fa.flash_bwd_dkv(tq, tk, tv, o, tdo, lse, causal, 0.125,
                                delta=delta))
    alone = (fa.flash_bwd_dq(tq, tk, tv, o, tdo, lse, causal, 0.125),
             *fa.flash_bwd_dkv(tq, tk, tv, o, tdo, lse, causal, 0.125))
    for name, a, b, jg in zip("qkv", shared, alone, jgrads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(jg), **TOL,
                                   err_msg=f"d{name}")


def test_backward_forms_delta_once_for_k4_and_k5(monkeypatch):
    """One backward through ``flash_attention`` runs one delta pass and
    hands that same tensor to K4 and to K5."""
    seen = {"delta": [], "dq": [], "dkv": []}

    def spy(key, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen[key].append(out if key == "delta" else
                             args[8] if len(args) > 8 else kw["delta"])
            return out
        return wrapped

    monkeypatch.setattr(fa, "flash_bwd_delta",
                        spy("delta", fa.flash_bwd_delta))
    monkeypatch.setattr(fa, "flash_bwd_dq", spy("dq", fa.flash_bwd_dq))
    monkeypatch.setattr(fa, "flash_bwd_dkv", spy("dkv", fa.flash_bwd_dkv))
    q, k, v, do = _inputs(22, 1, 128, 2, 64)
    _torch_fwd_bwd(q, k, v, do, causal=True)
    assert [len(seen[key]) for key in ("delta", "dq", "dkv")] == [1, 1, 1]
    assert seen["dq"][0] is seen["delta"][0]
    assert seen["dkv"][0] is seen["delta"][0]


@pytest.mark.parametrize("name", ["q", "k", "v", "o", "do"])
@pytest.mark.parametrize("case", ["contiguous", "c_attn_view",
                                  "odd_row_stride"])
def test_bf16_tma_contract(case, name):
    """bf16 K3/K4/K5 and the delta pass copy tiles with TMA or 16-byte
    loads: each of K4's inputs (q, k, v, and o and dO, which the delta
    pass reads) must start on 16 bytes and step in whole 16 bytes, as
    contiguous tensors and GPT-2's c_attn column views do;
    ``_check_tma`` (run before every bf16 launch) refuses the rest."""
    bf16 = torch.bfloat16
    if case == "contiguous":
        t = torch.zeros(2, 128, 2, 64, dtype=bf16)
    elif case == "c_attn_view":
        qkv = torch.zeros(2, 128, 3 * 2 * 64, dtype=bf16)
        t = qkv.split(128, dim=-1)[1].view(2, 128, 2, 64)
        assert t.stride() == (128 * 384, 384, 64, 1)
    else:
        t = torch.zeros(2, 128, 2, 68, dtype=bf16)[..., :64]
    if case == "odd_row_stride":
        with pytest.raises(ValueError, match=f"{name}: .*16-byte"):
            fa._check_tma(**{name: t})
    else:
        fa._check_tma(**{name: t})


# ptxas -v's lines for dkv_sm90<64> (with the performance warning it
# gets) and dq_sm90<64>, as nvcc printed them building the tensor-core
# library for sm_90a
_PTXAS_REPORT = """\
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in the function '_ZN56_GLOBAL__N__56ccc7f5_23_flash_attention_sm90_cu_52498dfd8dkv_sm90ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_NS_7StridesES6_iiiif'
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__56ccc7f5_23_flash_attention_sm90_cu_52498dfd8dkv_sm90ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_NS_7StridesES6_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN56_GLOBAL__N__56ccc7f5_23_flash_attention_sm90_cu_52498dfd8dkv_sm90ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_NS_7StridesES6_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 161 registers, used 1 barriers
ptxas info    : Compile time = 91.057 ms
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__56ccc7f5_23_flash_attention_sm90_cu_52498dfd7dq_sm90ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16NS_7StridesEiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN56_GLOBAL__N__56ccc7f5_23_flash_attention_sm90_cu_52498dfd7dq_sm90ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16NS_7StridesEiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 155 registers, used 1 barriers
ptxas info    : Compile time = 71.572 ms
"""


def test_ptxas_summary_names_the_dq_kernel():
    """Phase 1 of chip_smoke.py reads the tensor-core library's ptxas
    report through ``_build.ptxas_summary``: each kernel instance, dq_sm90
    among them, with its registers, spills and performance warnings."""
    from ray_tpu_torch.ops import _build
    assert "dq_sm90" in fa._SM90_KERNELS
    summary = _build.ptxas_summary(_PTXAS_REPORT, fa._SM90_KERNELS)
    assert summary == {
        "dkv_sm90<64>": {"registers": 161, "spill_stores": 0,
                         "spill_loads": 0, "warnings": [
                             "wgmma.mma_async instructions are serialized "
                             "due to program dependence on compiler-"
                             "inserted WG.AR in divergent path"]},
        "dq_sm90<64>": {"registers": 155, "spill_stores": 0,
                        "spill_loads": 0, "warnings": []}}
    assert _build.ptxas_summary(_PTXAS_REPORT, ("fwd_sm90",)) == {}


def test_flash_sources_build_apart_with_ptxas_reports(tmp_path,
                                                      monkeypatch):
    """The scalar and the tensor-core sources are two libraries named by
    their own digests; each build leaves ptxas's report beside its
    library, and an unbuilt source has none. The tensor-core source
    defines every kernel phase 1 expects in its report, dq_sm90 among
    them."""
    from ray_tpu_torch.ops import _build
    paths = [_build.library_path(s) for s in (fa._SOURCE, fa._SOURCE_SM90)]
    assert paths[0].name.startswith("flash_attention-")
    assert paths[1].name.startswith("flash_attention_sm90-")
    assert "-v" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.ptxas_report(fa._SOURCE_SM90) == ""
    lib = _build.library_path(fa._SOURCE_SM90)
    lib.with_suffix(".ptxas.txt").write_text("ptxas info : Used 125 "
                                             "registers")
    assert "125 registers" in _build.ptxas_report(fa._SOURCE_SM90)
    assert _build.ptxas_report(fa._SOURCE) == ""
    text = (_build.CSRC / fa._SOURCE_SM90).read_text()
    for kernel in fa._SM90_KERNELS:
        assert re.search(rf"__global__[^;{{]*\b{kernel}\(", text), kernel
    assert 'extern "C" int flash_bwd_dq_sm90_launch(' in text


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
