"""Hand-written CUDA kernels of ray_tpu_torch against their plain
PyTorch versions, on the card.

Marked ``cuda``: skipped (decided in a fixture) where no CUDA device
is visible. This file imports no JAX, so it runs on a machine without
it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: fp32 inputs 1e-4 (abs and rel; the kernel and the plain
version sum in different orders, and the kernel multiplies q by
1/sqrt(D) before the dot product); bf16 inputs 4e-3 abs plus 2^-7 rel
(both compute in fp32 and round the output to bf16 once, so they may
differ by one bf16 ulp, at most 2^-7 of the value).

Flash attention (K3 forward, K4 dQ, K5 dK/dV): fp32 within 1e-4 abs
and rel of the plain versions; bf16 at the GPT-2-124M shape: the
output within 4e-3 + 2^-7·|ref| (one rounding of an fp32 result, as
K1), the gradients within 1e-2 + 2^-6·|ref| (they also round P and dS
to bf16 before the products, and the kernel rounds P under its running
maximum while the plain version uses the row's final one).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    return torch.device("cuda", 0)


def _layout(seed, B, H, KH, D, Pg, max_pages, n_pages, dtype, dev,
            positions=None, null_rows=()):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pv = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    perm = rng.permutation(n_pages - 1)[:B * max_pages] + 1
    pt = perm.reshape(B, max_pages).astype(np.int32)
    for b in null_rows:
        pt[b] = 0
    if positions is None:
        positions = rng.integers(0, max_pages * Pg, size=B)
    pos = np.asarray(positions, np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(q).to(dtype), t(pk).to(dtype), t(pv).to(dtype), t(pt),
            t(pos))


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_kernel_matches_plain_fp32(dev, rep, D):
    KH = 2
    args = _layout(rep * 1000 + D, 3, KH * rep, KH, D, 16, 4, 40,
                   torch.float32, dev)
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_position_zero_full_window_and_null_page(dev):
    B, KH, rep, D, Pg, mp = 4, 2, 4, 64, 8, 3
    args = _layout(7, B, KH * rep, KH, D, Pg, mp, 32, torch.float32, dev,
                   positions=[0, mp * Pg - 1, 5, 10**6], null_rows=(2,))
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    q, pk, pv, pt, _ = args
    # pos 0 attends one key: the output is V at position 0
    torch.testing.assert_close(out[0, 0], pv[0, pt[0, 0], 0],
                               rtol=1e-5, atol=1e-5)


def test_tinyllama_decode_shape_fp32_across_splits(dev):
    """The main-path shape in fp32, windows ending on each side of the
    split-K boundaries, so the merge of several splits is held at 1e-4."""
    split, Pg, mp = pa._SPLIT_KEYS, 64, 32
    positions = [0, split - 1, split, split + 1, 2 * split - 1, 2 * split,
                 Pg - 1, Pg, 5 * split - 1, 5 * split, 5 * split + 1,
                 mp * Pg - 2, mp * Pg - 1, 1000, 1500, 300]
    args = _layout(11, 16, 32, 4, 64, Pg, mp, 513, torch.float32, dev,
                   positions=positions)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_tinyllama_decode_shape_bf16(dev):
    args = _layout(3, 16, 32, 4, 64, 64, 32, 513, torch.bfloat16, dev)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=4e-3)


def test_launch_counter_counts_kernel_launches_only(dev):
    args = _layout(5, 2, 8, 2, 64, 8, 2, 16, torch.float32, dev)
    before = pa.paged_decode_attention.launches
    pa.paged_decode_attention(*args)
    pa.paged_decode_attention(*args)
    pa.paged_decode_attention_reference(*args)
    assert pa.paged_decode_attention.launches == before + 2


@pytest.mark.parametrize("bad", ["head_dim", "rep", "dtype", "int64",
                                 "noncontig"])
def test_kernel_refuses_what_it_does_not_take(dev, bad):
    q, pk, pv, pt, pos = _layout(9, 2, 8, 2, 64, 8, 2, 16, torch.float32,
                                 dev)
    if bad == "head_dim":
        q, pk, pv = q[..., :32].contiguous(), pk[..., :32].contiguous(), \
            pv[..., :32].contiguous()
    elif bad == "rep":
        q = torch.cat([q, q, q], dim=1)[:, :18].contiguous()
    elif bad == "dtype":
        q = q.half()
    elif bad == "int64":
        pt = pt.long()
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, pk, pv, pt, pos)


def test_engine_on_card_matches_cpu(dev):
    """The same fp32 weights served on the card (decode through the
    kernel) and on the CPU (plain version) give identical greedy
    streams."""
    from ray_tpu_torch.models.llama import build_model, init_params, \
        llama_tiny
    from ray_tpu_torch.serve.engine import LLMEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_tiny(dtype=torch.float32, dim=128, n_heads=2,
                     n_kv_heads=1)
    sd = init_params(cfg, seed=0, device="cpu")
    prompts = [[3], list(range(1, 9)), [4] * 9, list(range(1, 30))]
    streams = []
    for d in ("cpu", dev):
        eng = LLMEngine(build_model(cfg, sd, d), max_slots=4, page_size=8,
                        n_pages=64, chunk=4, device=d)
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        while eng.step():
            pass
        streams.append([h.result() for h in hs])
        assert eng.alloc.occupancy() == 0
    assert streams[0] == streams[1]


def test_bf16_deployment_on_card(dev):
    from ray_tpu_torch.models.llama import llama_tiny
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = llama_tiny(dim=256, n_heads=4, n_kv_heads=2)
    dep = LlamaDeployment(cfg, max_new_tokens=8, page_size=16, device=dev)
    try:
        before = pa.paged_decode_attention.launches
        out = dep([1, 2, 3])
        assert len(out) == 11 and out[:3] == [1, 2, 3]
        assert all(0 <= t < cfg.vocab_size for t in out)
        # one launch per layer for every decode step dispatched
        steps = dep.engine().stats["decode_steps"]
        assert steps >= 7
        assert (pa.paged_decode_attention.launches - before
                == steps * cfg.n_layers)
    finally:
        dep.shutdown()


# --------------------------------------------------------------------
# Flash attention: K3, K4, K5
# --------------------------------------------------------------------

def _flash_case(seed, B, T, H, D, dtype, dev, Tk=None):
    g = np.random.default_rng(seed)
    shapes = [(B, T, H, D), (B, Tk or T, H, D), (B, Tk or T, H, D),
              (B, T, H, D)]
    return [torch.from_numpy(g.standard_normal(s).astype(np.float32)).to(
        dev, dtype) for s in shapes]


def _flash_all(q, k, v, do, causal, scale, kernel):
    if kernel:
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        dq = fa.flash_bwd_dq(q, k, v, o, do, lse, causal, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, o, do, lse, causal, scale)
    else:
        o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
        dq = fa.flash_bwd_dq_reference(q, k, v, o, do, lse, causal, scale)
        dk, dv = fa.flash_bwd_dkv_reference(q, k, v, o, do, lse, causal,
                                            scale)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("T,D,causal", [
    (128, 64, True), (128, 64, False), (256, 64, True), (512, 64, False),
    (256, 128, True), (512, 128, True), (128, 128, False)])
def test_flash_kernels_match_plain_fp32(dev, T, D, causal):
    q, k, v, do = _flash_case(T + D, 2, T, 3, D, torch.float32, dev)
    scale = 1 / D ** 0.5
    out = _flash_all(q, k, v, do, causal, scale, kernel=True)
    torch.cuda.synchronize()
    ref = _flash_all(q, k, v, do, causal, scale, kernel=False)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("T,D,causal", [
    (128, 64, True), (512, 64, False), (256, 128, True), (256, 128, False)])
def test_flash_kernels_match_plain_bf16(dev, T, D, causal):
    """Every bf16 instantiation (D 64 and 128) at the bf16 limits."""
    q, k, v, do = _flash_case(T * D, 2, T, 3, D, torch.bfloat16, dev)
    out = _flash_all(q, k, v, do, causal, 1 / D ** 0.5, kernel=True)
    ref = _flash_all(q, k, v, do, causal, 1 / D ** 0.5, kernel=False)
    limits = [(4e-3, 2 ** -7), (1e-4, 1e-4)] + [(1e-2, 2 ** -6)] * 3
    for name, a, b, (atol, rtol) in zip(("o", "lse", "dq", "dk", "dv"),
                                        out, ref, limits):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")


def test_flash_kernels_cross_length_non_causal(dev):
    q, k, v, do = _flash_case(4, 1, 128, 2, 64, torch.float32, dev, Tk=384)
    out = _flash_all(q, k, v, do, False, 0.125, kernel=True)
    ref = _flash_all(q, k, v, do, False, 0.125, kernel=False)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_flash_kernels_gpt2_shape_bf16(dev):
    """The GPT-2-124M attention shape (B 24, T 1024, H 12, D 64)."""
    q, k, v, do = _flash_case(1, 24, 1024, 12, 64, torch.bfloat16, dev)
    out = _flash_all(q, k, v, do, True, 0.125, kernel=True)
    ref = _flash_all(q, k, v, do, True, 0.125, kernel=False)
    limits = [(4e-3, 2 ** -7), (1e-4, 1e-4)] + [(1e-2, 2 ** -6)] * 3
    for name, a, b, (atol, rtol) in zip(("o", "lse", "dq", "dk", "dv"),
                                        out, ref, limits):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")


def test_flash_attention_on_strided_views_and_padded_head(dev):
    """q, k, v as column views of one fused projection (row stride 3C)
    with head_dim 16, padded to 64 by the wrapper; gradients through
    the kernels equal those of the dense fp32 path."""
    from ray_tpu_torch.ops.attention import dense_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.random.default_rng(2)
    B, T, H, D = 2, 256, 4, 16
    x = g.standard_normal((B, T, 3 * H * D)).astype(np.float32)
    grads = []
    for kernel in (True, False):
        qkv = torch.tensor(x, device=dev, requires_grad=True)
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        o = (fa.flash_attention(q, k, v) if kernel else
             dense_attention(q, k, v, precision="highest"))
        (o.float() ** 2).sum().backward()
        grads.append((o.detach(), qkv.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-4,
                               atol=1e-4)


def test_flash_launch_counters_count_kernel_launches_only(dev):
    q, k, v, do = _flash_case(6, 1, 128, 2, 64, torch.float32, dev)
    q.requires_grad_(True)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o = fa.flash_attention(q, k, v)
    o.backward(do)
    _flash_all(q.detach(), k, v, do, True, 0.125, kernel=False)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "length",
                                 "cross_causal", "mixed"])
def test_flash_kernels_refuse_what_they_do_not_take(dev, bad):
    q, k, v, _ = _flash_case(8, 1, 128, 2, 64, torch.float32, dev)
    causal = True
    if bad == "head_dim":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "length":
        q, k, v = (t[:, :96] for t in (q, k, v))
    elif bad == "cross_causal":
        k, v = (torch.cat([t, t], dim=1) for t in (k, v))
    else:
        k = k.bfloat16()
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, causal, 0.125)


def _gpt2_loss(model, b):
    from ray_tpu_torch.models.gpt2 import linear_cross_entropy
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    return linear_cross_entropy(model(x, return_features=True), model.wte,
                                y)


def _train(cfg, sd, batch, dev, steps):
    from ray_tpu_torch.models.gpt2 import build_model
    from ray_tpu_torch.train import spmd
    opt = spmd.adamw(1e-3, weight_decay=0.1)
    state = spmd.TrainState.create(build_model(cfg, sd, dev), opt)
    step = spmd.make_train_step(_gpt2_loss, opt)
    b = spmd.put_batch(batch, dev)
    out = []
    for _ in range(steps):
        state, m = step(state, b)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


def test_gpt2_train_step_fp32_card_matches_cpu(dev):
    from ray_tpu_torch.models.gpt2 import gpt2_tiny, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_tiny(n_ctx=128, dtype=torch.float32, attention_impl="flash")
    sd = init_params(cfg, 0, "cpu")
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)}
    before = fa.flash_bwd_dkv.launches
    card = _train(cfg, sd, batch, dev, 3)
    assert fa.flash_bwd_dkv.launches - before == 3 * cfg.n_layer
    cpu = _train(cfg, sd, batch, "cpu", 3)
    np.testing.assert_allclose(card, cpu, rtol=1e-4)


def test_gpt2_bf16_train_step_on_card(dev):
    from ray_tpu_torch.models.gpt2 import gpt2_tiny, init_params
    cfg = gpt2_tiny(n_ctx=256, n_embd=256, n_head=4, vocab_size=512)
    sd = init_params(cfg, 1, dev)
    batch = {"ids": np.random.RandomState(1).randint(
        0, cfg.vocab_size, (4, 257)).astype(np.int32)}
    counts = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq,
                                   fa.flash_bwd_dkv)]
    flash = _train(cfg, sd, batch, dev, 3)
    assert [f.launches - c for f, c in zip(
        (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv), counts)] == \
        [3 * cfg.n_layer] * 3
    losses = [m[0] for m in flash]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    dense = _train(dataclasses.replace(cfg, attention_impl="dense_fp32"),
                   sd, batch, dev, 1)
    assert abs(flash[0][0] - dense[0][0]) < 1e-2
    assert abs(flash[0][1] - dense[0][1]) < 0.02 * dense[0][1]
