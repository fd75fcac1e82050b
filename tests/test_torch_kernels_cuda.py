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
"""
import numpy as np
import pytest
import torch

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
