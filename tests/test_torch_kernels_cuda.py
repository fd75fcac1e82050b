"""Hand-written CUDA kernels of ray_tpu_torch against their plain
PyTorch versions, on the card.

Marked ``cuda``: skipped (decided in a fixture) where no CUDA device
is visible. This file imports no JAX, so it runs on a machine without
it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: fp32 inputs 1e-4 (abs and rel; the kernel and the plain
version sum in different orders, and the kernel multiplies q by
1/sqrt(D) before the dot product), for K1 and for K2 (int8 pages,
dequantized in the same order by both); bf16 inputs 4e-3 abs plus 2^-7 rel
(both compute in fp32 and round the output to bf16 once, so they may
differ by one bf16 ulp, at most 2^-7 of the value; the tensor-core pass
of bf16 K1 and bf16-q K2 also rounds P to bf16, within the same limit,
as tests/test_torch_paged_attention.py's emulation of its rounding
shows against the JAX kernel on the CPU).

Flash attention (K3 forward, K4 dQ, K5 dK/dV): fp32 (the scalar
kernels) within 1e-4 abs and rel of the plain versions; bf16 (K3, K4
and K5 on the tensor cores): the output within 4e-3 + 2^-7·|ref| (one
rounding of an fp32 result, as K1), lse and the delta pass within
1e-4, the gradients within 1e-2 + 2^-6·|ref| (they also round P and dS
to bf16 before the products, and the forward rounds P under its
running maximum while the plain version uses the row's final one).
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
            positions=None, null_rows=(), int8=False):
    """(q, pk, pv, pt, pos) with pages in ``dtype`` from a standard
    normal; with ``int8`` (K2's inputs), int8 pages from
    integers(-127, 128) and their scales (sk, sv) from uniform(0.1, 2.0)
    appended."""
    rng = np.random.default_rng(seed)
    shape, sshape = (KH, n_pages, Pg, D), (KH, n_pages, 1)
    if int8:
        pk, pv = (rng.integers(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        scales = [rng.uniform(0.1, 2.0, sshape).astype(np.float32)
                  for _ in range(2)]
    else:
        pk, pv = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        scales = []
    perm = rng.permutation(n_pages - 1)[:B * max_pages] + 1
    pt = perm.reshape(B, max_pages).astype(np.int32)
    for b in null_rows:
        pt[b] = 0
    if positions is None:
        positions = rng.integers(0, max_pages * Pg, size=B)
    pos = np.asarray(positions, np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    page_dtype = torch.int8 if int8 else dtype
    return (t(q).to(dtype), t(pk).to(page_dtype), t(pv).to(page_dtype),
            t(pt), t(pos), *map(t, scales))


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


def _split_passes(names) -> dict:
    """How many of the profiler's device-kernel ``names`` are each
    decode split pass: the tensor-core split_sm90 over bf16 pages (bf16
    K1) and over int8 pages (bf16-q K2), the scalar split_kernel over
    bf16, fp32 and int8 pages."""
    return {
        "sm90": sum("::split_sm90<__nv_bfloat16" in n for n in names),
        "sm90_int8": sum("::split_sm90<signed char" in n for n in names),
        "scalar_bf16": sum("::split_kernel<__nv_bfloat16, __nv_bfloat16"
                           in n for n in names),
        "scalar_fp32": sum("::split_kernel<float, float" in n
                           for n in names),
        "scalar_int8": sum("::split_kernel<" in n and "signed char" in n
                           for n in names)}


def _device_kernel_names(fn):
    """Names of the kernels ``fn`` ran on the card, from torch.profiler.
    A session that is not the process's first can miss a kernel of its
    first calls (two of four in a bf16 flash forward and backward, on
    the H100), so each session runs ``fn`` once, then three spin kernels
    as a marker, then ``fn`` again, and only the kernels that start
    after the last marker ends are returned."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    assert marks, "the profiler recorded no marker kernel"
    return [e.name for e in events if e.time_range.start >= max(marks)]


@pytest.mark.parametrize("Pg", [8, 16, 64])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_bf16_k1_tensor_core_pass_matches_plain(dev, rep, D, Pg):
    """bf16 K1 (the tensor-core split pass) against the plain version
    in bf16: windows of one key, ending on each side of a split
    boundary and filling the page table, beyond it (clipped), a slot
    with no visible key, a row of null pages, and random ones."""
    split, L = pa._SPLIT_KEYS_BF16, 4 * pa._SPLIT_KEYS_BF16
    positions = [0, split - 1, split, split + 1, L - 1, L + 40, -1, 0,
                 2 * split + 5, 77]
    args = _layout(100 + rep * 10 + D + Pg, len(positions), 2 * rep, 2, D,
                   Pg, L // Pg, len(positions) * (L // Pg) + 1,
                   torch.bfloat16, dev, positions=positions,
                   null_rows=(7, 9))
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(*args)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=4e-3)
    assert bool((out[6] == 0).all())     # no visible key: zeros
    # one key: that key's value, exactly
    pv, pt = args[2], args[3]
    first = pv[:, pt[0, 0].long(), 0].repeat_interleave(rep, 0)
    torch.testing.assert_close(out[0], first, rtol=0, atol=0)


@pytest.mark.parametrize("split", [64, 128, 256])
def test_bf16_k1_every_split_size_matches_plain(dev, split):
    """The split sizes the tensor-core pass is built for (the profiling
    tool's sweep), at the TinyLlama decode shape, split boundaries
    included."""
    positions = [0, split - 1, split, split + 1, 3 * split - 1,
                 3 * split, 2047, 1000, 17, 64, 63, 65, 500, 1500, 1999,
                 128]
    args = _layout(21, 16, 32, 4, 64, 64, 32, 513, torch.bfloat16, dev,
                   positions=positions)
    out = pa._launch_kernel(*args, split_keys=split)
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=4e-3)


def test_bf16_k1_refuses_other_split_sizes(dev):
    args = _layout(22, 2, 8, 2, 64, 8, 4, 16, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="split_keys"):
        pa._launch_kernel(*args, split_keys=96)


def test_k1_passes_by_dtype(dev):
    """bf16 K1 runs the tensor-core pass over bf16 pages and bf16-q K2
    the one over int8 pages, never a scalar bf16-q template; fp32 K1
    and fp32-q K2 run the scalar one (the profiler's device-kernel
    names). Each call is that one launch: the splits merge inside it,
    and no merge kernel runs."""
    cases = {
        "sm90": _layout(23, 4, 16, 2, 64, 16, 8, 40, torch.bfloat16, dev),
        "scalar_fp32": _layout(24, 4, 16, 2, 64, 16, 8, 40, torch.float32,
                               dev),
        "sm90_int8": _layout(25, 4, 16, 2, 64, 16, 8, 40, torch.bfloat16,
                             dev, int8=True),
        "scalar_int8": _layout(25, 4, 16, 2, 64, 16, 8, 40, torch.float32,
                               dev, int8=True)}
    for want, args in cases.items():
        names = _device_kernel_names(
            lambda: pa.paged_decode_attention(*args))
        count = _split_passes(names)
        assert count == {k: int(k == want) for k in count}, (want, names)
        assert not any("merge_kernel" in n for n in names), names
        assert len(names) == 1, names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [False, True], ids=["K1", "K2"])
def test_repeated_calls_are_bitwise_identical(dev, int8, dtype):
    """Whichever split block of a slot ends last merges its splits, in
    a fixed order: three calls on the same inputs give the same bits,
    at the decode shape with many live splits."""
    args = _layout(27, 16, 32, 4, 64, 64, 32, 513, dtype, dev, int8=int8)
    outs = [pa.paged_decode_attention(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [False, True], ids=["K1", "K2"])
def test_merge_of_many_splits_matches_plain(dev, int8, dtype):
    """A 16,384-key window: with the smallest split each kernel takes,
    slots of 1 to 256 live splits, past the splits whose weights the
    merge keeps in shared memory (64) and over many rounds of loads."""
    split = 64 if dtype == torch.bfloat16 else pa._SPLIT_KEYS
    positions = [16383, 9000, 64 * split - 1, 64 * split, 8 * split,
                 8 * split - 1, 9 * split, 0]
    args = _layout(28, len(positions), 8, 2, 64, 64, 256,
                   256 * len(positions) + 1, dtype, dev,
                   positions=positions, int8=int8)
    out = pa._launch_kernel(*args[:5], split_keys=split,
                            scales_k=args[5] if int8 else None,
                            scales_v=args[6] if int8 else None)
    ref = pa.paged_decode_attention_reference(*args)
    tol = (dict(rtol=2.0 ** -7, atol=4e-3) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_bf16_k1_counts_one_launch_per_call(dev):
    args = _layout(26, 3, 8, 1, 128, 16, 4, 16, torch.bfloat16, dev)
    k1, k2 = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention.launches_int8)
    pa.paged_decode_attention(*args)
    pa.paged_decode_attention(*args)
    pa.paged_decode_attention_reference(*args)
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.launches_int8) == (k1 + 2, k2)


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


def test_generate_on_card_matches_cpu(dev):
    """Static-cache greedy ``generate`` on the card equals the CPU's for
    the same fp32 weights, and ``generate_stream`` gives its tokens."""
    from ray_tpu_torch.models.llama import (build_model, generate,
                                            generate_stream, init_params,
                                            llama_tiny)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_tiny(dtype=torch.float32, dim=128, n_heads=2, n_kv_heads=1)
    sd = init_params(cfg, seed=0, device="cpu")
    prompt = np.random.RandomState(0).randint(1, 200, (2, 9))
    cpu = generate(build_model(cfg, sd, "cpu"), prompt, 20)
    model = build_model(cfg, sd, dev)
    card = generate(model, prompt, 20)
    assert card.device.type == "cuda" and card.dtype == torch.int32
    assert torch.equal(card.cpu(), cpu)
    rows = list(generate_stream(model, prompt, 20, chunk_size=8))
    np.testing.assert_array_equal(np.stack(rows, axis=1),
                                  cpu[:, 9:].numpy())


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
# K2: int8 pages with per-page fp32 scales
# --------------------------------------------------------------------

@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_k2_matches_plain_fp32(dev, rep, D):
    args = _layout(rep * 100 + D, 3, 2 * rep, 2, D, 16, 4, 40,
                   torch.float32, dev, int8=True)
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_k2_position_zero_full_window_and_null_page(dev):
    args = _layout(17, 4, 8, 2, 64, 8, 3, 32, torch.float32, dev,
                   positions=[0, 3 * 8 - 1, 5, 12], null_rows=(2,),
                   int8=True)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    _q, _pk, pv, pt, _pos, _sk, sv = args
    v0 = pv[0, pt[0, 0], 0].float() * (sv[0, pt[0, 0], 0] * (1 / 127))
    torch.testing.assert_close(out[0, 0], v0, rtol=1e-5, atol=1e-5)


def test_k2_tinyllama_decode_shape_fp32_across_splits(dev):
    split, Pg, mp = pa._SPLIT_KEYS, 64, 32
    positions = [0, split - 1, split, split + 1, 2 * split - 1, 2 * split,
                 Pg - 1, Pg, 5 * split - 1, 5 * split, 5 * split + 1,
                 mp * Pg - 2, mp * Pg - 1, 1000, 1500, 300]
    args = _layout(21, 16, 32, 4, 64, Pg, mp, 513, torch.float32, dev,
                   positions=positions, int8=True)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_k2_tinyllama_decode_shape_bf16(dev):
    args = _layout(23, 16, 32, 4, 64, 64, 32, 513, torch.bfloat16, dev,
                   int8=True)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=4e-3)


def _contrast_scales(args):
    """K2's inputs with the scales of every slot's odd logical pages
    times 1e-6, so neighbouring pages' scales differ by 10^6 and a key
    read with another page's scale shows."""
    q, pk, pv, pt, pos, sk, sv = args
    odd = pt[:, 1::2].reshape(-1).long()
    odd = odd[odd > 0]
    sk, sv = sk.clone(), sv.clone()
    sk[:, odd] *= 1e-6
    sv[:, odd] *= 1e-6
    return q, pk, pv, pt, pos, sk, sv


@pytest.mark.parametrize("Pg", [8, 16, 64])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_bf16_k2_tensor_core_pass_matches_plain(dev, rep, D, Pg):
    """bf16-q K2 (the tensor-core pass over int8 pages) against the
    plain version: windows of one key, ending on each side of a split
    boundary and filling the page table, beyond it (clipped), a slot
    with no visible key, a row of null pages, and random ones; scales
    10^6 apart between neighbouring pages."""
    split, L = pa._SPLIT_KEYS_BF16, 4 * pa._SPLIT_KEYS_BF16
    positions = [0, split - 1, split, split + 1, L - 1, L + 40, -1, 0,
                 2 * split + 5, 77]
    args = _contrast_scales(_layout(
        300 + rep * 10 + D + Pg, len(positions), 2 * rep, 2, D, Pg,
        L // Pg, len(positions) * (L // Pg) + 1, torch.bfloat16, dev,
        positions=positions, null_rows=(7, 9), int8=True))
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(*args)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=4e-3)
    assert bool((out[6] == 0).all())     # no visible key: zeros
    # one key: that key's dequantized value, within two bf16 roundings
    # (P * s_v / 127, then the output)
    _q, _pk, pv, pt, _pos, _sk, sv = args
    page = pt[0, 0].long()
    first = pv[:, page, 0].float() * (sv[:, page] / 127.0)
    torch.testing.assert_close(out[0].float(),
                               first.repeat_interleave(rep, 0),
                               rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("split", [64, 128, 256])
def test_bf16_k2_every_split_size_matches_plain(dev, split):
    """The split sizes the tensor-core pass is built for, over int8
    pages at the TinyLlama decode shape, split boundaries included."""
    positions = [0, split - 1, split, split + 1, 3 * split - 1,
                 3 * split, 2047, 1000, 17, 64, 63, 65, 500, 1500, 1999,
                 128]
    args = _contrast_scales(_layout(
        31, 16, 32, 4, 64, 64, 32, 513, torch.bfloat16, dev,
        positions=positions, int8=True))
    out = pa._launch_kernel(*args[:5], split_keys=split, scales_k=args[5],
                            scales_v=args[6])
    ref = pa.paged_decode_attention_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=4e-3)


def test_bf16_k2_refuses_other_split_sizes(dev):
    args = _layout(32, 2, 8, 2, 64, 8, 4, 16, torch.bfloat16, dev,
                   int8=True)
    with pytest.raises(ValueError, match="split_keys"):
        pa._launch_kernel(*args[:5], split_keys=96, scales_k=args[5],
                          scales_v=args[6])


def test_k2_counts_its_own_launches(dev):
    args = _layout(25, 2, 8, 2, 64, 8, 2, 16, torch.float32, dev, int8=True)
    k1, k2 = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention.launches_int8)
    pa.paged_decode_attention(*args)
    pa.paged_decode_attention_reference(*args)
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.launches_int8) == (k1, k2 + 1)


@pytest.mark.parametrize("bad", ["head_dim", "rep", "q_dtype", "pages_fp",
                                 "scale_dtype", "scale_shape", "one_scale",
                                 "noncontig_scale"])
def test_k2_refuses_what_it_does_not_take(dev, bad):
    q, pk, pv, pt, pos, sk, sv = _layout(27, 2, 8, 2, 64, 8, 2, 16,
                                         torch.float32, dev, int8=True)
    err = ValueError
    if bad == "head_dim":
        q, pk, pv = (t[..., :32].contiguous() for t in (q, pk, pv))
    elif bad == "rep":
        q = torch.cat([q, q, q], dim=1)[:, :18].contiguous()
    elif bad == "q_dtype":
        q = q.half()
    elif bad == "pages_fp":
        pk, pv = pk.float(), pv.float()
        err = pa.PagedShapeError
    elif bad == "scale_dtype":
        sk = sk.double()
    elif bad == "scale_shape":
        sk, sv = sk[:, :, 0], sv[:, :, 0]
        err = pa.PagedShapeError
    elif bad == "one_scale":
        sv = None
        err = pa.PagedShapeError
    else:
        sk = torch.cat([sk, sk], dim=2)[:, :, :1]
    with pytest.raises(err):
        pa.paged_decode_attention(q, pk, pv, pt, pos, sk, sv)


def test_int8_prefix_engine_on_card_matches_cpu(dev):
    """The int8 pool with the prefix cache, the same fp32 weights on the
    card (K2) and on the CPU (plain version): identical greedy streams
    over a cold wave, a fully cached page-aligned repeat (the COW path)
    and a prompt sharing its first page; both engines leak-free."""
    from ray_tpu_torch.models.llama import build_model, init_params, \
        llama_tiny
    from ray_tpu_torch.serve.engine import LLMEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_tiny(dtype=torch.float32, dim=128, n_heads=2,
                     n_kv_heads=1)
    sd = init_params(cfg, seed=0, device="cpu")
    waves = [[[3], list(range(1, 9)), [4] * 9, list(range(1, 30))],
             [list(range(1, 9)), list(range(1, 9)) + [7] * 6]]
    streams = []
    for d in ("cpu", dev):
        eng = LLMEngine(build_model(cfg, sd, d), max_slots=4, page_size=8,
                        n_pages=64, chunk=4, kv_dtype="int8",
                        prefix_cache=True, device=d)
        k2 = pa.paged_decode_attention.launches_int8
        out = []
        for wave in waves:
            hs = [eng.submit(p, max_new_tokens=12) for p in wave]
            while eng.step():
                pass
            out.append([h.result() for h in hs])
        streams.append(out)
        assert eng.stats["cache_hit_admissions"] == 2
        assert eng.alloc.occupancy() == eng.prefix_cache.cached_pages
        eng.prefix_cache.check_invariants()
        if d != "cpu":
            assert (pa.paged_decode_attention.launches_int8 - k2
                    == eng.stats["decode_steps"] * cfg.n_layers)
    assert streams[0] == streams[1]


def _engine_case(d):
    """A reduced fp32 Llama on ``d`` (the same weights everywhere) and
    an engine factory over it."""
    from ray_tpu_torch.models.llama import build_model, init_params, \
        llama_tiny
    from ray_tpu_torch.serve.engine import LLMEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_tiny(dtype=torch.float32, dim=128, n_heads=2,
                     n_kv_heads=1)
    model = build_model(cfg, init_params(cfg, seed=0, device="cpu"), d)
    return lambda **kw: LLMEngine(model, device=d, **{
        **dict(max_slots=4, page_size=8, n_pages=64, chunk=4), **kw})


_WAVE = [[3], list(range(1, 9)), [4] * 9, [5, 6, 7, 8] * 5]


def _wave(eng, n=16):
    hs = [eng.submit(p, max_new_tokens=n) for p in _WAVE]
    while eng.step():
        pass
    return [h.result() for h in hs], [h.logprobs for h in hs]


def test_verify_dispatch_on_card_matches_cpu(dev):
    """One speculative verify (``_verify_step``: the paged T > 1 forward
    at each row's own offset, argmax read back) over the same pool
    contents and rows: the same argmax on the card and on the CPU."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, (4, 32)).astype(np.int32)
    ids = rng.integers(0, 256, (4, 5)).astype(np.int32)
    start = np.asarray([0, 7, 8, 30], np.int32)
    pt = np.arange(1, 4 * 8 + 1, dtype=np.int32).reshape(4, 8)
    out = []
    for d in ("cpu", dev):
        eng = _engine_case(d)()
        # the pages the rows attend to hold one 32-token prefill each
        eng._prefill_step(prompt, np.zeros(4, np.int32),
                          np.full(4, 31, np.int32), pt)
        out.append(eng._verify_step(ids, start, pt))
    assert out[0].shape == (4, 5) and (out[0] == out[1]).all()


def test_overlapped_streams_on_card_equal_lockstep(dev):
    """The overlapped loop (with an eos mid-stream, with and without
    speculation) gives the lockstep loop's streams on the card. Each
    decode dispatch is queued behind a ~50 ms spin kernel, so the card
    runs behind the host and the next round is really planned while
    the newest dispatch is unfinished (its event not done): two
    dispatches in flight. The decode chunk is 2 (dispatches of at most
    4 steps, ~600 kernels): a dispatch of more kernels than CUDA's
    launch queue holds blocks the host behind the spin until the card
    catches up."""
    make = _engine_case(dev)
    base, _ = _wave(make(overlap=False))
    eos = next(t for i, t in enumerate(base[0]) if i >= 4
               and t not in base[0][:i])
    want = [s[:s.index(eos) + 1] if eos in s else s for s in base]
    for kw in (dict(overlap=False), dict(overlap=True),
               dict(overlap=True, spec_len=4, spec_ngram=1)):
        eng = make(eos_id=eos, chunk=2, **kw)
        depths = []
        dispatch = eng._dispatch_chunk_locked

        def lagged(steps, dispatch=dispatch, eng=eng, depths=depths):
            torch.cuda._sleep(100_000_000)
            dispatch(steps)
            depths.append(eng._report_locked()["fetchq_depth"])

        eng._dispatch_chunk_locked = lagged
        assert _wave(eng)[0] == want, kw
        del eng._dispatch_chunk_locked
        assert eng.alloc.occupancy() == 0
        # lockstep drains before planning; the overlapped loop holds
        # two (a verify round drains first, so speculation may hold one)
        assert max(depths) == {False: 1, True: 2}[kw["overlap"]] or (
            "spec_len" in kw and max(depths) == 1)


def test_captured_logprobs_on_card_match_cpu(dev):
    """Logprob capture: the same greedy streams on the card and on the
    CPU, logprobs within 1e-4 and as many as tokens."""
    got = [_wave(_engine_case(d)(capture_logprobs=True))
           for d in ("cpu", dev)]
    assert got[0][0] == got[1][0]
    for toks, a, b in zip(got[0][0], got[0][1], got[1][1]):
        assert len(a) == len(b) == len(toks)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def _pull(make, kv_dtype, prompt, n_prefix):
    """A donor engine serves ``prompt``'s first ``n_prefix`` tokens plus
    a tail; a requester (both from ``make``) pulls that prefix over the
    JSON + base64 loopback wire and serves ``prompt``. Returns its
    stream, its re-export of the landed pages, the donor's export of
    them and the requester."""
    from ray_tpu_torch.serve import kv_migration as km
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    donor_eng = make(kv_dtype=kv_dtype, prefix_cache=True)
    h = donor_eng.submit(prompt[:n_prefix] + [7, 7, 7], max_new_tokens=4)
    while donor_eng.step():
        pass
    h.result()
    donor = km.KVDonor(donor_eng)
    req = make(kv_dtype=kv_dtype, prefix_cache=True)
    req.kv_fetcher = lambda pull: km.pull_prefix(
        km.loopback_call(donor), pull["hashes"],
        stats=req.kv_migration_stats)
    hashes = path_hashes(prompt[:n_prefix], req.Pg)
    h = req.submit(prompt, max_new_tokens=8, pull={"hashes": hashes})
    while req.step():
        pass
    out = h.result()
    from ray_tpu_torch.models.kv_cache import export_page_bytes
    exports = []
    for eng in (req, donor_eng):
        pages = eng.kv_pin_prefix(hashes)
        exports.append(eng.kv_export_pages(pages))
        # the engine's batched export gives the per-page export's bytes
        assert exports[-1] == [export_page_bytes(eng.pages, p)
                               for p in pages]
        eng.kv_release_pages(pages)
    assert donor.open_transfers() == 0
    assert donor_eng.prefix_cache.evictable_pages() \
        == donor_eng.prefix_cache.cached_pages
    return out, exports[0], exports[1], req


@pytest.mark.parametrize("kv_dtype,dtype", [
    ("fp", torch.float32), ("fp", torch.bfloat16), ("int8", torch.float32)],
    ids=["fp32", "bf16", "int8"])
def test_pull_between_card_engines_lands_donor_bytes(dev, kv_dtype, dtype):
    """A pull between two small engines on the card: the landed pages
    hold the donor's bytes exactly (re-exported from the requester),
    the pull is counted with no fallback, and the stream equals a cold
    recompute on the card (fp32 and int8: the same device, the same
    prefill shape)."""
    from ray_tpu_torch.models.llama import build_model, init_params, \
        llama_tiny
    from ray_tpu_torch.serve.engine import LLMEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama_tiny(dtype=dtype, dim=128, n_heads=2, n_kv_heads=1)
    model = build_model(cfg, init_params(cfg, seed=0, device="cpu"), dev)

    def make(**kw):
        return LLMEngine(model, max_slots=4, page_size=8, n_pages=64,
                         chunk=4, device=dev, **kw)

    prompt = list(range(1, 33)) + [40, 41, 42]
    out, landed, donor_bytes, req = _pull(make, kv_dtype, prompt, 32)
    assert len(landed) == 4 and landed == donor_bytes
    st = req.kv_migration_stats
    assert (st["pulled_pages"], st["fallbacks"], st["aborts"]) == (4, 0, 0)
    assert req.stats["cache_hit_tokens"] == 32 and len(out) == 8
    if dtype == torch.float32:
        cold = make(kv_dtype=kv_dtype)
        h = cold.submit(prompt, max_new_tokens=8)
        while cold.step():
            pass
        assert out == h.result()


def test_fp32_swap_on_card_is_token_identical(dev):
    """A preempt-mode swap on the card, mid-request, to the same fp32
    weights staged from the host under a new id: the stream equals an
    unswapped run, the fence reads 1, and the staged model is a new
    module (the serving one is never written)."""
    make = _engine_case(dev)
    want, _ = _wave(make())
    eng = make(prefix_cache=True)
    old_model = eng.model
    sd = {k: v.detach().cpu() for k, v in old_model.state_dict().items()}
    hs = [eng.submit(p, max_new_tokens=16) for p in _WAVE]
    eng.step()                 # prefills and a first decode chunk
    assert any(s is not None for s in eng.slots)
    assert eng.swap_weights(sd, weights_id="same-v2") == 1
    while eng.step():
        pass
    assert [h.result() for h in hs] == want
    assert eng.load_report()["weight_generation"] == 1
    assert eng.model is not old_model
    assert eng.stats["preemptions"] >= 1
    assert eng.alloc.occupancy() == eng.prefix_cache.cached_pages


def _outcome(h):
    try:
        return ("ok", h.result())
    except Exception as e:  # noqa: BLE001 - the record names the type
        return ("err", type(e).__name__, str(e))


def test_decode_dispatch_fault_on_card_matches_cpu(dev):
    """A decode-dispatch fault on one rider, on the card and on the
    CPU: the culprit fails typed, its co-rider requeues once and its
    stream, the counters and the quiesced pool are the same on both."""
    from ray_tpu_torch.serve.faults import FaultInjector, check_quiesced
    rec = []
    for d in ("cpu", dev):
        inj = FaultInjector()
        inj.inject("dispatch_decode", sid=1, round=3)
        eng = _engine_case(d)(chunk=2, fault_injector=inj,
                              retry_backoff_s=0.005)
        hs = [eng.submit(p, max_new_tokens=16) for p in _WAVE[:2]]
        while eng.step():
            pass
        check_quiesced(eng)
        rec.append(([_outcome(h) for h in hs], eng.lifecycle_stats()))
    assert rec[0] == rec[1]
    outs, life = rec[1]
    assert outs[1] == ("err", "RuntimeError",
                       "injected fault at dispatch_decode")
    assert outs[0][0] == "ok" and len(outs[0][1]) == 16
    assert (life["contained_faults"], life["retries"],
            life["fault_failed"]) == (1, 1, 1)


def test_lone_slot_exhaustion_on_card_matches_cpu(dev):
    """A donor pin leaves a lone slot unable to grow: on the card as on
    the CPU only that request fails (the reference's error), the other
    is served, the engine keeps serving, and the pool quiesces once the
    pin drops."""
    from ray_tpu_torch.serve.faults import check_quiesced
    from ray_tpu_torch.serve.prefix_cache import path_hashes
    rec = []
    for d in ("cpu", dev):
        eng = _engine_case(d)(max_slots=2, n_pages=9, prefix_cache=True)
        prefix = list(range(1, 33))
        eng.submit(prefix, max_new_tokens=1)
        while eng.step():
            pass
        pinned = eng.kv_pin_prefix(path_hashes(prefix, 8))
        hs = [eng.submit(list(range(40, 56)), max_new_tokens=40),
              eng.submit([5, 9, 2], max_new_tokens=2)]
        while eng.step():
            pass
        after = eng.submit([4, 4, 8], max_new_tokens=6)
        while eng.step():
            pass
        eng.kv_release_pages(pinned)
        check_quiesced(eng)
        rec.append(([_outcome(h) for h in hs + [after]],
                    eng.lifecycle_stats(), eng.load_report()["stopped"]))
    assert rec[0] == rec[1]
    outs, life, stopped = rec[1]
    assert outs[0] == ("err", "RequestError",
                       "request 1: page pool exhausted by one slot")
    assert outs[1][0] == outs[2][0] == "ok" and not stopped
    assert (life["contained_faults"], life["fault_failed"]) == (1, 1)


def _reduced_model(d):
    """The reduced fp32 Llama of ``_engine_case`` on ``d``."""
    from ray_tpu_torch.models.llama import build_model, init_params, \
        llama_tiny
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama_tiny(dtype=torch.float32, dim=128, n_heads=2,
                     n_kv_heads=1)
    return build_model(cfg, init_params(cfg, seed=0, device="cpu"), d)


_POOL_WAVE = [[3, 9, 4], list(range(1, 17)), [4] * 17, [5, 6, 7, 8] * 5,
              list(range(30, 60)), [7] * 5]


def test_pool_kill_on_card_matches_cpu(dev):
    """chip_smoke's phase 3 pool case: two engines of a pool, every
    request routed before the first round, replica 0 killed at its round
    6. On the card as on the CPU: the same routes, the same requests
    resubmitted (and served by replica 1) or failed typed, the same
    streams and pool events."""
    import chip_smoke
    rec = [chip_smoke._pool_kill_case(_reduced_model(d), str(d),
                                      _POOL_WAVE, 16)
           for d in ("cpu", dev)]
    assert rec[0] == rec[1]
    kinds = [k for k, _r in rec[1]["events"]]
    assert kinds.count("replica_death") == 1
    assert rec[1]["counters"]["requeues"] == kinds.count("resubmit")
    assert {o[1] for o in rec[1]["out"] if o[0] == "err"} <= \
        {"EngineShutdown"}


def test_engine_events_on_card_match_cpu(dev, tmp_path):
    """chip_smoke's phase 3 event case: one engine with a contained
    decode fault and ``flight_dir``; the event log (kinds, requests,
    slots, data but times), ``sched_trace`` and the flight bundle's
    culprit are the same on the card as on the CPU."""
    import chip_smoke
    rec = []
    for d in ("cpu", dev):
        flight = tmp_path / str(d).replace(":", "-")
        flight.mkdir()
        rec.append(chip_smoke._event_case(_reduced_model(d), str(d),
                                          _POOL_WAVE, 16, str(flight)))
    assert rec[0] == rec[1]
    assert rec[1]["culprit"][0] == "engine-fault"
    kinds = [e[0] for e in rec[1]["events"]]
    assert {"submit", "admit", "prefill", "decode", "fault", "requeue",
            "fault_failed", "first_token", "emit", "retire",
            "round"} <= set(kinds)


def test_disagg_handoff_on_card_matches_cpu(dev):
    """chip_smoke's phase 3 disaggregated case: one prefill and one
    decode engine; on the card as on the CPU the same streams, pool
    events, handoffs and pulls (the decode leg lands the prompt's full
    pages from the prefill replica)."""
    import chip_smoke
    rec = [chip_smoke._disagg_case(_reduced_model(d), str(d), _POOL_WAVE,
                                   16) for d in ("cpu", dev)]
    assert rec[0] == rec[1]
    assert (rec[1]["handoffs"], rec[1]["fallbacks"]) == (len(_POOL_WAVE),
                                                         0)
    assert rec[1]["pulls"]["pulled_pages"] == sum(
        len(p) // 16 for p in _POOL_WAVE)


def test_watchdog_wedge_on_card_matches_cpu(dev, tmp_path):
    """chip_smoke's phase 3 watchdog case: a hang at replica 0's round 6
    under a ``PoolWatchdog``; on the card as on the CPU the same routes,
    outcomes, suspect -> wedged -> death sequence and counters, and the
    released zombie commits nothing."""
    import chip_smoke
    rec = []
    for d in ("cpu", dev):
        flight = tmp_path / str(d).replace(":", "-")
        flight.mkdir()
        rec.append(chip_smoke._watchdog_case(_reduced_model(d), str(d),
                                             _POOL_WAVE, 16, str(flight)))
    for r in rec:
        # the survivor may be suspected while a resubmit wakes it from
        # idle, and must recover; whether it is depends on timing
        alarms = r.pop("survivor_alarms")
        assert alarms == ["suspect", "recovered"] * (len(alarms) // 2)
    assert rec[0] == rec[1]
    assert rec[1]["log"] == [("suspect", 0), ("wedged", 0)]
    assert rec[1]["zombie_committed_nothing"] and rec[1]["bundle"]
    assert rec[1]["counters"]["wedged"] == 1


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


_BF16_LIMITS = [(4e-3, 2 ** -7), (1e-4, 1e-4)] + [(1e-2, 2 ** -6)] * 3


def _assert_bf16_close(out, ref):
    for name, a, b, (atol, rtol) in zip(("o", "lse", "dq", "dk", "dv"),
                                        out, ref, _BF16_LIMITS):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("T,D,causal", [
    (128, 64, True), (128, 64, False), (192, 64, True), (192, 64, False),
    (512, 64, True), (512, 64, False), (1024, 64, True), (128, 128, True),
    (128, 128, False), (192, 128, True), (192, 128, False),
    (256, 128, True), (256, 128, False), (512, 128, True),
    (512, 128, False), (1024, 128, False)])
def test_flash_kernels_match_plain_bf16(dev, T, D, causal):
    """The tensor-core K3/K4/K5 in bf16 at D 64 and 128, one tile, a
    trailing 64-row tile past a 128 multiple (T 192), several tiles, at
    the bf16 limits."""
    q, k, v, do = _flash_case(T * D, 2, T, 3, D, torch.bfloat16, dev)
    out = _flash_all(q, k, v, do, causal, 1 / D ** 0.5, kernel=True)
    ref = _flash_all(q, k, v, do, causal, 1 / D ** 0.5, kernel=False)
    _assert_bf16_close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_cross_length_non_causal(dev, dtype):
    q, k, v, do = _flash_case(4, 1, 128, 2, 64, dtype, dev, Tk=384)
    out = _flash_all(q, k, v, do, False, 0.125, kernel=True)
    ref = _flash_all(q, k, v, do, False, 0.125, kernel=False)
    if dtype == torch.bfloat16:
        _assert_bf16_close(out, ref)
    else:
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_flash_kernels_gpt2_shape_bf16(dev):
    """The GPT-2-124M attention shape (B 24, T 1024, H 12, D 64)."""
    q, k, v, do = _flash_case(1, 24, 1024, 12, 64, torch.bfloat16, dev)
    out = _flash_all(q, k, v, do, True, 0.125, kernel=True)
    ref = _flash_all(q, k, v, do, True, 0.125, kernel=False)
    _assert_bf16_close(out, ref)


def test_flash_kernels_tinyllama_training_shape_bf16(dev):
    """The TinyLlama-1.1B training attention shape (B 8, T 1024, H 32, D
    64, causal), K and V of 4 kv heads repeated per head as the
    cache-free Llama forward gives them (``repeat_interleave``)."""
    q, k, v, do = _flash_case(2, 8, 1024, 32, 64, torch.bfloat16, dev)
    k, v = (x[:, :, :4].repeat_interleave(8, dim=2) for x in (k, v))
    out = _flash_all(q, k, v, do, True, 0.125, kernel=True)
    ref = _flash_all(q, k, v, do, True, 0.125, kernel=False)
    _assert_bf16_close(out, ref)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_on_strided_qkv_views_bf16(dev, D):
    """bf16 q, k, v as the column views of one fused projection (row
    stride 3C, GPT-2's c_attn layout), read in place by the tensor maps;
    o and dO strided the same way."""
    g = np.random.default_rng(D)
    B, T, H = 2, 256, 3
    qkv, odo = (torch.from_numpy(g.standard_normal(
        (B, T, n * H * D)).astype(np.float32)).to(dev, torch.bfloat16)
        for n in (3, 2))
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    _, do = (t.view(B, T, H, D) for t in odo.split(H * D, dim=-1))
    assert q.stride(1) == 3 * H * D and not q.is_contiguous()
    out = _flash_all(q, k, v, do, True, 1 / D ** 0.5, kernel=True)
    ref = _flash_all(q, k, v, do, True, 1 / D ** 0.5, kernel=False)
    _assert_bf16_close(out, ref)
    # the backward kernels (and their delta pass) on a strided o as well
    o = odo[..., :H * D].view(B, T, H, D).copy_(out[0])
    dq = fa.flash_bwd_dq(q, k, v, o, do, out[1], True, 1 / D ** 0.5)
    dk, dv = fa.flash_bwd_dkv(q, k, v, o, do, out[1], True, 1 / D ** 0.5)
    torch.testing.assert_close((dq.float(), dk.float(), dv.float()),
                               (out[2].float(), out[3].float(),
                                out[4].float()), rtol=0, atol=0)


@pytest.mark.parametrize("B,T,H,D,causal", [
    (2, 256, 3, 64, True), (2, 192, 3, 128, False),
    (24, 1024, 12, 64, True)])
def test_flash_backward_on_shared_delta_matches_alone(dev, B, T, H, D,
                                                      causal):
    """bf16 K4 and K5 on one delta from ``flash_bwd_delta`` (as a
    backward runs them) give exactly what each gives alone, running its
    own pass; the pass is within 1e-4 of its plain version."""
    q, k, v, do = _flash_case(B * T + D, B, T, H, D, torch.bfloat16, dev)
    scale = 1 / D ** 0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_bwd_delta(o, do)
    torch.testing.assert_close(delta, fa.flash_bwd_delta_reference(o, do),
                               rtol=1e-4, atol=1e-4)
    shared = (fa.flash_bwd_dq(q, k, v, o, do, lse, causal, scale, delta),
              *fa.flash_bwd_dkv(q, k, v, o, do, lse, causal, scale, delta))
    alone = (fa.flash_bwd_dq(q, k, v, o, do, lse, causal, scale),
             *fa.flash_bwd_dkv(q, k, v, o, do, lse, causal, scale))
    for a, b in zip(shared, alone):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_backward_runs_the_tensor_core_kernels(dev):
    """One bf16 forward and backward through ``flash_attention`` runs
    fwd_sm90, one delta pass, dq_sm90 and dkv_sm90 on the card (the
    profiler's kernel names), and no scalar flash kernel."""
    q, k, v, do = _flash_case(9, 2, 256, 3, 64, torch.bfloat16, dev)
    q.requires_grad_(True)
    names = _device_kernel_names(
        lambda: fa.flash_attention(q, k, v).backward(do))
    count = {kern: sum(f"::{kern}<64>" in n for n in names)
             for kern in ("fwd_sm90", "delta_kernel", "dq_sm90",
                          "dkv_sm90", "fwd_kernel", "bwd_dq_kernel",
                          "bwd_dkv_kernel")}
    assert count == {"fwd_sm90": 1, "delta_kernel": 1, "dq_sm90": 1,
                     "dkv_sm90": 1, "fwd_kernel": 0, "bwd_dq_kernel": 0,
                     "bwd_dkv_kernel": 0}


def test_fp32_kernels_take_no_delta(dev):
    """The fp32 kernels form delta themselves: there is no fp32 delta
    pass, and a delta handed to fp32 K4 or K5 is refused."""
    q, k, v, do = _flash_case(10, 1, 128, 2, 64, torch.float32, dev)
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    delta = fa.flash_bwd_delta_reference(o, do)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_bwd_delta(o, do)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_bwd_dq(q, k, v, o, do, lse, True, 0.125, delta)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_bwd_dkv(q, k, v, o, do, lse, True, 0.125, delta)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_counters_count_kernel_launches_only(dev, dtype):
    """One forward and backward through ``flash_attention`` adds one to
    each kernel's count, in either dtype (bf16 through the tensor-core
    K3/K4/K5, fp32 through the scalar ones); the delta pass counts apart
    from K4 and K5, once per bf16 backward, and fp32 has none; the plain
    versions add nothing."""
    q, k, v, do = _flash_case(6, 1, 128, 2, 64, dtype, dev)
    q.requires_grad_(True)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches, fa.flash_bwd_delta.launches)
    o = fa.flash_attention(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert torch.isfinite(q.grad.float()).all()
    _flash_all(q.detach(), k, v, do, True, 0.125, kernel=False)
    fa.flash_bwd_delta_reference(o.detach(), do)
    passes = 1 if dtype == torch.bfloat16 else 0
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches, fa.flash_bwd_delta.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3] + passes)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "length",
                                 "cross_causal", "mixed", "tma_stride"])
def test_flash_kernels_refuse_what_they_do_not_take(dev, bad):
    q, k, v, _ = _flash_case(8, 1, 128, 2, 64, torch.float32, dev)
    causal = True
    if bad == "tma_stride":
        # bf16 rows 68 elements apart: not whole 16 bytes for TMA
        q, k, v = (torch.nn.functional.pad(t, (0, 4)).bfloat16()[..., :64]
                   for t in (q, k, v))
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


def _llama_loss(model, b):
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    logits = model(x)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())


def test_llama_train_step_fp32_card_matches_cpu(dev):
    """The Llama train step (GQA, remat, flash) in fp32: 3 AdamW steps
    on the card (K3, K4, K5; K3 twice per layer under remat) against the
    CPU (plain versions)."""
    from ray_tpu_torch.models.llama import build_train_model, init_params, \
        llama_tiny
    from ray_tpu_torch.train import spmd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_tiny(max_seq_len=128, dtype=torch.float32, dim=128,
                     remat=True, attention_impl="flash")
    sd = init_params(cfg, 0, "cpu")
    batch = {"ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)}
    runs = []
    for d in (dev, "cpu"):
        opt = spmd.adamw(1e-3, weight_decay=0.1)
        state = spmd.TrainState.create(build_train_model(cfg, sd, d), opt)
        step = spmd.make_train_step(_llama_loss, opt)
        b = spmd.put_batch(batch, d)
        before = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches)
        out = []
        for _ in range(3):
            state, m = step(state, b)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        if d == dev:
            assert (fa.flash_fwd.launches - before[0],
                    fa.flash_bwd_dkv.launches - before[1]) == \
                (2 * 3 * cfg.n_layers, 3 * cfg.n_layers)
        runs.append(out)
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-4)


def test_gpt2_bf16_train_step_on_card(dev):
    from ray_tpu_torch.models.gpt2 import gpt2_tiny, init_params
    cfg = gpt2_tiny(n_ctx=256, n_embd=256, n_head=4, vocab_size=512)
    sd = init_params(cfg, 1, dev)
    batch = {"ids": np.random.RandomState(1).randint(
        0, cfg.vocab_size, (4, 257)).astype(np.int32)}
    wrappers = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
                fa.flash_bwd_dkv)
    counts = [f.launches for f in wrappers]
    flash = _train(cfg, sd, batch, dev, 3)
    assert [f.launches - c for f, c in zip(wrappers, counts)] == \
        [3 * cfg.n_layer] * 4
    losses = [m[0] for m in flash]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    dense = _train(dataclasses.replace(cfg, attention_impl="dense_fp32"),
                   sd, batch, dev, 1)
    assert abs(flash[0][0] - dense[0][0]) < 1e-2
    assert abs(flash[0][1] - dense[0][1]) < 0.02 * dense[0][1]


def test_bf16_payload_published_from_the_card_swaps_in_token_identically(
        dev, tmp_path):
    """A bf16 state dict on the card, published and loaded back (CPU
    tensors), swapped into an engine serving other weights: the engine
    then gives the same tokens as an engine built on the same weights
    directly, K1 on every decode step."""
    from ray_tpu_torch.models.llama import build_model, init_params, \
        llama_tiny
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.weight_rollout import (load_weights,
                                                    publish_weights,
                                                    weights_id_from_payload)
    cfg = llama_tiny(dtype=torch.bfloat16, dim=128, n_heads=2,
                     n_kv_heads=1, max_seq_len=256)   # head_dim 64
    sd = init_params(cfg, 3, dev)
    path, wid = publish_weights(sd, str(tmp_path / "w"), step=1,
                                extra={"release": "r1"})
    loaded, wid2 = load_weights(path)
    assert wid2 == wid == weights_id_from_payload(
        {"release": "r1", "params": {k: v.cpu() for k, v in sd.items()}})
    assert all(v.device.type == "cpu" and v.dtype == sd[k].dtype
               and torch.equal(v, sd[k].cpu()) for k, v in loaded.items())
    prompts = [list(range(1, 20)), list(range(40, 47)), [5] * 33]
    knobs = dict(max_slots=4, page_size=8, n_pages=128, device=dev)
    direct = LLMEngine(build_model(cfg, sd, dev), **knobs)
    hs = [direct.submit(p, 16) for p in prompts]
    while direct.step():
        pass
    want = [h.result() for h in hs]
    eng = LLMEngine(build_model(cfg, init_params(cfg, 4, dev), dev), **knobs)
    assert eng.swap_weights(loaded, weights_id=wid) == 1
    before = pa.paged_decode_attention.launches
    hs = [eng.submit(p, 16) for p in prompts]
    while eng.step():
        pass
    assert [h.result() for h in hs] == want
    assert eng.weights_id == wid
    assert pa.paged_decode_attention.launches - before == \
        cfg.n_layers * eng.stats["decode_steps"]


def test_save_async_of_cuda_parameters_under_an_in_place_update(
        dev, tmp_path):
    """CUDA parameters and AdamW moments saved asynchronously, then
    updated in place by ``optimizer.step()`` while the writer is held:
    the committed bytes are the step's, bit for bit."""
    import threading
    from ray_tpu_torch.air.checkpoint_manager import CheckpointManager
    torch.manual_seed(0)
    model = torch.nn.Linear(64, 32).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    x = torch.randn(16, 64, device=dev)

    def train():
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()

    train()
    # clones: ``.cpu()`` of the optimizer's host-side step is itself
    want = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    want_opt = {i: {k: v.cpu().clone() for k, v in s.items()}
                for i, s in opt.state_dict()["state"].items()}
    gate = threading.Event()
    mgr = CheckpointManager(str(tmp_path),
                            pre_commit_hook=lambda s: gate.wait(30))
    try:
        h = mgr.save_async({"model": model.state_dict(),
                            "optimizer": opt.state_dict()}, 1)
        for _ in range(3):
            train()
        torch.cuda.synchronize(dev)
        assert not torch.equal(model.weight.cpu(), want["weight"])
        gate.set()
        assert h.wait(30) and h.committed
        got = mgr.latest_complete().to_dict()
    finally:
        gate.set()
        mgr.close()
    for k, v in want.items():
        assert got["model"][k].device.type == "cpu"
        assert torch.equal(got["model"][k], v)
    for i, s in want_opt.items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v)


# --------------------------------------------------------------------
# The RL learner and generator
# --------------------------------------------------------------------

def _rl_batch(vocab, B, plen, n_new, seed=0):
    from ray_tpu_torch.rl import RolloutBatch
    g = np.random.default_rng(seed)
    return RolloutBatch(
        batch_id="round-0", round_idx=0,
        prompts=g.integers(0, vocab, (B, plen)).tolist(),
        completions=g.integers(0, vocab, (B, n_new)).tolist(),
        logprobs=g.normal(-np.log(vocab), 0.3, (B, n_new)).tolist(),
        weights_id="w0", generation=0,
        rewards=g.normal(0.5, 1.0, B).tolist())


def test_rl_learner_update_runs_the_flash_kernels(dev):
    """``RolloutLearner`` at ``llama_tiny`` bf16 on fp32 masters, L = 96
    + 32 = 128: attention ``"auto"`` takes flash on the card, so each
    update launches K3, K4, K5 and the delta pass once per layer; three
    updates on one batch give finite losses that fall."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.rl import RolloutLearner
    cfg = tl.llama_tiny()
    sd = tl.init_params(dataclasses.replace(cfg, dtype=cfg.param_dtype), 0,
                        device=dev)
    learner = RolloutLearner(cfg, sd, algo="ppo", lr=1e-2, device=dev)
    batch = _rl_batch(cfg.vocab_size, 4, 96, 32)
    kernels = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
               fa.flash_bwd_dkv)
    for kern in kernels:
        kern.launches = 0
    losses = [learner.update(batch)["loss"] for _ in range(3)]
    assert [k.launches for k in kernels] == [3 * cfg.n_layers] * 4
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert {p.dtype for p in learner.model.parameters()} == {torch.float32}


def test_rl_sync_weights_from_a_learner_installs_its_payload(dev, tmp_path):
    """A learner's state dict, published, swaps into an engine on the
    card through ``RolloutGenerator.sync_weights``: the engine serves
    the published ``weights_id`` at the next generation, and its next
    batch is stamped with it."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.rl import RolloutGenerator, RolloutLearner
    from ray_tpu_torch.serve.engine import LLMEngine
    from ray_tpu_torch.serve.weight_rollout import publish_weights
    cfg = tl.llama_tiny(dim=256)      # head_dim 64, as K1 takes it
    sd = tl.init_params(dataclasses.replace(cfg, dtype=cfg.param_dtype), 0,
                        device=dev)
    learner = RolloutLearner(cfg, sd, lr=1e-2, device=dev)
    learner.update(_rl_batch(cfg.vocab_size, 4, 8, 4))
    host = learner.host_params()
    _path, wid = publish_weights(host, str(tmp_path / "pub"), step=1)
    eng = LLMEngine(tl.build_model(cfg, sd, dev), max_slots=4, page_size=16,
                    n_pages=64, temperature=1.0, capture_logprobs=True,
                    device=dev).start()
    try:
        gen = RolloutGenerator(eng, max_new_tokens=4)
        g0 = eng.weight_generation
        assert gen.sync_weights(host, weights_id=wid) == g0 + 1
        assert gen.weights_stamp() == (g0 + 1, wid)
        batch = gen.generate([[1, 2, 3, 4]] * 2, round_idx=1)
        assert (batch.weights_id, batch.generation) == (wid, g0 + 1)
        assert all(len(lp) == 4 for lp in batch.logprobs)
        want = tl.build_model(cfg, host, dev).tok_embeddings
        assert torch.equal(eng.model.tok_embeddings, want)
    finally:
        eng.shutdown()


# --------------------------------------------------------------------
# The fleet on the card
# --------------------------------------------------------------------

def test_loopback_fleet_on_card_matches_one_engine(dev):
    """``LlamaDeployment(fleet=2)`` (a loopback directory, two agents
    and the router) at a bf16 ``llama_tiny`` with head_dim 64 on the
    card: the single-engine deployment's greedy tokens, K1 on every
    member's decode step."""
    from ray_tpu_torch.models.llama import init_params, llama_tiny
    from ray_tpu_torch.serve.llm import LlamaDeployment
    cfg = llama_tiny(dim=256, n_heads=4, n_kv_heads=2)
    sd = init_params(cfg, seed=0, device=dev)
    kw = dict(max_new_tokens=8, page_size=16, max_slots=4, device=dev)
    fleet = LlamaDeployment(cfg, sd, fleet=2, **kw)
    one = LlamaDeployment(cfg, sd, **kw)
    try:
        prompts = [[1, 2, 3], list(range(5, 40)), [7] * 17]
        for p in prompts:
            assert fleet(p) == one(p)
        steps = sum(a.engine.stats["decode_steps"]
                    for a in fleet._fleet_agents.values())
        before = pa.paged_decode_attention.launches
        out = fleet({"prompt_ids": [4, 5, 6], "echo_replica": True})
        steps = sum(a.engine.stats["decode_steps"]
                    for a in fleet._fleet_agents.values()) - steps
        assert out["replica"] in ("r0:0", "r1:0")
        assert (pa.paged_decode_attention.launches - before
                == steps * cfg.n_layers) and steps >= 7
    finally:
        fleet.shutdown()
        one.shutdown()


def test_agent_process_on_card_registers_serves_and_is_reaped(dev, tmp_path):
    """A directory process and one ``--model tinyllama --layers 1``
    agent process on the card, started as chip_smoke's phase 4j starts
    them, with the kernels built here first (an agent never builds): it
    registers, serves this process's engine's greedy tokens, and is
    reaped, with nothing left alive."""
    import chip_smoke
    from ray_tpu_torch.serve.fleet.agent import model_engine_factory
    from ray_tpu_torch.serve.fleet.directory import DirectoryClient
    from ray_tpu_torch.serve.fleet.transport import SocketTransport
    pa.load_kernel()
    prompt = list(range(1, 70))
    eng = model_engine_factory("tinyllama", layers=1, device=dev,
                               max_slots=4, page_size=16, n_pages=64)(0)
    want = eng.submit(prompt, max_new_tokens=8).result()
    eng.shutdown()
    procs = chip_smoke._FleetProcs(str(tmp_path))
    try:
        procs.start("directory", "ray_tpu_torch.serve.fleet.directory",
                    ["--lease-ttl-s", 5.0])
        dport, _ = procs.ready("directory")
        procs.start("a0", "ray_tpu_torch.serve.fleet.agent",
                    ["--replica-id", "a0", "--directory-port", dport,
                     "--model", "tinyllama", "--layers", 1,
                     "--max-slots", 4, "--page-size", 16, "--n-pages", 64])
        port, _ = procs.ready("a0")
        dc = DirectoryClient(SocketTransport(("127.0.0.1", dport)))
        assert [m["replica_id"] for m in dc.snapshot()["members"]] == ["a0"]
        assert chip_smoke._agent_tokens(port, prompt, 8, "k") == want
    finally:
        procs.reap()
    assert procs.alive() == []
