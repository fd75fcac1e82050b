"""ray_tpu_torch.ops.paged_attention against ray_tpu.ops.paged_attention
on the CPU.

The JAX decode kernel runs in Pallas interpret mode (as
tests/test_paged_attention.py runs it); the port's wrapper runs its
plain PyTorch version on CPU tensors. Same numpy inputs on both sides.

Tolerances: decode attention rtol/atol 2e-4 in fp32 (two fp32
softmax-weighted sums taken in different orders); in bf16 1e-2, since
both round an fp32 result to bf16 once and may land one bf16 ulp apart
(2^-8 relative). ``paged_append`` must leave the pool bytes identical,
except in null-page cells that more than one padding token targets —
which of those writes wins is unspecified in both packages.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import paged_attention as tpa


def _random_layout(rng, B, n_pages, max_pages, Pg, KH, D, H):
    # Page 0 is the null page; each slot gets a distinct page chain.
    pages_k = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pages_v = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    perm = rng.permutation(n_pages - 1)[: B * max_pages] + 1
    page_table = perm.reshape(B, max_pages).astype(np.int32)
    positions = rng.integers(0, max_pages * Pg, size=B).astype(np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, pages_k, pages_v, page_table, positions


def _both(args, dtype=np.float32):
    """(JAX kernel in interpret mode, port's CPU path) on ``args``."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, pk, pv, pt, pos = args
    j = jpa.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
        jnp.asarray(pt), jnp.asarray(pos), interpret=True)
    t = tpa.paged_decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(pk).to(tdt),
        torch.from_numpy(pv).to(tdt), torch.from_numpy(pt),
        torch.from_numpy(pos))
    assert t.dtype == tdt
    return np.asarray(j, np.float32), t.float().numpy()


@pytest.mark.parametrize("rep", [1, 4])
def test_decode_matches_jax_kernel(rep):
    rng = np.random.default_rng(0)
    B, Pg, KH, D = 3, 8, 2, 16
    args = _random_layout(rng, B, 64, 4, Pg, KH, D, KH * rep)
    j, t = _both(args)
    np.testing.assert_allclose(t, j, rtol=2e-4, atol=2e-4)


def test_decode_position_zero_full_window_and_null_slot():
    rng = np.random.default_rng(1)
    B, Pg, KH, D, max_pages = 3, 4, 1, 8, 3
    q, pk, pv, pt, _ = _random_layout(rng, B, 32, max_pages, Pg, KH, D, 2)
    pos = np.array([0, max_pages * Pg - 1, 2], np.int32)
    pt[2] = 0                           # an inactive slot: null page
    j, t = _both((q, pk, pv, pt, pos))
    np.testing.assert_allclose(t, j, rtol=2e-4, atol=2e-4)
    # pos 0 attends one key: the output is V at position 0
    np.testing.assert_allclose(t[0, 0], pv[0, pt[0, 0], 0],
                               rtol=1e-5, atol=1e-5)


def test_decode_bf16():
    rng = np.random.default_rng(2)
    args = _random_layout(rng, 2, 16, 2, 8, 2, 16, 4)
    j, t = _both(args, "bf16")
    np.testing.assert_allclose(t, j, rtol=1e-2, atol=1e-2)


def test_cpu_path_counts_no_launch():
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a)
            for a in _random_layout(rng, 2, 16, 2, 4, 2, 8, 4)]
    before = tpa.paged_decode_attention.launches
    tpa.paged_decode_attention(*args)
    assert tpa.paged_decode_attention.launches == before


def test_decode_refuses_other_devices():
    args = [torch.empty(s, device="meta")
            for s in ((2, 4, 64), (2, 8, 4, 64), (2, 8, 4, 64))]
    args += [torch.empty((2, 2), dtype=torch.int32, device="meta"),
             torch.empty((2,), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_decode_attention(*args)


def _kernel_args(**change):
    """Valid kernel arguments (as CPU tensors, for the wrapper's checks
    only), with one entry replaced."""
    a = dict(q=torch.zeros(2, 8, 64), pages_k=torch.zeros(2, 4, 8, 64),
             pages_v=torch.zeros(2, 4, 8, 64),
             page_table=torch.zeros(2, 3, dtype=torch.int32),
             positions=torch.zeros(2, dtype=torch.int32))
    a.update(change)
    return a


def test_kernel_checks_accept_valid_args():
    tpa._check_decode_args(**_kernel_args())
    tpa._check_decode_args(**_kernel_args(
        q=torch.zeros(2, 8, 128), pages_k=torch.zeros(2, 4, 8, 128),
        pages_v=torch.zeros(2, 4, 8, 128)))


@pytest.mark.parametrize("change", [
    dict(q=torch.zeros(2, 8, 32), pages_k=torch.zeros(2, 4, 8, 32),
         pages_v=torch.zeros(2, 4, 8, 32)),                 # head_dim 32
    dict(q=torch.zeros(2, 18, 64)),                         # group 9
    dict(q=torch.zeros(2, 7, 64)),                          # 7 % 2
    dict(q=torch.zeros(2, 8, 64, dtype=torch.float16)),     # dtype
    dict(pages_v=torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16)),
    dict(page_table=torch.zeros(2, 3, dtype=torch.int64)),
    dict(positions=torch.zeros(3, dtype=torch.int32)),
    dict(q=torch.zeros(8, 2, 64).transpose(0, 1)),          # strided
], ids=["head_dim", "group", "heads", "dtype", "pool_dtype", "int64",
        "batch", "strided"])
def test_kernel_checks_refuse(change):
    with pytest.raises(ValueError):
        tpa._check_decode_args(**_kernel_args(**change))


def _append_both(pk, pv, pt, pos, k, v, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jk, jv = jpa.paged_append(
        jnp.asarray(pk, jdt), jnp.asarray(pv, jdt), jnp.asarray(pt),
        jnp.asarray(pos), jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    tk, tv = torch.from_numpy(pk).to(tdt), torch.from_numpy(pv).to(tdt)
    ret = tpa.paged_append(tk, tv, torch.from_numpy(pt),
                           torch.from_numpy(pos),
                           torch.from_numpy(k).to(tdt),
                           torch.from_numpy(v).to(tdt))
    assert ret is None                  # in place
    as_bytes = lambda a: np.asarray(a).view(np.uint16 if dtype == "bf16"  # noqa: E731
                                            else np.uint32)
    return ((as_bytes(jk), as_bytes(jv)),
            (tk.view(torch.int16).numpy().view(np.uint16)
             if dtype == "bf16" else tk.numpy().view(np.uint32),
             tv.view(torch.int16).numpy().view(np.uint16)
             if dtype == "bf16" else tv.numpy().view(np.uint32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_append_mid_page_span_bytes_identical(dtype):
    rng = np.random.default_rng(3)
    B, T, KH, D, Pg, n_pages = 2, 6, 2, 8, 4, 16
    pk = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pv = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.array([3, 5], np.int32)      # both start mid-page
    k = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    (jk, jv), (tk, tv) = _append_both(pk, pv, pt, pos, k, v, dtype)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)


def test_append_tail_hits_null_page_only():
    rng = np.random.default_rng(4)
    B, T, KH, D, Pg, n_pages, max_pages = 1, 8, 1, 4, 4, 8, 2
    pk = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pv = rng.standard_normal((KH, n_pages, Pg, D)).astype(np.float32)
    pt = np.zeros((B, max_pages), np.int32)
    pt[0, 0] = 3                          # ONE allocated page
    pos = np.array([2], np.int32)         # 8-token chunk overruns it
    k = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    (jk, jv), (tk, tv) = _append_both(pk, pv, pt, pos, k, v, "f32")
    # logical positions 2..9 clamp to 7: tokens 5, 6, 7 all target the
    # null page's cell 3, so only that cell may differ
    keep = np.ones((KH, n_pages, Pg, D), bool)
    keep[:, 0, 3] = False
    np.testing.assert_array_equal(tk[keep], jk[keep])
    np.testing.assert_array_equal(tv[keep], jv[keep])
    # page 3 got its two in-window tokens; no other page moved
    np.testing.assert_array_equal(tk.view(np.float32)[:, 3, 2], k[0, 0])
    for pg in range(1, n_pages):
        if pg != 3:
            np.testing.assert_array_equal(tk.view(np.float32)[:, pg],
                                          pk[:, pg])


@pytest.mark.parametrize("case", [
    "pool_rank", "pool_mismatch", "chunk_rank", "chunk_mismatch",
    "kv_heads", "head_dim", "table_rank", "table_rows", "table_float",
    "pos_shape"])
def test_append_shape_errors(case):
    pk = torch.zeros(2, 8, 4, 16)
    pv = torch.zeros(2, 8, 4, 16)
    pt = torch.zeros(3, 2, dtype=torch.int32)
    pos = torch.zeros(3, dtype=torch.int32)
    k = torch.zeros(3, 5, 2, 16)
    v = torch.zeros(3, 5, 2, 16)
    if case == "pool_rank":
        pk = pv = torch.zeros(8, 4, 16)
    elif case == "pool_mismatch":
        pv = torch.zeros(2, 8, 4, 8)
    elif case == "chunk_rank":
        k = v = torch.zeros(3, 5, 32)
    elif case == "chunk_mismatch":
        v = torch.zeros(3, 4, 2, 16)
    elif case == "kv_heads":
        k = v = torch.zeros(3, 5, 1, 16)
    elif case == "head_dim":
        k = v = torch.zeros(3, 5, 2, 8)
    elif case == "table_rank":
        pt = torch.zeros(3, dtype=torch.int32)
    elif case == "table_rows":
        pt = torch.zeros(2, 2, dtype=torch.int32)
    elif case == "table_float":
        pt = torch.zeros(3, 2)
    else:
        pos = torch.zeros(3, 1, dtype=torch.int32)
    before = pk.clone()
    with pytest.raises(tpa.PagedShapeError):
        tpa.paged_append(pk, pv, pt, pos, k, v)
    assert torch.equal(pk, before)      # nothing written


def test_build_names_libraries_by_content():
    assert (_build.CSRC / "paged_decode_attention.cu").is_file()
    path = _build.library_path("paged_decode_attention.cu")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("paged_decode_attention-")
    assert path == _build.library_path("paged_decode_attention.cu")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """K1 and K2 are built from two sources that include one header: an
    edit to the header alone must name a new library for each, so a
    stale build is never loaded."""
    for name in (tpa._SOURCE, tpa._SOURCE_INT8,
                 "paged_decode_attention.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = [_build.library_path(s)
              for s in (tpa._SOURCE, tpa._SOURCE_INT8)]
    assert before[0].name.startswith("paged_decode_attention-")
    assert before[1].name.startswith("paged_decode_attention_int8-")
    header = tmp_path / "paged_decode_attention.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [_build.library_path(s)
             for s in (tpa._SOURCE, tpa._SOURCE_INT8)]
    assert before[0] != after[0] and before[1] != after[1]


def test_bf16_k1_takes_only_its_split_sizes():
    """The bf16 tensor-core pass is built for 64-, 128- and 256-key
    splits: any other size raises before anything is built or
    launched (the checks run on CPU tensors)."""
    a = _kernel_args(q=torch.zeros(2, 8, 64, dtype=torch.bfloat16),
                     pages_k=torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16),
                     pages_v=torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16))
    assert tpa.split_keys_for(torch.bfloat16, False) == \
        tpa._SPLIT_KEYS_BF16 in tpa._BF16_SPLITS
    # fp32 K1 and K2 (bf16 q over int8 pages) keep the scalar split
    assert tpa.split_keys_for(torch.float32, False) == tpa._SPLIT_KEYS
    assert tpa.split_keys_for(torch.bfloat16, True) == tpa._SPLIT_KEYS
    with pytest.raises(ValueError, match="split_keys"):
        tpa._launch_kernel(**a, split_keys=96)


def test_bf16_k1_source_is_the_tensor_core_pass():
    """K1's library sends bf16 (dtype 1) to split_sm90, whose source
    issues cp.async copies and mma.sync products and calls no library
    kernel; fp32 stays on the scalar template."""
    cu = (_build.CSRC / tpa._SOURCE).read_text()
    sm90 = (_build.CSRC / tpa._SOURCE_SM90).read_text()
    assert '#include "paged_decode_attention_sm90.cuh"' in cu
    assert re.search(r"dtype == 1 && D == 64\) RTT_LAUNCH_SM90", cu)
    assert re.search(r"dtype == 0 && D == 64\) RTT_LAUNCH\(float", cu)
    assert "__nv_bfloat16, 64)" not in cu  # no scalar bf16 instance
    assert re.search(r"__global__[^;{]*\bsplit_sm90\(", sm90)
    for ptx in ("cp.async.cg.shared.global", "cp.async.wait_group",
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16"):
        assert ptx in sm90, ptx
    assert "#include <cublas" not in sm90 and "cutlass" not in sm90


def test_build_digest_covers_the_sm90_header(tmp_path, monkeypatch):
    """An edit to the tensor-core header alone names a new K1
    library."""
    for name in (tpa._SOURCE, "paged_decode_attention.cuh",
                 "paged_decode_attention_sm90.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(tpa._SOURCE)
    header = tmp_path / "paged_decode_attention_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(tpa._SOURCE) != before


def test_ptxas_summary_names_both_template_ints():
    """Phase 1 of chip_smoke.py reads K1's ptxas report for each
    split_sm90<D, KW> instance (head_dim, keys per warp)."""
    fn = ("_ZN12_GLOBAL__N_110split_sm90ILi{}ELi{}EEEvPK13__nv_bfloat16"
          "S3_S3_PKiS5_PfS6_S6_iiiiif")
    report = "".join(
        f"ptxas info    : Compiling entry function '{fn.format(d, kw)}' "
        f"for 'sm_90a'\n"
        f"ptxas info    : Function properties for {fn.format(d, kw)}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
        f"bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for d, kw, regs, spill in ((64, 32, 90, 0), (128, 64, 168, 8)))
    assert _build.ptxas_summary(report, ("split_sm90",)) == {
        "split_sm90<64, 32>": {"registers": 90, "spill_stores": 0,
                               "spill_loads": 0, "warnings": []},
        "split_sm90<128, 64>": {"registers": 168, "spill_stores": 8,
                                "spill_loads": 8, "warnings": []}}
