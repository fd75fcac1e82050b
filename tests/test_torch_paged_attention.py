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
    """K1 and K2 are built from two sources that include both headers
    (the scalar pass with the merge, and the tensor-core pass): an edit
    to either header alone must name a new library for each, so a stale
    build is never loaded."""
    for name in (tpa._SOURCE, tpa._SOURCE_INT8,
                 "paged_decode_attention.cuh", tpa._SOURCE_SM90):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = [_build.library_path(s)
              for s in (tpa._SOURCE, tpa._SOURCE_INT8)]
    assert before[0].name.startswith("paged_decode_attention-")
    assert before[1].name.startswith("paged_decode_attention_int8-")
    for header in ("paged_decode_attention.cuh", tpa._SOURCE_SM90):
        path = tmp_path / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = [_build.library_path(s)
                 for s in (tpa._SOURCE, tpa._SOURCE_INT8)]
        assert before[0] != after[0] and before[1] != after[1], header
        before = after


def test_bf16_k1_takes_only_its_split_sizes():
    """The bf16 tensor-core pass (bf16 K1, and K2 with bf16 q over int8
    pages) is built for 64-, 128- and 256-key splits: any other size
    raises before anything is built or launched (the checks run on CPU
    tensors)."""
    a = _kernel_args(q=torch.zeros(2, 8, 64, dtype=torch.bfloat16),
                     pages_k=torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16),
                     pages_v=torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16))
    # bf16 K1 and bf16-q K2 run the tensor-core pass at one split size;
    # fp32 K1 and fp32-q K2 keep the scalar split
    assert tpa.split_keys_for(torch.bfloat16) == \
        tpa._SPLIT_KEYS_BF16 in tpa._BF16_SPLITS
    assert tpa.split_keys_for(torch.float32) == tpa._SPLIT_KEYS
    with pytest.raises(ValueError, match="split_keys"):
        tpa._launch_kernel(**a, split_keys=96)
    i8 = torch.zeros(2, 4, 8, 64, dtype=torch.int8)
    scales = torch.ones(2, 4, 1)
    with pytest.raises(ValueError, match="split_keys"):
        tpa._launch_kernel(a["q"], i8, i8, a["page_table"], a["positions"],
                           96, scales, scales)


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
    """Phase 1 of chip_smoke.py reads K1's and K2's ptxas reports for
    each split_sm90<P, D, KW> instance (page type, head_dim, keys per
    warp): the bf16 and int8 instances are told apart, and a template
    of ints alone is still named by its ints."""
    sig = "EEEvPK13__nv_bfloat16PKT_S6_PKfS8_PKiSA_PS3_PfSC_SC_Piiiiiif"
    report = "".join(
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {fn}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
        f"bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for fn, regs, spill in (
            ("_ZN12_GLOBAL__N_110split_sm90I13__nv_bfloat16Li64ELi64"
             + sig, 96, 0),
            ("_ZN12_GLOBAL__N_110split_sm90IaLi64ELi64" + sig, 90, 0),
            ("_ZN12_GLOBAL__N_110split_sm90IaLi128ELi16" + sig, 168, 8),
            ("_ZN12_GLOBAL__N_18fwd_sm90ILi64EEEvPK13__nv_bfloat16",
             120, 0)))
    assert _build.ptxas_summary(report, ("split_sm90", "fwd_sm90")) == {
        "split_sm90<__nv_bfloat16, 64, 64>": {
            "registers": 96, "spill_stores": 0, "spill_loads": 0,
            "warnings": []},
        "split_sm90<int8_t, 64, 64>": {
            "registers": 90, "spill_stores": 0, "spill_loads": 0,
            "warnings": []},
        "split_sm90<int8_t, 128, 16>": {
            "registers": 168, "spill_stores": 8, "spill_loads": 8,
            "warnings": []},
        "fwd_sm90<64>": {"registers": 120, "spill_stores": 0,
                         "spill_loads": 0, "warnings": []}}


def test_k2_source_sends_bf16_q_to_the_tensor_core_pass():
    """K2's library sends bf16 q (dtype 1) to split_sm90 over int8
    pages and fp32 q to the scalar template, with no scalar bf16-q
    instance left; the tensor-core pass widens int8 to bf16 and runs
    mma.sync; every split pass ends in merge_tail, and no separate
    merge kernel is left in csrc/."""
    cu = (_build.CSRC / tpa._SOURCE_INT8).read_text()
    sm90 = (_build.CSRC / tpa._SOURCE_SM90).read_text()
    cuh = (_build.CSRC / "paged_decode_attention.cuh").read_text()
    assert '#include "paged_decode_attention_sm90.cuh"' in cu
    assert re.search(r"dtype == 1 && D == 64\) RTT_LAUNCH_SM90", cu)
    assert re.search(r"dtype == 1 && D == 128\) RTT_LAUNCH_SM90", cu)
    assert "launch_split_sm90<int8_t" in cu
    assert re.search(r"dtype == 0 && D == 64\) RTT_LAUNCH\(float", cu)
    assert "launch<T, int8_t" in cu
    assert "__nv_bfloat16" not in cu       # no scalar bf16-q instance
    assert re.search(r"template <typename P, int D, int KW>\s*"
                     r"__global__[^;{]*\bsplit_sm90\(", sm90)
    for text in ("widen_rows<G>(k_s", "widen_rows<G>(v_s",
                 "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"):
        assert text in sm90, text
    for src in (sm90, cuh):
        assert src.count("merge_tail<") == 1
    for path in _build.CSRC.glob("paged_decode_attention*"):
        assert "merge_kernel" not in path.read_text(), path.name


# ------------------------------- the int8 tensor-core pass's rounding


def _emulate_int8_tensor_core_pass(q, pk, pv, pt, pos, sk, sv, split):
    """The arithmetic of split_sm90<int8_t, D, split / 4> and its merge
    in plain torch, at each of its rounding points: q in bf16, q8
    widened to bf16 exactly, S = (q . q8) in fp32 scaled per key by
    s_k / 127 / sqrt(D) after the product; each warp's softmax over its
    split / 4 keys with the max floored at -1e29, l over the unrounded
    P, P * s_v / 127 rounded to bf16 before PV; the 4 warps merged, then
    the live splits merged in split order; bf16 out. Test-only."""
    B, H, D = q.shape
    KH, _, Pg, _ = pk.shape
    rep, L, kw = H // KH, pt.shape[1] * Pg, split // 4
    ptl = pt.long()
    k8 = pk[:, ptl].reshape(KH, B, L, D).to(torch.bfloat16).float()
    v8 = pv[:, ptl].reshape(KH, B, L, D).to(torch.bfloat16).float()
    ks = (sk[:, ptl, 0] * (1.0 / 127.0) * (1.0 / np.sqrt(D))).float()
    vs = (sv[:, ptl, 0] * (1.0 / 127.0)).float()
    ks = ks.repeat_interleave(Pg, dim=2)                   # [KH, B, L]
    vs = vs.repeat_interleave(Pg, dim=2)
    qf = q.to(torch.bfloat16).float().reshape(B, KH, rep, D)
    out = torch.zeros(B, KH, rep, D)

    def merge(parts):   # [(m, l, o)] in order -> (M, L, O)
        m = torch.stack([p[0] for p in parts]).amax(0)
        w = [torch.exp(p[0] - m) for p in parts]
        return (m, sum(p[1] * wi for p, wi in zip(parts, w)),
                sum(p[2] * wi[:, None] for p, wi in zip(parts, w)))

    for b in range(B):
        n = min(int(pos[b]) + 1, L)
        for kh in range(KH):
            splits = []
            for k0 in range(0, max(n, 0), split):
                warps = []
                for w0 in range(k0, k0 + split, kw):
                    keys = torch.arange(w0, w0 + kw)
                    s = (qf[b, kh] @ k8[kh, b, w0:w0 + kw].T) * \
                        ks[kh, b, w0:w0 + kw]
                    s = torch.where(keys < n, s, torch.tensor(-1e30))
                    m = s.amax(-1).clamp(min=-1e29)
                    p = torch.exp(s - m[:, None])
                    pb = (p * vs[kh, b, w0:w0 + kw]).to(torch.bfloat16)
                    warps.append((m, p.sum(-1),
                                  pb.float() @ v8[kh, b, w0:w0 + kw]))
                splits.append(merge(warps))
            if splits:
                _, l, o = merge(splits) if len(splits) > 1 else splits[0]
                out[b, kh] = o / l.clamp(min=1e-30)[:, None]
    return out.reshape(B, H, D).to(torch.bfloat16)


@pytest.mark.parametrize("Pg", [16, 64])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_int8_tensor_core_rounding_within_bf16_limit(rep, Pg):
    """The int8 tensor-core pass's rounding points, emulated, against
    the JAX kernel _kernel_q in interpret mode (bf16 q, the served
    dtype): within the card tests' bf16 limit, 4e-3 + 2^-7 * |ref|, with
    windows on each side of the 64-key split boundaries, one key, no
    visible key and past the window."""
    rng = np.random.default_rng(40 + rep + Pg)
    B, KH, D, split, L = 6, 2, 64, 64, 256
    max_pages = L // Pg
    n_pages = B * max_pages + 1
    pk, pv = (rng.integers(-127, 128, (KH, n_pages, Pg, D)).astype(np.int8)
              for _ in range(2))
    sk, sv = (rng.uniform(0.1, 2.0, (KH, n_pages, 1)).astype(np.float32)
              for _ in range(2))
    pt = (rng.permutation(n_pages - 1)[:B * max_pages] + 1).reshape(
        B, max_pages).astype(np.int32)
    pos = np.array([0, split - 1, split, 3 * split + 5, -1, L + 9],
                   np.int32)
    q = rng.standard_normal((B, KH * rep, D)).astype(np.float32)
    q16 = torch.from_numpy(q).to(torch.bfloat16)
    ref = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q16.float().numpy(), jnp.bfloat16), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(pt), jnp.asarray(pos),
        jnp.asarray(sk), jnp.asarray(sv), interpret=True), np.float32)
    emu = _emulate_int8_tensor_core_pass(
        q16, *map(torch.from_numpy, (pk, pv, pt, pos, sk, sv)), split)
    np.testing.assert_allclose(emu.float().numpy(), ref, rtol=2.0 ** -7,
                               atol=4e-3)
    assert not emu[4].any()                  # no visible key: zeros
