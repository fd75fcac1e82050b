"""The port's int8 KV pool (ray_tpu_torch) against the JAX package's on
the CPU: quantized append, the K2 plain version, the pool and its byte
format, the dtype knob, and the engine with ``kv_dtype="int8"``.

Op level: every append case of tests/test_kv_quant.py runs the same
numpy write history through both packages' ``paged_append`` and must
leave IDENTICAL int8 page bytes and fp32 scales (the port keeps the
reference's fp32 operation order; no tolerance), then checks the
case's own property. K2's plain version (the port's CPU path of
``paged_decode_attention`` with scales) is held against the JAX kernel
in Pallas interpret mode at 2e-4 in fp32 (two softmax-weighted sums in
different orders) and 1e-2 in bf16 (one bf16 rounding of an fp32
result each, one ulp apart at most), as K1's parity test does.
``export_page_bytes`` must be byte-identical across the packages.

Engine level: ``llama_tiny`` fp32 with the flax params of PRNGKey(0)
in both packages; the JAX engine runs with ``overlap=False``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import kv_cache as jkv
from ray_tpu.models import llama as jl
from ray_tpu.ops import paged_attention as jpa
from ray_tpu.serve.engine import LLMEngine as JEngine
from ray_tpu.util import envknobs as jenv
from ray_tpu_torch.models import kv_cache as tkv
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.engine import LLMEngine
from ray_tpu_torch.util import envknobs as tenv

KH, PG, D = 2, 8, 16
# the reference's append under jit, as its engine runs it (one compile
# per chunk shape instead of one per eager op)
_jax_append = jax.jit(jpa.paged_append)


class _Pools:
    """One int8 pool held by both packages; ``append`` runs a chunk
    through each package's ``paged_append`` and asserts the bytes and
    scales stay identical."""

    def __init__(self, n_pages=8, B=1, max_pages=4):
        shape, sshape = (KH, n_pages, PG, D), (KH, n_pages, 1)
        self.pt = np.arange(1, 1 + B * max_pages).reshape(
            B, max_pages).astype(np.int32)
        self.j = [jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
                  jnp.zeros(sshape, jnp.float32),
                  jnp.zeros(sshape, jnp.float32)]
        self.t = [torch.zeros(shape, dtype=torch.int8),
                  torch.zeros(shape, dtype=torch.int8),
                  torch.zeros(sshape), torch.zeros(sshape)]

    def append(self, pos, k, v):
        pos = np.full((self.pt.shape[0],), pos, np.int32)
        pk, pv, sk, sv = self.j
        self.j = list(_jax_append(
            pk, pv, jnp.asarray(self.pt), jnp.asarray(pos),
            jnp.asarray(k), jnp.asarray(v), sk, sv))
        ret = tpa.paged_append(
            self.t[0], self.t[1], torch.from_numpy(self.pt),
            torch.from_numpy(pos), torch.from_numpy(k),
            torch.from_numpy(v), self.t[2], self.t[3])
        assert ret is None                  # in place
        for name, a, b in zip(("pages_k", "pages_v", "scales_k",
                               "scales_v"), self.j, self.t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)

    def deq(self, page):
        """The port's dequantized K page ``[KH, Pg, D]``."""
        return tpa.dequantize_pages(self.t[0], self.t[2])[:, page].numpy()

    def scale(self, page):
        return self.t[2][:, page].numpy()          # [KH, 1]


def _kv(rng, T, scale=1.0):
    k = (rng.standard_normal((1, T, KH, D)) * scale).astype(np.float32)
    v = (rng.standard_normal((1, T, KH, D)) * scale).astype(np.float32)
    return k, v


# ------------------------------------------------ the append cases


def test_bulk_roundtrip_within_half_step():
    rng = np.random.default_rng(0)
    pools = _Pools()
    k, v = _kv(rng, 2 * PG)                # fills pages 1 and 2
    pools.append(0, k, v)
    ref = k[0].transpose(1, 0, 2)          # [KH, T, D]
    for page, lo in ((1, 0), (2, PG)):
        # at most half a quantization step: scale / 254 per element
        tol = pools.scale(page) / 254.0 + 1e-6
        assert (np.abs(pools.deq(page) - ref[:, lo:lo + PG])
                <= tol[..., None]).all()


def test_per_page_scales_isolate_magnitude():
    rng = np.random.default_rng(1)
    pools = _Pools()
    k_big, v_big = _kv(rng, PG, scale=100.0)
    k_small, v_small = _kv(rng, PG, scale=0.01)
    pools.append(0, np.concatenate([k_big, k_small], 1),
                 np.concatenate([v_big, v_small], 1))   # spans 2 pages
    assert (pools.scale(1) > 1.0).all()
    assert (pools.scale(2) < 0.1).all()
    err = np.abs(pools.deq(2) - k_small[0].transpose(1, 0, 2))
    assert err.max() <= pools.scale(2).max() / 254.0 + 1e-7


def test_incremental_scale_matches_bulk_and_is_monotone():
    rng = np.random.default_rng(2)
    k, v = _kv(rng, PG)
    bulk = _Pools()
    bulk.append(0, k, v)
    inc = _Pools()
    last = np.zeros((KH, 1))
    for t in range(PG):
        inc.append(t, k[:, t:t + 1], v[:, t:t + 1])
        assert (inc.scale(1) >= last - 1e-7).all()   # monotone while live
        last = inc.scale(1)
    np.testing.assert_allclose(inc.scale(1), bulk.scale(1), rtol=1e-6)
    # bytes are write-history dependent (re-rounding at each growth),
    # values stay within one extra step
    step = bulk.scale(1)[..., None] / 127.0
    assert (np.abs(bulk.deq(1) - inc.deq(1)) <= 1.5 * step + 1e-7).all()


def test_scale_resets_on_offset_zero_rewrite():
    rng = np.random.default_rng(3)
    pools = _Pools()
    pools.append(0, *_kv(rng, PG, scale=50.0))
    assert pools.scale(1).max() > 10.0
    k_small, v_small = _kv(rng, PG, scale=0.02)
    pools.append(0, k_small, v_small)      # page 1 reused from offset 0
    assert pools.scale(1).max() < 0.1      # old owner's scale is gone
    err = np.abs(pools.deq(1) - k_small[0].transpose(1, 0, 2))
    assert err.max() <= pools.scale(1).max() / 254.0 + 1e-7


def test_mid_page_append_grows_scale_without_reset():
    rng = np.random.default_rng(4)
    pools = _Pools()
    k1, v1 = _kv(rng, 4, scale=0.5)
    pools.append(0, k1, v1)
    s1 = pools.scale(1).copy()
    pools.append(4, *_kv(rng, 4, scale=20.0))   # same page, offsets 4..7
    s2 = pools.scale(1)
    assert (s2 >= s1 - 1e-7).all() and s2.max() > 5.0
    err = np.abs(pools.deq(1)[:, :4] - k1[0].transpose(1, 0, 2))
    assert err.max() <= s2.max() / 127.0 + 1e-6


def test_rollback_garbage_is_masked_and_precision_only():
    rng = np.random.default_rng(5)
    pools = _Pools()
    n_real = 6
    pools.append(0, *_kv(rng, n_real))
    clean = [t.clone() for t in pools.t]
    pools.append(n_real, *_kv(rng, 2, scale=30.0))  # rejected drafts
    assert pools.scale(1).max() > clean[2][:, 1].max().item()
    q = rng.standard_normal((1, 2 * KH, D)).astype(np.float32)
    pos = np.full((1,), n_real - 1, np.int32)
    j = jpa.paged_decode_attention(
        jnp.asarray(q), *pools.j[:2], jnp.asarray(pools.pt),
        jnp.asarray(pos), *pools.j[2:], interpret=True)
    args = (torch.from_numpy(q), pools.t[0], pools.t[1],
            torch.from_numpy(pools.pt), torch.from_numpy(pos))
    out = tpa.paged_decode_attention(*args, *pools.t[2:]).numpy()
    np.testing.assert_allclose(out, np.asarray(j), rtol=2e-4, atol=2e-4)
    # garbage past pos is never attended: only the re-rounding of the
    # real tokens (scale growth) moves the output
    ref_clean = tpa.paged_decode_attention(
        args[0], clean[0], clean[1], *args[3:], *clean[2:]).numpy()
    assert np.abs(out - ref_clean).max() < 0.5


# ------------------------------------------- K2's plain version


def _int8_case(seed, B, H, max_pages, n_pages, positions=None,
               null_rows=()):
    rng = np.random.default_rng(seed)
    pk = rng.integers(-127, 128, (KH, n_pages, PG, D)).astype(np.int8)
    pv = rng.integers(-127, 128, (KH, n_pages, PG, D)).astype(np.int8)
    sk = rng.uniform(0.1, 2.0, (KH, n_pages, 1)).astype(np.float32)
    sv = rng.uniform(0.1, 2.0, (KH, n_pages, 1)).astype(np.float32)
    pt = (rng.permutation(n_pages - 1)[:B * max_pages]
          .reshape(B, max_pages) + 1).astype(np.int32)
    for b in null_rows:
        pt[b] = 0
    if positions is None:
        positions = rng.integers(0, max_pages * PG, B)
    pos = np.asarray(positions, np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, pk, pv, pt, pos, sk, sv


def _decode_both(case, bf16=False):
    q, pk, pv, pt, pos, sk, sv = case
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    j = jpa.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(sk),
        jnp.asarray(sv), interpret=True)
    before = tpa.paged_decode_attention.launches_int8
    t = tpa.paged_decode_attention(
        torch.from_numpy(q).to(tdt), *map(torch.from_numpy,
                                          (pk, pv, pt, pos, sk, sv)))
    assert tpa.paged_decode_attention.launches_int8 == before  # CPU path
    assert t.dtype == tdt
    return t.float().numpy(), np.asarray(j, np.float32)


@pytest.mark.parametrize("rep", [1, 4])
def test_k2_plain_matches_jax_kernel_fp32(rep):
    t, j = _decode_both(_int8_case(6 + rep, 3, KH * rep, 4, 32))
    np.testing.assert_allclose(t, j, rtol=2e-4, atol=2e-4)


def test_k2_plain_position_zero_full_window_and_null_slot():
    case = _int8_case(8, 3, 2 * KH, 3, 16, positions=[0, 3 * PG - 1, 2],
                      null_rows=(2,))
    t, j = _decode_both(case)
    np.testing.assert_allclose(t, j, rtol=2e-4, atol=2e-4)
    # pos 0 attends one key: the output is the dequantized V at 0
    q, pk, pv, pt, pos, sk, sv = case
    v0 = pv[0, pt[0, 0], 0].astype(np.float32) * (sv[0, pt[0, 0], 0]
                                                  * np.float32(1 / 127))
    np.testing.assert_allclose(t[0, 0], v0, rtol=1e-5, atol=1e-5)


def test_k2_plain_matches_jax_kernel_bf16():
    t, j = _decode_both(_int8_case(9, 2, 2 * KH, 2, 16), bf16=True)
    np.testing.assert_allclose(t, j, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("case,match", [
    ("no_scales", "without its per-page"),
    ("one_scale", "supplied together"),
    ("scale_shape", r"\[KH, n_pages, 1\]"),
    ("fp_pool", "not int8")])
def test_append_shape_errors_match_reference(case, match):
    rng = np.random.default_rng(7)
    k, v = _kv(rng, 2)
    pt = np.arange(1, 5).reshape(1, 4).astype(np.int32)
    pos = np.zeros(1, np.int32)
    errors = []
    for ns, pkg in ((jnp, jpa), (torch, tpa)):
        conv = (jnp.asarray if ns is jnp else torch.from_numpy)
        pk = ns.zeros((KH, 8, PG, D), dtype=ns.int8)
        sk = ns.zeros((KH, 8, 1), dtype=ns.float32)
        args = [pk, pk, conv(pt), conv(pos), conv(k), conv(v)]
        if case == "one_scale":
            args += [sk, None]
        elif case == "scale_shape":
            args += [sk[:, :, 0], sk[:, :, 0]]
        elif case == "fp_pool":
            fp = ns.zeros((KH, 8, PG, D), dtype=ns.float32)
            args = [fp, fp] + args[2:] + [sk, sk]
        with pytest.raises(pkg.PagedShapeError, match=match) as ei:
            pkg.paged_append(*args)
        errors.append(str(ei.value).replace("torch.", ""))
    if case != "scale_shape":              # shapes print as tuples here
        assert errors[0] == errors[1]


# ------------------------------------------------ pool and bytes


def test_pool_shapes_and_page_bytes_match_jax():
    jcfg, tcfg = jl.llama_tiny(), tl.llama_tiny()     # bf16
    jpool = jkv.init_kv_pool(jcfg, 16, 8, kv_dtype="int8")
    tpool = tkv.init_kv_pool(tcfg, 16, 8, kv_dtype="int8", device="cpu")
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for layer in tpool for t in layer] == \
        [(tuple(a.shape), a.dtype.name) for layer in jpool for a in layer]
    assert not any(t.any() for layer in tpool for t in layer)
    for kv_dtype in ("fp", "int8"):
        assert tkv.kv_pool_page_bytes(tcfg, 8, kv_dtype) == \
            jkv.kv_pool_page_bytes(jcfg, 8, kv_dtype)
    pt = torch.zeros(2, 4, dtype=torch.int32)
    view = tkv.kv_layer_view(tpool[0], pt)
    assert view.quantized and view.page_size == 8
    assert all(a is b for a, b in zip(tkv.kv_layer_store(view), tpool[0]))
    fp = tkv.kv_layer_view(tkv.init_kv_pool(tcfg, 4, 8, device="cpu")[0],
                           pt)
    assert not fp.quantized and len(tkv.kv_layer_store(fp)) == 2
    with pytest.raises(ValueError):
        tkv.init_kv_pool(tcfg, 16, 8, kv_dtype="int4", device="cpu")


def _filled_pools(kv_dtype):
    """The same random 2-layer pool (llama_tiny widths: 2 kv heads, head
    dim 16, 8-token pages) in both packages."""
    rng = np.random.default_rng(12)
    jcfg, tcfg = jl.llama_tiny(), tl.llama_tiny()
    shape, sshape = (2, 6, 8, 16), (2, 6, 1)
    jpool, tpool = [], []
    for _ in range(jcfg.n_layers):
        if kv_dtype == "int8":
            arrs = [rng.integers(-127, 128, shape).astype(np.int8)
                    for _ in range(2)]
            arrs += [rng.uniform(0.1, 2.0, sshape).astype(np.float32)
                     for _ in range(2)]
            jpool.append(tuple(jnp.asarray(a) for a in arrs))
            tpool.append(tuple(torch.from_numpy(a) for a in arrs))
        else:
            arrs = [rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2)]
            jpool.append(tuple(jnp.asarray(a, jnp.bfloat16) for a in arrs))
            tpool.append(tuple(torch.from_numpy(a).to(torch.bfloat16)
                               for a in arrs))
    return jcfg, tcfg, jpool, tpool


@pytest.mark.parametrize("kv_dtype", ["int8", "fp"])
def test_export_page_bytes_identical_to_jax(kv_dtype):
    jcfg, tcfg, jpool, tpool = _filled_pools(kv_dtype)
    jb = jkv.export_page_bytes(jpool, 3)
    tb = tkv.export_page_bytes(tpool, 3)
    assert tb == jb
    assert [len(b) for b in tb[0]] == (
        [256, 256, 8, 8] if kv_dtype == "int8" else [512, 512])
    cols = tkv.page_cols_from_bytes(tcfg, 8, kv_dtype, jb)
    for layer, tcols in zip(tpool, cols):
        for t, col in zip(layer, tcols):
            assert col.device.type == "cpu" and col.dtype == t.dtype
            assert torch.equal(col, t[:, 3])


@pytest.mark.parametrize("bad", ["truncated", "cross_dtype", "arity",
                                 "layers"])
def test_page_cols_from_bytes_refuses_like_jax(bad):
    jcfg, tcfg, jpool, _ = _filled_pools("int8")
    blobs = jkv.export_page_bytes(jpool, 2)
    kv_dtype = "int8"
    if bad == "truncated":
        blobs[1][2] = blobs[1][2][:-1]
    elif bad == "cross_dtype":            # bf16 payloads in an int8 pool
        blobs = jkv.export_page_bytes(_filled_pools("fp")[2], 2)
        blobs = [layer + layer for layer in blobs]
    elif bad == "arity":                  # int8 blobs into an fp pool
        kv_dtype = "fp"
    else:
        blobs = blobs[:1]
    msgs = []
    for pkg, cfg in ((jkv, jcfg), (tkv, tcfg)):
        with pytest.raises(ValueError) as ei:
            pkg.page_cols_from_bytes(cfg, 8, kv_dtype, blobs)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_kv_dtype_resolution_precedence(monkeypatch):
    def both(arg):
        outs = []
        for mod in (jenv, tenv):
            try:
                outs.append(mod.resolve_kv_dtype(arg))
            except ValueError as e:       # EnvKnobError is a ValueError
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1]
        return outs[1]

    monkeypatch.delenv("RAY_TPU_KV_DTYPE", raising=False)
    assert both(None) == "fp"
    assert both("int8") == "int8"
    monkeypatch.setenv("RAY_TPU_KV_DTYPE", "int8")
    assert both("fp") == "int8"            # env wins over the arg
    monkeypatch.setenv("RAY_TPU_KV_DTYPE", "")
    assert both("int8") == "int8"          # empty = unset
    assert both("fp16")[0] == "ValueError"       # bad ARG: plain error
    monkeypatch.setenv("RAY_TPU_KV_DTYPE", "int4")
    assert both(None)[0] == "EnvKnobError"       # bad ENV: typed error
    with pytest.raises(tenv.EnvKnobError) as ei:
        tenv.parse_kv_dtype_env()
    assert ei.value.name == "RAY_TPU_KV_DTYPE"
    assert isinstance(ei.value, ValueError)


# ------------------------------------------------------ engine level

_ENGINE = dict(max_slots=4, page_size=8, n_pages=64, chunk=4,
               prefill_chunk=16, temperature=0.0, seed=0, eos_id=-1)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, flax params, torch model) of llama_tiny fp32."""
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, tl.build_model(
        tl.llama_tiny(dtype=torch.float32), sd, "cpu")


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 255, size=10).tolist() for _ in range(4)]


def _run(eng, prompts, n):
    hs = [eng.submit(list(p), max_new_tokens=n) for p in prompts]
    while eng.step():
        pass
    out = [h.result() for h in hs]
    assert eng.alloc.occupancy() == 0
    return out


def _port(tiny, **kw):
    return LLMEngine(tiny[2], device="cpu", **{**_ENGINE, **kw})


@pytest.fixture(scope="module")
def jax_int8_streams(tiny):
    eng = JEngine(tiny[0], tiny[1], overlap=False, kv_dtype="int8",
                  **_ENGINE)
    out = _run(eng, _prompts(), 16)
    report = eng.load_report()
    eng.shutdown()
    return out, report


def test_engine_int8_matches_jax_engine(tiny, jax_int8_streams):
    assert _run(_port(tiny, kv_dtype="int8"), _prompts(), 16) == \
        jax_int8_streams[0]


def test_engine_int8_deterministic(tiny):
    outs = [_run(_port(tiny, kv_dtype="int8"), _prompts()[:2], 8)
            for _ in range(2)]
    assert outs[0] == outs[1]


def test_engine_int8_fp_token_agreement(tiny):
    fp = _run(_port(tiny), _prompts(), 16)
    q = _run(_port(tiny, kv_dtype="int8"), _prompts(), 16)
    total = sum(len(o) for o in fp)
    agree = sum(x == y for a, b in zip(fp, q) for x, y in zip(a, b))
    assert agree / total >= 0.8, (agree, total)


def test_int8_load_report_bytes(tiny, jax_int8_streams):
    eng = _port(tiny, kv_dtype="int8")
    rpt = eng.load_report()
    cfg = tiny[2].cfg
    assert rpt["kv_dtype"] == "int8"
    assert rpt["kv_page_bytes"] == tkv.kv_pool_page_bytes(cfg, 8, "int8")
    assert rpt["kv_bytes_total"] == 64 * rpt["kv_page_bytes"]
    assert rpt["kv_bytes_in_use"] == 0
    jrpt = jax_int8_streams[1]
    for key in ("kv_dtype", "kv_page_bytes", "kv_bytes_total",
                "kv_bytes_in_use"):
        assert rpt[key] == jrpt[key], key
    assert eng.pages[0][0].dtype == torch.int8 and len(eng.pages[0]) == 4


def test_engine_env_kv_dtype_override(tiny, monkeypatch):
    monkeypatch.setenv("RAY_TPU_KV_DTYPE", "int8")
    assert _port(tiny, kv_dtype="fp").kv_dtype == "int8"   # env wins
    monkeypatch.setenv("RAY_TPU_KV_DTYPE", "int4")
    with pytest.raises(tenv.EnvKnobError):
        _port(tiny)
