"""ray_tpu_torch.models.llama against ray_tpu.models.llama on the CPU.

The flax params of ``llama_tiny(dtype=float32)`` from ``PRNGKey(0)``
are carried into the torch model by ``load_flax_params``; both models
then run the paged branch over the same numpy page pools. Tolerance:
logits within 1e-4 (abs and rel) in fp32, the same for the pool bytes
each side appended (the K/V projections and RoPE run in different
summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models.kv_cache import PagedKVLayer as JPagedKVLayer
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.kv_cache import PagedKVLayer


@pytest.fixture(scope="module")
def models():
    cfg = jl.llama_tiny(dtype=jnp.float32)
    jmodel = jl.Llama(cfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tl.Llama(tl.llama_tiny(dtype=torch.float32))
    tl.load_flax_params(tmodel, tree)
    return jmodel, params, tmodel.eval()


def _pools(seed, cfg, n_pages, page_size):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_kv_heads, n_pages, page_size, cfg.head_dim)
    return [tuple((0.1 * rng.standard_normal(shape)).astype(np.float32)
                  for _ in range(2)) for _ in range(cfg.n_layers)]


@pytest.mark.parametrize("T,pos", [(5, [0, 6]), (1, [0, 13]),
                                   (1, [7, 15]), (3, [4, 1])],
                         ids=["chunk", "decode", "decode_page_end",
                              "chunk_mid_page"])
def test_paged_logits_and_pool_match_jax(models, T, pos):
    jmodel, params, tmodel = models
    cfg = tmodel.cfg
    pools = _pools(T * 100 + pos[1], cfg, 16, 4)
    pt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    ids = np.random.default_rng(pos[0]).integers(
        0, cfg.vocab_size, (2, T)).astype(np.int32)
    jkv = [JPagedKVLayer(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt))
           for k, v in pools]
    jlog, jnew = jmodel.apply(params, jnp.asarray(ids), kv_caches=jkv,
                              cache_len=jnp.asarray(pos, jnp.int32))
    tkv = [PagedKVLayer(torch.tensor(k), torch.tensor(v),
                        torch.from_numpy(pt)) for k, v in pools]
    tlog = tmodel(torch.from_numpy(ids), tkv,
                  torch.tensor(pos, dtype=torch.int32))
    assert tlog.dtype == torch.float32
    assert tlog.shape == (2, T, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)
    for jc, tc in zip(jnew, tkv):
        np.testing.assert_allclose(tc.pages_k.numpy(),
                                   np.asarray(jc.pages_k),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tc.pages_v.numpy(),
                                   np.asarray(jc.pages_v),
                                   rtol=1e-4, atol=1e-4)


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    positions = np.array([[0, 1, 2], [7, 8, 9]], np.int32)
    j = jl.apply_rope(jnp.asarray(x), jl.rope_freqs(16, 32, 10000.0),
                      jnp.asarray(positions))
    t = tl.apply_rope(torch.from_numpy(x), tl.rope_freqs(16, 32, 10000.0),
                      torch.from_numpy(positions))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("preset", ["llama_tiny", "LlamaConfig",
                                    "tinyllama_1_1b"])
def test_param_count_matches_jax_and_module(preset):
    tcfg = getattr(tl, preset)()      # LlamaConfig(): Llama-2-7B widths
    jcfg = jl.LlamaConfig(**{f.name: getattr(tcfg, f.name)
                             for f in tl.LlamaConfig.__dataclass_fields__
                             .values() if f.name != "dtype"})
    assert tl.llama_param_count(tcfg) == jl.llama_param_count(jcfg)
    meta = tl.Llama(tcfg, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == \
        tl.llama_param_count(tcfg)


def test_tinyllama_preset_widths():
    cfg = tl.tinyllama_1_1b()
    assert (cfg.vocab_size, cfg.dim, cfg.n_layers, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim,
            cfg.max_seq_len) == (32000, 2048, 22, 32, 4, 64, 5632, 2048)
    assert cfg.dtype == torch.bfloat16
    assert 1.0e9 < tl.llama_param_count(cfg) < 1.2e9


def test_init_params_seeded_at_flax_scales():
    cfg = tl.llama_tiny(dtype=torch.float32, dim=128, hidden_dim=256)
    a = tl.init_params(cfg, seed=3, device="cpu")
    b = tl.init_params(cfg, seed=3, device="cpu")
    c = tl.init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tok_embeddings"], c["tok_embeddings"])
    assert abs(a["tok_embeddings"].std().item() - 0.02) < 0.002
    w = a["layers.0.feed_forward.w2.weight"]          # fan_in 256
    assert w.shape == (128, 256)
    assert abs(w.std().item() - (1 / 256) ** 0.5) < 0.005
    std = (1 / 256) ** 0.5 / 0.87962566103423978
    assert w.abs().max().item() <= 2 * std + 1e-6
    assert torch.equal(a["norm.scale"], torch.ones(128))
    model = tl.build_model(cfg, a, "cpu")
    assert model.tok_embeddings.dtype == torch.float32


def test_pick_token_ties_take_first_max():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    assert tl._pick_token(logits, 0.0).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)
                      ).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    sampled = tl._pick_token(logits, 1.0, gen)
    assert sampled.dtype == torch.int32
    assert sampled[0].item() in (0, 1, 2, 3)


def test_tied_logits_are_fp32_from_bf16_operands():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, generator=g).to(torch.bfloat16)
    emb = torch.randn(40, 16, generator=g).to(torch.bfloat16)
    out = tl._tied_logits(x, emb)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 40)
    # each bf16 product is exact in fp32: no rounding to bf16 at the end
    torch.testing.assert_close(out, x.float() @ emb.float().t(),
                               rtol=1e-6, atol=1e-6)
