"""The static-cache and cache-free branches of
``ray_tpu_torch.models.llama``, ``generate``, ``generate_stream`` and
``LlamaDeployment(use_engine=False)``, against ``ray_tpu`` on the CPU.

``llama_tiny(dtype=float32)`` (4 q heads over 2 kv heads) with the flax
params of ``PRNGKey(0)`` carried into the port by ``flax_state_dict``;
prompts from numpy seeds. Tolerance: logits and cache contents within
1e-5 (abs and rel) in fp32 (the two sum in different orders); greedy
tokens identical. Sampled tokens (temperature > 0) come from a
``torch.Generator``, not ``jax.random``: only their shapes, range and
seeded repeatability are checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve.llm import LlamaDeployment as JaxDeployment
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm import LlamaDeployment

TOL = 1e-5
# XLA's backend optimizations cost most of the JAX side's compile time
# here and buy nothing at these sizes
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def models():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    tmodel = tl.build_model(tl.llama_tiny(dtype=torch.float32), sd, "cpu")
    return jmodel, params, tmodel, sd


def _prompt(seed, B, T):
    return np.random.RandomState(seed).randint(1, 200, (B, T)).astype(
        np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,T0", [(1, 5), (2, 12)])
def test_static_cache_prefill_then_decode_matches_jax(models, B, T0):
    """Prefill at position 0, then 4 single-token steps: each step's
    logits and the caches against JAX's, and the logits against the
    port's own cache-free forward over the whole sequence."""
    jmodel, params, tmodel, _ = models
    cfg, n = tmodel.cfg, 4
    ids = _prompt(T0, B, T0 + n)
    jcache = jl.init_kv_caches(jmodel.config, B, T0 + n)
    tcache = tl.init_kv_caches(cfg, B, T0 + n, "cpu")
    assert [tuple(k.shape) for k, _ in tcache] == \
        [(B, T0 + n, cfg.n_kv_heads, cfg.head_dim)] * cfg.n_layers
    jlog, jcache = jmodel.apply(params, jnp.asarray(ids[:, :T0]),
                                kv_caches=jcache, cache_len=0)
    tlog = tmodel(torch.from_numpy(ids[:, :T0]), tcache, 0)
    _close(tlog, jlog)
    steps = [tlog]
    for pos in range(T0, T0 + n):
        jlog, jcache = jmodel.apply(params, jnp.asarray(ids[:, pos:pos + 1]),
                                    kv_caches=jcache, cache_len=pos)
        tlog = tmodel(torch.from_numpy(ids[:, pos:pos + 1]), tcache, pos)
        assert tlog.dtype == torch.float32 and not tlog.requires_grad
        _close(tlog, jlog)
        steps.append(tlog)
    for (tk, tv), (jk, jv) in zip(tcache, jcache):
        _close(tk, jk)
        _close(tv, jv)
    full = tmodel(torch.from_numpy(ids))
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=TOL,
                               atol=TOL)


def test_static_cache_refuses_positions_past_its_end(models):
    _, _, tmodel, _ = models
    cache = tl.init_kv_caches(tmodel.cfg, 1, 6, "cpu")
    with pytest.raises(ValueError, match="static cache"):
        tmodel(torch.zeros((1, 4), dtype=torch.int32), cache, 3)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_cache_free_forward_matches_jax(models, impl):
    """T 128 (flash's multiple): JAX's Pallas kernel in interpret mode or
    its XLA attention, the port's plain version of K3 or its dense
    attention, on K/V repeated per head."""
    _, params, _, sd = models
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32, attention_impl=impl))
    ids = _prompt(7, 2, 128)
    jlog, _ = jax.jit(jmodel.apply, compiler_options=FAST_COMPILE)(
        params, jnp.asarray(ids))
    tmodel = tl.build_model(
        tl.llama_tiny(dtype=torch.float32, attention_impl=impl), sd, "cpu")
    tlog = tmodel(torch.from_numpy(ids))
    assert tlog.shape == (2, 128, tmodel.cfg.vocab_size)
    _close(tlog.detach(), jlog)


def test_cache_free_forward_records_autograd_and_caches_do_not(models):
    _, _, _, sd = models
    model = tl.build_train_model(tl.llama_tiny(dtype=torch.float32), sd,
                                 "cpu")
    ids = torch.from_numpy(_prompt(1, 1, 6))
    assert model(ids).requires_grad
    cache = tl.init_kv_caches(model.cfg, 1, 6, "cpu")
    assert not model(ids, cache, 0).requires_grad


def test_generate_greedy_matches_jax(models):
    jmodel, params, tmodel, _ = models
    prompt = _prompt(0, 2, 16)
    want = np.asarray(jl.generate(jmodel, params, jnp.asarray(prompt),
                                  max_new_tokens=21))
    got = tl.generate(tmodel, prompt, 21)
    assert got.dtype == torch.int32 and got.shape == (2, 37)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,B,eos", [(0, 2, 148), (0, 2, 144),
                                        (0, 1, None), (4, 2, 0)],
                         ids=["one_row_draws_eos", "all_rows_zero_tail",
                              "single_row_zero_tail", "eos_id_0"])
def test_generate_eos_matches_jax(models, seed, B, eos):
    """With the prompts of seed 0, row 0 draws 148 at step 0 and row 1
    never (generation runs to the end); both rows draw 144, the last at
    step 7 (the tail after it is zero); the single row's 6th token ends
    it; with seed 4 row 0 draws 0 at step 5 and row 1 never."""
    jmodel, params, tmodel, _ = models
    prompt = _prompt(seed, B, 16)
    if eos is None:
        eos = int(tl.generate(tmodel, prompt, 21)[0, 16 + 5])
    want = np.asarray(jl.generate(jmodel, params, jnp.asarray(prompt),
                                  max_new_tokens=21, eos_id=eos))
    got = tl.generate(tmodel, prompt, 21, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 16:] == eos).any(axis=1).any()


def test_generate_stops_when_the_last_row_draws_eos(models):
    """The zero tail starts right after the step at which every row has
    drawn eos (here the second row, at a step the host reads in the
    middle of a chunk of eos checks)."""
    _, _, tmodel, _ = models
    prompt = _prompt(0, 2, 16)
    free = tl.generate(tmodel, prompt, 21).numpy()[:, 16:]
    last = max(int(np.argmax(row == 144)) for row in free)
    got = tl.generate(tmodel, prompt, 21, eos_id=144).numpy()[:, 16:]
    np.testing.assert_array_equal(got[:, :last + 1], free[:, :last + 1])
    assert (got[:, last + 1:] == 0).all() and last + 1 < 21


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_generate_stream_matches_generate(models, chunk):
    jmodel, params, tmodel, _ = models
    prompt = _prompt(3, 2, 16)
    full = tl.generate(tmodel, prompt, 21).numpy()
    rows = list(tl.generate_stream(tmodel, prompt, 21, chunk_size=chunk))
    assert all(r.dtype == np.int32 and r.shape == (2,) for r in rows)
    np.testing.assert_array_equal(np.stack(rows, axis=1), full[:, 16:])
    if chunk == 4:
        jrows = list(jl.generate_stream(jmodel, params, jnp.asarray(prompt),
                                        max_new_tokens=21, chunk_size=4))
        np.testing.assert_array_equal(np.stack(rows, axis=1),
                                      np.stack(jrows, axis=1))


def test_generate_stream_eos_stops_as_jax(models):
    jmodel, params, tmodel, _ = models
    prompt = _prompt(5, 1, 16)
    eos = int(tl.generate(tmodel, prompt, 24)[0, 16 + 5])
    got = [int(t[0]) for t in tl.generate_stream(tmodel, prompt, 24,
                                                 eos_id=eos, chunk_size=4)]
    want = [int(t[0]) for t in jl.generate_stream(
        jmodel, params, jnp.asarray(prompt), max_new_tokens=24, eos_id=eos,
        chunk_size=4)]
    assert got == want and got[-1] == eos and got.index(eos) == 5


def test_sampling_is_seeded_and_in_range(models):
    _, _, tmodel, _ = models
    prompt = _prompt(2, 2, 10)
    vocab = tmodel.cfg.vocab_size

    def draw(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return tl.generate(tmodel, prompt, 12, temperature=1.0, generator=g)

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == (2, 22) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(draw(None), draw(None))    # seeded 0 by default
    np.testing.assert_array_equal(a[:, :10].numpy(), prompt)
    assert int(a.min()) >= 0 and int(a.max()) < vocab
    rows = list(tl.generate_stream(tmodel, prompt, 12, temperature=1.0,
                                   chunk_size=5))
    assert len(rows) == 12 and all(
        r.shape == (2,) and 0 <= r.min() and r.max() < vocab for r in rows)


@pytest.mark.parametrize("bad", ["no_new_tokens", "id_past_vocab",
                                 "negative_id", "empty_prompt", "1d"])
def test_generate_refuses_what_it_cannot_serve(models, bad):
    _, _, tmodel, _ = models
    prompt, n = _prompt(0, 1, 4), 4
    if bad == "no_new_tokens":
        n = 0
    elif bad == "id_past_vocab":
        prompt[0, 2] = tmodel.cfg.vocab_size
    elif bad == "negative_id":
        prompt[0, 0] = -1
    elif bad == "empty_prompt":
        prompt = prompt[:, :0]
    else:
        prompt = prompt[0]
    for fn in (tl.generate, lambda *a: next(tl.generate_stream(*a))):
        with pytest.raises(ValueError):
            fn(tmodel, prompt, n)


@pytest.fixture(scope="module")
def deployments(models):
    _, params, _, sd = models
    kw = dict(max_new_tokens=10, use_engine=False, stream_chunk=4)
    return (JaxDeployment(jl.llama_tiny(dtype=jnp.float32), params, **kw),
            LlamaDeployment(tl.llama_tiny(dtype=torch.float32), sd,
                            device="cpu", **kw))


def test_deployment_call_and_stream_match_jax(deployments):
    jdep, tdep = deployments
    prompt = _prompt(11, 1, 8)[0].tolist()
    out = tdep(prompt)
    assert out == jdep(prompt) and len(out) == 18
    streamed = list(tdep.stream(prompt))
    assert streamed == list(jdep.stream(prompt)) == out[8:]
    assert tdep._engine is None


def test_deployment_generate_batch_buckets_as_jax(deployments):
    jdep, tdep = deployments
    prompts = [p.tolist() for p in _prompt(12, 2, 8)] + \
        [_prompt(13, 1, 5)[0].tolist()]
    prompts = [prompts[0], prompts[2], prompts[1]]
    got = tdep.generate_batch(prompts)
    assert got == jdep.generate_batch(prompts)
    assert [len(g) for g in got] == [10, 10, 10]
    assert got[0] == tdep(prompts[0])[8:]
