"""ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2 on the CPU.

The flax params of ``gpt2_tiny(n_ctx=128, dtype=float32)`` from
``PRNGKey(0)`` are carried into the torch model by
``load_flax_params``; both models then run on the same numpy token
ids. Tolerance: logits, features and the three losses within 1e-4 (abs
and rel) in fp32, where the two differ only in summation order. The
bf16 forward is held to 0.05 abs + 2^-5 rel on the logits: the two
frameworks round the bf16 activations at different places (flax adds
the Dense bias to a bf16-rounded product, cuBLAS/CPU torch adds it
before rounding; the gelu and the residual sums round once per op), and
over 2 layers that grows to a few bf16 ulps of the hidden state.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu_torch.models import gpt2 as tg

TOL = dict(rtol=1e-4, atol=1e-4)
# XLA's backend optimizations cost most of the JAX side's compile time
# here and buy nothing at these sizes
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jcfg(tcfg):
    fields = {f.name: getattr(tcfg, f.name)
              for f in dataclasses.fields(tcfg)
              if f.name not in ("dtype", "param_dtype", "attention_impl")}
    return jg.GPT2Config(**fields, dtype=getattr(jnp, str(tcfg.dtype)[6:]))


@pytest.fixture(scope="module")
def models():
    tcfg = tg.gpt2_tiny(n_ctx=128, dtype=torch.float32)
    jmodel = jg.GPT2(_jcfg(tcfg))
    params = jax.jit(jmodel.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tg.load_flax_params(tg.GPT2(tcfg), tree)
    return _JitModel(jmodel), params, tmodel, tree


class _JitModel:
    """The flax model's ``apply`` under ``jax.jit`` (eager flax is the
    slow part of these tests)."""

    def __init__(self, model):
        self.apply = jax.jit(model.apply,
                             static_argnames=("return_features",),
                             compiler_options=FAST_COMPILE)


def _batch(seed, B=2, T=128, vocab=256):
    g = np.random.default_rng(seed)
    ids = g.integers(0, vocab, (B, T + 1)).astype(np.int32)
    tgt = ids[:, 1:].copy()
    tgt[0, :7] = -100                 # ignored positions
    return ids[:, :-1], tgt


@pytest.mark.parametrize("T", [128, 40])
def test_logits_and_features_match_jax(models, T):
    jmodel, params, tmodel, _ = models
    ids, _ = _batch(1)
    ids = ids[:, :T]
    jlog = jmodel.apply(params, jnp.asarray(ids))
    jfeat = jmodel.apply(params, jnp.asarray(ids), return_features=True)
    with torch.no_grad():
        tlog = tmodel(torch.from_numpy(ids))
        tfeat = tmodel(torch.from_numpy(ids), return_features=True)
    assert tlog.dtype == torch.float32 and tlog.shape == (2, T, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), **TOL)


@pytest.mark.parametrize("loss", ["cross_entropy_loss",
                                  "linear_cross_entropy",
                                  "fused_linear_cross_entropy"])
def test_losses_match_jax(models, loss):
    jmodel, params, tmodel, _ = models
    ids, tgt = _batch(2)
    if loss == "cross_entropy_loss":
        jl = jg.cross_entropy_loss(jmodel.apply(params, jnp.asarray(ids)),
                                   jnp.asarray(tgt))
        tl = tg.cross_entropy_loss(tmodel(torch.from_numpy(ids)),
                                   torch.from_numpy(tgt))
    else:
        jfeat = jmodel.apply(params, jnp.asarray(ids), return_features=True)
        kw = {"chunk": 32} if loss.startswith("fused") else {}
        jl = jax.jit(functools.partial(getattr(jg, loss), **kw),
                     compiler_options=FAST_COMPILE)(
            jfeat, params["params"]["wte"], jnp.asarray(tgt))
        tl = getattr(tg, loss)(
            tmodel(torch.from_numpy(ids), return_features=True),
            tmodel.wte, torch.from_numpy(tgt), **kw)
    assert tl.dtype == torch.float32 and tl.ndim == 0
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)


def test_fused_loss_gradients_equal_the_unfused_ones(models):
    _, _, tmodel, _ = models
    ids, tgt = _batch(3)
    grads = []
    for loss in (tg.linear_cross_entropy, tg.fused_linear_cross_entropy):
        tmodel.zero_grad()
        loss(tmodel(torch.from_numpy(ids), return_features=True),
             tmodel.wte, torch.from_numpy(tgt)).backward()
        grads.append([p.grad.clone() for p in tmodel.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)
    tmodel.zero_grad()


def test_bf16_forward_matches_jax(models):
    _, _, _, tree = models
    tcfg = tg.gpt2_tiny(n_ctx=128)
    jmodel = _JitModel(jg.GPT2(_jcfg(tcfg)))
    tmodel = tg.load_flax_params(tg.GPT2(tcfg), tree)
    ids, _ = _batch(4)
    jlog = jmodel.apply(tree, jnp.asarray(ids))
    with torch.no_grad():
        tlog = tmodel(torch.from_numpy(ids))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2 ** -5,
                               atol=0.05)


def test_flash_and_dense_agree_inside_the_model(models):
    _, _, _, tree = models
    outs = []
    for impl in ("flash", "dense", "dense_fp32"):
        cfg = tg.gpt2_tiny(n_ctx=128, dtype=torch.float32,
                           attention_impl=impl)
        model = tg.load_flax_params(tg.GPT2(cfg), tree)
        ids, tgt = _batch(5)
        loss = tg.linear_cross_entropy(
            model(torch.from_numpy(ids), return_features=True), model.wte,
            torch.from_numpy(tgt))
        loss.backward()
        outs.append((loss.detach(), model.h[0].attn.c_attn.weight.grad))
    for loss, grad in outs[1:]:
        torch.testing.assert_close(loss, outs[0][0], **TOL)
        torch.testing.assert_close(grad, outs[0][1], **TOL)


def test_remat_gives_the_same_loss_and_gradients(models):
    _, _, _, tree = models
    res = []
    for remat in (False, True):
        cfg = tg.gpt2_tiny(n_ctx=128, dtype=torch.float32, remat=remat)
        model = tg.load_flax_params(tg.GPT2(cfg), tree)
        ids, tgt = _batch(6)
        tg.cross_entropy_loss(model(torch.from_numpy(ids)),
                              torch.from_numpy(tgt)).backward()
        res.append([p.grad for p in model.parameters()])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("preset", ["gpt2_124m", "gpt2_tiny"])
def test_count_params_and_flops_match_jax(preset):
    tcfg = getattr(tg, preset)()
    jcfg = _jcfg(tcfg)
    shapes = jax.eval_shape(lambda: jg.GPT2(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    n = tg.count_params(tg.GPT2(tcfg, device="meta"))
    assert n == jg.count_params(shapes)
    for seq in (None, 256):
        assert tg.flops_per_token(tcfg, seq) == jg.flops_per_token(jcfg,
                                                                   seq)


def test_gpt2_124m_preset_widths():
    cfg = tg.gpt2_124m()
    assert (cfg.vocab_size, cfg.n_ctx, cfg.n_embd, cfg.n_layer, cfg.n_head,
            cfg.head_dim) == (50304, 1024, 768, 12, 12, 64)
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert 124e6 < tg.count_params(tg.GPT2(cfg, device="meta")) < 125e6


def test_init_params_seeded_at_flax_scales():
    cfg = tg.gpt2_tiny(n_embd=128, dtype=torch.float32)
    a = tg.init_params(cfg, seed=3, device="cpu")
    b = tg.init_params(cfg, seed=3, device="cpu")
    c = tg.init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte"], c["wte"])
    assert all(t.dtype == torch.float32 for t in a.values())
    assert abs(a["wte"].std().item() - 0.02) < 0.002
    assert abs(a["wpe"].std().item() - 0.01) < 0.001
    w = a["h.0.mlp.c_proj.weight"]                    # fan_in 512
    assert w.shape == (128, 512)
    assert abs(w.std().item() - (1 / 512) ** 0.5) < 0.003
    std = (1 / 512) ** 0.5 / 0.87962566103423978
    assert w.abs().max().item() <= 2 * std + 1e-6
    assert not a["h.0.mlp.c_proj.bias"].any()
    assert torch.equal(a["h.1.ln_2.scale"], torch.ones(128))
    assert tg.count_params(a) == tg.count_params(tg.GPT2(cfg, "meta"))
    model = tg.build_model(cfg, a, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    # the model holds copies: training it leaves the state dict alone
    with torch.no_grad():
        model.wte.add_(1.0)
    assert torch.equal(a["wte"], b["wte"])
