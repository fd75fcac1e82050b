"""The Llama train step of ``bench.py --model llama-1.1b`` in the port
against the JAX package on the CPU.

``llama_tiny(max_seq_len=128, dtype=float32, attention_impl="flash")``
(4 q heads over 2 kv heads): the JAX side runs ``nn.remat`` blocks and
its Pallas kernels in interpret mode, the port the plain versions of
K3-K5 through the kernels' ``autograd.Function``, on fp32 masters
(``build_train_model``), with ``remat`` off and on. The loss is bench's:
the mean softmax cross-entropy of the fp32 logits of ``ids[:, :-1]``
against ``ids[:, 1:]``; the optimizer ``adamw(1e-3, weight_decay=0.1)``
(optax's, and ``train.spmd.adamw``). Same flax weights, same numpy
batch. Step 1's gradients agree leaf by leaf within 1e-4 (abs and rel),
the losses and grad norms of 3 steps within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import llama as jl
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import spmd

LR, WD = 1e-3, 0.1
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _torch_loss(model, b):
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    logits = model(x)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1).long())


def _train(tree, batch, remat, dtype=torch.float32):
    cfg = tl.llama_tiny(max_seq_len=128, dtype=dtype,
                        attention_impl="flash", remat=remat)
    model = tl.build_train_model(cfg, tl.flax_state_dict(tree), "cpu")
    opt = spmd.adamw(LR, weight_decay=WD)
    state = spmd.TrainState.create(model, opt)
    step = spmd.make_train_step(_torch_loss, opt)
    b = spmd.put_batch(batch, "cpu")
    metrics, grads = [], None
    for _ in range(3):
        state, m = step(state, b)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics, grads, state


@pytest.fixture(scope="module")
def runs():
    jcfg = jl.llama_tiny(max_seq_len=128, dtype=jnp.float32,
                         attention_impl="flash", remat=True)
    jmodel = jl.Llama(jcfg)
    ids = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, size=(2, 129)).astype(np.int32)
    params = jax.jit(jmodel.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jnp.asarray(ids[:, :-1]))

    def loss_fn(p, b):
        x, y = b["ids"][:, :-1], b["ids"][:, 1:]
        logits, _ = jmodel.apply(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y).mean()

    batch = {"ids": jnp.asarray(ids)}
    jgrads = jax.jit(jax.grad(loss_fn), compiler_options=FAST_COMPILE)(
        params, batch)
    opt = optax.adamw(LR, weight_decay=WD)
    state = jspmd.TrainState.create(params, opt)
    jstep = jspmd.make_train_step(loss_fn, opt, donate=False).lower(
        state, batch).compile(FAST_COMPILE)
    jmetrics = []
    for _ in range(3):
        state, m = jstep(state, batch)
        jmetrics.append((float(m["loss"]), float(m["grad_norm"])))
    tree = jax.tree_util.tree_map(np.asarray, params)
    out = {"jmetrics": jmetrics, "tree": tree, "ids": ids,
           "jgrads": tl.flax_state_dict(jax.tree_util.tree_map(np.asarray,
                                                               jgrads))}
    for remat in (False, True):
        out[remat] = _train(tree, {"ids": ids}, remat)
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
def test_step1_gradients_match_jax_leaf_by_leaf(runs, remat):
    jg, tg = runs["jgrads"], runs[remat][1]
    assert set(jg) == set(tg)
    for name in jg:
        np.testing.assert_allclose(tg[name].numpy(), jg[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
@pytest.mark.parametrize("i", [0, 1, 2])
def test_losses_and_grad_norms_match_optax(runs, remat, i):
    (jloss, jnorm), (tloss, tnorm) = runs["jmetrics"][i], runs[remat][0][i]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    np.testing.assert_allclose(tnorm, jnorm, rtol=1e-4)


def test_remat_leaves_the_step_unchanged(runs):
    """The checkpointed blocks recompute the same forward: step 1's loss
    is identical and the three steps' metrics agree to fp32 rounding."""
    off, on = runs[False][0], runs[True][0]
    assert off[0][0] == on[0][0]
    np.testing.assert_allclose(on, off, rtol=1e-6)
    assert runs[True][2].step == 3
    assert on[2][0] < on[1][0] < on[0][0]


def test_bf16_compute_on_fp32_masters(runs):
    """The training model keeps fp32 masters and gradients whatever the
    compute dtype; the serving model stores its weights in cfg.dtype.
    bf16 steps on the CPU stay finite and near the fp32 ones."""
    metrics, grads, state = _train(runs["tree"], {"ids": runs["ids"]},
                                   True, torch.bfloat16)
    model = state.params
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {g.dtype for g in grads.values()} == {torch.float32}
    assert np.isfinite(metrics).all()
    np.testing.assert_allclose(metrics[0][0], runs[True][0][0][0],
                               rtol=1e-2)
    serving = tl.build_model(model.cfg, model.state_dict(), "cpu")
    assert serving.tok_embeddings.dtype == torch.bfloat16
    assert serving.layers[0].attention.wq.weight.dtype == torch.bfloat16
    assert serving.norm.scale.dtype == torch.float32


def test_build_train_model_copies_its_weights(runs):
    sd = tl.flax_state_dict(runs["tree"])
    model = tl.build_train_model(tl.llama_tiny(dtype=torch.float32), sd,
                                 "cpu")
    with torch.no_grad():
        model.tok_embeddings.add_(1.0)
    assert not torch.equal(model.tok_embeddings, sd["tok_embeddings"])
    assert all(p.is_leaf and p.requires_grad for p in model.parameters())


def _jax_cfg(tcfg):
    return jl.LlamaConfig(**{f: getattr(tcfg, f) for f in (
        "vocab_size", "max_seq_len", "dim", "n_layers", "n_heads",
        "n_kv_heads", "hidden_dim", "rope_theta", "norm_eps")})


@pytest.mark.parametrize("preset,seq", [("llama_tiny", 128),
                                        ("tinyllama_1_1b", 1024),
                                        ("LlamaConfig", 4096)])
def test_llama_flops_per_token_matches_jax(preset, seq):
    tcfg = getattr(tl, preset)()
    assert tl.llama_flops_per_token(tcfg, seq) == \
        jl.llama_flops_per_token(_jax_cfg(tcfg), seq)


def test_tinyllama_training_flops_per_token():
    cfg = tl.tinyllama_1_1b(max_seq_len=1024, remat=True)
    assert tl.llama_param_count(cfg) == 1_034_512_384
    assert tl.llama_flops_per_token(cfg, 1024) == 6_760_722_432


@pytest.mark.parametrize("tp", [0, 1, 2, 3, 4, 8, 16])
def test_llama_tp_validate_matches_jax(tp):
    tcfg = tl.tinyllama_1_1b()
    jcfg = _jax_cfg(tcfg)
    errors = []
    for fn, cfg in ((jl.llama_tp_validate, jcfg),
                    (tl.llama_tp_validate, tcfg)):
        try:
            fn(cfg, tp)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
