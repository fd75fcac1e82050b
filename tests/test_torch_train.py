"""ray_tpu_torch.train.spmd against ray_tpu.train.spmd on the CPU.

The GPT-2 train step of ``bench.py`` (features + ``linear_cross_entropy``
under AdamW) on ``gpt2_tiny(n_ctx=128, dtype=float32)`` with flash
attention on both sides: the JAX step runs its Pallas kernels in
interpret mode, the port its plain versions through the kernels'
``autograd.Function``. Same flax weights, same numpy batch. Step 1's
gradients agree leaf by leaf within 1e-4 (abs and rel); the losses and
grad norms of 3 steps within 1e-4 relative. (The parameters themselves
are not compared after the steps: the k part of ``c_attn``'s bias has
a gradient that is zero in exact arithmetic, so both sides hold
rounding noise there, and AdamW's first steps move each such element
by about the learning rate in the direction of that noise.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.train import spmd

LR, WD = 1e-3, 0.1
# XLA's backend optimizations cost most of the JAX side's compile time
# here and buy nothing at these sizes
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _torch_loss(model, b):
    x, y = b["ids"][:, :-1], b["ids"][:, 1:]
    return tg.linear_cross_entropy(model(x, return_features=True),
                                   model.wte, y)


@pytest.fixture(scope="module")
def runs():
    jcfg = jg.gpt2_tiny(n_ctx=128, dtype=jnp.float32, attention_impl="flash")
    jmodel = jg.GPT2(jcfg)
    ids = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, size=(2, 129)).astype(np.int32)
    params = jax.jit(jmodel.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jnp.asarray(ids[:, :-1]))

    def loss_fn(p, b):
        x, y = b["ids"][:, :-1], b["ids"][:, 1:]
        feats = jmodel.apply(p, x, return_features=True)
        return jg.linear_cross_entropy(feats, p["params"]["wte"], y)

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

    tcfg = tg.gpt2_tiny(n_ctx=128, dtype=torch.float32,
                        attention_impl="flash")
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = tg.build_model(tcfg, tg.flax_state_dict(tree), "cpu")
    topt = spmd.adamw(LR, weight_decay=WD)
    tstate = spmd.TrainState.create(model, topt)
    tstep = spmd.make_train_step(_torch_loss, topt)
    tbatch = spmd.put_batch({"ids": ids}, "cpu")
    tmetrics, tgrads = [], None
    for _ in range(3):
        tstate, m = tstep(tstate, tbatch)
        tmetrics.append((m["loss"].item(), m["grad_norm"].item()))
        if tgrads is None:
            tgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    jgrads_sd = tg.flax_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, jgrads=jgrads_sd,
                tgrads=tgrads, tstate=tstate)


def test_step1_gradients_match_jax_leaf_by_leaf(runs):
    jg_, tg_ = runs["jgrads"], runs["tgrads"]
    assert set(jg_) == set(tg_)
    for name in jg_:
        np.testing.assert_allclose(tg_[name].numpy(), jg_[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_losses_and_grad_norms_match_jax(runs, i):
    (jl, jn), (tl, tn) = runs["jmetrics"][i], runs["tmetrics"][i]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)


def test_three_steps_take_the_loss_down(runs):
    assert runs["tstate"].step == 3
    losses = [m[0] for m in runs["tmetrics"]]
    assert losses[2] < losses[1] < losses[0]


def test_adamw_is_optax_adamw_with_decay_on_every_param():
    """Three updates of the same params from the same gradients agree to
    1e-5 relative: the two compute the update in different orders, a
    few fp32 ulps apart."""
    g = np.random.default_rng(0)
    params = {"w": g.standard_normal((4, 3)).astype(np.float32),
              "bias": g.standard_normal(3).astype(np.float32)}
    grads = [{k: g.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    opt = optax.adamw(1e-2, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    topt = spmd.adamw(1e-2, weight_decay=0.1)(tp.values())
    for gr in grads:
        upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, gr), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(gr[k])
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


def test_train_step_refuses_a_foreign_optimizer_state():
    cfg = tg.gpt2_tiny(dtype=torch.float32)
    model = tg.build_model(cfg, tg.init_params(cfg, 0, "cpu"), "cpu")
    state = spmd.TrainState(model, torch.optim.SGD(model.parameters(), 0.1),
                            0)
    step = spmd.make_train_step(_torch_loss, spmd.adamw(1e-3))
    batch = spmd.put_batch({"ids": np.zeros((1, 9), np.int32)}, "cpu")
    with pytest.raises(TypeError):
        step(state, batch)


def test_put_batch_places_nested_batches():
    out = spmd.put_batch({"ids": np.arange(6, dtype=np.int32).reshape(2, 3),
                          "pair": (torch.ones(2), [np.zeros(1)])}, "cpu")
    assert out["ids"].dtype == torch.int32 and out["ids"].shape == (2, 3)
    assert isinstance(out["pair"], tuple) and isinstance(out["pair"][1], list)
    assert all(t.device.type == "cpu"
               for t in (out["ids"], out["pair"][0], out["pair"][1][0]))
