"""The port's RL loss pieces, attempt fence and rollout learner
(``ray_tpu_torch.rllib``, ``ray_tpu_torch.train.chaos``,
``ray_tpu_torch.rl.learner``) against the JAX package's, on the CPU.

- ``clipped_surrogate_loss`` (value and gradient) and ``vtrace_returns``
  on the same numpy arrays (seeded), padding included: 1e-6 absolute
  and relative (fp32, one op sequence each side).
- The GENERATION-file fence: one script of fences and checks run
  through both packages' ``chaos`` modules on their own directories
  gives the same generations and the same ``StaleGeneration``s; each
  package reads the other's file.
- ``RolloutLearner`` against the JAX learner on one scored
  ``RolloutBatch`` (``llama_tiny`` fp32, the flax params of
  PRNGKey(0), 4 samples of 5-9 prompt and 0-6 completion tokens,
  behavior logprobs the policy's own plus noise, seeded rewards), for
  ``ppo`` and ``vtrace``, ``lr=1e-3``, ``entropy_coef=0.01``,
  ``sgd_epochs=2``, three updates: every stat within 1e-4 relative
  (1e-6 absolute); the first epoch's gradients, and the params after
  the three updates, leaf by leaf within 1e-4 absolute and relative
  (tests/test_torch_llama_train.py's tolerance), the params but for the
  elements whose gradient is at rounding level, which Adam moves by up
  to ``lr`` a step in either package (held to that bound instead).
- The parity hazards on their own: the advantage normalized by the
  population std, the first update's baseline the batch mean then an
  EWMA, shapes frozen on the first batch, the logprob-length check,
  ``get_state`` copies, and no CPU fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.rl.learner import RolloutLearner as JLearner
from ray_tpu.rl.rollout import RolloutBatch as JBatch
from ray_tpu.rllib.impala import vtrace_returns as jvtrace
from ray_tpu.rllib.ppo import clipped_surrogate_loss as jsurrogate
from ray_tpu.train import chaos as jchaos
from ray_tpu_torch._device import NoCudaError
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.rl import RolloutBatch, RolloutLearner
from ray_tpu_torch.rllib import clipped_surrogate_loss, vtrace_returns
from ray_tpu_torch.train import chaos as tchaos

TOL = dict(rtol=1e-6, atol=1e-6)
LR = 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0}


# ------------------------------------------------------- loss pieces

@pytest.mark.parametrize("clip_eps", [0.1, 0.2])
def test_clipped_surrogate_loss_and_gradient_match_jax(clip_eps):
    g = np.random.default_rng(0)
    n = 48
    logp = g.normal(-2.0, 0.5, n).astype(np.float32)
    behavior = (logp + g.normal(0.0, 0.3, n)).astype(np.float32)
    adv = g.normal(0.0, 1.0, n).astype(np.float32)
    adv[-8:] = 0.0                                  # padding: counts, adds 0
    jloss, jgrad = jax.value_and_grad(
        lambda lp: jsurrogate(lp, behavior, adv, clip_eps))(
            jnp.asarray(logp))
    t = torch.tensor(logp, requires_grad=True)
    loss = clipped_surrogate_loss(t, torch.tensor(behavior),
                                  torch.tensor(adv), clip_eps)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **TOL)
    # the mean runs over all n entries, the zero-advantage ones too
    unpadded = clipped_surrogate_loss(t[:-8].detach(),
                                      torch.tensor(behavior[:-8]),
                                      torch.tensor(adv[:-8]), clip_eps)
    np.testing.assert_allclose(loss.item() * n / (n - 8), unpadded.item(),
                               rtol=1e-5)


def _vtrace_inputs(seed, B, T):
    g = np.random.default_rng(seed)
    values = g.normal(0.0, 1.0, (B, T)).astype(np.float32)
    rewards = g.normal(0.0, 1.0, (B, T)).astype(np.float32)
    dones = (g.random((B, T)) < 0.2).astype(np.float32)
    rhos = np.exp(g.normal(0.0, 0.7, (B, T))).astype(np.float32)
    last = g.normal(0.0, 1.0, B).astype(np.float32)
    return values, last, rewards, dones, rhos


@pytest.mark.parametrize("gamma,rho_bar,c_bar", [(1.0, 1.0, 1.0),
                                                 (0.9, 2.0, 0.5)])
def test_vtrace_returns_match_jax(gamma, rho_bar, c_bar):
    """One [T] sequence as the reference takes it, and [B, T] rows
    against the reference mapped over rows (the learner's vmap)."""
    values, last, rewards, dones, rhos = _vtrace_inputs(1, 3, 7)
    kw = dict(gamma=gamma, rho_bar=rho_bar, c_bar=c_bar)
    jvs, jpg = jax.vmap(lambda v, lv, r, d, rh: jvtrace(
        v, lv, r, d, rh, **kw))(*map(jnp.asarray, (values, last, rewards,
                                                   dones, rhos)))
    vs, pg = vtrace_returns(*map(torch.tensor, (values, last, rewards,
                                                dones, rhos)), **kw)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jpg), **TOL)
    jvs0, jpg0 = jvtrace(*map(jnp.asarray, (values[0], last[0], rewards[0],
                                            dones[0], rhos[0])), **kw)
    vs0, pg0 = vtrace_returns(torch.tensor(values[0]), float(last[0]),
                              torch.tensor(rewards[0]),
                              torch.tensor(dones[0]),
                              torch.tensor(rhos[0]), **kw)
    np.testing.assert_allclose(vs0.numpy(), np.asarray(jvs0), **TOL)
    np.testing.assert_allclose(pg0.numpy(), np.asarray(jpg0), **TOL)


def test_vtrace_returns_are_detached():
    values, last, rewards, dones, rhos = _vtrace_inputs(2, 2, 5)
    v = torch.tensor(values, requires_grad=True)
    rh = torch.tensor(rhos, requires_grad=True)
    vs, pg = vtrace_returns(v, torch.tensor(last), torch.tensor(rewards),
                            torch.tensor(dones), rh, gamma=0.95)
    assert not vs.requires_grad and not pg.requires_grad


# ------------------------------------------------------------ fence

def _fence_script(chaos, root):
    """Fences and checks in the order two attempts would make them."""
    out = [chaos.generation(str(root))]
    with chaos.AttemptFence(str(root / "ctl"), 1) as f1:
        ctl = str(root / "ctl")
        out.append(chaos.generation(ctl))
        f1.check()
        out.append(chaos.fence(ctl, 1))            # idempotent
        with chaos.AttemptFence(ctl, 3):
            out.append(chaos.generation(ctl))
            with pytest.raises(chaos.StaleGeneration) as ei:
                f1.check()
            out.append(str(ei.value))
            out.append(chaos.fence(ctl, 2))        # never moves back
            chaos.check_generation(ctl, 3)
            chaos.check_generation("", 0)          # no dir: no fence
    with open(root / "ctl" / chaos.GEN_FILE) as fh:
        out.append(fh.read())
    return out


def test_attempt_fence_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    got = _fence_script(tchaos, tmp_path / "t")
    assert got == _fence_script(jchaos, tmp_path / "j")
    assert got == [0, 1, 1, 3, "gang attempt 1 superseded by attempt 3", 3,
                   "3"]
    assert tchaos.GEN_FILE == jchaos.GEN_FILE
    # each package reads and honours the other's file
    assert tchaos.generation(str(tmp_path / "j" / "ctl")) == 3
    with pytest.raises(tchaos.StaleGeneration):
        tchaos.check_generation(str(tmp_path / "j" / "ctl"), 2)
    jchaos.fence(str(tmp_path / "t" / "ctl"), 4)
    with pytest.raises(tchaos.StaleGeneration):
        tchaos.AttemptFence(str(tmp_path / "t" / "ctl"), 3).check()


def test_unreadable_generation_file_reads_as_zero(tmp_path):
    (tmp_path / tchaos.GEN_FILE).write_text("not a number")
    assert tchaos.generation(str(tmp_path)) == 0
    assert tchaos.fence(str(tmp_path), 2) == 2


# ---------------------------------------------------------- learner

@pytest.fixture(scope="module")
def tiny():
    cfg = jl.llama_tiny(dtype=jnp.float32)
    jmodel = jl.Llama(cfg)
    params = jax.jit(jmodel.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = tl.llama_tiny(dtype=torch.float32)
    sd = tl.flax_state_dict(tree)
    return {"jmodel": jmodel, "params": params, "sd": sd, "cfg": cfg,
            "model": tl.build_model(cfg, sd, "cpu")}


def _batch_fields(tiny, seed=3):
    """4 samples: prompts of 5-9 tokens, completions of 0-6 (one
    empty), behavior logprobs the initial policy's teacher-forced ones
    plus noise (so some ratios clip), seeded rewards."""
    g = np.random.default_rng(seed)
    prompts = [g.integers(1, 256, int(n)).tolist() for n in (5, 9, 7, 6)]
    completions = [g.integers(0, 256, int(n)).tolist() for n in (6, 3, 0, 5)]
    logprobs = []
    for p, c in zip(prompts, completions):
        with torch.no_grad():
            ref = torch.log_softmax(
                tiny["model"](torch.tensor([p + c]))[0], dim=-1).numpy()
        lp = [float(ref[len(p) - 1 + j, t]) for j, t in enumerate(c)]
        logprobs.append([x + float(g.normal(0.0, 0.3)) for x in lp])
    rewards = g.normal(0.5, 1.0, len(prompts)).astype(np.float32).tolist()
    return dict(batch_id="round-0", round_idx=0, prompts=prompts,
                completions=completions, logprobs=logprobs,
                weights_id="w0", generation=0, rewards=rewards)


def _learn(kind, tiny, fields, algo, n=3):
    kw = dict(algo=algo, lr=LR, entropy_coef=0.01, sgd_epochs=2,
              gamma=0.99)
    if kind == "jax":
        learner = JLearner(tiny["jmodel"], tiny["params"], **kw)
        batch = JBatch(**fields)
    else:
        learner = RolloutLearner(tiny["cfg"], tiny["sd"], device="cpu", **kw)
        batch = RolloutBatch(**fields)
    stats = [learner.update(batch) for _ in range(n)]
    if kind == "jax":
        params = tl.flax_state_dict(jax.tree_util.tree_map(
            np.asarray, jax.device_get(learner.params)))
    else:
        params = {k: v.detach() for k, v in learner.model.state_dict().items()}
    return stats, params


def _jax_loss(jlearner, params, packed):
    """The JAX learner's own loss: the ``loss_fn`` its jitted update
    closes over."""
    fn = jlearner._update_fn.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return cells["loss_fn"](params, packed)[0]


def _first_grads(tiny, fields, algo):
    """The first epoch's gradients in each package, through each
    learner's own loss on its own packing of the batch."""
    kw = dict(algo=algo, entropy_coef=0.01, gamma=0.99)
    tlearner = RolloutLearner(tiny["cfg"], tiny["sd"], device="cpu", lr=LR,
                              **kw)
    loss, _, _ = tlearner._loss(tlearner._pack(RolloutBatch(**fields)))
    loss.backward()
    tg = {n: p.grad.detach().clone()
          for n, p in tlearner.model.named_parameters()}
    jlearner = JLearner(tiny["jmodel"], tiny["params"], lr=LR, **kw)
    packed = jlearner._pack(JBatch(**fields))
    jg = jax.jit(jax.grad(lambda p: _jax_loss(jlearner, p, packed)),
                 compiler_options=FAST_COMPILE)(tiny["params"])
    return tg, tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, jg))


@pytest.fixture(scope="module", params=["ppo", "vtrace"])
def learned(request, tiny):
    fields = _batch_fields(tiny)
    out = {kind: _learn(kind, tiny, fields, request.param)
           for kind in ("jax", "torch")}
    out["grads"], out["jgrads"] = _first_grads(tiny, fields, request.param)
    return out


def test_learner_stats_match_jax(learned):
    (jstats, _), (tstats, _) = learned["jax"], learned["torch"]
    assert len(jstats) == len(tstats) == 3
    for js, ts in zip(jstats, tstats):
        assert set(js) == set(ts)
        assert (ts["update"], ts["num_tokens"]) == (js["update"],
                                                    js["num_tokens"])
        for key in ("loss", "pg_loss", "entropy", "reward_mean", "baseline"):
            np.testing.assert_allclose(ts[key], js[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)
    assert np.isfinite([s["loss"] for s in tstats]).all()


def test_learner_params_match_jax_after_three_updates(learned):
    """Leaf by leaf within 1e-4, but for elements whose first gradient
    is at fp32 rounding level (below 1e-6 of its leaf's largest): Adam
    divides a gradient by its own magnitude, so such an element moves
    by up to ``lr`` per step in a direction the rounding picks, in
    either package. Those are held to that bound, 6 steps x lr."""
    (_, jp), (_, tp) = learned["jax"], learned["torch"]
    grads = learned["grads"]
    assert set(jp) == set(tp) == set(grads)
    noise = 0
    for name in jp:
        g = grads[name].abs()
        loud = (g >= 1e-6 * g.max()).numpy()
        noise += int((~loud).sum())
        np.testing.assert_allclose(tp[name].numpy()[loud],
                                   jp[name].numpy()[loud],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        assert np.all(np.abs(tp[name].numpy() - jp[name].numpy())
                      <= 6 * LR + 1e-4), name
    assert noise < 1e-3 * sum(v.numel() for v in tp.values())


def test_learner_first_gradients_match_jax(learned):
    """The first epoch's gradients, leaf by leaf within 1e-4 absolute
    and relative (tests/test_torch_llama_train.py's step-1 check),
    against the JAX learner's loss differentiated on the same batch."""
    jg, tg = learned["jgrads"], learned["grads"]
    assert set(jg) == set(tg)
    for name in jg:
        np.testing.assert_allclose(tg[name].numpy(), jg[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _learner(tiny, **kw):
    return RolloutLearner(tiny["cfg"], tiny["sd"], device="cpu", **kw)


def test_pack_normalizes_by_the_population_std_and_baselines(tiny):
    fields = _batch_fields(tiny)
    learner = _learner(tiny, baseline_beta=0.25)
    rew = np.asarray(fields["rewards"], np.float32)
    packed = learner._pack(RolloutBatch(**fields))
    centered = rew - rew.mean()
    want = centered / (centered.std(ddof=0) + 1e-8)
    np.testing.assert_allclose(packed["adv"].numpy(), want, rtol=1e-6)
    assert not np.allclose(want, centered / (centered.std(ddof=1) + 1e-8))
    assert packed["baseline"] == pytest.approx(float(rew.mean()))
    # first update: the batch mean; then an EWMA with baseline_beta
    learner.update(RolloutBatch(**fields))
    assert learner.baseline == pytest.approx(float(np.mean(rew)))
    fields2 = dict(fields, rewards=(rew + 2.0).tolist())
    learner.update(RolloutBatch(**fields2))
    assert learner.baseline == pytest.approx(
        0.75 * float(np.mean(rew)) + 0.25 * float(np.mean(rew + 2.0)))
    packed = learner._pack(RolloutBatch(**fields))
    assert packed["baseline"] == pytest.approx(learner.baseline)
    # positions: completion token i is scored by the logits at plen-1+i
    p, c = fields["prompts"][0], fields["completions"][0]
    assert packed["gpos"][0, :len(c)].tolist() == list(
        range(len(p) - 1, len(p) - 1 + len(c)))
    assert packed["mask"][2].sum().item() == 0     # the empty completion


def test_shapes_freeze_on_the_first_batch(tiny):
    fields = _batch_fields(tiny)
    learner = _learner(tiny)
    with pytest.raises(ValueError, match="unscored"):
        learner.update(RolloutBatch(**dict(fields, rewards=None)))
    learner.update(RolloutBatch(**fields))
    B, L, T = learner._shape
    assert (B, L, T) == (4, 12, 6)
    with pytest.raises(ValueError, match="batch size changed"):
        learner.update(RolloutBatch(**{k: (v[:3] if isinstance(v, list)
                                           else v)
                                       for k, v in fields.items()}))
    longer = dict(fields, completions=[c + [1] * 3 for c in
                                       fields["completions"]],
                  logprobs=[lp + [-1.0] * 3 for lp in fields["logprobs"]])
    with pytest.raises(ValueError, match="exceeds frozen shape"):
        learner.update(RolloutBatch(**longer))
    short = dict(fields, logprobs=[lp[:-1] if lp else lp
                                   for lp in fields["logprobs"]])
    with pytest.raises(ValueError, match="capture_logprobs=True"):
        learner.update(RolloutBatch(**short))


def test_get_state_is_a_copy_and_set_state_restores(tiny):
    fields = _batch_fields(tiny)
    a = _learner(tiny, sgd_epochs=2)
    a.update(RolloutBatch(**fields))
    state = a.get_state()
    frozen = {k: v.clone() for k, v in state["params"].items()}
    moments = [v["exp_avg"].clone()
               for v in state["opt_state"]["state"].values()]
    nxt = a.update(RolloutBatch(**fields))
    # torch updated params and moments in place: the state kept its own
    for k, v in state["params"].items():
        assert torch.equal(v, frozen[k]), k
    for v, m in zip(state["opt_state"]["state"].values(), moments):
        assert torch.equal(v["exp_avg"], m)
    b = _learner(tiny, sgd_epochs=2)
    b.set_state(state)
    assert (b.update_count, b.baseline) == (1, state["baseline"])
    again = b.update(RolloutBatch(**fields))
    assert again == nxt
    for (k, v), w in zip(b.model.state_dict().items(),
                         a.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_learner_runs_on_the_card_unless_asked_for_the_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device works")
    with pytest.raises(NoCudaError):
        RolloutLearner(tiny["cfg"], tiny["sd"])
    with pytest.raises(ValueError, match="unknown algo"):
        RolloutLearner(tiny["cfg"], tiny["sd"], algo="a2c", device="cpu")
