"""The port's RLHF loop (``ray_tpu_torch/rl/loop.py`` + ``learner.py``)
on the CPU: the six cases of tests/test_rl_loop.py on the port's
``LLMEngine`` and ``RolloutLearner`` (``llama_tiny`` fp32, the flax
params of PRNGKey(0) through ``flax_state_dict``, ``device="cpu"``).

Round N+1's generation overlaps round N's learner step when the
staleness bound allows it, the bound is enforced on both sides
(generator blocks; consumption raises), and both chaos kills —
generator mid-round, learner pre-commit — recover with exactly-once
rollout accounting and the generator re-synced to the recovered
payload (same bytes, same ``weights_id``). Last, chip_smoke's phase 8
rehearsed with the CPU standing in for the card. Sampling draws from a
``torch.Generator``, so rewards and published ids differ from the JAX
loop's; what these hold is structural: the ledger, batch ids,
staleness, the resume round, restarts and the id equalities.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.rl import (DuplicateRollout, GeneratorKilled, RLHFLoop,
                              RolloutBatch, RolloutGenerator, RolloutLearner,
                              StalenessViolation)
from ray_tpu_torch.serve.engine import LLMEngine
from ray_tpu_torch.train.chaos import AttemptFence, StaleGeneration

ROUNDS = 4
N_PROMPTS = 4
PROMPT_LEN = 6
MAX_NEW = 4
DELAY_S = 0.2
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def tiny_model():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jnp.zeros((1, PROMPT_LEN), jnp.int32))
    cfg = tl.llama_tiny(dtype=torch.float32)
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    return cfg, sd


@pytest.fixture()
def stack(tiny_model):
    cfg, sd = tiny_model
    eng = LLMEngine(tl.build_model(cfg, sd, "cpu"), max_slots=4,
                    page_size=16, n_pages=128, chunk=4, prefill_chunk=16,
                    temperature=1.0, eos_id=-1, seed=0,
                    capture_logprobs=True, device="cpu").start()
    gen = RolloutGenerator(eng, max_new_tokens=MAX_NEW)
    learner = RolloutLearner(cfg, sd, algo="ppo", lr=1e-2, sgd_epochs=1,
                             device="cpu")
    yield eng, gen, learner
    eng.shutdown()


def _prompts_fn(round_idx):
    rng = np.random.RandomState(1000 + round_idx)
    return [rng.randint(1, 128, size=PROMPT_LEN).tolist()
            for _ in range(N_PROMPTS)]


def _reward_fn(prompt, completion):
    if not completion:
        return 0.0
    return sum(1 for t in completion if t >= 128) / len(completion)


def _loop(gen, learner, tmp_path, **kw):
    args = dict(rounds=ROUNDS, staleness_bound=1, overlap=True,
                ckpt_dir=str(tmp_path / "ckpt"),
                publish_dir=str(tmp_path / "pub"),
                learner_delay_s=DELAY_S)
    args.update(kw)
    return RLHFLoop(gen, learner, _reward_fn, _prompts_fn, **args)


def _audit(ledger, rounds):
    expected = [f"round-{i}" for i in range(rounds)]
    assert sorted(ledger) == expected, \
        f"ledger must hold every round exactly once: {ledger}"


# --------------------------------------------- async-sampling unit


def test_generation_overlaps_slow_learner_step(stack, tmp_path):
    """With a deliberately slow learner and staleness bound 1, round
    N+1's decode must START before round N's learner step ENDS — the
    sebulba overlap — while every consumed batch still lags the
    learner by at most the bound."""
    _eng, gen, learner = stack
    stats = _loop(gen, learner, tmp_path).run()
    assert stats["overlap_observed"], \
        "round N+1 generation never ran during round N's learner step"
    tl_ = stats["timeline"]
    assert any(b["gen_start"] < a["learn_end"]
               for a, b in zip(tl_, tl_[1:]))
    assert stats["max_staleness"] <= 1
    assert all(b["weights_id"] for b in stats["batch_log"])
    _audit(stats["ledger"], ROUNDS)
    # the engine ends on the payload that sampled the last batch: the
    # last round's publish is never synced, since no round follows it
    assert stats["final_weights_id"] == stats["batch_log"][-1]["weights_id"]
    assert all(np.isfinite(stats["reward_curve"]))
    assert {"publish_s", "commit_s", "sync_s"} <= set(tl_[0])


def test_staleness_bound_zero_degenerates_to_serialized(stack,
                                                        tmp_path):
    """Bound 0 = the generator blocks until the previous round is
    consumed: no overlap may be observed and staleness stays 0."""
    _eng, gen, learner = stack
    stats = _loop(gen, learner, tmp_path, staleness_bound=0).run()
    assert not stats["overlap_observed"]
    assert stats["max_staleness"] == 0
    _audit(stats["ledger"], ROUNDS)


def test_consume_refuses_duplicate_and_stale_batches(stack, tmp_path):
    """_consume is the invariant wall: a ledgered batch id raises
    DuplicateRollout, a batch lagging the learner past the bound
    raises StalenessViolation — neither may pass silently."""
    _eng, gen, learner = stack
    loop = RLHFLoop(gen, learner, _reward_fn, _prompts_fn,
                    rounds=2, staleness_bound=1,
                    ckpt_dir=str(tmp_path / "unused-ck"),
                    publish_dir=str(tmp_path / "unused-pub"))
    batch = RolloutBatch(
        batch_id="round-0", round_idx=0,
        prompts=[[1, 2]], completions=[[3, 4]],
        logprobs=[[-1.0, -1.0]], weights_id="w0", generation=1)
    loop.ledger.append("round-0")
    with pytest.raises(DuplicateRollout):
        loop._consume(0, batch, synced_update=0)
    batch.batch_id = "round-1"
    with pytest.raises(StalenessViolation):
        loop._consume(1, batch,
                      synced_update=learner.update_count - 2)


# ------------------------------------------------------ chaos kills


def test_generator_kill_mid_round_resumes_exactly_once(stack,
                                                       tmp_path):
    """A generator death after submit, before collection: the loop
    restarts it at exactly the unconsumed round; deterministic batch
    ids make the regeneration a single ledger entry — 0 duplicated,
    0 lost."""
    _eng, gen, learner = stack
    killed = []

    def mid_round(r):
        if r == 2 and not killed:
            killed.append(r)
            raise GeneratorKilled("chaos: died mid-round 2")

    stats = _loop(gen, learner, tmp_path,
                  generator_mid_round_hook=mid_round).run()
    assert killed == [2]
    assert stats["generator_restarts"] == 1
    _audit(stats["ledger"], ROUNDS)
    assert stats["max_staleness"] <= 1


def test_learner_kill_precommit_resumes_from_last_complete(
        stack, tiny_model, tmp_path):
    """A learner death on the commit path: the round's checkpoint
    never lands, run() raises, and a fresh attempt resumes from the
    last COMPLETE checkpoint — replaying only the uncommitted round —
    with the generator provably re-synced to the recovered
    weights_id (same bytes => same id)."""
    eng, gen, learner = stack

    def kill(step):
        if step == 2:
            raise RuntimeError("chaos: learner killed pre-commit")

    ctl = str(tmp_path / "ctl")
    with pytest.raises(RuntimeError, match="pre-commit"):
        _loop(gen, learner, tmp_path, control_dir=ctl, attempt=1,
              learner_kill_hook=kill).run()

    cfg, sd = tiny_model
    learner2 = RolloutLearner(cfg, sd, algo="ppo", lr=1e-2, sgd_epochs=1,
                              device="cpu")
    stats = _loop(gen, learner2, tmp_path, control_dir=ctl,
                  attempt=2).run()
    assert stats["resumed"]
    assert stats["start_round"] == 2, \
        "resume must replay exactly the uncommitted round"
    assert stats["recovered_weights_id"] == stats["resync_weights_id"]
    assert stats["restore_s"] > 0
    _audit(stats["ledger"], ROUNDS)
    assert learner2.update_count == ROUNDS


def test_superseded_attempt_cannot_commit(stack, tmp_path):
    """AttemptFence: once attempt 2 fences the control dir, attempt
    1's next commit attempt dies StaleGeneration instead of
    overwriting its successor's checkpoints."""
    _eng, gen, learner = stack
    ctl = str(tmp_path / "ctl")
    loop = _loop(gen, learner, tmp_path, control_dir=ctl, attempt=1)
    with AttemptFence(ctl, 2):
        with pytest.raises(StaleGeneration):
            loop.run()


def test_chip_smoke_rl_phase_rehearses_on_the_cpu():
    """chip_smoke phase 8 at ``llama_tiny`` fp32 and 4 prompts a round on
    the CPU: its loops, chaos kills and checks hold (the kernel counts
    are the card's only), and its learner parity runs."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    stats = smoke._rl_learner_parity(tl, 0, "cpu")
    assert np.isfinite(stats).all() and len(stats) == 2
    res = smoke.phase_rl_loop(tl, pa, fa, 0, "cpu",
                              cfg=tl.llama_tiny(dtype=torch.float32),
                              device="cpu", B=4)
    assert len(res["main"]["rounds"]) == smoke.RL_ROUNDS == 2
    assert res["main"]["overlap_observed"]
    assert res["main"]["decode_steps"] > 0
    assert res["generator_kill"]["generator_restarts"] == 1
    assert res["learner_kill"]["restore_s"] > 0
