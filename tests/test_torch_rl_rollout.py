"""The port's rollout generation (``ray_tpu_torch/rl/rollout.py`` and the
engine's logprob-capture and rollout-batch surfaces) on the CPU: the
five cases of tests/test_rl_rollout.py on the port's ``LLMEngine``
(``llama_tiny`` fp32, the flax params of PRNGKey(0) through
``flax_state_dict``).

Captured per-token logprobs ARE the sampling distribution (a dense
teacher-forced recompute by the JAX model on the same weights agrees
within 1e-4, temperature included), rollout batches are stamped with
the payload that produced them, an in-flight batch-lane request
survives a preempt-mode weight swap token-identically, and batch-lane
TTFT never reaches the online SLO signals.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.rl import RolloutGenerator
from ray_tpu_torch.serve.engine import LLMEngine

FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def tiny_model():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    model = tl.build_model(tl.llama_tiny(dtype=torch.float32), sd, "cpu")
    apply = jax.jit(jmodel.apply, compiler_options=FAST_COMPILE)
    return model, sd, lambda ids: apply(params, ids)[0]


def _engine(model, **kw):
    args = dict(max_slots=4, page_size=16, n_pages=128, chunk=4,
                prefill_chunk=16, temperature=1.0, eos_id=-1, seed=0,
                capture_logprobs=True, device="cpu")
    args.update(kw)
    return LLMEngine(model, **args).start()


def _prompts(n, seed=7, length=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, size=length).tolist()
            for _ in range(n)]


# -------------------------------------------------- logprob capture


def test_captured_logprobs_match_teacher_forced_dense(tiny_model):
    """The captured behavior logprobs must equal a dense
    teacher-forced recompute under the SAMPLING distribution
    (logits/temperature) — importance ratios start at exactly 1."""
    model, _sd, jax_logits = tiny_model
    temp = 0.7
    eng = _engine(model, temperature=temp)
    try:
        prompts = _prompts(6)
        handles = eng.submit_rollout_batch(prompts, max_new_tokens=8)
        outs = [h.result() for h in handles]
        lps = [list(h.logprobs) for h in handles]
    finally:
        eng.shutdown()
    for p, c, lp in zip(prompts, outs, lps):
        assert len(lp) == len(c), \
            "logprobs must be index-aligned with the completion"
        logits = jax_logits(jnp.asarray([p + c], jnp.int32))
        ref = jax.nn.log_softmax(
            np.asarray(logits, np.float32)[0] / temp, axis=-1)
        for j, tok in enumerate(c):
            got = lp[j]
            want = float(ref[len(p) - 1 + j, tok])
            assert abs(got - want) < 1e-4, (j, got, want)


def test_capture_covers_prefill_and_decode_paths(tiny_model):
    """The first token's logprob comes from the prefill capture path,
    the rest from decode — both must land, through truncation too."""
    model, _sd, _ = tiny_model
    eng = _engine(model)
    try:
        h = eng.submit(_prompts(1)[0], max_new_tokens=5)
        out = h.result()
        assert len(out) == 5
        assert h.logprobs is not None and len(h.logprobs) == 5
        assert all(lp <= 0.0 for lp in h.logprobs)
    finally:
        eng.shutdown()


# ---------------------------------------------- generator stamping


def test_rollout_batch_stamped_with_producing_payload(tiny_model):
    model, sd, _ = tiny_model
    eng = _engine(model)
    try:
        gen = RolloutGenerator(eng, max_new_tokens=4)
        batch = gen.generate(_prompts(3), round_idx=0)
        assert batch.batch_id == "round-0"
        assert batch.generation == eng.weight_generation
        assert batch.weights_id == eng.weights_id
        assert batch.num_samples() == 3
        assert batch.num_tokens() == sum(
            len(c) for c in batch.completions)
        assert [len(l) for l in batch.logprobs] == \
            [len(c) for c in batch.completions]

        # Sync advances the fence and restamps; the next round carries
        # the new identity.
        new_gen = gen.sync_weights(sd, weights_id="wid-next")
        assert new_gen == batch.generation + 1
        batch2 = gen.generate(_prompts(3, seed=8), round_idx=1)
        assert batch2.batch_id == "round-1"
        assert batch2.weights_id == "wid-next"
        assert batch2.generation == new_gen
    finally:
        eng.shutdown()


# ---------------------------------- lanes x the weight-swap fence


def test_inflight_batch_lane_survives_preempt_swap_token_identical(
        tiny_model):
    """A preempt-mode swap to the SAME payload mid-flight must leave
    an in-flight LANE_BATCH request's greedy completion untouched:
    preempted slots re-prefill from recorded tokens, so the recompute
    is invisible in the output."""
    model, sd, _ = tiny_model
    prompts = _prompts(3, seed=11)
    ref_eng = _engine(model, temperature=0.0,
                      capture_logprobs=False, prefix_cache=True)
    try:
        ref = [h.result() for h in ref_eng.submit_rollout_batch(
            prompts, max_new_tokens=12)]
    finally:
        ref_eng.shutdown()

    eng = _engine(model, temperature=0.0,
                  capture_logprobs=False, prefix_cache=True, chunk=2)
    try:
        handles = eng.submit_rollout_batch(prompts, max_new_tokens=12)
        deadline = time.monotonic() + 30
        while (not any(h.ttft_s is not None for h in handles)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        gen = eng.swap_weights(
            sd, generation=eng.weight_generation + 1,
            weights_id="same-bytes-new-gen", mode="preempt")
        out = [h.result() for h in handles]
    finally:
        eng.shutdown()
    assert out == ref, \
        "preempt-mode swap changed in-flight batch-lane tokens"
    assert gen == 1 and all(h.weights_tag for h in handles)


def test_batch_lane_ttft_excluded_from_canary_signals(tiny_model):
    """Batch-lane (rollout) TTFT must never reach ttfts_s / the EWMA
    the canary health probes and autoscaler read — a rollout may sit
    queued by design and would poison the online latency signal."""
    model, _sd, _ = tiny_model
    eng = _engine(model, temperature=0.0,
                  capture_logprobs=False)
    try:
        for h in eng.submit_rollout_batch(_prompts(3),
                                          max_new_tokens=4):
            h.result()
        assert eng.load_report()["ttft_ewma_s"] is None
        assert len(eng.ttfts_s) == 0

        h = eng.submit(_prompts(1, seed=9)[0], max_new_tokens=4)
        h.result()
        rep = eng.load_report()
        assert rep["ttft_ewma_s"] is not None
        assert len(eng.ttfts_s) == 1
    finally:
        eng.shutdown()
