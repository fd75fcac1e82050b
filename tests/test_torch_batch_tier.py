"""The port's batch tier (``ray_tpu_torch/serve/batch_tier.py``) and named
scheduler profiles against the JAX package's, on the CPU.

- The profile cases of tests/test_batch_tier.py: ``SCHEDULER_PROFILES``,
  ``scheduler_profile`` and ``engine_kwargs_for_profile`` equal the JAX
  dicts (and refusals), and the kwargs land on the engine's knobs.
- The batch-job cases of tests/test_batch_tier.py (token parity and
  progress, the exactly-once resume after a driver crash, a foreign
  job's checkpoint refused, the bounded row retries) run the same
  script through both packages (``llama_tiny`` fp32, the flax params of
  PRNGKey(0); the port's engine on their ``flax_state_dict``): results,
  ``stats``, ``progress()`` and the committed ledger must be EQUAL, and
  every row equals JAX ``generate``. Added: a job over a 2-replica pool.
- The pool batch-spill cases of tests/test_batch_tier.py (not in
  tests/test_torch_engine_pool.py): batch routing writes no sticky
  placement, and spills to the least batch backlog, in both pools.
  ``Dataset`` and ``DatasetPipeline`` sources wait for the port's data
  layer.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.air import checkpoint as jck
from ray_tpu.models import llama as jl
from ray_tpu.serve import batch_tier as jbt
from ray_tpu.serve import engine as jeng
from ray_tpu.serve import engine_pool as jpool
from ray_tpu.serve import scheduler as jsched
from ray_tpu_torch.air import checkpoint as tck
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import batch_tier as tbt
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import engine_pool as tpool
from ray_tpu_torch.serve import scheduler as tsched

PROMPTS = [[5, 9, 2], [7, 11, 3, 1], [2, 4, 6, 8, 10], [9, 1],
           [3, 3, 5, 7], [12, 2, 9, 4, 1, 6]]


# ------------------------------------------------------------ profiles


def test_scheduler_profiles_equal_the_reference():
    assert tsched.SCHEDULER_PROFILES == jsched.SCHEDULER_PROFILES
    assert set(tsched.SCHEDULER_PROFILES) == {"latency", "throughput"}
    for name in tsched.SCHEDULER_PROFILES:
        assert tsched.scheduler_profile(name) == \
            jsched.scheduler_profile(name)
    assert tsched.scheduler_profile("throughput")["max_queued"] is None
    with pytest.raises(ValueError) as ei:
        tsched.scheduler_profile("nope")
    with pytest.raises(ValueError) as ej:
        jsched.scheduler_profile("nope")
    assert str(ei.value) == str(ej.value)
    # a fresh dict each call
    p = tsched.scheduler_profile("latency")
    p["decode_chunk"] = 99
    assert tsched.SCHEDULER_PROFILES["latency"]["decode_chunk"] == 4


@pytest.fixture(scope="module")
def tiny():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8),
                                                           jnp.int32))
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    tmodel = tl.build_model(tl.llama_tiny(dtype=torch.float32), sd, "cpu")
    cache = {}

    def want(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            out = jl.generate(jmodel, params,
                              jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=n, temperature=0.0)
            cache[key] = np.asarray(out)[0, len(prompt):].tolist()
        return cache[key]

    defaults = dict(max_slots=2, page_size=8, n_pages=32, chunk=4,
                    temperature=0.0, eos_id=-1, seed=0)
    return {
        "jax": types.SimpleNamespace(
            bt=jbt, ck=jck, pool=jpool, want=want,
            engine=lambda **kw: jeng.LLMEngine(jmodel, params,
                                               **{**defaults, **kw})),
        "torch": types.SimpleNamespace(
            bt=tbt, ck=tck, pool=tpool, want=want,
            engine=lambda **kw: teng.LLMEngine(tmodel, device="cpu",
                                               **{**defaults, **kw})),
    }


def _both(tiny, case, *args):
    rec = {pkg: case(s, *args) for pkg, s in tiny.items()}
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def test_engine_kwargs_for_profile_equal_jax_and_land_on_the_engine(tiny):
    for name in ("latency", "throughput"):
        assert tbt.engine_kwargs_for_profile(name) == \
            jbt.engine_kwargs_for_profile(name)
    kw = tbt.engine_kwargs_for_profile("throughput")
    assert kw == {"chunk": 16, "prefill_chunk": 512,
                  "max_run_ahead": 512, "max_queued": None}
    eng = tiny["torch"].engine(**kw)
    assert (eng.K, eng.PC, eng.KMAX, eng.max_queued) == (16, 512, 512, None)
    kw["chunk"] = 999
    assert tbt.engine_kwargs_for_profile("throughput")["chunk"] == 16
    with pytest.raises(ValueError):
        tbt.engine_kwargs_for_profile("nope")


# ------------------------------------------------------------- batch job


def _parity(s, tmp):
    eng = s.engine().start()
    try:
        job = s.bt.BatchInferenceJob(
            eng, PROMPTS, max_new_tokens=8, max_in_flight=3,
            checkpoint_dir=str(tmp / "ck"), checkpoint_every=2,
            job_id="parity")
        results = job.run()
    finally:
        eng.shutdown()
    assert results == [s.want(p, 8) for p in PROMPTS]
    data = s.ck.Checkpoint.from_directory(str(tmp / "ck")).to_dict()
    return {"results": results, "stats": job.stats,
            "progress": job.progress(), "ledger": data,
            "step": s.ck.load_manifest(str(tmp / "ck"))["step"]}


def test_batch_job_token_parity_and_progress(tiny, tmp_path):
    rec = {pkg: _parity(s, tmp_path / pkg) for pkg, s in tiny.items()}
    assert rec["torch"] == rec["jax"]
    rec = rec["torch"]
    assert rec["stats"]["rows_completed"] == len(PROMPTS)
    assert rec["stats"]["checkpoints_written"] >= 1
    assert rec["progress"]["rows_in_ledger"] == len(PROMPTS)
    assert rec["ledger"]["job_id"] == "parity"
    assert len(rec["ledger"]["completed"]) == len(PROMPTS)
    assert rec["step"] == len(PROMPTS)


class _CrashingTarget:
    """Engine wrapper whose submit raises after N calls — a mid-run
    driver crash with rows committed AND rows in flight."""

    def __init__(self, eng, crash_after):
        self._eng = eng
        self._left = crash_after

    def submit(self, *a, **kw):
        if self._left <= 0:
            raise RuntimeError("simulated driver crash")
        self._left -= 1
        return self._eng.submit(*a, **kw)


class _CountingTarget:
    def __init__(self, eng):
        self._eng = eng
        self.submitted = []

    def submit(self, prompt, **kw):
        self.submitted.append(list(prompt))
        return self._eng.submit(prompt, **kw)


def _resume(s, tmp):
    ck = str(tmp / "ck")
    eng = s.engine().start()
    try:
        with pytest.raises(RuntimeError, match="simulated"):
            s.bt.BatchInferenceJob(
                _CrashingTarget(eng, 5), PROMPTS, max_new_tokens=8,
                max_in_flight=2, checkpoint_dir=ck,
                checkpoint_every=2, job_id="chaos").run()
    finally:
        eng.shutdown()
    committed = s.ck.Checkpoint.from_directory(ck).to_dict()["completed"]
    eng2 = s.engine().start()
    try:
        target = _CountingTarget(eng2)
        job = s.bt.BatchInferenceJob(
            target, PROMPTS, max_new_tokens=8, max_in_flight=2,
            checkpoint_dir=ck, checkpoint_every=2, job_id="chaos")
        results = job.run()
    finally:
        eng2.shutdown()
    return {"committed": sorted(committed), "results": results,
            "submitted": target.submitted, "stats": job.stats,
            "progress": job.progress()}


def test_resume_from_manifest_exactly_once(tiny, tmp_path):
    """Kill the job mid-run, resume from its manifest: 0 duplicate rows
    (committed rows are never resubmitted), 0 missing rows (uncommitted
    ones recompute)."""
    rec = {pkg: _resume(s, tmp_path / pkg) for pkg, s in tiny.items()}
    assert rec["torch"] == rec["jax"]
    rec = rec["torch"]
    n = len(rec["committed"])
    assert 0 < n < len(PROMPTS)
    assert rec["results"] == [tiny["jax"].want(p, 8) for p in PROMPTS]
    assert rec["stats"]["rows_resumed"] == n
    assert len(rec["submitted"]) == len(PROMPTS) - n
    assert sorted(map(tuple, rec["submitted"])) == sorted(
        tuple(p) for i, p in enumerate(PROMPTS)
        if i not in rec["committed"])


def _foreign(s, tmp):
    ck = str(tmp / "ck")
    eng = s.engine().start()
    try:
        out = s.bt.run_batch_job(eng, PROMPTS[:2], max_new_tokens=4,
                                 checkpoint_dir=ck, job_id="job-a")
        with pytest.raises(ValueError, match="job-a") as ei:
            s.bt.BatchInferenceJob(eng, PROMPTS[:2], max_new_tokens=4,
                                   checkpoint_dir=ck, job_id="job-b").run()
    finally:
        eng.shutdown()
    return {"out": out, "error": str(ei.value).replace(str(tmp), "<tmp>")}


def test_checkpoint_refuses_foreign_job(tiny, tmp_path):
    rec = {pkg: _foreign(s, tmp_path / pkg) for pkg, s in tiny.items()}
    assert rec["torch"]["error"].replace("torch", "<pkg>") == \
        rec["jax"]["error"].replace("jax", "<pkg>")
    assert rec["torch"]["out"] == rec["jax"]["out"]


def _retries(s):
    class _AlwaysFailHandle:
        def result(self):
            raise RuntimeError("row fault")

    class _FaultyTarget:
        def submit(self, *a, **kw):
            return _AlwaysFailHandle()

    job = s.bt.BatchInferenceJob(_FaultyTarget(), [[1, 2]],
                                 max_new_tokens=4, max_row_retries=2)
    with pytest.raises(s.bt.BatchRowError) as ei:
        job.run()
    return {"index": ei.value.index, "msg": str(ei.value),
            "cause": repr(ei.value.cause), "stats": job.stats}


def test_row_retry_budget_is_bounded(tiny):
    rec = _both(tiny, _retries)
    assert rec["index"] == 0 and rec["stats"]["rows_retried"] == 2
    with pytest.raises(ValueError):
        tbt.BatchInferenceJob(None, [], max_in_flight=0)
    with pytest.raises(ValueError):
        tbt.BatchInferenceJob(None, [], checkpoint_every=0)


def _pool_job(s):
    pool = s.pool.EnginePool(lambda i: s.engine(seed=i), 2, seed=5)
    try:
        job = s.bt.BatchInferenceJob(pool, PROMPTS, max_new_tokens=6,
                                     max_in_flight=4)
        results = job.run()
        return {"results": results, "stats": job.stats,
                "route_batch": pool.route_stats.get("route_batch", 0)}
    finally:
        pool.shutdown()


def test_batch_job_over_a_pool(tiny):
    rec = _both(tiny, _pool_job)
    assert rec["results"] == [tiny["jax"].want(p, 6) for p in PROMPTS]
    assert rec["route_batch"] == len(PROMPTS)


# ------------------------------------------------------------- pool lane


def _spill_sticky(s):
    pool = s.pool.EnginePool(lambda i: s.engine(), 2, seed=7)
    try:
        hb = pool.submit(PROMPTS[0], max_new_tokens=6,
                         session_id="sess", priority="batch")
        assert hb.result() == s.want(PROMPTS[0], 6)
        rec = {"route_batch": pool.route_stats.get("route_batch", 0),
               "sticky_after_batch": "sess" in pool._sticky}
        ho = pool.submit(PROMPTS[1], max_new_tokens=6, session_id="sess")
        assert ho.result() == s.want(PROMPTS[1], 6)
        rec.update(sticky=pool._sticky.get("sess") == ho.replica_idx,
                   has_batch_depth="queue_depth_batch" in pool.load_report())
        return rec
    finally:
        pool.shutdown()


def test_pool_batch_spill_never_touches_sticky(tiny):
    assert _both(tiny, _spill_sticky) == {
        "route_batch": 1, "sticky_after_batch": False, "sticky": True,
        "has_batch_depth": True}


def _least_backlog(s):
    pool = s.pool.EnginePool(lambda i: s.engine(max_queued_batch=4), 2,
                             seed=3)
    try:
        hs = [pool.submit(PROMPTS[i % len(PROMPTS)], max_new_tokens=4,
                          priority="batch") for i in range(4)]
        seen = sorted({h.replica_idx for h in hs})
        out = [h.result() for h in hs]
        assert out == [s.want(PROMPTS[i % len(PROMPTS)], 4)
                       for i in range(4)]
        return {"seen": seen}
    finally:
        pool.shutdown()


def test_pool_batch_routes_to_least_batch_backlog(tiny):
    assert _both(tiny, _least_backlog) == {"seen": [0, 1]}
