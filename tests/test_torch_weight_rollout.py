"""The port's live weight rollout (``ray_tpu_torch/serve/weight_rollout.py``)
against the JAX package's, on the CPU.

- Payload identity: ``weights_id_from_payload`` gives the JAX package's
  id for the same values — numpy leaves on the JAX side, tensors on the
  port's — in fp32, int8 and bf16 (ml_dtypes' ``bfloat16`` against a
  torch bf16 tensor of the same bits), with strided and 0-d leaves and
  string, integer, float, bool and None metadata;
  ``weights_id_from_manifest`` equals the reference's on one manifest.
- The publish/load cases of tests/test_weight_rollout.py: a round trip
  whose id derives from the payload alone, a bit-flipped payload and a
  checkpoint without params refused typed.
- The controller cases of tests/test_weight_rollout.py (a green
  rollout, a canary whose parity probe fails and rolls back, a resume
  after a controller death, rebuilt and added replicas re-stamped, a
  swap refused on a dead replica, the pool handle's ``weights_tag``)
  run through both packages' 3-replica pools (``llama_tiny`` fp32, the
  flax params of PRNGKey(0); the port's as ``flax_state_dict``) with
  the same script. Reports, pool events (kinds and data),
  ``fleet_weights()``, route stats and the rollback counter must be
  EQUAL, but for times, bundle paths, and ids hashed from the two
  packages' differently named payloads (mapped to one label each); every
  stream equals JAX ``generate``. The weight fence of ``_pull_hint``
  is held to JAX in tests/test_torch_engine_pool.py.
"""
import os
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.air import checkpoint as jck
from ray_tpu.models import llama as jl
from ray_tpu.serve import engine as jeng
from ray_tpu.serve import engine_pool as jpool
from ray_tpu.serve import weight_rollout as jwr
from ray_tpu_torch.air import Checkpoint, InvalidCheckpointError
from ray_tpu_torch.air.checkpoint import load_manifest
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import engine as teng
from ray_tpu_torch.serve import engine_pool as tpool
from ray_tpu_torch.serve import weight_rollout as twr


# ------------------------------------------------------ payload identity


def _as_tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _payloads(dtype):
    """The same payload for each package: numpy leaves (JAX), tensors
    (the port), metadata alike."""
    g = np.random.default_rng(3)
    if dtype == "int8":
        w = g.integers(-128, 128, (4, 6)).astype(np.int8)
    else:
        w = g.standard_normal((4, 6)).astype(np.float32)
        if dtype == "bfloat16":
            w = w.astype(ml_dtypes.bfloat16)
    scale = np.float32(0.5)

    def build(arr, tr, zero_d):
        return {"params": {"layers.0.attention.wq.weight": arr(w),
                           "layers.0.attention.wo.weight": tr(w),
                           "norm.scale": arr(np.ones(6, np.float32)),
                           "scale": zero_d,
                           "stack": [arr(w[0]), {"b": arr(w[1:3])}]},
                "release": "v2", "step": 7, "lr": 3e-4, "flag": True,
                "tags": ["a", "bc"], "none": None}

    ref = build(lambda a: a, lambda a: a.T, np.asarray(scale))
    port = build(_as_tensor, lambda a: _as_tensor(a).t(),
                 torch.tensor(0.5))
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_weights_id_from_payload_equals_jax(dtype):
    ref, port = _payloads(dtype)
    wid = jwr.weights_id_from_payload(ref)
    assert twr.weights_id_from_payload(port) == wid
    # numpy leaves take the reference's path in the port too
    assert twr.weights_id_from_payload(ref) == wid
    # the id moves with a value, a key and a metadata entry
    for change in (lambda p: p["params"]["norm.scale"].__setitem__(0, 2.0),
                   lambda p: p["params"].__setitem__(
                       "extra", p["params"].pop("scale")),
                   lambda p: p.__setitem__("release", "v3")):
        _ref, other = _payloads(dtype)
        change(other)
        assert twr.weights_id_from_payload(other) != wid


def test_weights_id_of_a_card_free_bf16_state_dict_is_its_numpy_twins():
    """A bf16 state dict of the port and its flax-layout twin: the id of
    each payload is the same in both packages."""
    sd = tl.init_params(tl.llama_tiny(dtype=torch.bfloat16), 1,
                        device="cpu")
    as_np = {k: (v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                 if v.dtype == torch.bfloat16 else v.numpy())
             for k, v in sd.items()}
    for extra in ({}, {"release": "r1", "step": 3}):
        assert twr.weights_id_from_payload({**extra, "params": sd}) == \
            jwr.weights_id_from_payload({**extra, "params": as_np})


def test_weights_id_from_manifest_equals_jax(tmp_path):
    path = Checkpoint.from_dict({"w": torch.arange(3.0), "note": "x"}
                                ).to_directory(str(tmp_path / "c"))
    manifest = load_manifest(path)
    assert twr.weights_id_from_manifest(manifest) == \
        jwr.weights_id_from_manifest(manifest)
    assert twr.weights_id_from_manifest({}) == \
        jwr.weights_id_from_manifest({})


# --------------------------------------------- checkpoint publish/load


@pytest.fixture(scope="module")
def tiny():
    jmodel = jl.Llama(jl.llama_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8),
                                                           jnp.int32))
    bad = jax.tree_util.tree_map(lambda x: x + 0.25, params)
    sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, params))
    bad_sd = tl.flax_state_dict(jax.tree_util.tree_map(np.asarray, bad))
    cfg = tl.llama_tiny(dtype=torch.float32)
    tmodel = tl.build_model(cfg, sd, "cpu")
    cache = {}

    def want(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            out = jl.generate(jmodel, params,
                              jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=n, temperature=0.0)
            cache[key] = np.asarray(out)[0, len(prompt):].tolist()
        return cache[key]

    knobs = dict(max_slots=2, page_size=8, n_pages=64, chunk=4,
                 temperature=0.0, prefix_cache=True)
    return {
        "jax": types.SimpleNamespace(
            wr=jwr, pool=jpool, params=params, bad=bad, want=want,
            engine=lambda i: jeng.LLMEngine(jmodel, params, seed=i,
                                            **knobs)),
        "torch": types.SimpleNamespace(
            wr=twr, pool=tpool, params=sd, bad=bad_sd, want=want,
            engine=lambda i: teng.LLMEngine(tmodel, device="cpu", seed=i,
                                            **knobs)),
    }


def test_publish_load_roundtrip_and_payload_identity(tmp_path, tiny):
    sd = tiny["torch"].params
    p1, wid1 = twr.publish_weights(sd, str(tmp_path / "v1"), step=1)
    p2, wid2 = twr.publish_weights(sd, str(tmp_path / "v2"), step=2,
                                   extra={"release": "v2"})
    assert wid1 != wid2, \
        "metadata must distinguish byte-identical tensor payloads"
    p3, wid3 = twr.publish_weights(sd, str(tmp_path / "v3"), step=3)
    assert wid3 == wid1, "the same payload republished keeps its id"
    loaded, wid = twr.load_weights(p1)
    assert wid == wid1
    assert list(loaded) == list(sd)
    for k, v in sd.items():
        assert loaded[k].device.type == "cpu"
        assert torch.equal(loaded[k], v)
    assert load_manifest(p2)["step"] == 2
    # a published payload verifies in the JAX package too
    assert jck.verify_checkpoint_dir(p1, deep=True)[0]


def test_torn_checkpoint_refused_typed(tmp_path, tiny):
    """A bit-flipped or truncated payload fails its manifest and is
    refused InvalidCheckpointError before any replica is touched."""
    for damage in ("flip", "truncate"):
        path, _wid = twr.publish_weights(tiny["torch"].params,
                                         str(tmp_path / damage))
        full = os.path.join(path, "arrays", "tensors.pt")
        if damage == "flip":
            with open(full, "r+b") as f:
                first = f.read(1)
                f.seek(0)
                f.write(bytes([first[0] ^ 0xFF]))
        else:
            os.truncate(full, os.path.getsize(full) // 2)
        with pytest.raises(InvalidCheckpointError) as ei:
            twr.load_weights(path)
        assert ("hash" if damage == "flip" else "manifest says") in \
            ei.value.reason


def test_checkpoint_without_params_refused(tmp_path):
    out = Checkpoint.from_dict({"note": "no tensors"}).to_directory(
        str(tmp_path / "empty"))
    with pytest.raises(InvalidCheckpointError) as ei:
        twr.load_weights(out)
    jout = jck.Checkpoint.from_dict({"note": "no tensors"}).to_directory(
        str(tmp_path / "jax-empty"))
    with pytest.raises(jck.InvalidCheckpointError) as ej:
        jwr.load_weights(jout)
    assert ei.value.reason == ej.value.reason


def test_publish_and_swap_on_one_engine(tmp_path, tiny):
    """The co-located learner's shortcut: publish, then swap the same
    payload in under the next generation and that id."""
    s = tiny["torch"]
    eng = s.engine(0)
    gen, wid = twr.publish_and_swap(eng, s.params, str(tmp_path / "p"),
                                    step=4)
    assert (gen, eng.weight_generation, eng.weights_id) == (1, 1, wid)
    assert twr.load_weights(str(tmp_path / "p"))[1] == wid
    eng.shutdown()


# ------------------------------------------------ fleet controller


def _pool(s, n=3):
    return s.pool.EnginePool(s.engine, n)


def _norm(x, ids):
    """``x`` with each id in ``ids`` replaced by its label (also inside
    strings), tuples as lists, and times and bundle paths dropped."""
    if isinstance(x, dict):
        return {_norm(k, ids): _norm(v, ids) for k, v in x.items()
                if k not in ("bundle", "t", "t_wall", "t_mono")}
    if isinstance(x, (list, tuple)):
        return [_norm(v, ids) for v in x]
    if isinstance(x, str):
        for wid, label in ids.items():
            x = x.replace(wid, label)
        return x
    return x


def _events(pool):
    return [(e[2], e[4], e[5]) for e in pool.events.snapshot()]


def _rollbacks(pkg):
    eng = jeng if pkg == "jax" else teng
    return sum(v for _k, v in eng._metrics()["weight_rollbacks"]._samples())


def _both(tiny, tmp_path, case):
    rec = {}
    for pkg, s in tiny.items():
        rec[pkg] = case(s, str(tmp_path / pkg), pkg)
    assert rec["torch"] == rec["jax"]
    return rec["torch"]


def _green(s, tmp, pkg):
    pool = _pool(s)
    try:
        _p2, wid2 = s.wr.publish_weights(s.params, os.path.join(tmp, "v2"),
                                         extra={"release": "v2"})
        prompt = [2, 7, 1, 8, 2, 8]
        want = s.want(prompt, 8)
        ctl = s.wr.WeightRolloutController(
            pool, canary_fraction=0.3,      # ceil(0.9) = 1 canary of 3
            probes=[(prompt, want[:4])],
            flight_dir=os.path.join(tmp, "flight"))
        report = ctl.rollout(s.params, weights_id=wid2,
                             baseline_params=s.params,
                             baseline_weights_id="g0")
        out = pool.submit(list(prompt), max_new_tokens=8).result()
        assert out == want
        agg = pool.load_report()
        bundles = sorted(b.split("-0")[0] for b in
                         os.listdir(os.path.join(tmp, "flight")))
        return _norm({"report": report, "fleet": ctl.fleet_weights(),
                      "weight_swaps": pool.route_stats["weight_swaps"],
                      "agg": (agg["weight_generation"],
                              agg["weights_mixed"]),
                      "bundles": bundles, "events": _events(pool)},
                     {wid2: "<v2>"})
    finally:
        pool.shutdown()


def test_rollout_completes_and_serves_token_identically(tmp_path, tiny):
    rec = _both(tiny, tmp_path, _green)
    report = rec["report"]
    assert report["status"] == "completed"
    assert report["generation"] >= 1
    assert len(report["canary"]) == 1
    assert sorted(sum(report["waves"], report["canary"])) == [0, 1, 2]
    assert {wid for _g, wid in rec["fleet"].values()} == {"<v2>"}
    seen = {}
    for tr in report["transitions"]:
        assert tr["to"] > tr["from"]
        assert tr["to"] > seen.get(tr["idx"], -1)
        seen[tr["idx"]] = tr["to"]
    assert rec["weight_swaps"] == 3
    assert rec["agg"][0] >= 1 and rec["agg"][1] is False
    assert rec["bundles"] == ["weight-rollout-done"]


def _red(s, tmp, pkg):
    pool = _pool(s)
    try:
        prompt = [3, 1, 4, 1, 5]
        want = s.want(prompt, 6)
        flight = os.path.join(tmp, "flight")
        ctl = s.wr.WeightRolloutController(
            pool, canary_fraction=0.34, probes=[(prompt, want)],
            flight_dir=flight)
        before = _rollbacks(pkg)
        report = ctl.rollout(s.bad, weights_id="bad-widXXXX",
                             baseline_params=s.params,
                             baseline_weights_id="g0")
        canary = report["canary"][0]
        out = pool.submit(list(prompt), max_new_tokens=6).result()
        assert out == want
        bundles = sorted(b.split("-0")[0] for b in os.listdir(flight))
        return _norm({"report": report, "fleet": ctl.fleet_weights(),
                      "canary_generation":
                          pool.replica(canary).engine.weight_generation,
                      "swaps": [pool.replica(i).engine.stats["weight_swaps"]
                                for i in range(3)],
                      "rollbacks": pool.route_stats["weight_rollbacks"],
                      "counter": _rollbacks(pkg) - before,
                      "bundles": bundles, "events": _events(pool)}, {})
    finally:
        pool.shutdown()


def test_canary_parity_failure_auto_rolls_back(tmp_path, tiny):
    """An injected regression (perturbed tensors) fails the canary's
    output-parity probe; the controller rolls the pool back onto the
    baseline payload under a fresh generation and flight-explains it."""
    rec = _both(tiny, tmp_path, _red)
    report = rec["report"]
    assert report["status"] == "rolled_back"
    assert "parity" in report["rollback_reason"]
    assert report["probe_failures"]
    rb = report["rollback"]
    assert rb["converged"] is True and rb["failed_replicas"] == []
    assert {wid for _g, wid in rec["fleet"].values()} == {"g0"}
    # ceil(0.34 x 3) = 2 canaries: each swapped twice (to the payload
    # and back under a fresh generation), the third replica never
    assert rec["canary_generation"] == 2
    assert len(report["canary"]) == 2 and report["waves"] == [[2]]
    assert rec["swaps"] == [2, 2, 0], "an untouched replica swapped"
    assert rec["rollbacks"] == 1 and rec["counter"] == 1
    assert rec["bundles"] == ["weight-rollback"]


def _resume(s, tmp, pkg):
    pool = _pool(s)
    try:
        _p2, wid2 = s.wr.publish_weights(s.params, os.path.join(tmp, "v2"),
                                         extra={"release": "v2"})
        # the "dead" controller got exactly one replica swapped
        pool.swap_replica_weights(0, s.params, weights_id=wid2)
        ctl = s.wr.WeightRolloutController(
            pool, canary_fraction=0.34, flight_dir=os.path.join(tmp, "f"))
        report = ctl.rollout(s.params, weights_id=wid2,
                             baseline_params=s.params,
                             baseline_weights_id="g0")
        return _norm({"report": report, "fleet": ctl.fleet_weights(),
                      "events": _events(pool)}, {wid2: "<v2>"})
    finally:
        pool.shutdown()


def test_rollout_resumes_after_controller_death(tmp_path, tiny):
    rec = _both(tiny, tmp_path, _resume)
    report = rec["report"]
    assert report["status"] == "completed"
    assert report["resumed"] == [0]
    assert 0 not in sum(report["waves"], report["canary"])
    assert {wid for _g, wid in rec["fleet"].values()} == {"<v2>"}


def _restamp(s, tmp, pkg):
    pool = _pool(s, n=2)
    try:
        _p2, wid2 = s.wr.publish_weights(s.params, os.path.join(tmp, "v2"),
                                         extra={"release": "v2"})
        ctl = s.wr.WeightRolloutController(pool, canary_fraction=0.5,
                                           flight_dir=os.path.join(tmp, "f"))
        status = ctl.rollout(s.params, weights_id=wid2,
                             baseline_params=s.params,
                             baseline_weights_id="g0")["status"]
        assert pool.drain(0)            # drain -> factory -> restamp
        rep = pool.replica(0)
        rebuilt = (rep.state, rep.generation, rep.engine.weights_id,
                   rep.engine.weight_generation)
        idx = pool.add_replica()        # scale-up path
        added = (idx, pool.replica(idx).engine.weights_id,
                 pool.replica(idx).engine.weight_generation)
        out = pool.submit([1, 2, 3], max_new_tokens=4).result()
        assert out == s.want([1, 2, 3], 4)
        return _norm({"status": status, "rebuilt": rebuilt, "added": added,
                      "events": _events(pool)}, {wid2: "<v2>"})
    finally:
        pool.shutdown()


def test_rebuilt_and_added_replicas_are_restamped(tmp_path, tiny):
    """A replica rebuilt (or added) AFTER a completed rollout rejoins on
    the pool's current payload, not the factory's generation-0 one."""
    rec = _both(tiny, tmp_path, _restamp)
    assert rec["status"] == "completed"
    assert rec["rebuilt"][:3] == ["healthy", 1, "<v2>"]
    assert rec["rebuilt"][3] >= 1
    assert rec["added"][1] == "<v2>"
    assert "weight_restamp" in [e[0] for e in rec["events"]]


def _dead_replica(s, tmp, pkg):
    pool = _pool(s, n=2)
    try:
        pool.replica(1).state = "dead"
        with pytest.raises(RuntimeError) as ei:
            pool.swap_replica_weights(1, s.params, weights_id="x")
        pool.replica(1).state = "healthy"
        return {"refused": str(ei.value)}
    finally:
        pool.shutdown()


def test_swap_refused_on_dead_replica(tmp_path, tiny):
    assert "dead" in _both(tiny, tmp_path, _dead_replica)["refused"]


def _handle_tags(s, tmp, pkg):
    pool = _pool(s, n=1)
    try:
        tags = []
        for wid in (None, "w2"):
            if wid is not None:
                pool.swap_replica_weights(0, s.params, weights_id=wid)
            h = pool.submit([1, 2, 3], max_new_tokens=2)
            assert h.result() == s.want([1, 2, 3], 2)
            tags.append(h.weights_tag)
        return {"tags": tags}
    finally:
        pool.shutdown()


def test_pool_handle_weights_tag(tmp_path, tiny):
    assert _both(tiny, tmp_path, _handle_tags)["tags"] == ["0:g0", "1:w2"]
