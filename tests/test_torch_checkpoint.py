"""The port's durable checkpoints (``ray_tpu_torch/air/checkpoint.py``,
``checkpoint_manager.py``) against the JAX package's, on the CPU.

- The cases of tests/test_checkpoint.py (but ``test_sharded_restore``,
  which waits for the port's mesh) and tests/test_checkpoint_manager.py,
  run on the port: manifests, typed refusals of torn, corrupt and
  unmanifested directories, the atomic re-commit, async saves that
  snapshot, the racing reader, torn-directory resolution, retention and
  writer errors.
- Cross-checks with the JAX package: each package's
  ``verify_checkpoint_dir`` accepts a directory the other wrote,
  shallow and deep, and both refuse the same damage (a truncation, a
  flipped byte, a missing and a malformed manifest) with the same
  reasons; round trips of bf16 tensors, numpy arrays and dotted or
  integer keys are exact; a snapshot survives an in-place
  ``optimizer.step()``.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu.air import checkpoint as jck
from ray_tpu_torch.air import Checkpoint, InvalidCheckpointError
from ray_tpu_torch.air import checkpoint as tck
from ray_tpu_torch.air.checkpoint import (MANIFEST_FILE, MANIFEST_FORMAT,
                                          load_manifest,
                                          verify_checkpoint_dir)
from ray_tpu_torch.air.checkpoint_manager import (CheckpointManager,
                                                  step_dir_name)


def test_dict_roundtrip():
    ckpt = Checkpoint.from_dict({"step": 3, "note": "hi"})
    assert ckpt.to_dict() == {"step": 3, "note": "hi"}
    assert ckpt["step"] == 3
    assert "note" in ckpt
    assert ckpt.get("missing", 7) == 7


def test_directory_roundtrip_with_arrays(tmp_path):
    params = {"w": torch.arange(8.0), "b": np.ones((4,), np.float32)}
    ckpt = Checkpoint.from_dict({
        "params": params, "step": 42, "name": "trial-1"})
    path = ckpt.to_directory(str(tmp_path / "ckpt"))
    restored = Checkpoint.from_directory(path).to_dict()
    assert restored["step"] == 42
    assert restored["name"] == "trial-1"
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.arange(8.0))
    np.testing.assert_array_equal(restored["params"]["b"], np.ones((4,)))


def test_constructor_validation():
    with pytest.raises(ValueError):
        Checkpoint()
    with pytest.raises(FileNotFoundError):
        Checkpoint.from_directory("/nonexistent/path")


# ---------------------------------------------------------------------------
# Durability: manifests, torn-checkpoint detection, atomic commit
# ---------------------------------------------------------------------------


def _commit(tmp_path, name="c", step=7, extra=None):
    data = {"w": torch.arange(4.0, dtype=torch.float64), "step": step}
    data.update(extra or {})
    return Checkpoint.from_dict(data).to_directory(
        str(tmp_path / name), step=step)


def test_to_directory_writes_manifest(tmp_path):
    path = _commit(tmp_path, step=42)
    manifest = load_manifest(path)
    assert manifest["step"] == 42
    assert manifest["format"] == MANIFEST_FORMAT
    assert isinstance(manifest["wall_time"], float)
    assert sorted(manifest["files"]) == ["arrays/tensors.pt", "meta.pkl"]
    for rel, rec in manifest["files"].items():
        assert rel != MANIFEST_FILE
        assert len(rec["sha256"]) == 64
        assert rec["bytes"] == os.path.getsize(os.path.join(path, rel))
    assert verify_checkpoint_dir(path)[0]
    assert verify_checkpoint_dir(path, deep=True)[0]


def test_from_directory_refuses_missing_manifest(tmp_path):
    bogus = tmp_path / "not_a_ckpt"
    bogus.mkdir()
    (bogus / "meta.pkl").write_bytes(b"whatever")
    with pytest.raises(InvalidCheckpointError) as ei:
        Checkpoint.from_directory(str(bogus))
    assert "manifest" in str(ei.value)


def test_from_directory_refuses_invalid_manifest(tmp_path):
    bogus = tmp_path / "bad_manifest"
    bogus.mkdir()
    (bogus / MANIFEST_FILE).write_text("{not json")
    with pytest.raises(InvalidCheckpointError):
        Checkpoint.from_directory(str(bogus))
    (bogus / MANIFEST_FILE).write_text('{"format": 99, "files": {}}')
    with pytest.raises(InvalidCheckpointError):
        Checkpoint.from_directory(str(bogus))


def test_from_directory_refuses_torn_payload(tmp_path):
    """Truncating a payload file after commit = torn copy; the shallow
    size check already refuses it."""
    path = _commit(tmp_path)
    for rel in sorted(load_manifest(path)["files"]):
        full = os.path.join(path, rel)
        with open(full, "rb") as f:
            content = f.read()
        with open(full, "wb") as f:
            f.write(content[: max(0, len(content) - 1)])
        with pytest.raises(InvalidCheckpointError):
            Checkpoint.from_directory(str(path))
        with open(full, "wb") as f:
            f.write(content)
        Checkpoint.from_directory(str(path))


def test_deep_verify_catches_same_size_corruption(tmp_path):
    """Bit rot that preserves file size passes shallow verification
    but MUST fail the deep (re-hash) pass latest_complete() uses."""
    path = _commit(tmp_path)
    rel = sorted(load_manifest(path)["files"])[0]
    full = os.path.join(path, rel)
    with open(full, "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))
    ok_shallow, _, manifest = verify_checkpoint_dir(path)
    ok_deep, reason, _ = verify_checkpoint_dir(path, deep=True)
    assert ok_shallow
    assert manifest["files"], "verify must return the parsed manifest"
    assert not ok_deep
    assert "hash" in reason


def test_commit_displaces_existing_directory(tmp_path):
    """Re-saving over an old checkpoint swaps it atomically — the
    target is never a half-written mix of the two, and no displaced
    directory is left behind."""
    target = tmp_path / "slot"
    Checkpoint.from_dict({"v": 1, "step": 1}).to_directory(
        str(target), step=1)
    Checkpoint.from_dict({"v": 2, "step": 2}).to_directory(
        str(target), step=2)
    assert load_manifest(str(target))["step"] == 2
    assert Checkpoint.from_directory(str(target)).to_dict()["v"] == 2
    assert os.listdir(str(tmp_path)) == ["slot"]


def test_commit_falls_back_to_two_renames(tmp_path, monkeypatch):
    """Where the atomic exchange is unsupported, the reference's
    rename-away-then-in commit still installs the new payload."""
    monkeypatch.setattr(tck, "_exchange", lambda a, b: False)
    target = tmp_path / "slot"
    for v in (1, 2):
        Checkpoint.from_dict({"v": v}).to_directory(str(target), step=v)
    assert Checkpoint.from_directory(str(target)).to_dict()["v"] == 2
    assert os.listdir(str(tmp_path)) == ["slot"]


def test_to_directory_of_a_directory_checkpoint_recommits(tmp_path):
    """A directory checkpoint copied elsewhere is re-manifested, its step
    carried over from the source's manifest."""
    src = _commit(tmp_path, step=9)
    out = Checkpoint.from_directory(src).to_directory(
        str(tmp_path / "copy"))
    assert load_manifest(out)["step"] == 9
    assert verify_checkpoint_dir(out, deep=True)[0]
    np.testing.assert_array_equal(
        Checkpoint.from_directory(out).to_dict()["w"].numpy(),
        np.arange(4.0))


# ---------------------------------------------------------------------------
# Cross-checks with the JAX package
# ---------------------------------------------------------------------------


def _write(pkg, path):
    data = {"w": np.arange(16.0, dtype=np.float32).reshape(4, 4),
            "step": 5, "note": "release-a"}
    if pkg == "jax":
        return jck.Checkpoint.from_dict(data).to_directory(path, step=5)
    data["t"] = torch.arange(6, dtype=torch.int32)
    return Checkpoint.from_dict(data).to_directory(path, step=5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_verifies_the_others_directory(tmp_path, writer):
    path = _write(writer, str(tmp_path / "c"))
    for verify in (tck.verify_checkpoint_dir, jck.verify_checkpoint_dir):
        for deep in (False, True):
            ok, reason, manifest = verify(path, deep=deep)
            assert ok and reason is None, (verify.__module__, reason)
            assert manifest["step"] == 5
    assert load_manifest(path) == jck.load_manifest(path)
    Checkpoint.from_directory(path)
    jck.Checkpoint.from_directory(path)


def _truncate(path, rel):
    full = os.path.join(path, rel)
    with open(full, "rb") as f:
        content = f.read()
    with open(full, "wb") as f:
        f.write(content[:-1])


def _flip(path, rel):
    full = os.path.join(path, rel)
    with open(full, "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))


def _damage(kind, path):
    files = load_manifest(path)["files"]
    rel = max(sorted(files), key=lambda r: files[r]["bytes"])
    if kind == "truncated":
        _truncate(path, rel)
    elif kind == "flipped":
        _flip(path, rel)
    elif kind == "missing_file":
        os.remove(os.path.join(path, rel))
    elif kind == "missing_manifest":
        os.remove(os.path.join(path, MANIFEST_FILE))
    elif kind == "unparseable_manifest":
        with open(os.path.join(path, MANIFEST_FILE), "w") as f:
            f.write("{not json")
    elif kind == "wrong_format":
        with open(os.path.join(path, MANIFEST_FILE), "w") as f:
            json.dump({"format": 99, "files": {}}, f)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["truncated", "flipped", "missing_file",
                                  "missing_manifest", "unparseable_manifest",
                                  "wrong_format"])
def test_both_packages_refuse_the_same_damage_with_the_same_reason(
        tmp_path, writer, kind):
    path = _write(writer, str(tmp_path / "c"))
    _damage(kind, path)
    for deep in (False, True):
        port = tck.verify_checkpoint_dir(path, deep=deep)
        ref = jck.verify_checkpoint_dir(path, deep=deep)
        assert port[:2] == ref[:2]
        assert port[2] == ref[2]
    assert not tck.verify_checkpoint_dir(path, deep=True)[0]
    if kind == "flipped":           # same size: only the deep pass sees it
        assert tck.verify_checkpoint_dir(path)[0]
        return
    with pytest.raises(InvalidCheckpointError) as ei:
        Checkpoint.from_directory(path)
    with pytest.raises(jck.InvalidCheckpointError) as ej:
        jck.Checkpoint.from_directory(path)
    assert ei.value.reason == ej.value.reason
    assert str(ei.value) == str(ej.value)


def test_round_trips_are_exact(tmp_path):
    """bf16, fp16, int8, bool and 0-d tensors come back as CPU tensors,
    numpy leaves as numpy, with their dtypes, shapes and bytes; dotted,
    integer and empty keys survive, and so does a tensor shared by two
    keys."""
    g = torch.Generator().manual_seed(0)
    shared = torch.randn(3, generator=g)
    sd = {"layers.0.attention.wo.weight":
          torch.randn(8, 4, generator=g).to(torch.bfloat16),
          "layers.0.ffn_norm.scale": torch.rand(4, generator=g),
          "tok_embeddings": torch.randn(5, 4, generator=g,
                                        dtype=torch.float64)}
    data = {"params": sd, "opt": {"state": {0: {"step": torch.tensor(3.0),
                                                "exp_avg": shared}},
                                  "param_groups": [{"lr": 1e-3,
                                                    "params": [0]}]},
            "extra": {"": "empty key", "a.b.c": np.arange(6, dtype=np.int8)
                      .reshape(2, 3), "h": np.float16([1.5, -2.25]),
                      "flags": torch.tensor([True, False]),
                      "q": torch.randint(-128, 127, (2, 2), generator=g,
                                         dtype=torch.int8),
                      "again": shared},
            "step": 11, "release": "v2"}
    path = Checkpoint.from_dict(data).to_directory(str(tmp_path / "x"))
    back = Checkpoint.from_directory(path).to_dict()

    def same(a, b):
        assert type(a) is type(b) or (isinstance(a, dict)
                                      and isinstance(b, dict)), (a, b)
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, torch.Tensor):
            assert b.device.type == "cpu"
            assert (a.dtype, a.shape) == (b.dtype, b.shape)
            assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                               b.view(torch.uint8) if b.dim() else b)
        elif isinstance(a, np.ndarray):
            assert (a.dtype, a.shape) == (b.dtype, b.shape)
            assert a.tobytes() == b.tobytes()
        else:
            assert a == b

    same(data, back)
    assert back["extra"]["again"] is back["opt"]["state"][0]["exp_avg"]


def test_round_trip_of_a_bf16_state_dict_builds_the_same_model(tmp_path):
    from ray_tpu_torch.models import llama as tl
    cfg = tl.llama_tiny(dtype=torch.bfloat16)
    sd = tl.init_params(cfg, 0, device="cpu")
    path = Checkpoint.from_dict({"params": sd}).to_directory(
        str(tmp_path / "w"))
    back = Checkpoint.from_directory(path).to_dict()["params"]
    assert list(back) == list(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k])
    ids = torch.tensor([[1, 2, 3, 4]])
    a = tl.build_model(cfg, sd, "cpu")(ids)
    b = tl.build_model(cfg, back, "cpu")(ids)
    assert torch.equal(a, b)


def test_snapshot_survives_in_place_optimizer_step(tmp_path):
    """Torch updates parameters and moments in place: the async save
    copies every tensor leaf before it returns, so the committed bytes
    are the step's even though ``optimizer.step()`` runs while the
    writer is held."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    x = torch.randn(8, 4)
    for _ in range(2):
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = {i: {k: v.clone() for k, v in s.items()}
                for i, s in opt.state_dict()["state"].items()}
    gate = threading.Event()
    mgr = CheckpointManager(str(tmp_path),
                            pre_commit_hook=lambda s: gate.wait(10))
    try:
        handle = mgr.save_async({"model": model.state_dict(),
                                 "optimizer": opt.state_dict(),
                                 "step": 2}, 2)
        for _ in range(3):          # train on while the save is held
            opt.zero_grad()
            model(x).square().mean().backward()
            opt.step()
        assert not torch.equal(model.weight, want_model["weight"])
        gate.set()
        assert handle.wait(10) and handle.committed
        got = mgr.latest_complete().to_dict()
    finally:
        gate.set()
        mgr.close()
    for k, v in want_model.items():
        assert torch.equal(got["model"][k], v)
    for i, s in want_opt.items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v)
    # and it restores: a fresh model and optimizer continue as the
    # uninterrupted pair does from the step's values (each optimizer
    # loads its own copy: ``load_state_dict`` keeps the given tensors)
    twins = []
    for state in (got, {"model": want_model, "optimizer": {
            "state": want_opt,
            "param_groups": got["optimizer"]["param_groups"]}}):
        m = torch.nn.Linear(4, 3)
        o = torch.optim.AdamW(m.parameters(), lr=0.1)
        m.load_state_dict(state["model"])
        o.load_state_dict(state["optimizer"])
        o.zero_grad()
        m(x).square().mean().backward()
        o.step()
        twins.append(m.weight.detach())
    assert torch.equal(twins[0], twins[1])


# ---------------------------------------------------------------------------
# CheckpointManager (tests/test_checkpoint_manager.py)
# ---------------------------------------------------------------------------


def _plant_torn(root, step, payload=b"\x00torn\x00"):
    """A directory that shallow-passes (sizes match) but deep-fails
    (hash mismatch) — what a torn copy or bit rot looks like."""
    torn = os.path.join(root, step_dir_name(step))
    os.makedirs(torn, exist_ok=True)
    with open(os.path.join(torn, "meta.pkl"), "wb") as f:
        f.write(payload)
    manifest = {"format": MANIFEST_FORMAT, "step": step, "wall_time": 0.0,
                "files": {"meta.pkl": {"sha256": "0" * 64,
                                       "bytes": len(payload)}}}
    with open(os.path.join(torn, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f)
    return torn


def test_save_async_is_nonblocking_and_snapshots(tmp_path):
    """save_async returns while the commit is still in flight, and the
    committed bytes are the values AT THE REQUESTED STEP even if the
    loop mutates its arrays (numpy and torch) right after."""
    gate = threading.Event()
    mgr = CheckpointManager(str(tmp_path),
                            pre_commit_hook=lambda s: gate.wait(10))
    try:
        w = np.arange(4.0)
        t = torch.arange(4.0)
        t0 = time.monotonic()
        handle = mgr.save_async({"w": w, "t": t, "step": 5}, 5)
        elapsed = time.monotonic() - t0
        assert elapsed < 1.0, "save_async blocked on the commit"
        assert not handle.done(), "commit is gated; cannot be done yet"
        w += 100.0            # train step overlapping the save
        t += 100.0
        gate.set()
        assert handle.wait(10)
        assert handle.committed and handle.error is None
        assert load_manifest(handle.path)["step"] == 5
        got = mgr.latest_complete().to_dict()
        np.testing.assert_array_equal(got["w"], np.arange(4.0))
        assert torch.equal(got["t"], torch.arange(4.0))
    finally:
        gate.set()
        mgr.close()


def test_save_async_racing_reader_never_sees_torn(tmp_path):
    """A reader calling ``Checkpoint.from_directory`` on a slot that an
    async save is re-committing must see the OLD complete checkpoint or
    the NEW complete one — never a torn mix and never a missing path.
    Two probes:

    1. deterministic: while the writer is held in ``pre_commit_hook``
       (staged, rename not yet observable) the reader gets the old
       payload;
    2. stochastic: hammer threads read in a loop across the commit
       (the atomic exchange and the removal of the displaced
       directory), through several re-commits, and every read must
       parse as exactly one of the committed payloads.
    """
    in_hook, release = threading.Event(), threading.Event()

    def hook(step):
        in_hook.set()
        assert release.wait(10)

    mgr = CheckpointManager(str(tmp_path), pre_commit_hook=hook)
    try:
        release.set()                       # first save runs unheld
        mgr.save({"v": 1, "t": torch.full((64,), 1.0), "step": 7}, 7)
        path = os.path.join(str(tmp_path), step_dir_name(7))
        release.clear()
        in_hook.clear()

        seen, errors, reads = set(), [], [0]
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    d = Checkpoint.from_directory(path).to_dict()
                    assert torch.equal(d["t"], torch.full((64,),
                                                          float(d["v"])))
                    seen.add(d["v"])
                    reads[0] += 1
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        threads = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(2)]
        for t in threads:
            t.start()
        handle = mgr.save_async({"v": 2, "t": torch.full((64,), 2.0),
                                 "step": 7}, 7)
        assert in_hook.wait(10)
        # Staged but not committed: reads resolve to the OLD payload.
        assert Checkpoint.from_directory(path).to_dict()["v"] == 1
        release.set()
        assert handle.wait(10) and handle.committed
        # Committed: reads resolve to the NEW payload.
        assert Checkpoint.from_directory(path).to_dict()["v"] == 2
        for v in range(3, 13):              # more commits under the hammer
            mgr.save({"v": v, "t": torch.full((64,), float(v)),
                      "step": 7}, 7)
        time.sleep(0.05)                    # let the hammer observe
        stop.set()
        for t in threads:
            t.join(10)
        assert not errors, f"reader saw a torn checkpoint: {errors[:3]}"
        assert seen and seen <= set(range(1, 13)), \
            f"reads must be old- or new-complete, got {seen}"
        assert reads[0] > 0
    finally:
        release.set()
        mgr.close()


def test_latest_complete_skips_torn_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    try:
        mgr.save({"w": np.zeros(2), "step": 0}, 0)
        mgr.save({"w": np.ones(2), "step": 6}, 6)
        _plant_torn(str(tmp_path), 12)
        ck = mgr.latest_complete()
        assert ck is not None
        assert load_manifest(ck._path)["step"] == 6
        assert mgr.latest_step() == 6
    finally:
        mgr.close()


def test_latest_complete_none_when_only_torn(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    try:
        _plant_torn(str(tmp_path), 3)
        assert mgr.latest_complete() is None
        assert mgr.latest_step() is None
    finally:
        mgr.close()


def test_tmp_litter_is_invisible(tmp_path):
    """`.tmp-*` staging litter (a crash mid-write) must never appear in
    scans or resolution."""
    mgr = CheckpointManager(str(tmp_path))
    try:
        mgr.save({"step": 2}, 2)
        os.makedirs(str(tmp_path / ".tmp-step_00000009-dead"))
        assert mgr.steps() == [2]
        assert mgr.latest_step() == 2
    finally:
        mgr.close()


def test_keep_last_k_prunes_only_complete(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_k=2)
    try:
        torn = _plant_torn(str(tmp_path), 1)
        for step in (6, 12, 18, 24):
            mgr.save({"step": step}, step)
        kept = sorted(n for n in os.listdir(str(tmp_path))
                      if n.startswith("step_"))
        assert kept == [step_dir_name(1), step_dir_name(18),
                        step_dir_name(24)]
        assert os.path.isdir(torn), \
            "torn directories are evidence, never pruned"
    finally:
        mgr.close()


def test_writer_error_propagates(tmp_path):
    boom = RuntimeError("disk on fire")

    def hook(step):
        raise boom

    mgr = CheckpointManager(str(tmp_path), pre_commit_hook=hook)
    try:
        handle = mgr.save_async({"step": 1}, 1)
        handle.wait(10)
        assert handle.error is boom and not handle.committed
        with pytest.raises(RuntimeError, match="disk on fire"):
            mgr.wait(10)
        with pytest.raises(RuntimeError, match="disk on fire"):
            mgr.save({"step": 2}, 2)
        assert mgr.latest_complete() is None, \
            "a failed save must not leave a committed directory"
    finally:
        mgr.close()


def test_save_after_close_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.close()
    with pytest.raises(RuntimeError):
        mgr.save_async({"step": 0}, 0)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep_last_k=0)
