"""Port of ``ray_tpu/serve/weight_rollout.py``: live weight rollout,
the hot checkpoint swap under traffic.

A new payload is published in the air/checkpoint.py sha256-manifest
format, each replica stages it off the hot path and flips between
scheduler rounds under the engine's monotonic weight-generation fence
(``LLMEngine.swap_weights``), and a staged controller walks the pool
through it — canary a configurable fraction of replicas, watch health
and output-parity probes, advance on green, roll back on regression.
``params`` is a state dict of the port's Llama (``models.llama``), the
form ``swap_weights`` and ``EnginePool.set_weight_source`` take;
``load_weights`` returns it as CPU tensors.

Identity model: the **generation** is a per-engine strictly monotonic
fence (every swap advances it, rollbacks included), so "which payload
is serving" is named by the **weights_id** — derived from the payload's
canonical content (tree paths + dtypes + shapes + raw leaf bytes), so
the same bytes always get the same id, across independent publishes and
across the two packages, and a rollback provably converges the pool
back onto the old payload. Every transition is evented into the pool
ring, and the terminal transitions (rollback, completion) are
flight-bundle-explained.

Failure stances:

- torn / corrupt checkpoint: ``load_weights`` deep-verifies against
  the manifest and refuses typed (``InvalidCheckpointError``) before
  any replica is touched.
- replica killed mid-swap: the swap raises; the pool's death path
  rebuilds the replica (and ``EnginePool._restamp_weights`` re-stamps
  it from the recorded weight source), the controller re-attempts a
  bounded number of times, then rolls the pool back rather than
  leaving it torn.
- controller killed mid-rollout: per-replica ``weights_id`` is the
  durable state. A fresh ``rollout()`` call skips replicas already on
  the target payload, so re-running the controller resumes (or
  ``rollback`` converges everyone back).
"""
from __future__ import annotations

import hashlib
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.air.checkpoint import (Checkpoint, InvalidCheckpointError,
                                          verify_checkpoint_dir)
from ray_tpu_torch.serve import obs
from ray_tpu_torch.serve.engine import _metrics as _engine_metrics

HEALTHY_STATES = ("healthy", "suspect")


def weights_id_from_manifest(manifest: Dict[str, Any]) -> str:
    """Legacy payload identity: a digest over the manifest's per-file
    sha256 table. Stable for one committed directory, but no payload
    identity: it names the store's files, which differ between the two
    packages' stores (and, in the reference's, between republishes of
    the same tensors). Kept for auditing a specific directory;
    ``publish_weights``/``load_weights`` stamp ids with
    ``weights_id_from_payload`` instead."""
    h = hashlib.sha256()
    for rel in sorted(manifest.get("files") or {}):
        rec = manifest["files"][rel]
        h.update(rel.encode())
        h.update(str(rec.get("sha256")).encode())
    return h.hexdigest()[:12]


def weights_id_from_payload(data: Dict[str, Any]) -> str:
    """Canonical payload identity: a digest over the checkpoint
    dict's tree paths, dtypes, shapes and raw leaf bytes (metadata
    entries included, so release tags still distinguish byte-identical
    tensors). Same content -> same id across independent publishes —
    the property rollback convergence relies on — and the same id as
    the JAX package's for the same values: a tensor leaf hashes as the
    numpy array it equals (its numpy dtype name, its shape as a tuple,
    its C-order bytes, from a contiguous host copy); a dtype numpy
    lacks hashes under its own name (``bfloat16``, as ml_dtypes names
    it) over its raw bytes. Every other leaf goes through
    ``np.asarray`` exactly as in the reference (a string as ``<U...``
    with its UCS-4 bytes)."""
    h = hashlib.sha256()

    def leaf(v: Any) -> None:
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            try:
                a = t.numpy()
            except TypeError:            # no numpy dtype: bfloat16, ...
                h.update(str(t.dtype).replace("torch.", "").encode())
                h.update(str(tuple(t.shape)).encode())
                h.update(memoryview(t.reshape(-1).view(torch.uint8)
                                    .numpy()))
                return
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(memoryview(a.reshape(-1).view(np.uint8)))
            return
        try:
            a = np.asarray(v)
        except Exception:
            a = None
        if a is None or a.dtype == object:
            h.update(repr(v).encode())
        else:
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())

    def walk(prefix: str, v: Any) -> None:
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{prefix}/{k}", v[k])
            return
        if isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
            return
        h.update(prefix.encode())
        leaf(v)

    walk("", data)
    return h.hexdigest()[:12]


def publish_weights(params, path: str, step: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Tuple[str, str]:
    """Publish ``params`` as a committed checkpoint directory (stage
    -> fsync -> manifest -> atomic rename; never observable torn).
    ``extra`` entries (release tags, training metadata) ride in the
    payload and distinguish the ``weights_id`` even when the tensors
    are byte-identical. Returns ``(path, weights_id)``."""
    data = dict(extra or {})
    data["params"] = params
    out = Checkpoint.from_dict(data).to_directory(path, step=step)
    ok, reason, _manifest = verify_checkpoint_dir(out)
    if not ok:                                    # pragma: no cover
        raise InvalidCheckpointError(out, reason)
    return out, weights_id_from_payload(data)


def load_weights(path: str) -> Tuple[Any, str]:
    """Deep-verify then load a published checkpoint's params. A torn,
    truncated, or bit-rotted directory is refused TYPED
    (``InvalidCheckpointError``) before any replica is touched.
    Returns ``(params, weights_id)``."""
    ok, reason, _manifest = verify_checkpoint_dir(path, deep=True)
    if not ok:
        raise InvalidCheckpointError(path, reason)
    data = Checkpoint.from_directory(path).to_dict()
    if "params" not in data:
        raise InvalidCheckpointError(
            path, "checkpoint carries no 'params' entry")
    return data["params"], weights_id_from_payload(data)


def publish_and_swap(engine, params, path: str, *,
                     step: Optional[int] = None, mode: str = "preempt",
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Tuple[int, str]:
    """In-process publish -> swap shortcut for a co-located learner
    (the RLHF loop's per-update path): commit ``params`` as a durable
    manifest checkpoint, then install them on ``engine`` under the next
    generation. The durable copy is what a restarted generator re-syncs
    from; the swap is what live decode picks up. Returns
    ``(generation, weights_id)``."""
    _, wid = publish_weights(params, path, step=step, extra=extra)
    gen = engine.swap_weights(
        params, generation=engine.weight_generation + 1,
        weights_id=wid, mode=mode)
    return gen, wid


class WeightRolloutController:
    """Staged fleet rollout over an ``EnginePool``.

    ``canary_fraction`` of live replicas swap first; ``probes`` —
    ``(prompt_ids, expected_ids)`` pairs — run against each canary
    (greedy output parity: the new payload must reproduce its golden
    outputs), TTFT EWMAs are compared against the pre-rollout baseline
    through the load_report plane, and only a green canary lets the
    remaining waves advance. Any regression rolls every touched
    replica back to the baseline payload under a FRESH generation (the
    fence never retreats) and flight-explains the decision."""

    def __init__(self, pool, *, canary_fraction: float = 0.34,
                 probes: Optional[Sequence[Tuple[Sequence[int],
                                                 Sequence[int]]]] = None,
                 ttft_ratio_limit: Optional[float] = 3.0,
                 ttft_floor_s: float = 0.05,
                 swap_mode: str = "preempt",
                 max_swap_attempts: int = 3,
                 rebuild_wait_s: float = 10.0,
                 flight_dir: Optional[str] = None):
        if not 0.0 < canary_fraction <= 1.0:
            raise ValueError("canary_fraction must be in (0, 1]")
        self.pool = pool
        self.canary_fraction = float(canary_fraction)
        self.probes = [(list(p), list(e)) for p, e in (probes or ())]
        self.ttft_ratio_limit = ttft_ratio_limit
        self.ttft_floor_s = float(ttft_floor_s)
        self.swap_mode = swap_mode
        self.max_swap_attempts = max(1, int(max_swap_attempts))
        self.rebuild_wait_s = float(rebuild_wait_s)
        self.flight_dir = flight_dir

    # ----------------------------------------------------------- state

    def _live_replicas(self) -> List[Dict[str, Any]]:
        return [r for r in self.pool.pool_stats()["replicas"]
                if r["state"] in HEALTHY_STATES]

    def fleet_weights(self) -> Dict[int, Tuple[int, Optional[str]]]:
        """Per-replica ``idx -> (weight_generation, weights_id)`` for
        live replicas — the durable rollout state a resuming
        controller reads."""
        return {r["idx"]: (r["weight_generation"], r["weights_id"])
                for r in self._live_replicas()}

    # ---------------------------------------------------------- health

    def _probe_replica(self, idx: int) -> List[Dict[str, Any]]:
        """Run every parity probe directly against replica ``idx``
        (bypassing routing on purpose: the probe adjudicates THIS
        replica's payload). Returns the failures."""
        eng = self.pool.replica(idx).engine
        failures: List[Dict[str, Any]] = []
        for pi, (prompt, expected) in enumerate(self.probes):
            try:
                out = eng.submit(list(prompt),
                                 max_new_tokens=len(expected)).result()
            except Exception as e:  # noqa: BLE001
                failures.append({"probe": pi, "error": repr(e)})
                continue
            if list(out) != list(expected):
                failures.append({"probe": pi, "got": list(out),
                                 "want": list(expected)})
        return failures

    def _health_regression(self, idx: int,
                           baseline_ttft: Optional[float]
                           ) -> Optional[str]:
        """Post-swap health through the telemetry plane: the replica
        must be alive and its TTFT EWMA must not have blown past the
        baseline ratio. Returns a reason string on regression."""
        try:
            rpt = self.pool.replica(idx).engine.load_report()
        except Exception as e:  # noqa: BLE001
            return f"load_report failed: {e!r}"
        if rpt.get("stopped"):
            return "replica stopped after swap"
        if self.ttft_ratio_limit is not None:
            cur = rpt.get("ttft_ewma_s")
            if cur is not None and baseline_ttft is not None:
                floor = max(baseline_ttft, self.ttft_floor_s)
                if cur > self.ttft_ratio_limit * floor:
                    return (f"ttft regression: {cur:.4f}s > "
                            f"{self.ttft_ratio_limit:.1f}x baseline "
                            f"{baseline_ttft:.4f}s")
        return None

    # ------------------------------------------------------------ swap

    def _swap_one(self, idx: int, params, weights_id: str,
                  transitions: List[Dict[str, Any]]) -> bool:
        """Swap one replica with bounded retry across a mid-swap
        death: the pool's death path rebuilds the replica (re-stamped
        from the recorded weight source), and the next attempt lands
        on the fresh incarnation."""
        for attempt in range(self.max_swap_attempts):
            rep = self.pool.replica(idx)
            before = getattr(rep.engine, "weight_generation", 0)
            try:
                gen = self.pool.swap_replica_weights(
                    idx, params, weights_id=weights_id,
                    mode=self.swap_mode)
                transitions.append({"idx": idx, "from": before,
                                    "to": gen,
                                    "weights_id": weights_id,
                                    "attempt": attempt})
                return True
            except Exception as e:  # noqa: BLE001
                self.pool.events.append(
                    "weight_swap_failed", sid=idx,
                    data={"attempt": attempt, "error": repr(e)})
                if not self._await_live(idx):
                    return False
        return False

    def _await_live(self, idx: int) -> bool:
        """Wait (bounded) for replica ``idx`` to be live again — the
        auto-restart rebuild after a mid-swap kill."""
        deadline = time.monotonic() + self.rebuild_wait_s
        while time.monotonic() < deadline:
            try:
                if self.pool.replica(idx).state in HEALTHY_STATES:
                    return True
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.05)
        try:
            return self.pool.replica(idx).state in HEALTHY_STATES
        except Exception:  # noqa: BLE001
            return False

    # --------------------------------------------------------- rollout

    def rollout(self, new_params, *, weights_id: str,
                baseline_params, baseline_weights_id: str
                ) -> Dict[str, Any]:
        """Stage the fleet onto ``new_params``. Returns a report dict
        with ``status`` of ``"completed"`` or ``"rolled_back"`` (the
        rollback reason rides along), per-replica generation
        transitions, and the canary/probe evidence. Replicas already
        serving ``weights_id`` are skipped, which is also the resume
        path after a controller death."""
        live = self._live_replicas()
        if not live:
            raise RuntimeError("no live replicas to roll out to")
        pending = [r["idx"] for r in live
                   if r["weights_id"] != weights_id]
        done_already = [r["idx"] for r in live
                        if r["weights_id"] == weights_id]
        baseline_ttft = {}
        for r in live:
            try:
                baseline_ttft[r["idx"]] = self.pool.replica(
                    r["idx"]).engine.load_report().get("ttft_ewma_s")
            except Exception:  # noqa: BLE001
                baseline_ttft[r["idx"]] = None
        n_canary = max(1, math.ceil(
            self.canary_fraction * (len(pending) + len(done_already))))
        # resume path: replicas already converged count against the
        # canary quota — a re-run after a controller death re-canaries
        # only what the dead controller never proved
        canary = pending[:max(0, n_canary - len(done_already))]
        waves: List[List[int]] = []
        rest = pending[len(canary):]
        wave_size = max(1, n_canary)
        for i in range(0, len(rest), wave_size):
            waves.append(rest[i:i + wave_size])
        transitions: List[Dict[str, Any]] = []
        report: Dict[str, Any] = {
            "weights_id": weights_id,
            "baseline_weights_id": baseline_weights_id,
            "canary": list(canary),
            "waves": [list(w) for w in waves],
            "resumed": list(done_already),
            "transitions": transitions,
            "probe_failures": [],
        }
        self.pool.events.append("rollout_start", data={
            "weights_id": weights_id, "canary": list(canary),
            "pending": list(pending), "resumed": list(done_already)})

        def _rollback(reason: str) -> Dict[str, Any]:
            rb = self.rollback(baseline_params,
                               baseline_weights_id=baseline_weights_id,
                               reason=reason,
                               transitions=transitions)
            report.update(status="rolled_back",
                          rollback=rb, rollback_reason=reason)
            return report

        # -------------------------------------------------- canary wave
        for idx in canary:
            self.pool.events.append("canary", sid=idx,
                                    data={"weights_id": weights_id})
            if not self._swap_one(idx, new_params, weights_id,
                                  transitions):
                return _rollback(
                    f"canary replica {idx} could not swap "
                    f"(died mid-swap and did not recover)")
        for idx in canary:
            failures = self._probe_replica(idx)
            if failures:
                report["probe_failures"] = failures
                return _rollback(
                    f"canary replica {idx} failed "
                    f"{len(failures)}/{len(self.probes)} parity "
                    f"probes")
            regression = self._health_regression(
                idx, baseline_ttft.get(idx))
            if regression:
                return _rollback(
                    f"canary replica {idx} health: {regression}")
        # ------------------------------------------------ advance waves
        for wave in waves:
            self.pool.events.append("advance", data={
                "replicas": list(wave), "weights_id": weights_id})
            for idx in wave:
                if not self._swap_one(idx, new_params, weights_id,
                                      transitions):
                    return _rollback(
                        f"replica {idx} could not swap during "
                        f"advance")
                regression = self._health_regression(
                    idx, baseline_ttft.get(idx))
                if regression:
                    return _rollback(
                        f"replica {idx} health after advance: "
                        f"{regression}")
        # ------------------------------------------------- convergence
        stragglers = [i for i, (_g, wid)
                      in self.fleet_weights().items()
                      if wid != weights_id]
        if stragglers:
            return _rollback(
                f"fleet did not converge: replicas {stragglers} not "
                f"on {weights_id}")
        fleet_gen = max(g for g, _ in self.fleet_weights().values())
        self.pool.set_weight_source(new_params, weights_id=weights_id,
                                    generation=fleet_gen)
        self.pool.events.append("rollout_done", data={
            "weights_id": weights_id, "generation": fleet_gen})
        obs.dump_flight_bundle(
            self.flight_dir, "weight-rollout-done", pool=self.pool,
            extra={"weights_id": weights_id,
                   "generation": fleet_gen,
                   "transitions": transitions})
        report.update(status="completed", generation=fleet_gen)
        return report

    # -------------------------------------------------------- rollback

    def rollback(self, baseline_params, *, baseline_weights_id: str,
                 reason: str,
                 transitions: Optional[List[Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
        """Converge every live replica back onto the baseline payload.
        The fence never retreats: each touched replica swaps to the
        OLD params under a NEW generation; ``weights_id`` equality is
        the convergence proof. Evented, counted, and
        flight-explained."""
        transitions = transitions if transitions is not None else []
        self.pool.events.append("rollback", data={
            "weights_id": baseline_weights_id, "reason": reason})
        failed: List[int] = []
        for idx, (_gen, wid) in sorted(self.fleet_weights().items()):
            if wid == baseline_weights_id:
                continue
            if not self._swap_one(idx, baseline_params,
                                  baseline_weights_id, transitions):
                failed.append(idx)
        converged = not failed and all(
            wid == baseline_weights_id
            for _g, wid in self.fleet_weights().values())
        if converged:
            fleet_gen = max(
                g for g, _ in self.fleet_weights().values())
            self.pool.set_weight_source(
                baseline_params, weights_id=baseline_weights_id,
                generation=fleet_gen)
        with self.pool._lock:
            self.pool.route_stats["weight_rollbacks"] += 1
        _engine_metrics()["weight_rollbacks"].inc()
        bundle = obs.dump_flight_bundle(
            self.flight_dir, "weight-rollback", pool=self.pool,
            extra={"reason": reason,
                   "baseline_weights_id": baseline_weights_id,
                   "converged": converged,
                   "failed_replicas": failed,
                   "fleet": {str(i): {"generation": g,
                                      "weights_id": w}
                             for i, (g, w)
                             in self.fleet_weights().items()}})
        return {"reason": reason, "converged": converged,
                "failed_replicas": failed, "bundle": bundle,
                "fleet": self.fleet_weights()}
