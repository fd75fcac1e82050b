"""Port of ``ray_tpu/rl/loop.py``: the RLHF loop, generate -> score ->
update -> publish -> swap, with round N+1's decode overlapping round
N's learner step.

Topology (Podracer's sebulba split): a generator thread drives the
serving engine on ``LANE_BATCH``; the main thread scores each batch
with a pluggable reward fn, steps the learner (rl/learner.py), then
publishes the new payload durably (``publish_weights`` of host copies
of the learner's state dict — the manifest checkpoint a restarted
generator re-syncs from) and exposes it to the generator, which
installs it via ``swap_weights`` at its NEXT round boundary under the
strictly monotonic generation fence. A swap never lands mid-round: it
would mix policies inside a batch's captured behavior logprobs.

Staleness is bounded on BOTH sides: the generator blocks before
starting round r until ``r - consumed_round <= staleness_bound``
(it may run at most ``staleness_bound`` rounds ahead — 0 degenerates
to the serialized loop), and the main thread re-checks at consumption that
the batch's weights lag the learner by at most ``staleness_bound``
updates, raising ``StalenessViolation`` otherwise (the bound is an
invariant, not a hint).

Exactly-once accounting: batch ids are deterministic per round
(``round-<i>``), every consumed id goes into a ledger committed
atomically WITH the learner state each round
(air/checkpoint_manager.py manifest discipline). Generator death
mid-round regenerates only the unconsumed round (same id, consumed
once); learner death pre-commit loses only the uncommitted round —
resume restores the last complete checkpoint, re-publishes the
recovered params (same bytes => same ``weights_id``, the payload-hash
property), and the generator re-syncs to exactly the recovered
payload. ``AttemptFence`` (train/chaos.py) keeps a superseded loop
from committing after its replacement starts.

Beyond the reference's stats, each round's ``timeline`` entry carries
``sync_s`` (the generator's weight sync before the round), ``publish_s``
and ``commit_s``, and the stats carry ``restore_s`` (a resume's find,
load and ``set_state``; 0 without one).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_tpu_torch.air.checkpoint_manager import CheckpointManager
from ray_tpu_torch.rl.learner import RolloutLearner
from ray_tpu_torch.rl.rollout import GeneratorKilled, RolloutGenerator
from ray_tpu_torch.serve.weight_rollout import publish_weights
from ray_tpu_torch.train.chaos import AttemptFence


class StalenessViolation(RuntimeError):
    """A consumed rollout batch lagged the learner by more than the
    staleness bound — the overlap machinery let a stale policy's data
    through, which must never happen silently."""


class DuplicateRollout(RuntimeError):
    """A batch id was consumed twice — the exactly-once ledger caught
    a duplicate (e.g. a resume replaying a committed round)."""


class RLHFLoop:
    def __init__(self, generator: RolloutGenerator,
                 learner: RolloutLearner,
                 reward_fn: Callable[[List[int], List[int]], float],
                 prompts_fn: Callable[[int], Sequence[Sequence[int]]],
                 *, rounds: int = 8, staleness_bound: int = 1,
                 overlap: bool = True,
                 ckpt_dir: str, publish_dir: str,
                 control_dir: Optional[str] = None, attempt: int = 1,
                 keep_last_k: Optional[int] = None,
                 learner_delay_s: float = 0.0,
                 generator_mid_round_hook:
                 Optional[Callable[[int], Any]] = None,
                 learner_kill_hook:
                 Optional[Callable[[int], Any]] = None,
                 max_generator_restarts: int = 2):
        self.generator = generator
        self.learner = learner
        self.reward_fn = reward_fn
        self.prompts_fn = prompts_fn
        self.rounds = int(rounds)
        self.staleness_bound = int(staleness_bound)
        self.overlap = bool(overlap)
        self.ckpt_dir = ckpt_dir
        self.publish_dir = publish_dir
        self.attempt = int(attempt)
        self.keep_last_k = keep_last_k
        self.learner_delay_s = float(learner_delay_s)
        self.generator_mid_round_hook = generator_mid_round_hook
        self.learner_kill_hook = learner_kill_hook
        self.max_generator_restarts = int(max_generator_restarts)
        self._fence = (AttemptFence(control_dir, self.attempt)
                       if control_dir else None)

        self._cond = threading.Condition()
        self._pending: Dict[int, Any] = {}
        self._published = None        # (host_params, weights_id, upd)
        self._consumed_round = -1
        self._gen_error = None        # (exc, round)
        self._abort = False
        self._gen_thread: Optional[threading.Thread] = None
        self.generator_restarts = 0

        self.ledger: List[str] = []
        self.reward_curve: List[float] = []
        self.batch_log: List[Dict[str, Any]] = []
        self.timeline: Dict[int, Dict[str, float]] = {}
        self.restore_s = 0.0          # resume: find, load and set state
        self._t0 = 0.0

    # -------------------------------------------------------- internals

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _pre_commit(self, step: int) -> None:
        if self._fence is not None:
            self._fence.check()
        if self.learner_kill_hook is not None:
            self.learner_kill_hook(step)

    def _publish(self, update_idx: int):
        """Durably publish the learner's current params (host copies
        of its state dict); returns ``(host_params, weights_id)``. The
        path carries the attempt so a resumed loop republishing the
        recovered update never collides with the dead attempt's
        directory — the weights_id depends only on the bytes, so the
        recovered payload keeps its identity."""
        host = self.learner.host_params()
        path = os.path.join(self.publish_dir,
                            f"update_{update_idx:05d}_a{self.attempt}")
        _, wid = publish_weights(host, path, step=update_idx,
                                 extra={"update": update_idx})
        return host, wid

    def _sync_generator(self, host, wid: str) -> None:
        cur_gen, cur_wid = self.generator.weights_stamp()
        if cur_wid != wid:
            self.generator.sync_weights(host, weights_id=wid)

    def _tl(self, r: int, **kv: float) -> None:
        self.timeline.setdefault(r, {"round": r}).update(kv)

    # -------------------------------------------------- generator thread

    def _start_generator(self, start_round: int) -> None:
        self._gen_thread = threading.Thread(
            target=self._generator_main, args=(start_round,),
            name="rl-rollout-generator", daemon=True)
        self._gen_thread.start()

    def _generator_main(self, start_round: int) -> None:
        r = start_round
        try:
            while True:
                with self._cond:
                    # Round r samples from weights published after
                    # round r-1-k was consumed => staleness k at
                    # consumption. Allowing r - consumed <= bound + 1
                    # is exactly "lag the learner by <= bound
                    # updates"; bound 0 degenerates to serialized.
                    while (not self._abort and r < self.rounds and
                           r - self._consumed_round >
                           self.staleness_bound + 1):
                        self._cond.wait(0.05)
                    if self._abort or r >= self.rounds:
                        return
                    host, wid, upd = self._published
                # Round boundary: no rollout in flight — the only
                # point a swap cannot mix policies inside a batch.
                t_s0 = self._now()
                self._sync_generator(host, wid)
                t_g0 = self._now()
                batch = self.generator.generate(
                    self.prompts_fn(r), round_idx=r,
                    mid_round_hook=self.generator_mid_round_hook)
                with self._cond:
                    self._pending[r] = (batch, upd)
                    self._tl(r, sync_s=t_g0 - t_s0, gen_start=t_g0,
                             gen_end=self._now())
                    self._cond.notify_all()
                r += 1
        except BaseException as e:  # noqa: BLE001 - handed to run()
            with self._cond:
                self._gen_error = (e, r)
                self._cond.notify_all()

    def _await_batch(self, r: int):
        """Block until round ``r``'s batch lands; restart a killed
        generator (bounded) at exactly the unconsumed round —
        deterministic batch ids make the regeneration invisible to the
        ledger except as the single expected consumption."""
        while True:
            with self._cond:
                while r not in self._pending and self._gen_error is None:
                    self._cond.wait(0.1)
                if r in self._pending:
                    return self._pending.pop(r)
                exc, err_round = self._gen_error
                self._gen_error = None
            if (not isinstance(exc, GeneratorKilled) or
                    self.generator_restarts >=
                    self.max_generator_restarts):
                raise exc
            self.generator_restarts += 1
            self._start_generator(err_round)

    # ------------------------------------------------------ main thread

    def _consume(self, r: int, batch, synced_update: int) -> None:
        if batch.batch_id in self.ledger:
            raise DuplicateRollout(
                f"batch {batch.batch_id} already consumed")
        staleness = self.learner.update_count - synced_update
        if staleness > self.staleness_bound:
            raise StalenessViolation(
                f"round {r}: batch generated {staleness} updates "
                f"behind the learner (bound {self.staleness_bound})")
        rewards = [self.reward_fn(p, c)
                   for p, c in zip(batch.prompts, batch.completions)]
        batch.rewards = rewards
        t_l0 = self._now()
        stats = self.learner.update(batch)
        if self.learner_delay_s:
            time.sleep(self.learner_delay_s)
        self.ledger.append(batch.batch_id)
        self.reward_curve.append(stats["reward_mean"])
        self.batch_log.append({
            "batch_id": batch.batch_id, "round": r,
            "weights_id": batch.weights_id,
            "generation": batch.generation,
            "staleness": staleness,
            "reward_mean": stats["reward_mean"],
            "num_tokens": batch.num_tokens(),
        })
        self._tl(r, learn_start=t_l0, learn_end=self._now())

    def _checkpoint(self, mgr: CheckpointManager, r: int,
                    wid: str) -> None:
        mgr.save({
            "learner": self.learner.get_state(),
            "round": r,
            "ledger": list(self.ledger),
            "reward_curve": list(self.reward_curve),
            "batch_log": list(self.batch_log),
            "weights_id": wid,
        }, step=r)

    def run(self) -> Dict[str, Any]:
        mgr = CheckpointManager(self.ckpt_dir,
                                keep_last_k=self.keep_last_k,
                                pre_commit_hook=self._pre_commit)
        start_round = 0
        resumed = False
        recovered_wid = None
        try:
            with contextlib.ExitStack() as stack:
                if self._fence is not None:
                    stack.enter_context(self._fence)
                t_r0 = time.monotonic()
                ckpt = mgr.latest_complete()
                if ckpt is not None:
                    st = ckpt.to_dict()
                    self.learner.set_state(st["learner"])
                    self.ledger = list(st["ledger"])
                    self.reward_curve = list(st["reward_curve"])
                    self.batch_log = list(st["batch_log"])
                    start_round = int(st["round"]) + 1
                    recovered_wid = st["weights_id"]
                    resumed = True
                    self.restore_s = time.monotonic() - t_r0
                self._consumed_round = start_round - 1
                self._t0 = time.monotonic()

                # Publish the starting payload (update 0 or the
                # recovered one); the generator syncs to it before its
                # first round. Same bytes => same weights_id, so a
                # resume provably lands back on the recovered payload.
                host, wid = self._publish(self.learner.update_count)
                self._published = (host, wid, self.learner.update_count)
                resync_wid = wid

                if self.overlap:
                    self._start_generator(start_round)
                for r in range(start_round, self.rounds):
                    if self._fence is not None:
                        self._fence.check()
                    if self.overlap:
                        batch, upd = self._await_batch(r)
                    else:
                        host, wid, upd = self._published
                        t_s0 = self._now()
                        self._sync_generator(host, wid)
                        t_g0 = self._now()
                        batch = self.generator.generate(
                            self.prompts_fn(r), round_idx=r,
                            mid_round_hook=(
                                self.generator_mid_round_hook))
                        self._tl(r, sync_s=t_g0 - t_s0, gen_start=t_g0,
                                 gen_end=self._now())
                    self._consume(r, batch, upd)
                    t_p0 = self._now()
                    host, wid = self._publish(self.learner.update_count)
                    t_c0 = self._now()
                    self._checkpoint(mgr, r, wid)
                    self._tl(r, publish_s=t_c0 - t_p0,
                             commit_s=self._now() - t_c0)
                    with self._cond:
                        self._published = (host, wid,
                                           self.learner.update_count)
                        self._consumed_round = r
                        self._cond.notify_all()
                wall = self._now()
        finally:
            with self._cond:
                self._abort = True
                self._cond.notify_all()
            t = self._gen_thread
            if t is not None:
                t.join(timeout=30)
            mgr.close()
        return self._stats(start_round, resumed, recovered_wid,
                           resync_wid, wall)

    # ------------------------------------------------------------ stats

    def _stats(self, start_round: int, resumed: bool,
               recovered_wid: Optional[str], resync_wid: str,
               wall: float) -> Dict[str, Any]:
        tl = [self.timeline[r] for r in sorted(self.timeline)]
        gen_busy = sum(e.get("gen_end", 0.0) - e.get("gen_start", 0.0)
                       for e in tl if "gen_start" in e)
        overlap_observed = any(
            "gen_start" in b and "learn_end" in a and
            b["gen_start"] < a["learn_end"]
            for a, b in zip(tl, tl[1:]))
        return {
            "mode": "overlap" if self.overlap else "serialized",
            "rounds": self.rounds,
            "start_round": start_round,
            "resumed": resumed,
            "recovered_weights_id": recovered_wid,
            "resync_weights_id": resync_wid,
            "restore_s": self.restore_s,
            "reward_curve": list(self.reward_curve),
            "ledger": list(self.ledger),
            "batch_log": list(self.batch_log),
            "staleness_bound": self.staleness_bound,
            "max_staleness": max(
                (b["staleness"] for b in self.batch_log), default=0),
            "generator_restarts": self.generator_restarts,
            "wall_s": wall,
            "gen_busy_s": gen_busy,
            "generator_utilization": gen_busy / max(wall, 1e-9),
            "overlap_observed": overlap_observed,
            "timeline": tl,
            "final_weights_id": self.generator.weights_stamp()[1],
        }
