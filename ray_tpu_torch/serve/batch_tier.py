"""Port of ``ray_tpu/serve/batch_tier.py``: the offline
batch-inference tier, streaming jobs over the online serving engines on
the BATCH priority lane.

A ``BatchInferenceJob`` drives a source of rows through the SAME
engines that serve online traffic (one ``LLMEngine`` or one
``EnginePool``), as ``priority=LANE_BATCH`` requests. The source is a
plain iterable; the reference's ``Dataset`` and ``DatasetPipeline``
sources wait for the port's data layer (ROADMAP.md, queue 1, item 13).

The lane contract (scheduler.py / engine.py / engine_pool.py) is what
makes colocation safe:

- a batch request admits only when no online request is waiting
  (per-lane FIFO, online lane always first);
- a batch slot is the FIRST preemption victim and re-admits
  token-identically (recompute or prefix-cache resume);
- batch backlog is bounded by ``max_queued_batch`` and reported in its
  own ``queue_depth_batch`` lane, so routing saturation and the
  autoscaler never react to preemptible work;
- pool routing for the lane is pure spill — least batch backlog,
  never touching the sticky/affinity placement online traffic owns.

Progress is checkpointed with the air.checkpoint sha256-manifest
discipline (stage -> fsync -> manifest -> atomic rename): the driver
periodically commits a manifest of completed rows keyed by GLOBAL ROW
INDEX, so a job killed at any instant resumes exactly-once — a
completed-but-uncommitted row is recomputed (keyed overwrite, never a
duplicate), and a torn checkpoint directory is refused loudly by
``Checkpoint.from_directory`` rather than resumed wrong.

Knob preset: ``engine_kwargs_for_profile("throughput")`` maps the
scheduler's throughput profile onto ``LLMEngine`` constructor knobs —
deep no-TTFT-SLO queues, large prefill chunks, long decode run-ahead.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.serve.errors import DeadlineExceeded, RequestCancelled
from ray_tpu_torch.serve.scheduler import LANE_BATCH, scheduler_profile


def engine_kwargs_for_profile(name: str) -> Dict[str, Any]:
    """Map a named scheduler profile ('latency' | 'throughput') onto
    ``LLMEngine`` constructor kwargs. The profile dict is pure data
    in the planner module (import-guarded); this is the layer that
    knows which engine knob each key lands on."""
    p = scheduler_profile(name)
    return {
        "chunk": p["decode_chunk"],
        "prefill_chunk": p["prefill_chunk"],
        "max_run_ahead": p["max_run_ahead"],
        "max_queued": p["max_queued"],
    }


class BatchRowError(RuntimeError):
    """A row exhausted its retry budget; carries the row index and
    the last underlying failure."""

    def __init__(self, index: int, cause: BaseException):
        super().__init__(
            f"batch row {index} failed after retries: {cause!r}")
        self.index = index
        self.cause = cause


class BatchInferenceJob:
    """Streaming batch-generation driver over one engine or pool.

    Parameters
    ----------
    target: anything with the engine ``submit`` surface
        (``LLMEngine`` or ``EnginePool``) — requests go in with
        ``priority=LANE_BATCH``. The target must be started/serving;
        the job never owns its lifecycle.
    source: the rows to generate for — a plain iterable of prompts
        (token-id lists; ``Dataset`` and ``DatasetPipeline`` sources
        wait for the data layer, ROADMAP.md queue 1 item 13).
        Iteration order MUST be deterministic across runs —
        row identity for exactly-once resume is the global iteration
        index.
    prompt_fn: row -> token-id list (default: the row IS the prompt).
    max_new_tokens: per-row generation budget.
    max_in_flight: the driver's concurrency window — how many rows
        are submitted but unharvested at once. This, not the engine
        queue bound, is the batch tier's depth knob (the throughput
        profile leaves ``max_queued_batch`` unbounded on purpose).
    checkpoint_dir: progress-manifest directory. None disables
        checkpointing (and resume).
    checkpoint_every: commit a manifest every N newly completed rows
        (and always once more at the end).
    max_row_retries: bounded per-row resubmits after engine faults.
        Cancels and deadline expiries are the caller's intent and
        never retried.
    pipeline_stats: pre-computed per-stage stats to embed in every
        manifest.
    """

    def __init__(self, target, source, *,
                 prompt_fn: Optional[Callable[[Any], List[int]]] = None,
                 max_new_tokens: int = 64,
                 max_in_flight: int = 64,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 64,
                 max_row_retries: int = 2,
                 job_id: str = "batch-job",
                 pipeline_stats: Optional[List[Dict[str, Any]]] = None):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self._target = target
        self._source = source
        self._prompt_fn = prompt_fn or (lambda row: row)
        self._mnt = int(max_new_tokens)
        self._window = int(max_in_flight)
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = int(checkpoint_every)
        self._max_row_retries = max(0, int(max_row_retries))
        self._job_id = job_id
        self._pipeline_stats: List[Dict[str, Any]] = list(
            pipeline_stats or [])
        # global row index -> generated token ids (the exactly-once
        # ledger: keyed overwrite makes recomputing an uncommitted
        # row idempotent)
        self._completed: Dict[int, List[int]] = {}
        self._resumed_rows = 0
        self.stats: Dict[str, Any] = {
            "rows_completed": 0, "rows_resumed": 0,
            "rows_retried": 0, "checkpoints_written": 0,
            "batch_tokens": 0,
        }

    # ----------------------------------------------------------- source

    # ----------------------------------------------------- checkpointing

    def _load_checkpoint(self) -> None:
        if self._ckpt_dir is None:
            return
        if not os.path.isdir(self._ckpt_dir) \
                or not os.listdir(self._ckpt_dir):
            # absent or empty: a fresh start, not torn state — the
            # manifest commit is a staged atomic rename, so a torn
            # commit never leaves the directory empty
            return
        # refuses torn state (InvalidCheckpointError) — resuming a
        # half-written ledger silently would break exactly-once
        data = Checkpoint.from_directory(self._ckpt_dir).to_dict()
        if data.get("job_id") != self._job_id:
            raise ValueError(
                f"checkpoint at {self._ckpt_dir} belongs to job "
                f"{data.get('job_id')!r}, not {self._job_id!r}")
        self._completed = {int(k): list(v)
                           for k, v in data.get("completed",
                                                {}).items()}
        self._resumed_rows = len(self._completed)
        self.stats["rows_resumed"] = self._resumed_rows

    def _write_checkpoint(self) -> None:
        if self._ckpt_dir is None:
            return
        Checkpoint.from_dict({
            "job_id": self._job_id,
            "completed": dict(self._completed),
            "pipeline_stats": list(self._pipeline_stats),
            "stats": dict(self.stats),
        }).to_directory(self._ckpt_dir,
                        step=len(self._completed))
        self.stats["checkpoints_written"] += 1

    # ------------------------------------------------------------ driving

    def _submit(self, prompt: List[int]):
        return self._target.submit(prompt, max_new_tokens=self._mnt,
                                   priority=LANE_BATCH)

    def run(self) -> List[List[int]]:
        """Drive the job to completion; returns the generated token
        ids for every row, in row order. Resumes from the checkpoint
        directory when one exists: committed rows are skipped
        outright (their results load from the manifest), uncommitted
        ones recompute — 0 duplicate / 0 missing rows by keyed-index
        construction."""
        self._load_checkpoint()
        # (index, prompt, retries_left, handle) — harvested oldest-
        # first. Head-of-line harvest order costs nothing: every
        # in-flight row is progressing concurrently inside the
        # engine regardless of the order results are collected.
        in_flight: deque = deque()
        since_ckpt = 0
        rows = iter(self._source)
        n_total = 0
        exhausted = False
        while True:
            while not exhausted and len(in_flight) < self._window:
                try:
                    row = next(rows)
                except StopIteration:
                    exhausted = True
                    break
                idx = n_total
                n_total += 1
                if idx in self._completed:
                    continue       # resumed: committed in a prior run
                prompt = [int(t) for t in self._prompt_fn(row)]
                in_flight.append((idx, prompt,
                                  self._max_row_retries,
                                  self._submit(prompt)))
            if not in_flight:
                if exhausted:
                    break
                continue
            idx, prompt, retries, handle = in_flight.popleft()
            try:
                toks = handle.result()
            except (RequestCancelled, DeadlineExceeded):
                raise                # caller intent: never retried
            except Exception as e:   # shutdown/drain/fault: bounded
                                     # resubmit, same row index
                if retries <= 0:
                    raise BatchRowError(idx, e) from e
                self.stats["rows_retried"] += 1
                in_flight.append((idx, prompt, retries - 1,
                                  self._submit(prompt)))
                continue
            self._completed[idx] = list(toks)
            self.stats["rows_completed"] += 1
            self.stats["batch_tokens"] += len(toks)
            since_ckpt += 1
            if since_ckpt >= self._ckpt_every:
                self._write_checkpoint()
                since_ckpt = 0
        if since_ckpt or (self._ckpt_dir is not None
                          and not self.stats["checkpoints_written"]):
            self._write_checkpoint()
        missing = [i for i in range(n_total)
                   if i not in self._completed]
        if missing:
            raise RuntimeError(
                f"batch job finished with missing rows {missing[:8]}"
                f" (of {n_total}) — exactly-once ledger violated")
        return [self._completed[i] for i in range(n_total)]

    # ---------------------------------------------------------- reporting

    def progress(self) -> Dict[str, Any]:
        """Point-in-time progress summary (the manifest's stats block
        plus the ledger size)."""
        return {"job_id": self._job_id,
                "rows_in_ledger": len(self._completed),
                "pipeline_stats": list(self._pipeline_stats),
                **self.stats}


def run_batch_job(target, source, **kwargs) -> List[List[int]]:
    """One-call convenience: build and run a ``BatchInferenceJob``."""
    return BatchInferenceJob(target, source, **kwargs).run()
