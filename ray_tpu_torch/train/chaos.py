"""Port of ``ray_tpu/train/chaos.py``: the GENERATION-file attempt fence
only (``GEN_FILE``, ``StaleGeneration``, ``generation``, ``fence``,
``check_generation``, ``AttemptFence``), which the RLHF loop
(``ray_tpu_torch.rl.loop``) uses to keep a superseded attempt from
committing.

The file holds the newest STARTED attempt id (a monotonic token the
caller assigns). Every loop fences its own attempt at start, and any
loop whose attempt is older than the file's raises ``StaleGeneration``
— per round and from its ``CheckpointManager`` pre-commit hook, so a
zombie can never commit a checkpoint. The chaos schedule, the injector
and the trainer-side gates of the reference module drive the elastic
trainer and come with it (ROADMAP.md, queue 1, item 11).
"""
from __future__ import annotations

import os
import uuid

GEN_FILE = "GENERATION"


class StaleGeneration(RuntimeError):
    """Raised by a superseded loop (a newer attempt owns the run)."""


def generation(control_dir: str) -> int:
    """The newest attempt id known to have started (0 when none)."""
    try:
        with open(os.path.join(control_dir, GEN_FILE)) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def fence(control_dir: str, attempt: int) -> int:
    """Record that ``attempt`` has started: advance the generation
    file to it (monotonic — an older writer can never move it back).
    Returns the resulting generation."""
    path = os.path.join(control_dir, GEN_FILE)
    cur = generation(control_dir)
    if attempt <= cur:
        return cur
    tmp = f"{path}.tmp-{uuid.uuid4().hex}"
    with open(tmp, "w") as f:
        f.write(str(attempt))
    os.replace(tmp, path)
    return attempt


def check_generation(control_dir: str, attempt: int) -> None:
    """Raise ``StaleGeneration`` when a newer attempt has started: this
    loop was superseded and must stop itself. Called every round AND
    from the CheckpointManager pre-commit hook (a zombie may not
    commit, ever)."""
    if control_dir and generation(control_dir) > attempt:
        raise StaleGeneration(
            f"gang attempt {attempt} superseded by attempt "
            f"{generation(control_dir)}")


class AttemptFence:
    """Context-manager packaging of the GENERATION-file fence for loops
    outside the trainer (the RLHF loop in ``ray_tpu_torch.rl``):
    entering records this attempt as started (``fence``); ``check()``
    is the per-round / pre-commit gate and raises ``StaleGeneration``
    once a newer attempt has fenced."""

    def __init__(self, control_dir: str, attempt: int):
        self.control_dir = control_dir
        self.attempt = attempt

    def __enter__(self) -> "AttemptFence":
        os.makedirs(self.control_dir, exist_ok=True)
        fence(self.control_dir, self.attempt)
        return self

    def check(self) -> None:
        check_generation(self.control_dir, self.attempt)

    def __exit__(self, *exc) -> bool:
        return False
