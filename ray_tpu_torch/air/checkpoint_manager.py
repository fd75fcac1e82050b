"""Port of ``ray_tpu/air/checkpoint_manager.py``: durable, asynchronous,
self-pruning checkpoints over :mod:`ray_tpu_torch.air.checkpoint`'s
atomic commit.

- ``save_async(data, step)`` snapshots the payload ON THE CALLING
  THREAD and hands serialization + fsync + atomic rename to one
  background writer thread, so a train step overlapping a save never
  blocks on checkpoint I/O and the committed bytes are exactly the
  values at the step the save was requested. Unlike JAX arrays, torch
  tensors are updated in place (an optimizer's ``step()``), so the
  snapshot copies EVERY tensor leaf — parameters and an optimizer's
  ``state_dict()`` tensors alike: a leaf on the card with one
  device-to-host copy into pinned memory, all of them synchronized
  before ``save_async`` returns; a host leaf with a clone. Numpy leaves
  are copied too, and every other leaf with them (the structure goes
  through ``pickle``).
- commits land as ``step_<N>`` directories via write-to-temp + manifest
  + atomic rename; a crash at any instant leaves only ``.tmp-*`` litter
  that no resolver reads.
- keep-last-K retention prunes older COMMITTED checkpoints after each
  successful commit (torn or alien directories are never counted
  against the budget and never deleted — they are evidence).
- ``latest_complete()`` scans newest-first and returns the first
  directory that passes a deep manifest verification, skipping torn or
  corrupted ones — the resume resolver.
"""
from __future__ import annotations

import logging
import os
import queue
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.air.checkpoint import (Checkpoint, join_tensors,
                                          split_tensors,
                                          verify_checkpoint_dir)

logger = logging.getLogger(__name__)

_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")


def step_dir_name(step: int) -> str:
    return f"step_{step:08d}"


def _snapshot(data: Dict[str, Any]) -> Dict[str, Any]:
    """A host copy of the payload that later in-place updates by the
    train loop cannot reach: every tensor leaf copied (card leaves into
    pinned host memory, one copy each, synchronized here), everything
    else through a pickle round trip."""
    meta, tensors = split_tensors(data)
    copies, devices = [], set()
    for t in tensors:
        t = t.detach()
        if t.is_cuda:
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
            devices.add(t.device)
        else:
            dst = t.clone()
        copies.append(dst)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return join_tensors(meta, copies)


class SaveHandle:
    """Tracks one async save. ``wait()`` blocks until the commit (or
    failure) of THIS save; ``committed`` / ``error`` afterwards."""

    def __init__(self, step: int):
        self.step = step
        self.committed = False
        self.error: Optional[BaseException] = None
        self.path: Optional[str] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class CheckpointManager:
    """One training run's checkpoint directory tree.

    ``keep_last_k=None`` keeps everything. ``pre_commit_hook`` is a test
    seam called on the writer thread after staging but before the
    atomic rename becomes observable — chaos tests use it to hold a
    save in flight or simulate a crash-before-commit.
    """

    def __init__(self, root_dir: str, keep_last_k: Optional[int] = None,
                 pre_commit_hook: Optional[Callable[[int], None]] = None):
        if keep_last_k is not None and keep_last_k < 1:
            raise ValueError("keep_last_k must be >= 1 or None")
        self.root = os.path.abspath(root_dir)
        os.makedirs(self.root, exist_ok=True)
        self.keep_last_k = keep_last_k
        self._pre_commit_hook = pre_commit_hook
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._inflight = 0
        self._idle = threading.Event()
        self._idle.set()
        self._last_error: Optional[BaseException] = None
        self._closed = False
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="ckpt-writer", daemon=True)
        self._writer.start()

    # ------------------------------------------------------------- saves

    def save_async(self, data: Dict[str, Any], step: int) -> SaveHandle:
        """Snapshot ``data`` now; commit ``step_<step>`` in the
        background. Never blocks on disk."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        handle = SaveHandle(step)
        snap = _snapshot(data)
        with self._lock:
            self._inflight += 1
            self._idle.clear()
        self._q.put((snap, step, handle))
        return handle

    def save(self, data: Dict[str, Any], step: int) -> SaveHandle:
        """Synchronous convenience: save_async + wait, raising on
        failure."""
        handle = self.save_async(data, step)
        handle.wait()
        if handle.error is not None:
            raise handle.error
        return handle

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every save enqueued so far has committed or
        failed. Raises the first writer error, if any."""
        if not self._idle.wait(timeout):
            raise TimeoutError(
                f"checkpoint writer still busy after {timeout}s")
        with self._lock:
            err, self._last_error = self._last_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Flush pending saves and stop the writer thread."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._writer.join(timeout=60)

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            snap, step, handle = item
            try:
                path = os.path.join(self.root, step_dir_name(step))
                if self._pre_commit_hook is not None:
                    self._pre_commit_hook(step)
                handle.path = Checkpoint.from_dict(snap).to_directory(
                    path, step=step)
                handle.committed = True
                self._retain()
            except BaseException as e:  # noqa: BLE001
                handle.error = e
                with self._lock:
                    if self._last_error is None:
                        self._last_error = e
                logger.warning("async checkpoint save (step %d) failed: "
                               "%s", step, e)
            finally:
                del snap, item       # the snapshot's host buffers go now
                handle._done.set()
                with self._lock:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.set()

    # ---------------------------------------------------------- resolve

    def _scan(self) -> List[Tuple[int, str]]:
        """(step, path) of every ``step_*`` directory, ascending by
        step. Staging litter (``.tmp-*``) is invisible by name."""
        out = []
        try:
            entries = os.listdir(self.root)
        except OSError:
            return out
        for name in entries:
            m = _STEP_DIR_RE.match(name)
            full = os.path.join(self.root, name)
            if m and os.path.isdir(full):
                out.append((int(m.group(1)), full))
        out.sort()
        return out

    def steps(self, complete_only: bool = True) -> List[int]:
        """Committed checkpoint steps, ascending. With
        ``complete_only`` each candidate is (shallow-)verified."""
        out = []
        for step, path in self._scan():
            if not complete_only or verify_checkpoint_dir(path)[0]:
                out.append(step)
        return out

    def latest_complete(self) -> Optional[Checkpoint]:
        """Newest checkpoint that passes DEEP verification (every file
        present, sized, and hash-matching its manifest). Torn or
        corrupted directories are skipped with a warning — resume must
        never load them — and the next-older complete one wins."""
        for step, path in reversed(self._scan()):
            ok, reason, _manifest = verify_checkpoint_dir(path, deep=True)
            if ok:
                return Checkpoint.from_directory(path)
            logger.warning("skipping torn checkpoint %s: %s", path,
                           reason)
        return None

    def latest_step(self) -> Optional[int]:
        """Step of :meth:`latest_complete`'s winner (manifest-recorded),
        None when no complete checkpoint exists."""
        for step, path in reversed(self._scan()):
            ok, _reason, manifest = verify_checkpoint_dir(path, deep=True)
            if ok:
                mstep = manifest.get("step")
                return mstep if isinstance(mstep, int) else step
        return None

    # --------------------------------------------------------- retention

    def _retain(self) -> None:
        if self.keep_last_k is None:
            return
        # Deep verification before deletion: a torn directory can pass
        # the shallow (size-only) check, and pruning one would destroy
        # the evidence of the corruption it records.
        complete = [(s, p) for s, p in self._scan()
                    if verify_checkpoint_dir(p, deep=True)[0]]
        for _step, path in complete[:-self.keep_last_k]:
            shutil.rmtree(path, ignore_errors=True)
