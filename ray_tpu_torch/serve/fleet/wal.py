"""Port of ``ray_tpu/serve/fleet/wal.py``: crash-durable directory state,
a write-ahead log and a snapshot.

The directory's membership table is tiny but load-bearing: the
fencing-token high-water mark and the tombstones must NEVER regress,
even across a crash. This module gives the directory the checkpoint
store's torn-file discipline (air/checkpoint.py) at control-plane
scale:

- **WAL** (``wal.log``): one mutation per line, each line led by a
  16-hex sha256 prefix over its own payload. An append is flushed and
  fsynced before the mutating RPC answers, so an acknowledged register,
  tombstone or promotion survives SIGKILL. Recovery scans the log front
  to back; the FIRST record that fails its checksum (or decodes dirty,
  or lost its newline) marks the torn tail, and everything from that
  byte on is TRUNCATED in place, never replayed: a torn record is a
  write the directory never acknowledged.
- **Snapshot** (``snapshot.json``): periodic compaction. The payload is
  staged to a ``.tmp-`` file (checksum line first, payload after),
  fsynced and renamed over the old snapshot; only then is the WAL
  truncated. A crash between the two replays records already IN the
  snapshot, which is harmless: every record type is idempotent under
  replay (member upserts, tombstone maxima, fence-counter maxima).

The on-disk format is the reference's byte for byte, so either package
recovers the other's data directory. Recovery is the snapshot (if its
checksum verifies) plus the surviving WAL suffix. Leases do not
survive: they are stamped on the directory's monotonic clock, which
dies with the process, so the directory re-arms every recovered member
with a fresh full TTL.

``_fsync_dir`` is this module's own copy of ``air/checkpoint.py``'s,
so that the directory process, which loads this module, does not
import ``torch``.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


WAL_NAME = "wal.log"
SNAPSHOT_NAME = "snapshot.json"
_TMP_PREFIX = ".tmp-"


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()[:16]


def _encode(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, separators=(",", ":"),
                      sort_keys=True).encode("utf-8")


class DirectoryWAL:
    """Append-only mutation log and checksummed snapshot of one
    directory's durable state. Thread-safe: the directory appends under
    its own lock, but recovery tooling may share an instance."""

    def __init__(self, data_dir: str, snapshot_every: int = 64):
        self.data_dir = data_dir
        self.snapshot_every = int(snapshot_every)
        os.makedirs(data_dir, exist_ok=True)
        self.wal_path = os.path.join(data_dir, WAL_NAME)
        self.snapshot_path = os.path.join(data_dir, SNAPSHOT_NAME)
        self._lock = threading.Lock()
        self._appends_since_snapshot = 0
        self.stats = {"appends": 0, "snapshots": 0,
                      "torn_records_truncated": 0,
                      "snapshot_checksum_rejects": 0}
        self._fh = None

    # ------------------------------------------------------------ write

    def _close_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None

    def append(self, record: Dict[str, Any]) -> bool:
        """Durably append one mutation record. True when the caller
        should compact (``snapshot_every`` appends since the last
        snapshot)."""
        payload = _encode(record)
        line = _digest(payload).encode("ascii") + b" " + payload + b"\n"
        with self._lock:
            if self._fh is None:
                self._fh = open(self.wal_path, "ab")
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.stats["appends"] += 1
            self._appends_since_snapshot += 1
            return self._appends_since_snapshot >= self.snapshot_every

    def snapshot(self, payload: Dict[str, Any]) -> None:
        """Atomically replace the snapshot with ``payload``, then
        truncate the WAL (in that order: a crash between the two replays
        records the snapshot already holds)."""
        body = _encode(payload)
        head = _digest(body).encode("ascii") + b"\n"
        with self._lock:
            stage = os.path.join(self.data_dir, _TMP_PREFIX + SNAPSHOT_NAME)
            with open(stage, "wb") as fh:
                fh.write(head + body)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(stage, self.snapshot_path)
            _fsync_dir(self.data_dir)
            self._close_locked()
            with open(self.wal_path, "wb") as fh:
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_dir(self.data_dir)
            self._appends_since_snapshot = 0
            self.stats["snapshots"] += 1

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    # ------------------------------------------------------------- read

    def load(self) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """``(snapshot payload or None, WAL records)``. A torn WAL tail
        is truncated in place; a snapshot that fails its checksum is
        ignored whole (the directory then falls back to the agents'
        re-registration: safe, just slower)."""
        return self._load_snapshot(), self._load_wal()

    def _load_snapshot(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.snapshot_path):
            return None
        with open(self.snapshot_path, "rb") as fh:
            head = fh.readline().strip()
            body = fh.read()
        try:
            if head.decode("ascii") != _digest(body):
                raise ValueError("checksum mismatch")
            return json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self.stats["snapshot_checksum_rejects"] += 1
            return None

    def _load_wal(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.wal_path):
            return []
        with open(self.wal_path, "rb") as fh:
            data = fh.read()
        records: List[Dict[str, Any]] = []
        good_end = offset = torn = 0
        while offset < len(data):
            nl = data.find(b"\n", offset)
            if nl < 0:
                torn += 1            # no newline: the write died mid-record
                break
            rec = _parse_line(data[offset:nl])
            if rec is None:
                # this record was never acknowledged: truncate here; the
                # records after it rode a corrupted region too
                torn += 1 + data.count(b"\n", nl + 1)
                break
            records.append(rec)
            good_end = offset = nl + 1
        if torn:
            self.stats["torn_records_truncated"] += torn
            with self._lock:
                self._close_locked()
                with open(self.wal_path, "r+b") as fh:
                    fh.truncate(good_end)
                    fh.flush()
                    os.fsync(fh.fileno())
        return records


def _parse_line(line: bytes) -> Optional[Dict[str, Any]]:
    """One WAL line without its newline: the record, or None when its
    shape or checksum is bad."""
    parts = line.split(b" ", 1)
    if len(parts) != 2:
        return None
    head, payload = parts
    try:
        if head.decode("ascii") != _digest(payload):
            return None
        rec = json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def inject_torn_tail(data_dir: str,
                     garbage: bytes = b'f00dfeedcafe4bad {"op":"mem') -> None:
    """Test and chaos hook: append a partial (torn) record to the WAL,
    as a crash mid-write leaves it. Recovery must truncate it."""
    with open(os.path.join(data_dir, WAL_NAME), "ab") as fh:
        fh.write(garbage)
        fh.flush()
        os.fsync(fh.fileno())


def wal_record_count(data_dir: str) -> int:
    """The intact records in the WAL now (a diagnostic)."""
    path = os.path.join(data_dir, WAL_NAME)
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as fh:
        return sum(1 for line in fh if line.endswith(b"\n")
                   and _parse_line(line[:-1]) is not None)
