"""Port of ``ray_tpu/air/checkpoint.py``: the durable checkpoint
directory (dict <-> directory), its content manifest and its typed
refusal of torn state.

Durability contract, the reference's: a checkpoint directory is NEVER
observable half-written. ``to_directory`` stages the whole payload in a
sibling ``.tmp-*`` directory, fsyncs every file, writes the content
manifest (``format`` 1, ``step``, ``wall_time``, and each file's sha256
and byte count) LAST, and commits with one atomic rename. A reader sees
either nothing or a complete, self-describing checkpoint; anything else
(a crash mid-write, a torn copy) leaves only ``.tmp-*`` litter that no
resolver reads, and ``from_directory`` refuses a directory without a
valid manifest with :class:`InvalidCheckpointError`, with the
reference's reason strings.

The array store is the port's own (the reference's is orbax, which the
port does not have): every ``torch.Tensor`` leaf, wherever it sits in
the dict, goes into ``arrays/tensors.pt`` with ``torch.save`` (written
even when the payload holds none) and comes
back through ``torch.load(weights_only=True, map_location="cpu")``;
everything else — numpy arrays, scalars, strings, the structure itself
with its keys — goes into ``meta.pkl`` with ``pickle``, the tensors
standing in it as persistent ids. Round trips are exact: a numpy leaf
comes back as numpy, a tensor as a CPU tensor, each with its dtype,
shape and bytes; any key survives.

Deliberate difference (ROADMAP.md, queue 3): re-committing over an
existing directory is one atomic exchange (``renameat2`` with
``RENAME_EXCHANGE``, through ctypes) where the reference renames the
old directory away and then the new one in, leaving a window in which
the path does not exist. Readers resolve the path to one directory
(one directory fd) for a whole verification or load, and resolve again
only if a concurrent commit displaced that directory under them. Where
the exchange is not supported, the reference's two renames remain.

The reference's ``restore_sharded`` waits for the port's mesh
(ROADMAP.md, queue 1, item 12).
"""
from __future__ import annotations

import contextlib
import ctypes
import errno
import functools
import hashlib
import io
import json
import os
import pickle
import shutil
import stat
import tempfile
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

_ARRAY_SUBDIR = "arrays"
_TENSOR_FILE = os.path.join(_ARRAY_SUBDIR, "tensors.pt")
_META_FILE = "meta.pkl"
MANIFEST_FILE = "manifest.json"
MANIFEST_FORMAT = 1
_TMP_PREFIX = ".tmp-"
_HASH_CHUNK = 16 << 20           # bytes per read when hashing
_RESOLVE_ATTEMPTS = 8            # re-resolutions after a concurrent commit


class InvalidCheckpointError(RuntimeError):
    """The directory is not a complete committed checkpoint: missing,
    unparseable, or inconsistent manifest, or files that disagree with
    it (torn write / partial copy / bit rot)."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"invalid checkpoint at {path}: {reason}")


# ------------------------------------------------------------ the store


class _Pickler(pickle.Pickler):
    """Pickles the payload's structure; each tensor leaf becomes a
    persistent id (its index in ``tensors``), the same tensor object one
    id however often it appears."""

    def __init__(self, f, tensors: List[torch.Tensor]):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.tensors = tensors
        self._ids: Dict[int, int] = {}

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            key = id(obj)
            if key not in self._ids:
                self._ids[key] = len(self.tensors)
                self.tensors.append(obj)
            return ("tensor", self._ids[key])
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, tensors: List[torch.Tensor]):
        super().__init__(f)
        self.tensors = tensors

    def persistent_load(self, pid):
        kind, idx = pid
        if kind != "tensor":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        return self.tensors[idx]


def split_tensors(data: Any) -> Tuple[bytes, List[torch.Tensor]]:
    """(pickled structure with tensors as persistent ids, the tensors)."""
    tensors: List[torch.Tensor] = []
    buf = io.BytesIO()
    _Pickler(buf, tensors).dump(data)
    return buf.getvalue(), tensors


def join_tensors(meta: bytes, tensors: List[torch.Tensor]) -> Any:
    """The inverse of :func:`split_tensors`."""
    return _Unpickler(io.BytesIO(meta), tensors).load()


# ------------------------------------------------------------ the files


def _sha256_fileobj(f) -> str:
    h = hashlib.sha256()
    for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
        h.update(chunk)
    return h.hexdigest()


def _sha256(path: str, dir_fd: Optional[int] = None) -> str:
    with open(path, "rb", opener=_opener(dir_fd)) as f:
        return _sha256_fileobj(f)


def _opener(dir_fd: Optional[int]):
    """``open(..., opener=)`` resolving names relative to ``dir_fd``."""
    if dir_fd is None:
        return None
    return lambda name, flags: os.open(name, flags, dir_fd=dir_fd)


def _payload_files(root: str) -> List[str]:
    """Every regular file under ``root`` except the manifest itself,
    as sorted relative paths."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root)
            if rel != MANIFEST_FILE:
                out.append(rel)
    return sorted(out)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_manifest(root: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Hash every payload file under ``root`` and write the manifest
    (fsynced). The manifest is written LAST so its presence implies the
    payload preceded it onto disk."""
    files = {}
    for rel in _payload_files(root):
        full = os.path.join(root, rel)
        files[rel] = {"sha256": _sha256(full),
                      "bytes": os.path.getsize(full)}
        _fsync_file(full)
    manifest = {"format": MANIFEST_FORMAT, "step": step,
                "wall_time": time.time(), "files": files}
    mpath = os.path.join(root, MANIFEST_FILE)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(root)
    return manifest


@contextlib.contextmanager
def _resolved(path: str) -> Iterator[int]:
    """A directory fd for ``path``: every read through it sees one
    directory, whatever a concurrent commit renames meanwhile."""
    fd = os.open(path, os.O_RDONLY | os.O_DIRECTORY)
    try:
        yield fd
    finally:
        os.close(fd)


def _displaced(path: str, fd: int) -> bool:
    """Did a commit replace the directory ``fd`` resolved at ``path``?"""
    try:
        st = os.stat(path)
    except OSError:
        return True
    here = os.fstat(fd)
    return (st.st_dev, st.st_ino) != (here.st_dev, here.st_ino)


def _load_manifest_at(path: str, dir_fd: Optional[int]) -> Dict[str, Any]:
    try:
        with open(MANIFEST_FILE if dir_fd is not None
                  else os.path.join(path, MANIFEST_FILE),
                  opener=_opener(dir_fd)) as f:
            manifest = json.load(f)
    except (FileNotFoundError, IsADirectoryError):
        raise InvalidCheckpointError(path, "missing manifest (torn or "
                                     "pre-manifest checkpoint)")
    except (OSError, json.JSONDecodeError) as e:
        raise InvalidCheckpointError(path, f"unreadable manifest: {e}")
    if not isinstance(manifest, dict) or \
            not isinstance(manifest.get("files"), dict) or \
            manifest.get("format") != MANIFEST_FORMAT:
        raise InvalidCheckpointError(path, "malformed manifest")
    return manifest


def load_manifest(path: str) -> Dict[str, Any]:
    """Read and structurally validate the manifest of a committed
    checkpoint directory. Raises :class:`InvalidCheckpointError`."""
    return _load_manifest_at(path, None)


def _verify_at(path: str, fd: int, deep: bool
               ) -> Tuple[bool, Optional[str], Optional[Dict[str, Any]]]:
    try:
        manifest = _load_manifest_at(path, fd)
    except InvalidCheckpointError as e:
        return False, e.reason, None
    for rel, rec in manifest["files"].items():
        try:
            st = os.stat(rel, dir_fd=fd)
        except OSError:
            st = None
        if st is None or not stat.S_ISREG(st.st_mode):
            return False, f"manifest lists missing file {rel!r}", manifest
        if st.st_size != rec.get("bytes"):
            return False, (f"file {rel!r} is {st.st_size}B, "
                           f"manifest says {rec.get('bytes')}B"), manifest
        if deep:
            try:
                digest = _sha256(rel, fd)
            except OSError:
                return (False, f"manifest lists missing file {rel!r}",
                        manifest)
            if digest != rec.get("sha256"):
                return (False, f"file {rel!r} fails its manifest hash",
                        manifest)
    # Extra payload files not in the manifest are tolerated, as in the
    # reference; a missing or short file is always fatal.
    return True, None, manifest


def verify_checkpoint_dir(path: str, deep: bool = False
                          ) -> Tuple[bool, Optional[str],
                                     Optional[Dict[str, Any]]]:
    """Is ``path`` a complete committed checkpoint? Shallow mode checks
    the manifest parses and every listed file exists with the recorded
    byte count; ``deep`` re-hashes contents (catches silent corruption,
    not just truncation). Returns (ok, reason_if_not, parsed_manifest).
    The whole check reads one directory; if a concurrent commit
    displaced it meanwhile, the path is resolved and checked again."""
    result: Tuple[bool, Optional[str], Optional[Dict[str, Any]]] = (
        False, "missing manifest (torn or pre-manifest checkpoint)", None)
    for _ in range(_RESOLVE_ATTEMPTS):
        try:
            with _resolved(path) as fd:
                result = _verify_at(path, fd, deep)
                if result[0] or not _displaced(path, fd):
                    return result
        except (FileNotFoundError, NotADirectoryError):
            return (False, "missing manifest (torn or pre-manifest "
                    "checkpoint)", None)
    return result


class Checkpoint:
    """Immutable checkpoint; create via ``from_dict``/``from_directory``."""

    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("Provide exactly one of data / path")
        self._data = data
        self._path = path

    # --- constructors -----------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        ok, reason, _manifest = verify_checkpoint_dir(path)
        if not ok:
            raise InvalidCheckpointError(path, reason)
        return cls(path=path)

    # --- conversions ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        for attempt in range(_RESOLVE_ATTEMPTS):
            with _resolved(self._path) as fd:
                try:
                    return self._read(fd)
                except FileNotFoundError:
                    # a concurrent commit displaced (and is removing)
                    # the directory this read resolved: resolve again
                    if attempt + 1 < _RESOLVE_ATTEMPTS and \
                            _displaced(self._path, fd):
                        continue
                    raise
        raise AssertionError("unreachable")

    @staticmethod
    def _read(fd: int) -> Dict[str, Any]:
        """The payload of the directory ``fd`` resolved: ``meta.pkl`` and
        the tensors it refers to (both always written)."""
        opener = _opener(fd)
        with open(_META_FILE, "rb", opener=opener) as f:
            meta = f.read()
        with open(_TENSOR_FILE, "rb", opener=opener) as f:
            tensors = torch.load(f, weights_only=True, map_location="cpu")
        return dict(join_tensors(meta, tensors))

    def to_directory(self, path: Optional[str] = None,
                     step: Optional[int] = None) -> str:
        """Materialize as a directory via stage -> fsync -> manifest ->
        atomic rename. ``step`` is recorded in the manifest (falls back
        to an integer ``data['step']`` when present) so resolvers can
        order checkpoints without deserializing payloads."""
        if path is None:
            path = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
            # mkdtemp created the target itself; commit must swap it.
        path = os.path.abspath(path)
        if self._path is not None and os.path.abspath(self._path) == path:
            return path
        if step is None and self._data is not None:
            maybe = self._data.get("step")
            if isinstance(maybe, int) and not isinstance(maybe, bool):
                step = maybe
        parent = os.path.dirname(path) or "."
        os.makedirs(parent, exist_ok=True)
        stage = os.path.join(
            parent, f"{_TMP_PREFIX}{os.path.basename(path)}-"
                    f"{uuid.uuid4().hex[:8]}")
        try:
            if self._path is not None:
                shutil.copytree(self._path, stage)
                # Re-manifest: hashes re-verify the copy, and a torn
                # copy can never masquerade as the committed source.
                old = os.path.join(stage, MANIFEST_FILE)
                if step is None and os.path.isfile(old):
                    try:
                        with open(old) as f:
                            step = json.load(f).get("step")
                    except (OSError, json.JSONDecodeError):
                        step = None
                if os.path.exists(old):
                    os.remove(old)
            else:
                os.makedirs(stage)
                _write_payload(stage, self._data)
            write_manifest(stage, step=step)
            _commit_dir(stage, path)
        finally:
            if os.path.isdir(stage):
                shutil.rmtree(stage, ignore_errors=True)
        return path

    # --- helpers ----------------------------------------------------------

    def __getitem__(self, key: str):
        return self.to_dict()[key]

    def get(self, key: str, default=None):
        return self.to_dict().get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self.to_dict()

    def __repr__(self):
        src = "dict" if self._data is not None else self._path
        return f"Checkpoint({src})"


def _write_payload(stage: str, data: Dict[str, Any]) -> None:
    """``meta.pkl`` (the structure and every non-tensor leaf) and
    ``arrays/tensors.pt`` (the tensor leaves, maybe none)."""
    meta, tensors = split_tensors(data)
    with open(os.path.join(stage, _META_FILE), "wb") as f:
        f.write(meta)
        f.flush()
        os.fsync(f.fileno())
    os.makedirs(os.path.join(stage, _ARRAY_SUBDIR))
    with open(os.path.join(stage, _TENSOR_FILE), "wb") as f:
        torch.save([t.detach() for t in tensors], f)


_AT_FDCWD = -100
_RENAME_EXCHANGE = 2


@functools.cache
def _renameat2():
    """The C library's ``renameat2``, or None where it has none."""
    try:
        fn = ctypes.CDLL(None, use_errno=True).renameat2
    except (AttributeError, OSError):
        return None
    fn.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                   ctypes.c_char_p, ctypes.c_uint]
    fn.restype = ctypes.c_int
    return fn


def _exchange(a: str, b: str) -> bool:
    """Atomically swap the directory entries ``a`` and ``b`` (both must
    exist). False where the C library or the file system cannot."""
    fn = _renameat2()
    if fn is None:
        return False
    if fn(_AT_FDCWD, os.fsencode(a), _AT_FDCWD, os.fsencode(b),
          _RENAME_EXCHANGE) == 0:
        return True
    err = ctypes.get_errno()
    if err in (errno.EINVAL, errno.ENOSYS, errno.EOPNOTSUPP):
        return False
    raise OSError(err, os.strerror(err), b)


def _commit_dir(stage: str, path: str) -> None:
    """Atomically install ``stage`` at ``path``. A pre-existing target
    (re-save over an old checkpoint, or mkdtemp's empty dir) is
    exchanged with the stage in one step and removed after — at every
    instant ``path`` names either the old complete state or the new
    one."""
    parent = os.path.dirname(path) or "."
    displaced = None
    if os.path.exists(path):
        if _exchange(stage, path):
            displaced = stage
        else:
            displaced = os.path.join(
                parent, f"{_TMP_PREFIX}displaced-{uuid.uuid4().hex[:8]}")
            os.rename(path, displaced)
            try:
                os.rename(stage, path)
            except OSError:
                os.rename(displaced, path)     # roll back
                raise
    else:
        os.rename(stage, path)
    _fsync_dir(parent)
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)


__all__ = ["Checkpoint", "InvalidCheckpointError", "MANIFEST_FILE",
           "MANIFEST_FORMAT", "load_manifest", "verify_checkpoint_dir",
           "write_manifest"]
