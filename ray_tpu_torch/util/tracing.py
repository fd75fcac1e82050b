"""Own copy of part of ``ray_tpu/util/tracing.py``: the span sink that
``serve/obs.py``'s ``emit_request_spans`` feeds — ``setup_tracing``,
``teardown_tracing``, ``is_enabled``, ``get_spans`` and the id
minting.

Spans go to an in-memory list and, once ``setup_tracing`` named a
trace directory, to ``<dir>/<pid>.jsonl`` as well, which ``get_spans``
merges back (the reference's cross-process sink: a process started
after the call inherits ``RAY_TPU_TRACE_DIR`` and appends there). The
default directory lies under the system temp directory (``TMPDIR``),
where the reference names ``/tmp``. The reference's ``span`` context
manager, its remote-call context propagation, its pluggable exporter
and ``export_json`` are not taken: nothing in the port uses them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import uuid
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_enabled = False
_spans: List[Dict[str, Any]] = []
_trace_dir: Optional[str] = None
_TRACE_DIR_ENV = "RAY_TPU_TRACE_DIR"


def setup_tracing(trace_dir: Optional[str] = None) -> None:
    """Enable tracing. ``trace_dir`` (default: a per-pid directory under
    the temp directory) collects each process's spans as JSONL and is
    exported through ``RAY_TPU_TRACE_DIR`` to processes started
    afterwards."""
    global _enabled, _trace_dir
    _enabled = True
    _trace_dir = trace_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu", "traces",
        f"p{os.getpid()}")
    os.makedirs(_trace_dir, exist_ok=True)
    os.environ[_TRACE_DIR_ENV] = _trace_dir


def teardown_tracing() -> None:
    """Disable tracing, drop the collected spans and the trace
    directory."""
    global _enabled, _trace_dir
    _enabled = False
    if _trace_dir is not None:
        shutil.rmtree(_trace_dir, ignore_errors=True)
    _trace_dir = None
    os.environ.pop(_TRACE_DIR_ENV, None)
    with _lock:
        _spans.clear()


def is_enabled() -> bool:
    return _enabled


def get_spans(include_workers: bool = True) -> List[Dict[str, Any]]:
    """This process's spans, plus (``include_workers``) every other
    process's JSONL file in the trace directory."""
    with _lock:
        out = list(_spans)
    if include_workers and _trace_dir and os.path.isdir(_trace_dir):
        own = f"{os.getpid()}.jsonl"
        for fname in os.listdir(_trace_dir):
            if not fname.endswith(".jsonl") or fname == own:
                continue
            try:
                with open(os.path.join(_trace_dir, fname)) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            out.append(json.loads(line))
            except OSError:
                pass
    return out


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def _emit(span: Dict[str, Any]) -> None:
    with _lock:
        _spans.append(span)
    if _trace_dir is not None:
        try:
            path = os.path.join(_trace_dir, f"{os.getpid()}.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps(span) + "\n")
        except OSError:
            pass
