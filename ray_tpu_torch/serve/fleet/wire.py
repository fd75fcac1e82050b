"""Own copy of ``ray_tpu/serve/fleet/wire.py``: the fleet wire schema,
JSON envelopes and typed errors across processes.

Every RPC is one request envelope and one response envelope, both
plain JSON objects (the transports own framing). The request carries
the ``trace_id``; the response carries either a ``result`` or a typed
``error`` that ``raise_error`` rebuilds on the caller side BY NAME, so
typing survives process boundaries without pickling exceptions — and
across the two packages: ``encode`` gives the reference's bytes for
the same envelope (sorted keys, compact separators), so a port process
and a JAX-package process speak one wire.

    request:  {"v": 1, "method": str, "args": {...},
               "trace_id": str | null}
    response: {"v": 1, "ok": true,  "result": ...}
            | {"v": 1, "ok": false,
               "error": {"type": str, "msg": str,
                         "retry_after_s": float | null}}

Fleet-specific typed errors subclass the serving taxonomy
(serve/errors.py) as the reference's do: ``StaleFencingToken``,
``UnknownMember``, ``AgentFenced``, ``NotPrimary`` and
``KVPullAborted``. The name ``ReplicaWedged`` resolves lazily, at raise
time, to the watchdog's class (serve/watchdog.py).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.errors import (DeadlineExceeded, EngineDraining,
                                        EngineOverloaded, EngineShutdown,
                                        PoolDegraded, RequestCancelled,
                                        RequestError, retry_after_s)

WIRE_VERSION = 1


class StaleFencingToken(EngineShutdown):
    """Write rejected: the fencing token belongs to a superseded
    registration. Monotonic tokens make this unambiguous — the writer
    lost a race it can never win again under that token."""


class UnknownMember(EngineShutdown):
    """The directory holds no member under that replica id (never
    registered, confirmed dead, or the directory restarted and lost
    its table). Agents re-register on seeing this."""


class AgentFenced(EngineDraining):
    """The agent's lease lapsed and it self-fenced: no admissions
    until it re-registers under a fresh generation."""


class NotPrimary(EngineShutdown):
    """The directory answering is a STANDBY: it replicates membership
    but does not adjudicate it. Callers holding an ordered endpoint
    list skip to the next endpoint; a standalone caller treats it like
    any 503."""


class KVPullAborted(EngineShutdown):
    """A cross-replica KV pull cannot complete on the donor side: the
    prefix is no longer resident, the transfer id is unknown (donor
    restarted or the transfer's pin deadline lapsed), or the donor is
    stopped. TYPED so the requester distinguishes "donor said no"
    (abort the pull, fall back to plain prefill immediately) from a
    ``TransportError`` (donor may be alive; bounded retry first).
    Never retried: the donor's answer cannot improve under the same
    transfer."""


_WIRE_ERRORS = {
    cls.__name__: cls
    for cls in (RequestError, RequestCancelled, DeadlineExceeded,
                EngineOverloaded, EngineShutdown, EngineDraining,
                PoolDegraded, StaleFencingToken, UnknownMember,
                AgentFenced, NotPrimary, KVPullAborted)
}


class WireError(RuntimeError):
    """A remote failure with no typed equivalent on this side."""


def _error_class(name: str):
    cls = _WIRE_ERRORS.get(name)
    if cls is None and name == "ReplicaWedged":
        # lazy: the watchdog imports the engine pool, which imports
        # fleet.routing, so resolving at raise time keeps this module
        # free of the import order
        from ray_tpu_torch.serve.watchdog import ReplicaWedged
        _WIRE_ERRORS[name] = cls = ReplicaWedged
    return cls


def request(method: str, args: Dict[str, Any],
            trace_id: Optional[str] = None) -> Dict[str, Any]:
    return {"v": WIRE_VERSION, "method": method, "args": args,
            "trace_id": trace_id}


def ok(result: Any) -> Dict[str, Any]:
    return {"v": WIRE_VERSION, "ok": True, "result": result}


def err(exc: BaseException) -> Dict[str, Any]:
    return {"v": WIRE_VERSION, "ok": False,
            "error": {"type": type(exc).__name__, "msg": str(exc),
                      "retry_after_s": retry_after_s(exc,
                                                     default=None)}}


def raise_error(error: Dict[str, Any]) -> None:
    """Rebuild and raise the typed error a response carried."""
    name = error.get("type", "WireError")
    msg = error.get("msg", "")
    cls = _error_class(name)
    if cls is None:
        raise WireError(f"{name}: {msg}")
    exc = cls(msg)
    ra = error.get("retry_after_s")
    if ra is not None:
        exc.retry_after_s = float(ra)
    raise exc


def encode(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, separators=(",", ":"),
                      sort_keys=True).encode("utf-8")


def decode(data: bytes) -> Dict[str, Any]:
    return json.loads(data.decode("utf-8"))
