"""Own copy of ``ray_tpu/serve/errors.py``: typed request-lifecycle
errors for the LLM serving stack (the port imports nothing from
``ray_tpu``).

A production serving path treats the request lifecycle — abort,
timeout, shed, isolate — as part of its contract, which means the
FAILURE TYPES are part of the API: the HTTP proxy maps them to
status codes (429/504/499), clients branch on them, and tests assert
them. They live in this jax-free module so the proxy and client code
can import them without dragging the engine's device stack in.

Hierarchy (all subclass ``RequestError`` so existing ``except
RequestError`` call sites keep working):

- ``RequestCancelled``  — the client aborted (``RequestHandle.
  cancel()`` or a disconnect detected upstream). HTTP: 499-style.
- ``DeadlineExceeded``  — the request's ``deadline_s`` elapsed before
  completion (at any phase: queued, mid-prefill, decoding,
  mid-speculation). HTTP: 504.
- ``EngineOverloaded``  — bounded admission shed the request at
  ``submit`` because ``max_queued`` was reached. Fast failure is the
  point: the alternative is silent TTFT collapse as the queue grows
  without bound. Carries ``retry_after_s``. HTTP: 429 + Retry-After.
- ``EngineShutdown``    — the engine stopped while the request was
  queued or in flight; consumers are unblocked instead of hanging.
"""
from __future__ import annotations


class RequestError(Exception):
    """Base class for engine request failures."""


class RequestCancelled(RequestError):
    """The request was aborted by the client (cancel/disconnect)."""


class DeadlineExceeded(RequestError):
    """The request's deadline elapsed before it completed."""


class EngineOverloaded(RequestError):
    """Admission queue full: the request was shed, not queued.

    ``retry_after_s`` is the engine's hint for when capacity is
    likely back (the proxy surfaces it as a Retry-After header)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class EngineShutdown(RequestError):
    """The engine stopped while the request was queued/in flight."""


class PoolDegraded(EngineShutdown):
    """The replica pool hit its crash-loop restart cap: one or more
    replicas died repeatedly, automatic rebuilding stopped for them,
    and no healthy replica remains to take the request. Distinct from
    a plain ``EngineShutdown`` so operators (and tests) can tell "the
    pool was stopped" from "the pool burned through its restart
    budget" — the latter needs a human or an autoscaler, not a retry.
    HTTP: 503 (inherits ``EngineShutdown`` classification), plus
    Retry-After when the pool can estimate a restart/provisioning ETA
    (``retry_after_s``; None = no honest hint, bare 503)."""

    def __init__(self, msg: str,
                 retry_after_s: "float | None" = None):
        super().__init__(msg)
        if retry_after_s is not None:
            self.retry_after_s = float(retry_after_s)


class EngineDraining(RequestError):
    """The replica is draining (finishing in-flight work before a
    restart) and admits nothing new. Routers skip draining replicas,
    so a client only sees this when talking to a replica directly.
    HTTP: 503 — retry lands on a healthy replica."""


def classify_http_status(exc: BaseException) -> int:
    """Map an exception (possibly wrapped by the remote-call layer:
    ``TaskError.cause`` / ``__cause__`` chains, or stringly re-raised)
    to the lifecycle HTTP status. 500 when it is none of ours.

    Matching is BY NAME along the cause chain, not isinstance: the
    exception may have crossed a process boundary and been rebuilt by
    a different import of this module, or be a remote-traceback
    wrapper whose string carries the type name.
    """
    status_by_name = {
        "EngineOverloaded": 429,
        "DeadlineExceeded": 504,
        "GetTimeoutError": 504,
        "EngineShutdown": 503,
        "PoolDegraded": 503,
        "EngineDraining": 503,
        "RequestCancelled": 499,
    }
    seen = set()
    stack = [exc]
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        name = type(e).__name__
        if name in status_by_name:
            return status_by_name[name]
        stack.extend([getattr(e, "cause", None), e.__cause__,
                      e.__context__])
    # last resort: a stringly-wrapped remote error still names the type
    msg = str(exc)
    for name, status in status_by_name.items():
        if name in msg:
            return status
    return 500


def retry_after_s(exc: BaseException, default: float = 1.0) -> float:
    """Best-effort Retry-After extraction across wrapping layers.

    Takes the MAX over every hint found along the cause chain, not the
    first: a pool-aggregate ``EngineOverloaded`` chains the last
    per-replica shed as its ``__cause__``, and an honest Retry-After
    must cover the slowest replica, not whichever wrapper the walker
    happened to visit first."""
    seen = set()
    stack = [exc]
    best = None
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        v = getattr(e, "retry_after_s", None)
        if isinstance(v, (int, float)):
            best = float(v) if best is None else max(best, float(v))
        stack.extend([getattr(e, "cause", None), e.__cause__,
                      e.__context__])
    return default if best is None else best
