"""Port of ``ray_tpu/util/envknobs.py``: the strict parser of the KV
pool dtype knob (``RAY_TPU_KV_DTYPE``), the one knob the port reads.

An env var is the last-resort override channel, so junk is rejected
with a typed error instead of defaulting: ``RAY_TPU_KV_DTYPE=int-8``
silently falling back to fp would make an A/B arm measure nothing.
Stdlib only; nothing else of the reference module is copied.
"""
from __future__ import annotations

import os
from typing import Optional

KV_DTYPES = ("fp", "int8")


class EnvKnobError(ValueError):
    """An environment knob is set to a value the port cannot parse."""

    def __init__(self, name: str, value: str, allowed) -> None:
        self.name = name
        self.value = value
        self.allowed = tuple(allowed)
        super().__init__(
            "%s=%r is not a valid setting (allowed: %s). Unset it or "
            "pick one of the allowed values — junk is rejected rather "
            "than silently defaulted." %
            (name, value, ", ".join(repr(a) for a in self.allowed)))


def parse_kv_dtype_env() -> Optional[str]:
    """RAY_TPU_KV_DTYPE: pool storage dtype override, or None when the
    knob is unset/empty (the caller falls back to its constructor
    arg)."""
    raw = os.environ.get("RAY_TPU_KV_DTYPE")
    if raw is None or raw == "":
        return None
    if raw in KV_DTYPES:
        return raw
    raise EnvKnobError("RAY_TPU_KV_DTYPE", raw, ("",) + KV_DTYPES)


def resolve_kv_dtype(arg: Optional[str]) -> str:
    """Merge the constructor arg with the env override (the env wins,
    so a harness can flip a whole fleet without touching code).
    Validates both sides: a bad arg raises ``ValueError``, a bad env
    value ``EnvKnobError``."""
    env = parse_kv_dtype_env()
    if env is not None:
        return env
    if arg is None:
        return "fp"
    if arg not in KV_DTYPES:
        raise ValueError(
            "kv_dtype=%r is not supported (choose one of %s)" %
            (arg, ", ".join(repr(d) for d in KV_DTYPES)))
    return arg
