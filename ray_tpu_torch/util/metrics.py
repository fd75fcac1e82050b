"""Own copy of ``ray_tpu/util/metrics.py``: the application metrics API
(``Counter``, ``Gauge``, ``Histogram``), a process-local registry with
tag support, and Prometheus text exposition.

The reference's optional node-wide shared-memory sink
(``set_shm_registry``, fed to ``ray_tpu/_private/shm_metrics.py``) is
not taken: it belongs to the reference's cluster runtime, which the
port does not have. Everything else behaves as the reference's, and a
family exposes the same text for the same records.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}


def registry() -> Dict[str, "Metric"]:
    return dict(_registry)


def clear_registry():
    with _registry_lock:
        _registry.clear()


class Metric:
    TYPE = "untyped"
    # Tag keys the exposition format itself claims for this type —
    # user labels must not shadow them (e.g. "le" on histograms).
    RESERVED_TAG_KEYS: Tuple[str, ...] = ()

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        if len(set(self.tag_keys)) != len(self.tag_keys):
            raise ValueError(
                f"metric {name!r}: duplicate tag keys "
                f"{list(self.tag_keys)}")
        for reserved in self.RESERVED_TAG_KEYS:
            if reserved in self.tag_keys:
                raise ValueError(
                    f"metric {name!r}: tag key {reserved!r} is "
                    f"reserved by the {self.TYPE} exposition format")
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            prior = _registry.get(name)
            if prior is not None and (
                    prior.TYPE != self.TYPE
                    or prior.tag_keys != self.tag_keys):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{prior.TYPE}{list(prior.tag_keys)}; refusing "
                    f"colliding re-registration as "
                    f"{self.TYPE}{list(self.tag_keys)} — a merged "
                    f"scrape would expose two families under one "
                    f"name")
            _registry[name] = self

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _resolve_tags(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"Unknown tags {sorted(extra)} for metric "
                f"{self.name!r} (declared: {self.tag_keys})")
        return tuple(sorted(merged.items()))

    def _samples(self) -> List[Tuple[Tuple, Any]]:
        raise NotImplementedError


class Counter(Metric):
    TYPE = "counter"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter increments must be >= 0")
        key = self._resolve_tags(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _samples(self):
        with self._lock:
            return list(self._values.items())


class Gauge(Metric):
    TYPE = "gauge"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        with self._lock:
            self._values[key] = float(value)

    def _samples(self):
        with self._lock:
            return list(self._values.items())


class Histogram(Metric):
    TYPE = "histogram"
    RESERVED_TAG_KEYS = ("le",)

    def __init__(self, name, description="",
                 boundaries: Sequence[float] = (), tag_keys=()):
        super().__init__(name, description, tag_keys)
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError("boundaries must be a sorted non-empty list")
        self.boundaries = list(boundaries)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def _samples(self):
        with self._lock:
            return [(k, {"counts": list(v),
                         "sum": self._sums[k],
                         "count": self._totals[k]})
                    for k, v in self._counts.items()]


def _escape_label(v) -> str:
    """Prometheus label-value escaping (exposition format spec):
    backslash, double-quote, and newline must be escaped or a value
    like 'say "hi"' corrupts every line after it."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(tags: Tuple) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in tags)
    return "{" + inner + "}"


def prometheus_text() -> str:
    """Prometheus exposition format for every registered metric.

    Deterministic: families sort by name and samples by their tag
    tuple, so two scrapes of the same state are byte-identical and a
    multi-process merged scrape is diffable."""
    lines: List[str] = []
    for _, m in sorted(registry().items()):
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.TYPE}")
        for tags, value in sorted(m._samples(), key=lambda kv: kv[0]):
            if isinstance(m, Histogram):
                cum = 0
                for bound, c in zip(m.boundaries + [float("inf")],
                                    value["counts"]):
                    cum += c
                    b = "+Inf" if bound == float("inf") else repr(bound)
                    tag_str = _fmt_tags(tags + (("le", b),))
                    lines.append(f"{m.name}_bucket{tag_str} {cum}")
                lines.append(
                    f"{m.name}_sum{_fmt_tags(tags)} {value['sum']}")
                lines.append(
                    f"{m.name}_count{_fmt_tags(tags)} {value['count']}")
            else:
                lines.append(f"{m.name}{_fmt_tags(tags)} {value}")
    return "\n".join(lines) + "\n"
