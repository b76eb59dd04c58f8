"""Metrics registry: counters and fixed-bucket histograms, plus the
dict-shaped `StatsView` the serving engine keeps its counters in.

This package's own copy of the part of the JAX package's
`telemetry/registry.py` and `telemetry/views.py` that the serving engine
reads. Stdlib only; an update is a dict lookup and a float add under a
per-metric lock. Quantile estimates, Prometheus export, gauges and
cross-process snapshots wait for a later slice.
"""

from __future__ import annotations

import bisect
import itertools
import re
import threading
from collections.abc import MutableMapping
from typing import Any, Iterator, Mapping, Sequence

__all__ = [
    "Counter",
    "Histogram",
    "Registry",
    "REGISTRY",
    "DEFAULT_MS_BUCKETS",
    "MetricError",
    "StatsView",
    "histogram",
]

# Latency buckets (milliseconds): sub-ms dispatch gaps up to 30 s tails.
DEFAULT_MS_BUCKETS: tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


class MetricError(ValueError):
    """Registration/usage conflict: kind, label names, or bucket mismatch."""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        self.name = _sanitize_name(name)
        self.help = help
        self.label_names: tuple[str, ...] = tuple(labels)
        self._series: dict[tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Mapping[str, Any]) -> tuple[str, ...]:
        if len(labels) != len(self.label_names) or any(
            n not in labels for n in self.label_names
        ):
            raise MetricError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.label_names)


class Counter(_Metric):
    """A labelled count, written through `StatsView`."""

    kind = "counter"

    def set_value(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: Any) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram: per-bucket counts (the last is the ``+Inf``
    overflow), running sum and count."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
    ):
        super().__init__(name, help, labels)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise MetricError(f"histogram {self.name!r} needs >= 1 bucket bound")
        self.buckets: tuple[float, ...] = bounds

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            state[0][idx] += 1
            state[1] += value
            state[2] += 1

    def sum(self, **labels: Any) -> float:
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            return 0.0 if state is None else float(state[1])


class Registry:
    """Named metrics; ``counter``/``histogram`` get-or-create and raise
    `MetricError` on a kind/label/bucket conflict."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls: type, name: str, kwargs: dict) -> Any:
        name = _sanitize_name(name)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is None:
                metric = self._metrics[name] = cls(name, **kwargs)
                return metric
            if type(existing) is not cls:
                raise MetricError(f"metric {name!r} already registered as {existing.kind}")
            if tuple(kwargs.get("labels", ())) != existing.label_names:
                raise MetricError(f"metric {name!r} label mismatch")
            if cls is Histogram and tuple(
                sorted(float(b) for b in kwargs.get("buckets", DEFAULT_MS_BUCKETS))
            ) != existing.buckets:
                raise MetricError(f"metric {name!r} bucket mismatch")
            return existing

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, {"help": help, "labels": labels})

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, {"help": help, "labels": labels, "buckets": buckets}
        )

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(_sanitize_name(name))


REGISTRY = Registry()


def histogram(
    name: str,
    help: str = "",
    labels: Sequence[str] = (),
    buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


_instance_ids = itertools.count()
_id_lock = threading.Lock()


class StatsView(MutableMapping):
    """Fixed-key mutable mapping backed by labelled registry counters named
    ``{prefix}_{key}``: ``stats["x"] += 1`` updates the registry series of
    this instance (label ``label=<instance id>``). Assigning an unknown key
    raises, so a typo cannot mint a new metric."""

    def __init__(
        self,
        prefix: str,
        keys: Sequence[str],
        *,
        label: str = "instance",
        registry: Registry | None = None,
    ):
        reg = registry if registry is not None else REGISTRY
        with _id_lock:
            instance = str(next(_instance_ids))
        self._labels = {label: instance}
        self._metrics: dict[str, Counter] = {}
        for key in keys:
            metric = reg.counter(f"{prefix}_{key}", labels=(label,))
            metric.set_value(0.0, **self._labels)
            self._metrics[key] = metric

    @property
    def labels(self) -> dict[str, str]:
        return dict(self._labels)

    def __getitem__(self, key: str) -> int | float:
        value = self._metrics[key].value(**self._labels)
        return int(value) if float(value).is_integer() else value

    def __setitem__(self, key: str, value: Any) -> None:
        self._metrics[key].set_value(float(value), **self._labels)  # unknown key -> KeyError

    def __delitem__(self, key: str) -> None:
        raise TypeError("StatsView has a fixed key set")

    def __iter__(self) -> Iterator[str]:
        return iter(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"
