"""Unified metrics registry: labelled counters, gauges, and histograms.

One process-wide ``MetricsRegistry`` (``repro_torch.obs.REGISTRY``) is the
home for every counter the system used to keep in ad-hoc ``.stats``
dicts — ``PatternQueryBatcher``, ``PlanCache``, ``CompiledPlan`` — plus
the kernel wrappers and the partial-embedding API.  Series are keyed by
(name, sorted label items), so ``counter("cutjoin.kernel_fallbacks",
cut=3)`` and ``cut=2`` are distinct series that still aggregate under
one name.

``StatsView`` preserves every pre-existing ``.stats`` consumer: it is a
dict-shaped ``MutableMapping`` whose reads are instance-local and exact
(what the old dicts gave), while positive writes mirror into the
registry's cumulative series — so process-wide telemetry aggregates
across instances without per-instance label leaks, and a local reset
(``clear()``, or assigning a smaller value) never decrements the
registry: registry counters are monotonic, instance views are not.

Zero-dependency by design (stdlib only): the registry must be importable
from every layer — kernels included — without cycles or heavyweight
imports.
"""
from __future__ import annotations

import json
import threading
from collections.abc import MutableMapping
from typing import Dict, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, object], ...]]


class _Series:
    """One labelled series.  ``kind`` is fixed at first touch: counters
    accumulate, gauges overwrite, histograms keep count/sum/min/max/last
    (enough for rate, mean, and envelope without storing samples)."""
    __slots__ = ("kind", "value", "count", "total", "vmin", "vmax", "last")

    def __init__(self, kind: str):
        self.kind = kind
        self.value = 0.0                 # counter / gauge
        self.count = 0                   # histogram
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self.last = None

    def summary(self):
        if self.kind == "histogram":
            return {"count": self.count, "sum": self.total,
                    "min": self.vmin, "max": self.vmax,
                    "mean": (self.total / self.count) if self.count else None,
                    "last": self.last}
        return self.value


class MetricsRegistry:
    """Labelled counter/gauge/histogram store.  Thread-safe: the serving
    batcher and background benchmark loops may increment concurrently."""

    def __init__(self):
        self._series: Dict[_Key, _Series] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, labels: dict) -> _Key:
        return (name, tuple(sorted(labels.items())))

    def _get_series(self, name: str, labels: dict, kind: str) -> _Series:
        key = self._key(name, labels)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, _Series(kind))
        return s

    def counter(self, name: str, value: float = 1, **labels) -> float:
        """Increment (default +1) and return the series' new total."""
        s = self._get_series(name, labels, "counter")
        with self._lock:
            s.value += value
            return s.value

    def gauge(self, name: str, value: float, **labels):
        """Set a point-in-time value (overwrites)."""
        s = self._get_series(name, labels, "gauge")
        s.value = value

    def observe(self, name: str, value: float, **labels):
        """Record one histogram sample."""
        s = self._get_series(name, labels, "histogram")
        with self._lock:
            s.count += 1
            s.total += value
            s.vmin = value if s.vmin is None else min(s.vmin, value)
            s.vmax = value if s.vmax is None else max(s.vmax, value)
            s.last = value

    def get(self, name: str, default=0.0, **labels):
        """Value of one series (counter/gauge total, histogram summary
        dict), or ``default`` when the series does not exist."""
        s = self._series.get(self._key(name, labels))
        return default if s is None else s.summary()

    def series(self, name: str) -> dict:
        """Every labelled series under one name: {label tuple: summary}."""
        return {lbl: s.summary() for (n, lbl), s in self._series.items()
                if n == name}

    def snapshot(self) -> dict:
        """JSON-ready dump of every series: {name: {label string: summary}}
        where the label string is "k=v,k=v" ("" for unlabelled)."""
        out: dict = {}
        for (name, lbl), s in sorted(self._series.items(),
                                     key=lambda kv: kv[0]):
            key = ",".join(f"{k}={v}" for k, v in lbl)
            out.setdefault(name, {})[key] = s.summary()
        return out

    def dump(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True,
                          default=str)

    def reset(self):
        """Drop every series (tests; a fresh process state)."""
        with self._lock:
            self._series.clear()


class StatsView(MutableMapping):
    """Dict-shaped stats facade backed by a ``MetricsRegistry``.

    Reads (``stats["x"]``) come from an instance-local table, exact per
    consumer — the contract the old ad-hoc dicts gave their tests and
    callers.  Writes flow through ``__setitem__`` (so ``stats["x"] += 1``
    works unchanged) and mirror any *positive* delta into the registry
    counter ``<prefix>.<key>`` with the view's bound labels; negative
    deltas (resets) only touch the local table, keeping registry
    counters monotonic across instance lifetimes.

    Integral values read back as ``int`` so reprs and equality checks
    match the old integer dicts."""

    def __init__(self, prefix: str, keys=(), registry=None, **labels):
        self._prefix = prefix
        self._reg = registry if registry is not None else REGISTRY
        self._labels = labels
        self._local: dict = {k: 0 for k in keys}

    def __getitem__(self, key):
        v = self._local[key]
        return int(v) if isinstance(v, float) and v.is_integer() else v

    def __setitem__(self, key, value):
        delta = value - self._local.get(key, 0)
        self._local[key] = value
        if delta > 0:
            self._reg.counter(f"{self._prefix}.{key}", delta,
                              **self._labels)

    def __delitem__(self, key):
        del self._local[key]

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)

    def __repr__(self):
        return repr({k: self[k] for k in self._local})

    def __eq__(self, other):
        """Equal to any mapping with the same items (the old dicts were
        compared with literal dicts in tests and call sites)."""
        if isinstance(other, (dict, MutableMapping)):
            return dict(self.items()) == dict(other.items())
        return NotImplemented


# the process-wide default registry; module-level helpers in
# ``repro_torch.obs`` delegate here
REGISTRY = MetricsRegistry()
