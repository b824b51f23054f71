"""Observability: plan-execution tracing, unified metrics, drift
accounting.

Three pieces, all stdlib apart from torch behind a lazy fence:

* ``trace`` — ``Tracer``/``Span``: per-node span trees over plan
  execution, exportable as JSON or Chrome ``chrome://tracing`` format.
  Attach with ``compiled_plan.tracer = Tracer()``; disabled (the
  default) costs one ``is None`` check per node eval.  ``fence``
  synchronises the card before a span closes.
* ``metrics`` — the process-wide ``MetricsRegistry`` (labelled
  counters/gauges/histograms) behind module-level helpers, plus
  ``StatsView``, the dict-shaped facade that mirrors ``.stats``
  increments into the registry.  Counter names and labels are the
  reference package's, so route counters compare one-to-one.
* ``drift`` — pairs each node's APCT *predicted* cost with its traced
  measured self time and aggregates a calibration report (rank
  correlation + per-class ratio spread) per node class × cut size ×
  route.

Typical use::

    from repro_torch import obs
    tr = obs.Tracer()
    cp = compiler.compile(p, g)
    cp.tracer = tr
    cp.count(p)
    tr.save("out.json")                      # or out.chrome.json
    report = obs.drift.aggregate(obs.drift.pairs_from_trace(tr.to_dict()))
"""
from __future__ import annotations

from repro_torch.obs import drift
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, StatsView
from repro_torch.obs.trace import Span, Tracer, fence

__all__ = ["Tracer", "Span", "fence", "MetricsRegistry", "StatsView",
           "REGISTRY", "drift", "counter", "gauge", "observe", "get",
           "snapshot", "dump", "reset"]


def counter(name: str, value: float = 1, **labels) -> float:
    """Increment a labelled counter on the process registry."""
    return REGISTRY.counter(name, value, **labels)


def gauge(name: str, value: float, **labels):
    REGISTRY.gauge(name, value, **labels)


def observe(name: str, value: float, **labels):
    REGISTRY.observe(name, value, **labels)


def get(name: str, default=0.0, **labels):
    return REGISTRY.get(name, default, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def dump(indent=1) -> str:
    return REGISTRY.dump(indent)


def reset():
    REGISTRY.reset()
