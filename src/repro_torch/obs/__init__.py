"""Observability: the unified metrics registry.

``metrics`` — the process-wide ``MetricsRegistry`` (labelled
counters/gauges/histograms) behind module-level helpers, plus
``StatsView``, the dict-shaped facade that mirrors ``.stats``
increments into the registry.  Counter names and labels are the
reference package's, so route counters compare one-to-one.

The reference's span tracer (``trace``) and cost-model drift report
(``drift``) are not ported yet; ``CompiledPlan`` therefore carries no
tracer hooks.
"""
from __future__ import annotations

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, StatsView

__all__ = ["MetricsRegistry", "StatsView", "REGISTRY", "counter", "gauge",
           "observe", "get", "snapshot", "dump", "reset"]


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
