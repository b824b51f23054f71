"""State carried across from the reference package.

Two functions that take numpy arrays and strings only (nothing of the
reference package is imported): a reference ``Graph`` travels as its
``n``, ``edges`` and ``labels`` arrays, a reference ``Plan`` as its
``to_json()`` text.  Tests use them so that both packages bind the same
plan to the same graph.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.compiler.ir import Plan
from repro_torch.graph.storage import Graph


def graph_from_numpy(n: int, edges: np.ndarray,
                     labels: Optional[np.ndarray] = None) -> Graph:
    """Rebuild a graph from the arrays a reference ``Graph`` exposes
    (``g.n``, ``g.edges``, ``g.labels``)."""
    return Graph(int(n), np.asarray(edges, np.int64).reshape(-1, 2),
                 None if labels is None else np.asarray(labels))


def plan_from_json(text: str) -> Plan:
    """Load a plan serialised by either package (``Plan.to_json()``); the
    IR schema and ``PLAN_FORMAT_VERSION`` are shared."""
    return Plan.from_json(text)
