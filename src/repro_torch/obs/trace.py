"""Plan-execution tracer: span trees over IR node evaluation.

``Tracer`` records one ``Span`` per evaluated plan node (plus one root
"execute" span per public read), nested exactly as the evaluation
recursion nests — a CutJoin span contains the Contract spans of the
factor tensors it had to materialise, a MobiusCombine span contains its
term evaluations, and a node served from the plan's value memo opens no
span at all.  Each span carries the node key, node class, cut size,
the route actually taken, the ``exact_block`` guard outcome, factor
shapes, and wall time from ``time.perf_counter``.

CUDA launches are asynchronous, so a span that closed the instant the
kernel call returned would time the *enqueue*, not the work: callers
fence the evaluated value with ``fence`` (``torch.cuda.synchronize`` on
the value's device) before the span closes.  Lowering converts scalar
node values to host floats (which forces a sync), so the fence is a
cheap no-op there and a correctness backstop for the tensor-valued
nodes.  The fence catches nothing: a launch error surfaces at the
synchronize and propagates, so no span closes over a failed kernel.

Exports: ``to_dict``/``to_json`` (the span tree, with per-span self
time and a root-coverage summary) and ``to_chrome`` (the Chrome
``chrome://tracing`` / Perfetto "traceEvents" format — load the file at
chrome://tracing to see the plan execute on a timeline).

Stdlib only, apart from torch, which ``fence`` imports when it meets a
CUDA tensor.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import List, Optional


def _cuda_devices(value, out: set):
    """The CUDA devices of every tensor in ``value`` (a tensor, or a
    tuple, list or dict holding tensors)."""
    if isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif getattr(value, "is_cuda", False):
        out.add(value.device)


def fence(value):
    """Block until every CUDA tensor in ``value`` is computed
    (``torch.cuda.synchronize`` on its device; a tuple, list or dict is
    searched for them) and return ``value``.  A no-op for host values.
    Whatever ``synchronize`` raises propagates."""
    devices: set = set()
    _cuda_devices(value, devices)
    if devices:
        import torch
        for dev in devices:
            torch.cuda.synchronize(dev)
    return value


class Span:
    """One timed node evaluation.  ``t0``/``t1`` are perf_counter
    seconds relative to the tracer's epoch; ``self_s`` (duration minus
    child durations) is the node's *own* work — the quantity the drift
    report pairs against its predicted cost."""
    __slots__ = ("name", "kind", "attrs", "t0", "t1", "children")

    def __init__(self, name: str, kind: str, attrs: dict, t0: float):
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self.t0 = t0
        self.t1 = t0
        self.children: List[Span] = []

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def self_s(self) -> float:
        return max(0.0, self.duration_s
                   - sum(c.duration_s for c in self.children))

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "start_us": self.t0 * 1e6,
                "dur_us": self.duration_s * 1e6,
                "self_us": self.self_s * 1e6,
                "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}


class Tracer:
    """Collects span trees across one or more plan executions.  Attach
    with ``compiled_plan.tracer = tracer``; every subsequent public read
    (``count`` / ``local_counts`` / ``exists`` / ``domains``) opens a
    root span and nests node spans beneath it.  ``meta["backend"]`` is
    the torch device type (``"cuda"`` or ``"cpu"``) of the first plan
    whose read it records, unless ``meta`` names one."""

    def __init__(self, meta: Optional[dict] = None):
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self.epoch = time.perf_counter()
        self.meta = dict(meta or {})

    # -- recording ---------------------------------------------------------------
    @contextmanager
    def span(self, name: str, kind: str = "node", **attrs):
        s = Span(name, kind, attrs, time.perf_counter() - self.epoch)
        if self._stack:
            self._stack[-1].children.append(s)
        else:
            self.roots.append(s)
        self._stack.append(s)
        try:
            yield s
        except BaseException as e:
            s.attrs["error"] = type(e).__name__
            raise
        finally:
            s.t1 = time.perf_counter() - self.epoch
            self._stack.pop()

    def annotate(self, **attrs):
        """Attach attributes to the innermost open span (no-op outside
        any span, so instrumented code paths also run untraced)."""
        if self._stack:
            self._stack[-1].attrs.update(attrs)

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    # -- analysis ----------------------------------------------------------------
    def walk(self):
        """Every span, depth-first, roots first."""
        stack = list(reversed(self.roots))
        while stack:
            s = stack.pop()
            yield s
            stack.extend(reversed(s.children))

    def coverage(self) -> Optional[float]:
        """Fraction of root-span ("execute") wall time covered by their
        immediate child node spans — how much of a measured end-to-end
        read the per-node accounting explains.  None without roots or
        with zero-duration roots."""
        execs = [r for r in self.roots if r.kind == "execute"] or self.roots
        total = sum(r.duration_s for r in execs)
        if total <= 0.0:
            return None
        inside = sum(c.duration_s for r in execs for c in r.children)
        return inside / total

    # -- export ------------------------------------------------------------------
    def to_dict(self) -> dict:
        cov = self.coverage()
        return {"meta": dict(self.meta),
                "coverage": cov,
                "spans": [r.to_dict() for r in self.roots]}

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_chrome(self) -> dict:
        """Chrome ``chrome://tracing`` "traceEvents" JSON: one complete
        ("ph": "X") event per span, all on one pid/tid so nesting renders
        as flame-graph depth."""
        events = []
        for s in self.walk():
            events.append({"name": s.name, "cat": s.kind, "ph": "X",
                           "ts": s.t0 * 1e6, "dur": s.duration_s * 1e6,
                           "pid": 0, "tid": 0,
                           "args": {k: repr(v) if not isinstance(
                               v, (int, float, str, bool, type(None)))
                               else v for k, v in s.attrs.items()}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": dict(self.meta)}

    def save(self, path: str, fmt: Optional[str] = None) -> str:
        """Write the trace to ``path``.  ``fmt`` is "json" (the span
        tree) or "chrome"; default infers chrome for paths ending in
        ``.chrome.json``, span-tree JSON otherwise."""
        if fmt is None:
            fmt = "chrome" if path.endswith(".chrome.json") else "json"
        with open(path, "w") as fh:
            if fmt == "chrome":
                json.dump(self.to_chrome(), fh, indent=1)
            else:
                fh.write(self.to_json())
        return path
