"""State carried across from the reference package.

Functions that take numpy arrays and strings only (nothing of the
reference package is imported): a reference ``Graph`` travels as its
``n``, ``edges`` and ``labels`` arrays, a reference ``Plan`` as its
``to_json()`` text, a reference parameter tree as numpy leaves.  Tests use
them so that both packages bind the same plan to the same graph, and run
the same weights.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16: same bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # a writable copy
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg, tree, device, dtype=None):
    """The port's parameters for a reference parameter tree whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``): the same
    nesting — ``embed``, ``final_norm``, ``unembed`` when untied,
    ``segments`` as a list of ``{"slot<j>": {...}}`` with stacked leaves —
    as tensors of ``dtype`` (default ``cfg.param_dtype``) on ``device``.
    Every leaf's shape is checked against ``param_specs(cfg)``."""
    from repro_torch.models.params import is_spec
    from repro_torch.models.transformer import _dtype, param_specs
    dtype = _dtype(cfg.param_dtype) if dtype is None else dtype

    def walk(spec, node, path):
        if is_spec(spec):
            if tuple(np.shape(node)) != tuple(spec.shape):
                raise ValueError(f"{path}: shape {np.shape(node)}, the "
                                 f"config wants {spec.shape}")
            return _tensor(node, dtype, device)
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                raise ValueError(f"{path}: keys {sorted(node)}, the config "
                                 f"wants {sorted(spec)}")
            return {k: walk(spec[k], node[k], f"{path}/{k}") for k in spec}
        if len(node) != len(spec):
            raise ValueError(f"{path}: {len(node)} entries, the config "
                             f"wants {len(spec)}")
        return [walk(s, n, f"{path}[{i}]")
                for i, (s, n) in enumerate(zip(spec, node))]

    return walk(param_specs(cfg), tree, "params")


def state_from_numpy(cfg, opt_cfg, tree, device):
    """The port's training state for a reference state whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, state)`` of
    ``repro.train.train_step.init_state`` or of a step's result):
    ``{"params", "opt": {"m", "v", "step"}}`` with the parameters in
    ``cfg.param_dtype`` and marked ``requires_grad``, the moments in
    ``opt_cfg.state_dtype`` and the step an int32 scalar, on ``device``."""
    from repro_torch.models.params import leaves
    params = params_from_numpy(cfg, tree["params"], device)
    for p in leaves(params):
        p.requires_grad_(True)
    moments = getattr(torch, opt_cfg.state_dtype)
    opt = tree["opt"]
    return {"params": params,
            "opt": {"m": params_from_numpy(cfg, opt["m"], device, moments),
                    "v": params_from_numpy(cfg, opt["v"], device, moments),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=device)}}
