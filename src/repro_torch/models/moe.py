"""Token-choice top-k MoE with capacity-based dispatch.

The reference package's ``repro.models.moe``, einsum path.  Dispatch is
per example with a static capacity C = ceil(S * top_k * capacity_factor /
E) (rounded up to a multiple of 8, at least 8, once S >= 8): every
(token, choice) pair takes the next free slot of its expert in (token,
choice) order, pairs past C are dropped (they add zero at slot C - 1 and
are combined with weight 0), and the kept ones run through the experts'
SwiGLU as batched products over a (B, E, C, d) buffer.  FLOPs scale with
E·C ≈ top_k·S·capacity_factor; at decode (S = 1, C = 1) the products
still read every expert's weights, as the reference's einsum does.

Routing is a pure function of the layer input (no host reads, no
data-dependent shapes), so a decode step that routes can be captured in a
CUDA graph, and remat's recomputation in the backward routes exactly as
the forward did.  Ties between experts' router probabilities go to the
lower expert index, as ``jax.lax.top_k`` orders them (``top_k``).

The reference's expert-parallel path (``moe_apply_ep``: ``shard_map``
with two ``all_to_all``\\s over a ``"model"`` mesh axis) is not ported.
The reference takes it only under an active mesh with a ``"model"`` axis;
the port's one mesh is the 1-D ``("data",)`` ``DataMesh`` of the mining
tier, so ``moe_apply`` always takes the einsum path.  The EP path comes
with the LM side of the mesh (ROADMAP queue 1, item 13f).  The
reference's ``constrain`` calls pin shardings and are no-ops without a
mesh; they are dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import P


def moe_specs(cfg):
    """Router, the three stacked expert weights and, with
    ``num_shared``, the shared experts' MLP — the reference's names,
    shapes, axes and leaf order."""
    e, d = cfg.moe, cfg.d_model
    s = {
        "router": P((d, e.num_experts), ("embed", None), scale=0.02),
        "wi": P((e.num_experts, d, e.d_expert),
                ("experts", "expert_embed", "expert_mlp")),
        "wg": P((e.num_experts, d, e.d_expert),
                ("experts", "expert_embed", "expert_mlp")),
        "wo": P((e.num_experts, e.d_expert, d),
                ("experts", "expert_mlp", "expert_embed")),
    }
    if e.num_shared:
        f = e.num_shared * e.d_expert
        s["shared_wi"] = P((d, f), ("embed", "mlp"))
        s["shared_wg"] = P((d, f), ("embed", "mlp"))
        s["shared_wo"] = P((f, d), ("mlp", "embed"))
    return s


def capacity(S: int, top_k: int, E: int, factor: float) -> int:
    c = math.ceil(S * top_k * factor / E)
    if S >= 8:
        c = max(8, ((c + 7) // 8) * 8)
    return max(1, c)


def top_k(probs, k: int):
    """The k largest of ``probs`` (..., E) and their indices, largest
    first.  A stable descending sort keeps equal values in index order,
    so ties go to the lower index, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order on ties)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


class Routing(NamedTuple):
    probs: torch.Tensor     # (B, S, E) f32 router softmax
    w: torch.Tensor         # (B, S·k) normalised top-k weights, x's dtype
    idx: torch.Tensor       # (B, S·k) expert of each (token, choice) pair
    oh: torch.Tensor        # (B, S·k, E) int32 one-hot of idx
    pos: torch.Tensor       # (B, S·k) the pair's slot in its expert
    keep: torch.Tensor      # (B, S·k) pos < C
    C: int                  # capacity per expert and example


def routing(p, x, cfg) -> Routing:
    """Router logits ``x @ router`` in x's dtype, cast to f32; softmax;
    top-k; weights normalised by max(Σw, 1e-9) and cast to x's dtype.
    Pairs flattened to (B, S·k) in (token, choice) order take the next
    free slot of their expert: the count of earlier pairs routed to it."""
    e = cfg.moe
    B, S, _ = x.shape
    E, k = e.num_experts, e.top_k
    logits = (x @ p["router"]).to(torch.float32)                 # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, k)                                     # (B,S,k)
    w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).to(x.dtype)
    idx = idx.reshape(B, S * k)
    oh = (idx[..., None] == torch.arange(E, device=x.device)).to(torch.int32)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)
    C = capacity(S, k, E, e.capacity_factor)
    return Routing(probs, w.reshape(B, S * k), idx, oh, pos, pos < C, C)


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (y (B, S, d), aux f32 scalar).  The einsum path
    always (see the module docstring)."""
    return _moe_apply_einsum(p, x, cfg)


def _moe_apply_einsum(p, x, cfg):
    e = cfg.moe
    B, S, d = x.shape
    E, k = e.num_experts, e.top_k
    r = routing(p, x, cfg)
    C = r.C
    # flat (b, e, c) slot of every pair; a kept pair owns its slot, so
    # index_add is exact in any order (dropped pairs add zeros at C - 1)
    base = torch.arange(B, device=x.device)[:, None] * (E * C)
    slot = (base + r.idx * C + torch.clamp(r.pos, max=C - 1)).reshape(-1)

    vals = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    vals = vals * r.keep[..., None].to(x.dtype)
    buf = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, vals.reshape(B * S * k, d))
    buf = buf.reshape(B, E, C, d)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wi"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["wg"])
    out = torch.einsum("becf,efd->becd", h, p["wo"])

    y = out.reshape(B * E * C, d).index_select(0, slot).reshape(B, S * k, d)
    y = y * (r.w * r.keep.to(r.w.dtype))[..., None]
    y = y.reshape(B, S, k, d).sum(dim=2)

    if e.num_shared:
        hs = F.silu(x @ p["shared_wi"]) * (x @ p["shared_wg"])
        y = y + hs @ p["shared_wo"]
    # load-balance aux: every routed pair counts, kept or not
    me = r.probs.mean(dim=(0, 1))                                # (E,)
    ce = (r.oh.sum(dim=1).to(torch.float32) / (S * k)).mean(0)   # (E,)
    aux = E * torch.sum(me * ce)
    return y, aux


class RoutingReport(NamedTuple):
    drops: torch.Tensor     # (B,) int64 (token, choice) pairs past C
    margin: torch.Tensor    # (B, S) f32 k-th minus (k+1)-th probability
    idx: torch.Tensor       # (B, S, k) chosen experts
    logits: torch.Tensor    # (B, S, E) f32 router logits


def routing_report(p, x, cfg) -> RoutingReport:
    """What the layer's routing does on ``x``, for reports: how many
    pairs it drops, and how close each token's choice came to a tie (the
    margin is inf when k = E)."""
    r = routing(p, x, cfg)
    B, S, _ = x.shape
    k = cfg.moe.top_k
    if k == cfg.moe.num_experts:
        margin = torch.full((B, S), math.inf, device=x.device)
    else:
        top = torch.sort(r.probs, dim=-1, descending=True)[0]
        margin = top[..., k - 1] - top[..., k]
    return RoutingReport((~r.keep).sum(-1), margin, r.idx.reshape(B, S, k),
                         (x @ p["router"]).to(torch.float32))
