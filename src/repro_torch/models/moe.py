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

Expert parallelism (``moe_apply_ep``): under an active mesh with a
``"model"`` axis that divides E, ``moe_apply`` takes the reference's rule
(full-mesh EP always, else only at ≤ 65 536 tokens) and its two
variants: full-mesh EP (experts over ``("data", "model")``) and ``"ff"``
(experts over ``"model"``, the FFN columns over ``"data"``).  The
reference runs a ``shard_map`` body per device with two ``all_to_all``\\s
(and, for ``"ff"``, an ``all_gather`` and a ``psum``); the port holds
every slot of the mesh in one process, so the body is written once over
a leading slot axis and each collective is a reshape, a permute or a sum
of that axis: the number of ops does not depend on the mesh's size (the
dry run traces it under 256 slots on meta tensors).  Each slot routes
its own tokens with its own capacity, as the reference's body does, so
what drops differs from the einsum path's.  The experts' weights are
read as views of the stacked leaves, never copied.  The body runs on x's
device: a live mesh whose slots lie on another device, or on more than
one, is refused (``NotImplementedError``).  Logical shardings are pinned
with ``distributed.meshes.constrain`` where the reference pins them.

Under the dry run's recorder (``distributed.meshes``) the body tells it
what the slot axis is: the body's inputs are pinned to the slot axis
(``pin``, the shard_map's in_specs), the dispatch index is slot-local
(``slot_local``; so is the einsum path's, whose pairs address their own
example's rows, as the reference's vmap over examples keeps them), and
each exchange sets its result's layout and reports what it moves
(``exchange``): the dispatch and return all-to-alls over a group of g
slots and, for ``"ff"``, the token all-gather over data and the psum,
each at its per-device result bytes.  Without a recorder these calls
return their argument.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import meshes
from repro_torch.distributed.meshes import constrain
from repro_torch.models.params import P

EP_MAX_TOKENS = 65_536      # past it only full-mesh EP is taken


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


def _router(p, x, cfg):
    """Router logits ``x @ router`` in x's dtype, cast to f32; softmax;
    top-k; weights normalised by max(Σw, 1e-9) and cast to x's dtype:
    (probs (B, S, E), w (B, S, k), idx (B, S, k))."""
    logits = (x @ p["router"]).to(torch.float32)                 # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.moe.top_k)                         # (B,S,k)
    w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).to(x.dtype)
    return probs, w, idx


def _slots_of(idx, E: int):
    """One-hot (..., n, E) int32 of pairs ``idx`` (..., n) and each pair's
    slot in its expert: the count of earlier pairs routed to it."""
    oh = (idx[..., None] == torch.arange(E, device=idx.device)).to(
        torch.int32)
    return oh, ((torch.cumsum(oh, dim=-2) - oh) * oh).sum(-1)


def routing(p, x, cfg) -> Routing:
    """``_router``; pairs flattened to (B, S·k) in (token, choice) order
    take the next free slot of their expert in their example."""
    e = cfg.moe
    B, S, _ = x.shape
    probs, w, idx = _router(p, x, cfg)
    idx = idx.reshape(B, S * e.top_k)
    oh, pos = _slots_of(idx, e.num_experts)
    C = capacity(S, e.top_k, e.num_experts, e.capacity_factor)
    return Routing(probs, w.reshape(B, S * e.top_k), idx, oh, pos, pos < C,
                   C)


def takes_ep(cfg, mesh, tokens: int) -> bool:
    """The reference's rule: a ``"model"`` axis that divides E, and either
    whole experts per slot over ``data`` × ``model`` or ≤ 65 536 tokens
    (for small-E training the token gather and psum cost more than the
    einsum dispatch, in the reference's measurements)."""
    if mesh is None or "model" not in mesh.shape:
        return False
    E, m = cfg.moe.num_experts, mesh.shape["model"]
    full_ep = E % (m * mesh.shape.get("data", 1)) == 0
    return E % m == 0 and (full_ep or tokens <= EP_MAX_TOKENS)


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (y (B, S, d), aux f32 scalar).  Under an active
    mesh that ``takes_ep``, the expert-parallel path; else the einsum
    path."""
    mesh = meshes.active_mesh()
    if takes_ep(cfg, mesh, x.shape[0] * x.shape[1]):
        return moe_apply_ep(p, x, cfg, mesh)
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
    slot = meshes.slot_local(     # an example's pairs address its own rows
        (base + r.idx * C + torch.clamp(r.pos, max=C - 1)).reshape(-1))

    vals = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    vals = vals * r.keep[..., None].to(x.dtype)
    buf = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, vals.reshape(B * S * k, d))
    buf = constrain(buf.reshape(B, E, C, d), "batch", "experts", None,
                    None)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wi"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["wg"])
    h = constrain(h, "batch", "experts", None, "expert_mlp")
    out = torch.einsum("becf,efd->becd", h, p["wo"])
    out = constrain(out, "batch", "experts", None, None)

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
    return constrain(y, "batch", "seq", None), aux


# ---------------------------------------------------------------------------
# Expert-parallel path: the reference's shard_map body over a slot axis
# ---------------------------------------------------------------------------

def _ep_specs(mesh, cfg, S: int, B: int):
    """The reference's layout: (xs, ws, ep_axes, wshard).  Tokens are
    (B, S, d) over ``("pod", "data")`` (the axes that divide B) and
    ``"model"`` (where it divides S); weights over ``("data", "model")``
    where that divides E (full-mesh EP, ``wshard`` "none"), else over
    ``"model"`` with the FFN columns over ``"data"`` where the rules put
    ``expert_mlp`` there (``wshard`` "ff"), else over ``"model"``."""
    prod, got = 1, []
    for ax in (a for a in ("pod", "data") if a in mesh.shape):
        if B % (prod * mesh.shape[ax]) == 0:
            got.append(ax)
            prod *= mesh.shape[ax]
    b = tuple(got) if len(got) > 1 else (got[0] if got else None)
    m = mesh.shape["model"]
    xs = (b, "model" if S % m == 0 else None, None)
    E = cfg.moe.num_experts
    if E % (m * mesh.shape.get("data", 1)) == 0:
        return xs, (("data", "model"), None, None), ("data", "model"), "none"
    if "data" in mesh.shape and \
            "data" in (meshes.current_rules().get("expert_mlp") or ()):
        return xs, ("model", None, "data"), ("model",), "ff"
    return xs, ("model", None, None), ("model",), "none"


def _slot_axes(mesh) -> tuple:
    """The slot grid's axes: the mesh's others, then "data", then
    "model", so that an exchange over ("data", "model") or "model" is
    over the trailing axes."""
    tail = tuple(a for a in ("data", "model") if a in mesh.shape)
    return tuple(a for a in mesh.axis_names if a not in tail) + tail


def _to_slots(t, spec, mesh, axes):
    """(*sizes of ``axes``, *block): every slot's block of ``t`` under
    ``spec`` (a view, broadcast over the axes t is not split over)."""
    shape, where = [], {}
    for dim, entry in zip(t.shape, spec):
        names = meshes.entry_axes(entry)
        for ax in names:
            where[ax] = len(shape)
            shape.append(mesh.shape[ax])
        shape.append(dim // math.prod(mesh.shape[ax] for ax in names))
    v = t.reshape(shape)
    local = [i for i in range(len(shape)) if i not in where.values()]
    free = [ax for ax in axes if ax not in where]
    v = v.reshape(shape + [1] * len(free))
    order = [where[ax] if ax in where else len(shape) + free.index(ax)
             for ax in axes]
    return v.permute(order + local).expand(
        [mesh.shape[ax] for ax in axes] + [shape[i] for i in local])


def _from_slots(blocks, spec, axes, shape):
    """The inverse of ``_to_slots``: the whole tensor of ``shape`` from
    the slots' blocks, read from slot 0 of each axis it is not split
    over (every slot there holds the same block)."""
    n = len(axes)
    split = {ax for entry in spec for ax in meshes.entry_axes(entry)}
    idx = tuple(slice(None) if ax in split else slice(0, 1) for ax in axes)
    v = blocks[idx]
    # dims: (axes..., local dims); move each split axis before its dim
    perm = []
    for d, entry in enumerate(spec):
        perm.extend(axes.index(ax) for ax in meshes.entry_axes(entry))
        perm.append(n + d)
    rest = [axes.index(ax) for ax in axes if ax not in split]
    return v.permute(perm + rest).reshape(shape)


def _check_ep_device(mesh, x):
    devices = set(getattr(mesh, "devices", ()) or ())
    if devices and devices != {x.device}:
        raise NotImplementedError(
            f"moe_apply_ep runs every slot on x's device ({x.device}); "
            f"this mesh's slots lie on {sorted(map(str, devices))}: "
            f"expert parallelism across devices is not implemented")


class EPRouting(NamedTuple):
    probs: torch.Tensor     # (B, S, E) f32 router softmax, whole batch
    idx: torch.Tensor       # (B, S, k) chosen experts, whole batch
    xs: tuple               # the tokens' spec (``_ep_specs``)
    axes: tuple             # the slot grid's axes (``_slot_axes``)
    grid: tuple             # their sizes
    block: tuple            # (Bl, Sl): a slot's rows and positions
    x: torch.Tensor         # (G, T, d) each slot's tokens
    idx_f: torch.Tensor     # (G, T·k) each slot's pairs' experts
    w_f: torch.Tensor       # (G, T·k) their weights
    pos: torch.Tensor       # (G, T·k) their slots in their expert
    keep: torch.Tensor      # (G, T·k) pos < C
    C: int                  # capacity per expert and slot


def ep_routing(p, x, cfg, mesh) -> EPRouting:
    """Routing over the whole batch, then per slot, from its own T tokens,
    as the reference's shard_map body routes: capacity C = ``capacity(T,
    k, E, factor)`` and each pair's slot in (token, choice) order."""
    e = cfg.moe
    B, S, d = x.shape
    k = e.top_k
    xs = _ep_specs(mesh, cfg, S, B)[0]
    axes = _slot_axes(mesh)
    probs, w, idx = _router(p, x, cfg)
    tok_spec = (xs[0], xs[1], None)
    xb = _to_slots(x, xs, mesh, axes)                 # (*grid, Bl, Sl, d)
    grid = tuple(xb.shape[:len(axes)])
    G, T = math.prod(grid), xb.shape[-3] * xb.shape[-2]
    on_slots = (axes, None)                           # G is the device axis
    idx_f = meshes.pin(_to_slots(idx, tok_spec, mesh, axes).reshape(
        G, T * k), on_slots)
    C = capacity(T, k, e.num_experts, e.capacity_factor)
    _, pos = _slots_of(idx_f, e.num_experts)
    return EPRouting(probs, idx, xs, axes, grid, tuple(xb.shape[-3:-1]),
                     meshes.pin(xb.reshape(G, T, d), on_slots + (None,)),
                     idx_f,
                     meshes.pin(_to_slots(w, tok_spec, mesh, axes).reshape(
                         G, T * k), on_slots),
                     pos, pos < C, C)


def moe_apply_ep(p, x, cfg, mesh):
    """The reference's expert-parallel MoE on ``mesh``'s slots: x (B, S,
    d) -> (y, aux).  ``ep_routing``; each slot's (E, C, d) dispatch
    buffer; the exchange to the experts' owners, SwiGLU with the owners'
    weights and the exchange back (``_experts``); the combine."""
    _check_ep_device(mesh, x)
    e = cfg.moe
    B, S, d = x.shape
    E, k = e.num_experts, e.top_k
    _, _, ep_axes, wshard = _ep_specs(mesh, cfg, S, B)
    if wshard == "ff" and e.d_expert % mesh.shape["data"]:
        raise ValueError(f"expert-parallel 'ff': the experts' {e.d_expert} "
                         f"FFN columns do not split over data = "
                         f"{mesh.shape['data']} (a shard_map refuses it too)")
    r = ep_routing(p, x, cfg, mesh)
    G, T, _ = r.x.shape
    C, keep = r.C, r.keep
    base = torch.arange(G, device=x.device)[:, None] * (E * C)
    slot = meshes.slot_local(
        (base + r.idx_f * C + torch.clamp(r.pos, max=C - 1)).reshape(-1))
    vals = r.x[:, :, None, :].expand(G, T, k, d).reshape(G, T * k, d)
    vals = vals * keep[..., None].to(x.dtype)
    buf = torch.zeros((G * E * C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, vals.reshape(G * T * k, d))

    out = _experts(p, buf.reshape(G, E, C, d), mesh, ep_axes, wshard)
    y = out.reshape(G * E * C, d).index_select(0, slot)
    y = y.reshape(G, T * k, d) * (r.w_f * keep.to(r.w_f.dtype))[..., None]
    y = y.reshape(*r.grid, *r.block, k, d).sum(dim=-2)
    # the out_specs: slots a token spec does not split over hold the same
    # rows (the reference's check_vma=False), read from the first
    split = {ax for entry in r.xs for ax in meshes.entry_axes(entry)}
    y = meshes.exchange(y, tuple(ax if ax in split else None
                                 for ax in r.axes) + (None,) * 3, [])
    y = _from_slots(y, r.xs, r.axes, (B, S, d))

    if e.num_shared:
        hs = F.silu(x @ p["shared_wi"]) * (x @ p["shared_wg"])
        y = y + hs @ p["shared_wo"]
    oh = (r.idx.reshape(B, S * k, 1) == torch.arange(E, device=x.device)).to(
        torch.float32)
    me = r.probs.mean(dim=(0, 1))
    ce = (oh.sum(dim=1) / (S * k)).mean(0)
    aux = E * torch.sum(me * ce)
    return constrain(y, "batch", "seq", None), aux


def owner_weights(p, mesh, ep_axes, wshard) -> tuple:
    """(wi, wg, wo) as the experts' owners read them, views of the stacked
    leaves (no copy): (owners, E / owners, d, f) for wi and wg; wo (owners,
    E / owners, f, d), or for "ff" (model, E / model, data, f / data, d),
    each data slot's rows of f apart."""
    E, d, f = p["wi"].shape
    M = mesh.shape["model"]
    n = M * mesh.shape.get("data", 1) if len(ep_axes) > 1 else M
    wi = p["wi"].view(n, E // n, d, f)
    wg = p["wg"].view(n, E // n, d, f)
    if wshard == "ff":
        Dn = mesh.shape["data"]
        return wi, wg, p["wo"].view(M, E // M, Dn, f // Dn, d)
    return wi, wg, p["wo"].view(n, E // n, f, d)


def _experts(p, buf, mesh, ep_axes, wshard):
    """Every slot's (E, C, d) dispatch buffer through the experts and back:
    (G, E, C, d) -> (G, E, C, d), G the slots in ``_slot_axes`` order.
    The exchange runs over the trailing group of axes (("data", "model")
    for full-mesh EP, "model" else): slot j of a group owns experts
    j·E/g .. (j + 1)·E/g and receives them from every slot of its group,
    concatenated along capacity in the senders' order (the reference's
    tiled ``all_to_all``, split over experts, concatenated over capacity);
    the way back is the inverse."""
    G, E, C, d = buf.shape
    M = mesh.shape["model"]
    Dn = mesh.shape.get("data", 1)
    g = M * Dn if len(ep_axes) > 1 else M          # an exchange group
    O = G // g                                     # groups
    El = E // g
    f = p["wi"].shape[-1]
    slots = _slot_axes(mesh)
    outer = tuple(ax for ax in slots if ax not in ep_axes) or None
    per_slot = buf.numel() * buf.element_size() // G
    recv = buf.reshape(O, g, g, El, C, d).permute(0, 2, 3, 1, 4, 5)
    recv = meshes.exchange(recv.reshape(O, g, El, g * C, d),
                           (outer, ep_axes, None, None, None),
                           [("all-to-all", per_slot, g)])  # (group, owner)
    wi, wg, wo = owner_weights(p, mesh, ep_axes, wshard)
    if wshard == "ff":
        # tokens gathered over the data axis (every data slot of a model
        # column sees them all), the FFN columns split over data: each
        # slot's partial output over its columns, summed over data (the
        # psum), each slot keeping its own tokens
        O2 = O // Dn
        Cg = Dn * g * C
        rest = tuple(ax for ax in slots if ax not in ("data", "model")) \
            or None
        bufg = recv.reshape(O2, Dn, M, El, g * C, d).permute(
            0, 2, 3, 1, 4, 5).reshape(O2, M, El, Cg, d)
        bufg = meshes.exchange(bufg, (rest, "model", None, None, None),
                               [("all-gather", Dn * per_slot, Dn)])
        h = F.silu(torch.einsum("omecd,medf->omecf", bufg, wi))
        h = h * torch.einsum("omecd,medf->omecf", bufg, wg)
        h = h.reshape(O2, M, El, Cg, Dn, f // Dn)
        part = torch.einsum("omecnf,menfd->onmecd", h, wo)
        outg = meshes.exchange(part.sum(dim=1),    # (O2, M, El, Cg, d)
                               (rest, "model", None, None, None),
                               [("all-reduce", Dn * per_slot, Dn)])
        out = outg.reshape(O2, M, El, Dn, g * C, d).permute(0, 3, 1, 2, 4, 5)
        out = out.reshape(O, g, El, g * C, d)
    else:
        h = F.silu(torch.einsum("ojecd,jedf->ojecf", recv, wi))
        h = h * torch.einsum("ojecd,jedf->ojecf", recv, wg)
        out = torch.einsum("ojecf,jefd->ojecd", h, wo)
    back = out.reshape(O, g, El, g, C, d).permute(0, 3, 1, 2, 4, 5)
    return meshes.exchange(back.reshape(G, E, C, d),
                           (slots, None, None, None),
                           [("all-to-all", per_slot, g)])


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
