"""Composable decoder: layer segments, a loop over periods, caches.

The layer stack is a list of *segments*; each segment is a period of
heterogeneous *slots* (mixer + ffn) repeated ``n`` times, with every
parameter and cache stacked along a leading ``(n, ...)`` layer axis, as in
the reference package.  The reference runs a segment with ``lax.scan``;
here it is a loop over that axis.

Ported mixers: self-attention ('A'), which covers the dense family
(qwen3-4b, deepseek-7b, command-r-35b, granite-20b, repro-100m) and
musicgen-large's backbone (embedding inputs), or, where the config has
``mla``, multi-head latent attention in its place (``models.mla``:
deepseek-v3-671b, with the MoE); Mamba2 ('M', ``models.ssm``:
mamba2-1.3b, and jamba-1.5-large-398b with 'A' and MoE); and gated
cross-attention over image embeddings ('X': llama-3.2-vision-11b), whose
mixer and feed-forward outputs are scaled by ``tanh`` of the slot's scalar
gates.  The feed-forward is an MLP or an MoE (``models.moe``: dbrx-132b),
whose load-balance aux is summed as the reference's scan carry sums it
(see ``_run_segment``).

Caches, per slot kind: 'A' keeps the flattened (B, S, KV·hd) K and V (an
MLA slot the latent ``ckv`` (B, S, kv_lora_rank) and the rotated ``kpe``
(B, S, qk_rope_dim)); 'M'
the last ``d_conv - 1`` conv inputs and the (B, H, P, N) state; 'X' the
projected image K and V, (B, T, KV, hd).  Decode writes them in place.

``mode="train"`` takes each layer's parameters as views of one
``torch.unbind`` of the stacked leaves (so autograd stacks the layers'
gradients once, not one full-size zero tensor per layer), and with
``cfg.remat`` runs each layer under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: only the
layer's input is kept, and the backward runs the layer again (an MoE
layer routes again, to the same experts: routing is a function of the
layer's input alone; the layer runs again under the mesh and rules its
forward ran under, so an MoE layer takes the same path) — the
counterpart of the reference's ``jax.checkpoint(body,
policy=nothing_saveable)`` around its scan body.  Prefill and decode
ignore ``cfg.remat``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.meshes import active_ctx, constrain, under_ctx
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import (P, abstract_tree, axes_tree,
                                       init_tree, stacked)


class Slot(NamedTuple):
    kind: str            # 'A' | 'M' | 'X'
    ffn: str             # 'mlp' | 'moe' | 'none'
    ff: int              # mlp hidden size (unused for moe/none)


class Segment(NamedTuple):
    slots: tuple
    n: int


def build_segments(cfg: ModelConfig) -> list[Segment]:
    kinds = cfg.pattern_layers()

    def slot_for(i):
        kind = kinds[i]
        if kind == "M" and cfg.family == "ssm":
            return Slot(kind, "none", 0)
        if cfg.is_moe_layer(i):
            return Slot(kind, "moe", 0)
        ff = (cfg.dense_prefix_ff
              if (cfg.moe is not None and i < cfg.dense_prefix
                  and cfg.dense_prefix_ff) else cfg.d_ff)
        return Slot(kind, "mlp", ff)

    segs = []
    start = 0
    if cfg.dense_prefix:
        slots = tuple(slot_for(i) for i in range(cfg.dense_prefix))
        assert len(set(slots)) == 1, "dense prefix must be homogeneous"
        segs.append(Segment((slots[0],), cfg.dense_prefix))
        start = cfg.dense_prefix
    rest = cfg.num_layers - start
    if rest == 0:
        # a config cut to its dense prefix (deepseek-v3-671b's 3 dense
        # layers, trained on the card at published widths): no second
        # segment.  The reference's build_segments indexes past the
        # pattern here and raises IndexError.
        return segs
    period = math.lcm(len(cfg.layer_pattern),
                      cfg.moe.every_k_layers if cfg.moe else 1)
    assert rest % period == 0, (cfg.name, rest, period)
    slots = tuple(slot_for(start + j) for j in range(period))
    # verify periodicity
    for i in range(start, cfg.num_layers):
        assert slot_for(i) == slots[(i - start) % period], (cfg.name, i)
    segs.append(Segment(slots, rest // period))
    return segs


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _mixer_specs(cfg, slot: Slot):
    if slot.kind == "A":
        return mla_mod.mla_specs(cfg) if cfg.mla is not None \
            else L.attn_specs(cfg)
    if slot.kind == "M":
        return ssm_mod.ssm_specs(cfg)
    if slot.kind == "X":
        return L.cross_attn_specs(cfg)
    raise ValueError(slot.kind)


def _slot_specs(cfg, slot: Slot):
    d = cfg.d_model
    s = {"norm1": P((d,), ("embed",), "ones"),
         "mixer": _mixer_specs(cfg, slot)}
    if slot.kind == "X":
        s["gate_attn"] = P((), (), "zeros")
        s["gate_ffn"] = P((), (), "zeros")
    if slot.ffn == "mlp":
        s["norm2"] = P((d,), ("embed",), "ones")
        s["ffn"] = L.mlp_specs(cfg, slot.ff)
    elif slot.ffn == "moe":
        s["norm2"] = P((d,), ("embed",), "ones")
        s["ffn"] = moe_mod.moe_specs(cfg)
    return s


def param_specs(cfg: ModelConfig):
    d = cfg.d_model
    specs = {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), scale=0.02),
        "final_norm": P((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P((d, cfg.vocab_size), ("embed", "vocab"))
    specs["segments"] = [
        {f"slot{j}": stacked(_slot_specs(cfg, slot), seg.n)
         for j, slot in enumerate(seg.slots)}
        for seg in build_segments(cfg)
    ]
    return specs


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _slot_cache_spec(cfg, slot: Slot, B: int, S: int):
    f = _dtype(cfg.compute_dtype)
    if slot.kind == "A":
        if cfg.mla is not None:
            m = cfg.mla
            return {"ckv": ((B, S, m.kv_lora_rank),
                            ("batch", "kv_seq", "lora"), f),
                    "kpe": ((B, S, m.qk_rope_dim),
                            ("batch", "kv_seq", None), f)}
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        # flattened (kv*hd) layout, as the reference's
        return {"k": ((B, S, kv * hd), ("batch", "kv_seq", "kv"), f),
                "v": ((B, S, kv * hd), ("batch", "kv_seq", "kv"), f)}
    if slot.kind == "M":
        s = cfg.ssm
        conv_dim = cfg.d_inner + 2 * s.n_groups * s.d_state
        return {"conv": ((B, s.d_conv - 1, conv_dim), ("batch", None, "mlp"), f),
                "ssm": ((B, cfg.ssm_heads, s.head_dim, s.d_state),
                        ("batch", "heads", None, "state"), f)}
    if slot.kind == "X":
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        T = cfg.num_image_tokens
        return {"xk": ((B, T, kv, hd), ("batch", "img", "kv", "head_dim"), f),
                "xv": ((B, T, kv, hd), ("batch", "img", "kv", "head_dim"), f)}
    raise ValueError(slot.kind)


def cache_specs(cfg: ModelConfig, B: int, S: int):
    """Returns (tree of (shape, dtype), tree of axes) for the decode
    cache, one dict per segment with stacked leaves."""
    shapes, axes = [], []
    for seg in build_segments(cfg):
        sh, ax = {}, {}
        for j, slot in enumerate(seg.slots):
            spec = _slot_cache_spec(cfg, slot, B, S)
            sh[f"slot{j}"] = {k: ((seg.n,) + s, d)
                              for k, (s, a, d) in spec.items()}
            ax[f"slot{j}"] = {k: ("layers",) + a
                              for k, (s, a, d) in spec.items()}
        shapes.append(sh)
        axes.append(ax)
    return shapes, axes


def init_cache(cfg: ModelConfig, B: int, S: int, device=None):
    """Zero caches for ``B`` sequences of capacity ``S`` on ``device``
    (``None`` means CUDA, see ``repro_torch.device``)."""
    dev = _device.resolve(device)
    shapes, _ = cache_specs(cfg, B, S)
    return [{slot: {k: torch.zeros(shape, dtype=dt, device=dev)
                    for k, (shape, dt) in leaves.items()}
             for slot, leaves in seg.items()} for seg in shapes]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_slot(cfg, slot: Slot, p, x, *, positions, mode, cache,
                image_embeds):
    """(x, new cache, aux): aux is the MoE layer's load-balance metric,
    None for a slot without MoE."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    aux = None
    if slot.kind == "A":
        fn = mla_mod.mla_attention if cfg.mla is not None else L.attention
        y, nc = fn(p["mixer"], h, cfg, positions=positions, mode=mode,
                   cache=cache)
    elif slot.kind == "M":
        y, nc = ssm_mod.mamba_mixer(p["mixer"], h, cfg, mode=mode,
                                    cache=cache)
    else:
        y, nc = L.cross_attention(p["mixer"], h, image_embeds, cfg,
                                  mode=mode, cache=cache)
        y = y * torch.tanh(p["gate_attn"]).to(y.dtype)
    x = x + y
    if slot.ffn != "none":
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        if slot.ffn == "moe":
            f, aux = moe_mod.moe_apply(p["ffn"], h2, cfg)
        else:
            f = L.mlp_apply(p["ffn"], h2)
        if slot.kind == "X":
            f = f * torch.tanh(p["gate_ffn"]).to(f.dtype)
        x = x + f
    return x, nc, aux


def _layer(tree, i):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree: views from one ``torch.unbind``
    per leaf."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _remat_slot(ctx, cfg, slot, p, x, positions, image_embeds):
    """``_train_slot`` under the (mesh, rules) of the forward's call."""
    with under_ctx(ctx):
        return _train_slot(cfg, slot, p, x, positions, image_embeds)


def _train_slot(cfg, slot: Slot, p, x, positions, image_embeds):
    x, _, aux = _apply_slot(cfg, slot, p, x, positions=positions,
                            mode="train", cache=None,
                            image_embeds=image_embeds)
    return x, aux


def _plus(total, aux):
    """The running aux sum; None stands for 0 (no MoE layer yet), so a
    model without MoE adds nothing per layer."""
    return aux if total is None else (total if aux is None else total + aux)


def _run_segment(cfg, seg: Segment, seg_params, x, *, positions, mode,
                 caches, image_embeds):
    """The reference's scan over the segment's stacked layers, as a loop.
    Decode caches are written in place; prefill caches are stacked.
    Returns (x, caches, aux): aux summed over the periods in order, as the
    reference's scan carry sums it — each period adds the aux of its
    *last* slot only (None where that slot has no MoE), since the
    reference's loop over a period's slots overwrites ``aux`` before the
    carry adds it.  In a one-slot period (dbrx-132b) that is every MoE
    layer; jamba-1.5-large-398b's period of eight adds slot 7's and drops
    slots 1, 3 and 5's (ROADMAP queue 3)."""
    aux_sum = None
    if mode == "train":
        layers = {f"slot{j}": _unbind(seg_params[f"slot{j}"], seg.n)
                  for j in range(len(seg.slots))}
        for i in range(seg.n):
            for j, slot in enumerate(seg.slots):
                p = layers[f"slot{j}"][i]
                if cfg.remat:
                    x, aux = checkpoint(_remat_slot, active_ctx(), cfg,
                                        slot, p, x, positions, image_embeds,
                                        use_reentrant=False)
                else:
                    x, aux = _train_slot(cfg, slot, p, x, positions,
                                         image_embeds)
            aux_sum = _plus(aux_sum, aux)       # the period's last slot's
        return x, {}, aux_sum
    new = {f"slot{j}": [] for j in range(len(seg.slots))}
    for i in range(seg.n):
        for j, slot in enumerate(seg.slots):
            name = f"slot{j}"
            c = _layer(caches[name], i) if caches is not None else None
            x, nc, aux = _apply_slot(cfg, slot, _layer(seg_params[name], i),
                                     x, positions=positions, mode=mode,
                                     cache=c, image_embeds=image_embeds)
            new[name].append(nc)
        aux_sum = _plus(aux_sum, aux)           # the period's last slot's
    if mode == "decode":
        return x, caches, aux_sum
    return x, {name: {k: torch.stack([c[k] for c in per_layer])
                      for k in (per_layer[0] if per_layer else {})}
               for name, per_layer in new.items()}, aux_sum


def forward(cfg: ModelConfig, params, inputs, *, mode: str,
            positions=None, caches=None, image_embeds=None):
    """Full decoder forward.

    mode='train'/'prefill': inputs (B,S) ids or (B,S,d) embeddings.
    mode='decode': inputs (B,1)/(B,1,d), positions (B,), caches required
    (written in place and returned).
    ``image_embeds`` (B, T, d), cast to the compute dtype, feeds every
    cross-attention slot in train and prefill.
    Returns (logits, new_caches, aux); aux is the MoE layers' summed
    load-balance metric (0 without MoE).
    """
    f = _dtype(cfg.compute_dtype)
    embed = params["embed"]
    inputs = torch.as_tensor(inputs, device=embed.device)
    if cfg.input_mode == "embeddings" and inputs.ndim == 3:
        x = inputs.to(f)
    else:
        # jnp.take clamps out-of-range ids; torch would raise
        x = embed[inputs.long().clamp(0, embed.shape[0] - 1)].to(f)
    S = x.shape[1]
    x = constrain(x, "batch", "seq", None)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    positions = torch.as_tensor(positions, device=x.device)
    if image_embeds is not None:
        image_embeds = torch.as_tensor(image_embeds, device=x.device).to(f)

    segs = build_segments(cfg)
    new_caches = []
    aux_total = None
    for i, seg in enumerate(segs):
        c = caches[i] if caches is not None else None
        x, nc, aux = _run_segment(cfg, seg, params["segments"][i], x,
                                  positions=positions, mode=mode, caches=c,
                                  image_embeds=image_embeds)
        new_caches.append(nc)
        aux_total = _plus(aux_total, aux)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, embed.to(f))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"].to(f))
    logits = constrain(logits, "batch", "seq", "vocab")
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, (new_caches if mode != "train" else None), aux_total


# ---------------------------------------------------------------------------
# Public model handle
# ---------------------------------------------------------------------------

class Model:
    """A thin handle over a parameter tree: ``init`` draws one, calling
    the model runs ``forward``."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = param_specs(cfg)

    def init(self, seed: int = 0, device=None):
        """Parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (``None`` means CUDA)."""
        dev = _device.resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_tree(self.specs, gen, _dtype(self.cfg.param_dtype), dev)

    def abstract_params(self):
        """The parameter tree as meta tensors (no storage anywhere)."""
        return abstract_tree(self.specs, _dtype(self.cfg.param_dtype))

    def param_axes(self):
        return axes_tree(self.specs)

    def __call__(self, params, inputs, **kw):
        return forward(self.cfg, params, inputs, **kw)
