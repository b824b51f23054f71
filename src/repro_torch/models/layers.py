"""Transformer building blocks: norms, RoPE, GQA/flash attention, MLP.

All functions are pure but ``cache_update``, which writes in place (see
there); parameters come in as dicts of tensors created from the spec
trees in this module.  Softmax/norm math runs in f32; matmuls run in the
config compute dtype.

Attention uses a per-head (B, S, H, D) layout with KV heads explicitly
expanded to H, as in the reference package.  The reference pins logical
shardings with ``distributed.meshes.constrain``, a no-op without a mesh;
the port has no mesh, so those calls are dropped.

Sequences longer than ``flash_block`` take ``flash_attention``, which on
a CUDA tensor is the hand-written kernel K9 (``kernels.flashattn``); in
training (``mode="train"``, the same routing as prefill: dense up to
``flash_block``, flash beyond it) q, k and v require grad, so the kernel
runs as ``FlashAttention``, whose backward is the kernel K9-bwd.  On a CPU
tensor autograd differentiates the plain version.
Cross-attention (VLM) is a dense f32 softmax over the image tokens, with
no mask, computed outside any kernel as the reference computes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flashattn as _fa
from repro_torch.models.params import P

NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions broadcastable to (..., S).
    The two halves of D are rotated against each other (no pair
    interleaving), as the reference does."""
    d = x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * inv           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def expand_kv(k, H: int):
    """(B, S, KV, D) -> (B, S, H, D): head h reads KV head h // (H/KV)."""
    KV = k.shape[2]
    if KV == H:
        return k
    return torch.repeat_interleave(k, H // KV, dim=2)


# ---------------------------------------------------------------------------
# Attention cores (per-head layout)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool, block: int,
                    q_positions=None, kv_positions=None, scale=None):
    """Memory-bounded attention, online softmax over KV blocks.

    q: (B, Sq, H, Dq); k: (B, Skv, H, Dq); v: (B, Skv, H, Dv).
    Returns (B, Sq, H, Dv) in q.dtype.  On a CUDA tensor this is the K9
    kernel (which tiles by its own blocks and takes no position vectors);
    on a CPU tensor the reference's scan over ``block``-row KV blocks.
    """
    Skv = k.shape[1]
    block = min(block, Skv)
    assert Skv % block == 0, (Skv, block)
    return _fa.flash_attention(q, k, v, causal=causal, block=block,
                               q_positions=q_positions,
                               kv_positions=kv_positions, scale=scale)


def causal_attention(q, k, v, *, flash_block: int, scale=None):
    """Full-sequence causal attention, flash-scanned beyond flash_block."""
    B, S, H, Dq = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    if S > flash_block:
        return flash_attention(q, k, v, causal=True, block=flash_block,
                               scale=scale)
    s = torch.einsum("bqhd,bthd->bqht", q.float(), k.float()) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                 device=q.device))[None, :, None, :]
    s = torch.where(mask, s, NEG_INF)
    o = torch.einsum("bqht,bthd->bqhd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype)


def _valid(positions, Sc, device):
    return torch.arange(Sc, device=device)[None, :] <= positions[:, None]


def decode_attention(q, k, v, positions, *, scale=None):
    """q: (B,1,H,Dq) against cache k/v: (B,Sc,H,D*); positions: (B,)."""
    Sc, Dq = k.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    s = torch.einsum("bqhd,bthd->bqht", q.float(), k.float()) * scale
    valid = _valid(positions, Sc, q.device)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    o = torch.einsum("bqht,bthd->bqhd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype)


def decode_attention_gqa(q, ck, cv, positions, *, groups: int, scale=None):
    """Grouped decode attention without expanding the KV cache to H heads:
    q (B,1,H,D) reshaped to (B,KV,G,D) against cache (B,S,KV,D); head h
    reads KV head h // G.  The reference multiplies the cache's type with
    an f32 result (``preferred_element_type``); here both products widen
    their operands to f32 first, which gives the same exact products of
    bf16 values, summed in f32.  As in the reference, the softmax is cast
    to the cache's type before P·V."""
    B, _, H, Dq = q.shape
    Sc = ck.shape[1]
    KV = H // groups
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    ck = ck.reshape(B, Sc, KV, Dq)
    cv = cv.reshape(B, Sc, KV, Dq)
    qg = q.reshape(B, KV, groups, Dq)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) * scale
    valid = _valid(positions, Sc, q.device)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p.float(), cv.float())
    return o.reshape(B, 1, H, Dq).to(q.dtype)


def cache_update(cache, new, positions):
    """Write (B,1,...) entries into (B,S,...) caches at per-example pos.

    The reference rewrites the whole cache through a mask; this writes
    the B entries **in place** and returns ``cache`` itself, which is the
    same function without rewriting every layer's cache each step.  A row
    whose position lies outside [0, S) is left as it is, as the mask
    leaves it (its slot 0 is written back with its own value, so nothing
    waits on the host).
    """
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    inside = (positions >= 0) & (positions < S)
    at = torch.where(inside, positions, 0).to(torch.long)
    keep = inside.reshape((B,) + (1,) * (cache.ndim - 2))
    cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype),
                                  cache[rows, at])
    return cache


# ---------------------------------------------------------------------------
# Self-attention layer (GQA, optional qk-norm)
# ---------------------------------------------------------------------------

def attn_specs(cfg):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": P((d, H * hd), ("embed", "heads")),
        "wk": P((d, KV * hd), ("embed", "kv")),
        "wv": P((d, KV * hd), ("embed", "kv")),
        "wo": P((H * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = P((hd,), ("head_dim",), "ones")
        s["k_norm"] = P((hd,), ("head_dim",), "ones")
    return s


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def attention(p, x, cfg, *, positions, mode: str, cache=None):
    """Self-attention for 'train' / 'prefill' / 'decode'.

    Returns (y, new_cache): {} for train, full-sequence KV for prefill,
    updated KV for decode (the cache's own tensors, written in place).
    """
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, _ = x.shape
    q = _split_heads(x @ p["wq"], H, hd)                          # (B,S,H,hd)
    k = _split_heads(x @ p["wk"], KV, hd)
    v = _split_heads(x @ p["wv"], KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    rope_pos = positions[:, None] if mode == "decode" else positions
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)

    if mode in ("train", "prefill"):
        o = causal_attention(q, expand_kv(k, H), expand_kv(v, H),
                             flash_block=cfg.flash_block)
        o = o.reshape(B, S, H * hd)
        if mode == "prefill":
            new_cache = {"k": k.reshape(B, S, KV * hd),
                         "v": v.reshape(B, S, KV * hd)}
        else:
            new_cache = {}
    else:
        ck = cache_update(cache["k"], k.reshape(B, 1, KV * hd), positions)
        cv = cache_update(cache["v"], v.reshape(B, 1, KV * hd), positions)
        o = decode_attention_gqa(q, ck, cv, positions, groups=H // KV)
        o = o.reshape(B, 1, H * hd)
        new_cache = {"k": ck, "v": cv}
    y = o @ p["wo"]
    return y, new_cache


def cross_attn_specs(cfg):
    s = attn_specs(cfg)
    s.pop("q_norm", None), s.pop("k_norm", None)
    return s


def cross_attention(p, x, image_embeds, cfg, *, mode: str, cache=None):
    """Gated cross-attention over image patch embeddings (VLM).  KV is
    position-free: prefill projects ``image_embeds`` (B, T, d) into the
    (B, T, KV, hd) ``xk`` / ``xv`` cache, decode reads it unchanged (and
    returns the cache's own tensors).  The gates are the caller's
    (``transformer._apply_slot``)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S, _ = x.shape
    q = _split_heads(x @ p["wq"], H, hd)
    if mode == "decode":
        k, v = cache["xk"], cache["xv"]
        new_cache = cache
    else:
        img = image_embeds.to(x.dtype)
        k = _split_heads(img @ p["wk"], KV, hd)
        v = _split_heads(img @ p["wv"], KV, hd)
        new_cache = {"xk": k, "xv": v} if mode == "prefill" else {}
    kh, vh = expand_kv(k, H), expand_kv(v, H)
    s = torch.einsum("bqhd,bthd->bqht", q.float(), kh.float()) / math.sqrt(hd)
    o = torch.einsum("bqht,bthd->bqhd", torch.softmax(s, dim=-1),
                     vh.float()).to(x.dtype)
    y = o.reshape(B, S, H * hd) @ p["wo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg, ff: int):
    d = cfg.d_model
    s = {
        "wi": P((d, ff), ("embed", "mlp")),
        "wo": P((ff, d), ("mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        s["wg"] = P((d, ff), ("embed", "mlp"))
    return s


def mlp_apply(p, x):
    if "wg" in p:
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
