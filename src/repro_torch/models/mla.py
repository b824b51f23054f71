"""DeepSeek-V3 Multi-head Latent Attention.

The reference package's ``repro.models.mla``.  Train and prefill expand
the latent to per-head K and V (qk head dim ``qk_nope_dim + qk_rope_dim``,
192 in deepseek-v3, v head dim ``v_dim``, 128) and run
``layers.causal_attention``, which past ``flash_block`` is the kernel K9
at (Dq, Dv) = (192, 128) on a CUDA tensor.  Decode uses the
weight-absorption trick and attends in latent space, so the cache keeps
only ``kv_lora_rank + qk_rope_dim`` values per token (``ckv``, ``kpe``),
written in place by ``layers.cache_update``; the step reads nothing back
to the host, so ``GraphedDecode`` captures it.  The reference's decode
runs no Pallas kernel: its products stay ``torch.einsum``.

The reference's ``constrain`` calls pin shardings and are no-ops without
a mesh; they are dropped.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (NEG_INF, apply_rope, cache_update,
                                       causal_attention, rms_norm)
from repro_torch.models.params import P


def mla_specs(cfg):
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": P((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": P((m.q_lora_rank,), ("lora",), "ones"),
        "wq_b": P((m.q_lora_rank, H * qk), ("lora", "heads")),
        "wkv_a": P((d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "lora")),
        "kv_norm": P((m.kv_lora_rank,), ("lora",), "ones"),
        "wkv_b": P((m.kv_lora_rank, H * (m.qk_nope_dim + m.v_dim)),
                   ("lora", "heads")),
        "wo": P((H * m.v_dim, d), ("heads", "embed")),
    }


def latent_attention(q_abs, q_pe, ckv, kpe, positions, scale: float):
    """Decode attention in latent space: scores q_abs·ckv + q_pe·kpe
    (B, 1, H, Sc), masked past each row's position, softmax, and the
    latent output (B, 1, H, r) in f32.  The reference multiplies the
    cache's type with an f32 result (``preferred_element_type``); here
    every product widens its operands to f32 first, which gives the same
    exact products of bf16 values, summed in f32 — no product is rounded
    to bf16.  As in the reference, the softmax is rounded to the cache's
    type before it weighs ``ckv``."""
    Sc = ckv.shape[1]
    s = (torch.einsum("bqhr,btr->bqht", q_abs.float(), ckv.float())
         + torch.einsum("bqhe,bte->bqht", q_pe.float(), kpe.float())) * scale
    valid = torch.arange(Sc, device=s.device)[None, :] <= positions[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(ckv.dtype)
    return torch.einsum("bqht,btr->bqhr", probs.float(), ckv.float())


def mla_attention(p, x, cfg, *, positions, mode: str, cache=None):
    """MLA for 'train' / 'prefill' / 'decode': (y, new cache) — {} in
    train, the prompt's ``{"ckv", "kpe"}`` in prefill, and in decode the
    cache's own tensors, written in place."""
    m, H = cfg.mla, cfg.num_heads
    B, S, _ = x.shape
    nope, rope_d, vd, r = m.qk_nope_dim, m.qk_rope_dim, m.v_dim, m.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope_d)
    rope_pos = positions[:, None] if mode == "decode" else positions

    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(B, S, H, nope + rope_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, rope_pos, cfg.rope_theta)

    ckv_full = x @ p["wkv_a"]                                   # (B,S,r+rope)
    ckv = rms_norm(ckv_full[..., :r], p["kv_norm"], cfg.norm_eps)
    kpe = apply_rope(ckv_full[..., None, r:], rope_pos, cfg.rope_theta)
    kpe = kpe[..., 0, :]                                        # (B,S,rope)

    wkv_b = p["wkv_b"].reshape(r, H, nope + vd)
    w_k = wkv_b[..., :nope]                                     # (r,H,nope)
    w_v = wkv_b[..., nope:]                                     # (r,H,vd)

    if mode in ("train", "prefill"):
        k_nope = torch.einsum("bsr,rhn->bshn", ckv, w_k)
        v = torch.einsum("bsr,rhv->bshv", ckv, w_v)
        k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, S, H, rope_d)],
                      dim=-1)
        qc = torch.cat([q_nope, q_pe], dim=-1)
        o = causal_attention(qc, k, v, flash_block=cfg.flash_block,
                             scale=scale)
        o = o.reshape(B, S, H * vd)
        new_cache = {"ckv": ckv, "kpe": kpe} if mode == "prefill" else {}
    else:
        cc = cache_update(cache["ckv"], ckv, positions)          # (B,Sc,r)
        ck = cache_update(cache["kpe"], kpe, positions)          # (B,Sc,rope)
        q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, w_k)
        o_lat = latent_attention(q_abs, q_pe, cc, ck, positions, scale)
        o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(x.dtype), w_v)
        o = o.reshape(B, 1, H * vd)
        new_cache = {"ckv": cc, "kpe": ck}
    y = o @ p["wo"]
    return y, new_cache
