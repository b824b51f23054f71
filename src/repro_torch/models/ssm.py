"""Mamba2 / SSD (state-space duality) mixer.

The reference package's ``repro.models.ssm``.  Training and prefill use
the chunked SSD algorithm (an attention-like quadratic term inside each
chunk plus a state recurrence across chunks); decode is the O(1)
recurrent state update.  Follows Dao & Gu 2024 (arXiv:2405.21060).

The reference's order and dtypes are kept: the products of the scan take
B, C and dt·x in f32 (so the config's compute dtype reaches them only
through their inputs), the inclusive cumsums and the masked segment sums
are f32, and ``y`` and the final state are cast back to the inputs'
dtype.  Its einsums are kept as written: contracted left to right, each
forms C·Bᵀ (or B·decay, C·state) first and never a tensor larger than the
(B, Cn, H, Q, Q) decay matrix.  Its ``lax.scan`` over chunks is a loop
over them, which autograd differentiates.  ``_causal_conv`` is the reference's sum of K shifted
products in x's dtype, not ``F.conv1d``, whose bf16 accumulation differs.
A decode step writes the ``conv`` and ``ssm`` caches it is given in place
and has no host sync and no shape that depends on data, so it can be
captured in a CUDA graph (``serve.batching.GraphedDecode``).  The
reference's ``constrain`` calls pin shardings and are no-ops without a
mesh; they are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.params import P

NEG_INF = -1e30
_F32 = torch.float32


def ssm_specs(cfg):
    s, d = cfg.ssm, cfg.d_model
    di = cfg.d_inner
    g = s.n_groups * s.d_state
    H = cfg.ssm_heads
    conv_dim = di + 2 * g
    return {
        "wz": P((d, di), ("embed", "mlp")),
        "wxbc": P((d, conv_dim), ("embed", "mlp")),
        "wdt": P((d, H), ("embed", "heads")),
        "conv_w": P((s.d_conv, conv_dim), ("conv", "mlp"), scale=0.2),
        "conv_b": P((conv_dim,), ("mlp",), "zeros"),
        "a_log": P((H,), ("heads",), "a_log"),
        "d_skip": P((H,), ("heads",), "ones"),
        "dt_bias": P((H,), ("heads",), "dt_bias"),
        "norm": P((di,), ("mlp",), "ones"),
        "out": P((di, d), ("mlp", "embed")),
    }


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q); out[i,j] = sum_{j<k<=i} x[k], NEG_INF
    for i<j."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, NEG_INF)


def _pad_seq(t, pad: int):
    """``t`` with ``pad`` zero steps appended along axis 1."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def ssd_chunked(xs, dt, A, B_, C_, chunk: int, init_state=None):
    """Chunked SSD scan.

    xs: (B,L,H,P) inputs; dt: (B,L,H) f32; A: (H,) negative; B_,C_: (B,L,H,N)
    (already broadcast from groups to heads).  Returns (y (B,L,H,P),
    final_state (B,H,P,N)), both in xs's dtype.
    """
    Bb, L, H, Pd = xs.shape
    N = B_.shape[-1]
    if L % chunk:
        # pad with dt=0 steps: zero contribution, unit decay — exact
        pad = chunk - L % chunk
        y, final = ssd_chunked(_pad_seq(xs, pad), _pad_seq(dt, pad), A,
                               _pad_seq(B_, pad), _pad_seq(C_, pad), chunk,
                               init_state)
        return y[:, :L], final
    Cn, Q = L // chunk, chunk

    def r(t):
        return t.reshape((Bb, Cn, Q) + tuple(t.shape[2:]))

    xc, dtc, Bc, Cc = r(xs), r(dt), r(B_).to(_F32), r(C_).to(_F32)
    dA = (dtc * A[None, None, None, :]).movedim(-1, 2)           # (B,Cn,H,Q)
    cs = torch.cumsum(dA, dim=-1)                                # inclusive

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA))                                # (B,Cn,H,Q,Q)
    dtx = (xc * dtc[..., None]).to(_F32)                         # (B,Cn,Q,H,P)
    Ydiag = torch.einsum("bcqhn,bcshn,bchqs,bcshp->bcqhp", Cc, Bc, Lmat, dtx)

    # end-of-chunk states
    decay = torch.exp(cs[..., -1:] - cs)                         # (B,Cn,H,Q)
    states = torch.einsum("bcshn,bchs,bcshp->bchpn", Bc, decay, dtx)

    # inter-chunk recurrence: the state entering each chunk
    total = torch.exp(cs[..., -1])                               # (B,Cn,H)
    s = (torch.zeros((Bb, H, Pd, N), dtype=_F32, device=xs.device)
         if init_state is None else init_state.to(_F32))
    prev = []
    for c in range(Cn):
        prev.append(s)
        s = states[:, c] + total[:, c, :, None, None] * s
    prev_states = torch.stack(prev, 1)                           # (B,Cn,H,P,N)

    Yoff = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cc, prev_states,
                        torch.exp(cs))
    y = (Ydiag + Yoff).reshape(Bb, L, H, Pd)
    return y.to(xs.dtype), s.to(xs.dtype)


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B,L,C), w (K,C) -> (B,L,C), a sum of K
    shifted products in x's dtype, in the reference's order."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    return y + b[None, None, :]


def _expand_groups(t, H: int):
    """(B,...,G,N) -> (B,...,H,N): head h reads group h // (H/G)."""
    G = t.shape[-2]
    return torch.repeat_interleave(t, H // G, dim=-2)


def mamba_mixer(p, x, cfg, *, mode: str, cache=None):
    """Mamba2 block mixer.  x: (B,S,d).  Returns (y, new_cache): {} for
    train; for prefill the last ``d_conv - 1`` rows of the conv input and
    the final state (a prompt shorter than that gives fewer rows, as the
    reference's slice does); for decode the given caches, written in
    place."""
    s = cfg.ssm
    B, S, d = x.shape
    di, H, Pd, N, G = cfg.d_inner, cfg.ssm_heads, s.head_dim, s.d_state, s.n_groups
    gdim = G * N

    z = x @ p["wz"]                                              # (B,S,di)
    xbc_raw = x @ p["wxbc"]                                      # (B,S,di+2g)
    dt_raw = x @ p["wdt"]                                        # (B,S,H)
    A = -torch.exp(p["a_log"].to(_F32))

    if mode in ("train", "prefill"):
        xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
        xs = xbc[..., :di].reshape(B, S, H, Pd)
        B_ = _expand_groups(xbc[..., di:di + gdim].reshape(B, S, G, N), H)
        C_ = _expand_groups(xbc[..., di + gdim:].reshape(B, S, G, N), H)
        dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"].to(_F32))
        y, final = ssd_chunked(xs, dt, A, B_, C_, min(s.chunk, S))
        y = y + p["d_skip"].to(x.dtype)[None, None, :, None] * xs
        y = y.reshape(B, S, di)
        if mode == "prefill":
            # Python's slice from a negative start: S < d_conv - 1 keeps
            # the S rows there are
            conv_cache = xbc_raw[:, S - (s.d_conv - 1):, :]      # (B,K-1,C)
            new_cache = {"conv": conv_cache, "ssm": final}
        else:
            new_cache = {}
    else:                                                        # decode, S == 1
        conv_cache, state = cache["conv"], cache["ssm"]
        full = torch.cat([conv_cache, xbc_raw], dim=1)           # (B,K,C)
        conv_out = torch.einsum("bkc,kc->bc", full, p["conv_w"]) + p["conv_b"]
        xbc = F.silu(conv_out)                                   # (B,C)
        xs = xbc[..., :di].reshape(B, H, Pd)
        B_ = _expand_groups(xbc[..., di:di + gdim].reshape(B, G, N), H)
        C_ = _expand_groups(xbc[..., di + gdim:].reshape(B, G, N), H)
        dt = F.softplus(dt_raw[:, 0].to(_F32)
                        + p["dt_bias"].to(_F32))                 # (B,H)
        dA = torch.exp(dt * A[None, :])                          # (B,H)
        new_state = (state.to(_F32) * dA[..., None, None]
                     + torch.einsum("bh,bhp,bhn->bhpn", dt, xs.to(_F32),
                                    B_.to(_F32)))
        y = torch.einsum("bhpn,bhn->bhp", new_state, C_.to(_F32))
        y = y.to(x.dtype) + p["d_skip"].to(x.dtype)[None, :, None] * xs
        y = y.reshape(B, 1, di)
        # ``full`` and ``new_state`` are new tensors: the caches can be
        # overwritten in place
        conv_cache.copy_(full[:, 1:, :])
        state.copy_(new_state.to(x.dtype))
        new_cache = cache

    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out"], new_cache
