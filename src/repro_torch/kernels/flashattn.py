"""Blocked causal flash attention: online softmax over KV tiles.

``flash_attention(q, k, v, causal=, block=)`` on q, k (B, S, H, Dq) and
v (B, S, H, Dv) tensors replaces the reference package's TPU kernel
``flash_attention`` (``src/repro/kernels/flashattn.py``) and, on the
serving path, the XLA scan ``models/layers.flash_attention`` it is held
equal to.  On a CUDA tensor it launches ``flashattn_f32`` /
``flashattn_bf16`` of ``csrc/flashattn.cu`` (compiled at first use, see
``kernels.build``; the source says what bounds it on the card), or
raises: only the head-dim pairs ``HEAD_DIM_PAIRS`` (Dq, Dv) = (64, 64),
(128, 128) and (192, 128) — the last deepseek-v3's latent attention,
``models/mla.py`` — f32 and bf16, q, k and v of one type on one device,
no position vectors.  The bf16 kernel runs both products on the Hopper
tensor cores (``wgmma``) with K and V staged by TMA, and keeps P to f32
grade by splitting it into two bf16 terms; the f32 kernel does both as
f32 FMAs.
Each C entry's arguments are named in ``ENTRY_ARGS``.
On a CPU tensor — and only because the tensor lies on the CPU — it takes
the plain PyTorch version ``flash_attention_plain``.

**Arithmetic contract** (both versions, the reference's): q, k and v are
widened to f32; q is scaled by ``scale`` (default 1/√Dq) before the
product; masked scores are ``NEG_INF`` = -1e30; per KV block the running
max, sum and accumulator are rescaled by exp(m_prev − m_new) and
p = exp(s − m_new) is zeroed where masked; the output is
acc / max(l, 1e-20) in q's type.  Causal masking compares absolute
positions (query i sees keys j <= i, top-left aligned).  The kernel's KV
tiles are its own (128 rows in bf16, 64 in f32); ``block`` sets the plain
version's KV block, as the reference's scan takes it.  Sums run in another
order in the two, so they agree to f32 rounding, not bit for bit; the
bf16 kernel scales S after the product and multiplies V by
P_hi + P_lo, within 2^-17·|P| of the f32 P (far under the output's one
rounding to bf16).

**Training.**  When grad mode is on and q, k or v requires grad, a CUDA
call goes through ``FlashAttention`` (a ``torch.autograd.Function``): its
forward launches K9 with a row statistic, lse = m + log(max(l, 1e-20)) per
(b, h, query row) in f32 at (B, H, Sq), and its backward launches K9-bwd,
``flashattn_bwd_f32`` / ``flashattn_bwd_bf16`` of ``csrc/flashattn_bwd.cu``
(``flash_attention_bwd``; ``launches["flashattn_bwd"]``).  The backward
takes K9's pairs ``HEAD_DIM_PAIRS`` and Sq == Skv only, and raises
``ValueError`` on anything else before any launch.  It computes, from q,
k, v, the output o, dO and lse: S = scale·QKᵀ under the mask,
P = exp(S − lse), Dᵢ = Σ_d dOᵢ·Oᵢ, dV = Pᵀ·dO, dP = dO·Vᵀ,
dS = P ⊙ (dP − Dᵢ), dQ = scale·dS·K, dK = scale·dSᵀ·Q, accumulated in f32
and rounded once to q's type; dq and dk take q's head dim Dq, dv v's Dv.  Three launches, no atomics (the same bits
on every run): the row statistics, then dK and dV per KV tile, then dQ per
Q tile, each recomputing S and dP.  The bf16 kernels run every product on
the Hopper tensor cores (``wgmma``; operands staged by TMA, so q, k, v, o
and dO views TMA cannot read are copied first) with P and dS split into
two bf16 terms, which keeps them to f32 grade; the f32 kernels run them as
three TF32 ``mma.sync`` products of split operands (a_hi·b_hi + a_hi·b_lo
+ a_lo·b_hi), which keeps f32 grade without rounding the inputs.  The
reference has no backward for its TPU kernel; its training path
differentiates the XLA scan ``models/layers.flash_attention`` with
``jax.vjp``, which is what the plain version ``flash_attention_bwd_plain``
is held to in the tests.  On a CPU tensor the training path differentiates
``flash_attention_plain`` by autograd.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as _build

NEG_INF = -1e30

# kernel launches, counted where the kernel is launched and nowhere else
# (plain-version calls do not count)
launches = {"flashattn": 0, "flashattn_bwd": 0}

_ENTRY = {torch.float32: "flashattn_f32", torch.bfloat16: "flashattn_bf16"}
_BWD_ENTRY = {torch.float32: "flashattn_bwd_f32",
              torch.bfloat16: "flashattn_bwd_bf16"}
# K9's and K9-bwd's (Dq, Dv) instances in csrc/flashattn.cu and
# csrc/flashattn_bwd.cu
HEAD_DIM_PAIRS = ((64, 64), (128, 128), (192, 128))
# K9-bwd's row statistics: two f32 planes of (B·H, S rounded up to this)
# (``PAD`` in csrc/flashattn_bwd.cu)
BWD_STAT_ROWS = 128
_BOUND: dict = {}


def reset_launches():
    for k in launches:
        launches[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = (("q", _P), ("k", _P), ("v", _P), ("out", _P), ("B", _I),
             ("H", _I), ("Sq", _I), ("Skv", _I), ("Dq", _I), ("Dv", _I),
             ("strides", _P), ("scale", _F), ("causal", _I), ("stream", _P),
             ("lse", _P))
_BWD_ARGS = (("q", _P), ("k", _P), ("v", _P), ("o", _P), ("dout", _P),
             ("lse", _P), ("stats", _P), ("dq", _P), ("dk", _P), ("dv", _P),
             ("B", _I), ("H", _I), ("S", _I), ("Dq", _I), ("Dv", _I),
             ("strides", _P), ("scale", _F), ("causal", _I), ("stream", _P))
# each C entry's arguments in order, by name and ctypes type: ``_bound``
# binds the types, ``_launch`` orders a call's arguments by the names
ENTRY_ARGS = {"flashattn_f32": _FWD_ARGS, "flashattn_bf16": _FWD_ARGS,
              "flashattn_bwd_f32": _BWD_ARGS, "flashattn_bwd_bf16": _BWD_ARGS}


def _bound(name: str, entries):
    """The kernel library ``name``, its ``entries`` bound to their
    ``ENTRY_ARGS`` types; the first call builds every library of the
    package."""
    if name not in _BOUND:
        lib = _build.load_all(_build.SOURCES)[name]
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = [t for _, t in ENTRY_ARGS[entry]]
            fn.restype = ctypes.c_int
        _BOUND[name] = lib
    return _BOUND[name]


def _lib():
    """The ``flashattn`` kernel library, bound."""
    return _bound("flashattn", _ENTRY.values())


def _bwd_lib():
    """The ``flashattn_bwd`` kernel library, bound."""
    return _bound("flashattn_bwd", _BWD_ENTRY.values())


def _launch(lib, entry: str, **args):
    """``entry`` of ``lib`` on the arguments named in ``ENTRY_ARGS``;
    raises ``KernelError`` on a non-zero return."""
    err = getattr(lib, entry)(*(args[name] for name, _ in ENTRY_ARGS[entry]))
    if err != 0:
        raise _build.KernelError(f"{entry} launch failed: CUDA error {err}")


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention takes (B, S, H, D) tensors: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, Dq = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, Dq) or \
            tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, Sq, H, Dq), "
                         f"(B, Skv, H, Dq), (B, Skv, H, Dv)")
    return B, Sq, H, Dq, k.shape[1], v.shape[3]


def flash_attention_plain(q, k, v, *, causal: bool, block=None,
                          q_positions=None, kv_positions=None, scale=None,
                          return_lse: bool = False):
    """Plain PyTorch version: the reference's scan over KV blocks of
    ``block`` rows (all of Skv when None), transcribed.  q (B, Sq, H, Dq),
    k (B, Skv, H, Dq), v (B, Skv, H, Dv) -> (B, Sq, H, Dv) in q's type;
    with ``return_lse`` also the row statistic the kernel writes for its
    backward, m + log(max(l, 1e-20)), f32 (B, H, Sq)."""
    B, Sq, H, Dq, Skv, Dv = _shapes(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    block = Skv if block is None else min(block, Skv)
    assert Skv % block == 0, (Skv, block)
    qf = q.float() * scale
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, H, Dv), dtype=torch.float32, device=dev)
    for start in range(0, Skv, block):
        kblk = k[:, start:start + block].float()
        vblk = v[:, start:start + block].float()
        pblk = kv_positions[start:start + block]
        s = torch.einsum("bqhd,bthd->bqht", qf, kblk)
        if causal:
            mask = (q_positions[:, None] >= pblk[None, :])[None, :, None, :]
        else:
            mask = torch.ones((1, 1, 1, block), dtype=torch.bool, device=dev)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqht,bthd->bqhd", p,
                                                    vblk)
        m = m_new
    den = torch.clamp(l, min=1e-20)
    out = (acc / den[..., None]).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(den)).permute(0, 2, 1).contiguous()
    return out


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool,
                              scale=None):
    """Plain PyTorch version of K9-bwd: the gradients (dq, dk, dv) of
    ``flash_attention`` at q, k, v for the output gradient ``do``, from the
    forward's output ``o`` and row statistic ``lse`` (B, H, Sq), whole (no
    blocks), in f32 (f64 inputs stay f64), each rounded once to its
    input's type."""
    B, Sq, H, D, Skv, Dv = _shapes(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc) * scale
    kf, vf = k.to(acc), v.to(acc)
    dof = do.to(acc)
    s = torch.einsum("bqhd,bthd->bhqt", qf, kf)
    p = torch.exp(s - lse.to(acc)[..., None])
    del s
    if causal:
        dev = q.device
        seen = torch.arange(Sq, device=dev)[:, None] >= \
            torch.arange(Skv, device=dev)[None, :]
        p = torch.where(seen, p, 0.0)
    delta = (dof * o.to(acc)).sum(-1).permute(0, 2, 1)       # (B, H, Sq)
    dv = torch.einsum("bhqt,bqhd->bthd", p, dof)
    ds = p * (torch.einsum("bqhd,bthd->bhqt", dof, vf) - delta[..., None])
    del p
    dq = torch.einsum("bhqt,bthd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqt,bqhd->bthd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_operands(q, k, v, q_positions, kv_positions):
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or \
            len({q.device, k.device, v.device}) > 1:
        raise ValueError("flash attention operands lie on different devices")
    if q_positions is not None or kv_positions is not None:
        raise ValueError("the flash attention kernel takes positions 0..S-1 "
                         "only; position vectors are not supported on the "
                         "card")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash attention kernel takes f32 or bf16 "
                         f"q, k, v of one type: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if (q.shape[3], v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"the flash attention kernel takes head dims "
                         f"(Dq, Dv) in {HEAD_DIM_PAIRS}: "
                         f"{(q.shape[3], v.shape[3])}")


def _kernel_reads(x) -> bool:
    """Whether the kernel can read ``x`` in place: unit stride along D, and
    for bf16 (TMA) a start on a 16-byte boundary and (batch, sequence, head)
    strides that are nonzero 16-byte multiples along dimensions longer
    than 1 (a broadcast view is copied)."""
    if x.stride(3) != 1:
        return False
    if x.dtype != torch.bfloat16:
        return True
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        st > 0 and st * size % 16 == 0
        for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)


def flash_attention(q, k, v, *, causal: bool, block=None, q_positions=None,
                    kv_positions=None, scale=None) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors (see the module docstring): the
    K9 kernel on a CUDA tensor, through ``FlashAttention`` when a gradient
    is wanted; the plain version on a CPU tensor."""
    q, k, v = (torch.as_tensor(x) for x in (q, k, v))
    B, Sq, H, D, Skv, Dv = _shapes(q, k, v)
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return flash_attention_plain(q, k, v, causal=causal, block=block,
                                     q_positions=q_positions,
                                     kv_positions=kv_positions, scale=scale)
    _check_kernel_operands(q, k, v, q_positions, kv_positions)
    if Skv == 0:
        raise ValueError("flash attention needs at least one key")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if Sq != Skv:
            raise ValueError(f"the flash attention backward kernel takes "
                             f"Sq == Skv: {Sq}, {Skv}")
        return FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return _forward(q, k, v, causal, scale, with_lse=False)[0]


def _forward(q, k, v, causal: bool, scale: float, *, with_lse: bool):
    """One launch of K9: (out, lse or None, (q, k, v) as the kernel read
    them — copies where it could not read the view in place)."""
    B, Sq, H, D, Skv, Dv = _shapes(q, k, v)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if B * Sq * H == 0:
        return out, lse, (q, k, v)
    # the kernel reads rows by their (batch, sequence, head) strides and
    # needs unit stride along D; the bf16 kernel's TMA copies also need a
    # 16-byte aligned start and strides of 16-byte multiples
    q, k, v = (x if _kernel_reads(x) else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, out) for s in x.stride()[:3]))
    entry = _ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        _launch(_lib(), entry, q=q.data_ptr(), k=k.data_ptr(),
                v=v.data_ptr(), out=out.data_ptr(), B=B, H=H, Sq=Sq,
                Skv=Skv, Dq=D, Dv=Dv, strides=ctypes.addressof(strides),
                scale=float(scale), causal=int(bool(causal)),
                stream=torch.cuda.current_stream().cuda_stream,
                lse=None if lse is None else lse.data_ptr())
    launches["flashattn"] += 1
    return out, lse, (q, k, v)


class FlashAttention(torch.autograd.Function):
    """K9 with K9-bwd as its gradient, on CUDA tensors: the forward saves
    q, k, v (as the kernel read them), the output and lse; the backward is
    ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse, read = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(*read, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def _check_bwd_operands(q, k, v, o, do, lse):
    B, Sq, H, D, Skv, Dv = _shapes(q, k, v)
    if not q.is_cuda or len({x.device for x in (q, k, v, o, do, lse)}) > 1:
        raise ValueError("flash attention backward operands lie on "
                         "different devices")
    if q.dtype not in _BWD_ENTRY or any(x.dtype != q.dtype
                                        for x in (k, v, o, do)):
        raise ValueError(f"the flash attention backward kernel takes f32 or "
                         f"bf16 q, k, v, o, dO of one type: "
                         f"{[x.dtype for x in (q, k, v, o, do)]}")
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"the flash attention backward kernel takes head "
                         f"dims (Dq, Dv) in {HEAD_DIM_PAIRS}: {(D, Dv)}")
    if Sq != Skv:
        raise ValueError(f"the flash attention backward kernel takes "
                         f"Sq == Skv: {Sq}, {Skv}")
    if tuple(o.shape) != tuple(v.shape) or tuple(do.shape) != tuple(v.shape):
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must "
                         f"have q's shape with v's head dim, "
                         f"{tuple(v.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 (B, H, Sq) = "
                         f"{(B, H, Sq)}: {lse.dtype} {tuple(lse.shape)}")


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool, scale=None):
    """(dq, dk, dv) for the output gradient ``do`` (see the module
    docstring): K9-bwd on CUDA tensors, three launches counted as one in
    ``launches["flashattn_bwd"]``; the plain version on CPU tensors.  Every
    operand is read by its strides where the kernel can (``_kernel_reads``:
    unit stride along D, and in bf16 what TMA reads); other views are
    copied first."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         scale=scale)
    _check_bwd_operands(q, k, v, o, do, lse)
    B, S, H, D = q.shape
    Dv = v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q, k, v, o, do = (x if _kernel_reads(x) else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v, o, do))
    dq, dk, dv = (torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
                  for d in (D, D, Dv))
    if B * S * H == 0:
        return dq, dk, dv
    rows = -(-S // BWD_STAT_ROWS) * BWD_STAT_ROWS
    stats = torch.empty((2, B * H, rows), dtype=torch.float32,
                        device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]))
    entry = _BWD_ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        _launch(_bwd_lib(), entry, **{
            name: x.data_ptr() for name, x in zip(
                ("q", "k", "v", "o", "dout", "lse", "stats", "dq", "dk",
                 "dv"), (q, k, v, o, do, lse, stats, dq, dk, dv))},
            B=B, H=H, S=S, Dq=D, Dv=Dv, strides=ctypes.addressof(strides),
            scale=float(scale), causal=int(bool(causal)),
            stream=torch.cuda.current_stream().cuda_stream)
    launches["flashattn_bwd"] += 1
    return dq, dk, dv
