"""Blocked causal flash attention: online softmax over KV tiles.

``flash_attention(q, k, v, causal=, block=)`` on (B, S, H, D) tensors
replaces the reference package's TPU kernel ``flash_attention``
(``src/repro/kernels/flashattn.py``) and, on the serving path, the XLA
scan ``models/layers.flash_attention`` it is held equal to.  On a CUDA
tensor it launches ``flashattn_f32`` / ``flashattn_bf16`` of
``csrc/flashattn.cu`` (compiled at first use, see ``kernels.build``; the
source says what bounds it on the card), or raises: only D = 64 and
D = 128, f32 and bf16, q, k and v of one type on one device, no position
vectors.  The bf16 kernel runs both products on the Hopper tensor cores
(``wgmma``) with K and V staged by TMA, and keeps P to f32 grade by
splitting it into two bf16 terms; the f32 kernel does both as f32 FMAs.
On a CPU tensor — and only because the tensor lies on the CPU — it takes
the plain PyTorch version ``flash_attention_plain``.

**Arithmetic contract** (both versions, the reference's): q, k and v are
widened to f32; q is scaled by ``scale`` (default 1/√D) before the
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
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as _build

NEG_INF = -1e30

# kernel launches, counted where the kernel is launched and nowhere else
# (plain-version calls do not count)
launches = {"flashattn": 0}

_ENTRY = {torch.float32: "flashattn_f32", torch.bfloat16: "flashattn_bf16"}
HEAD_DIMS = (64, 128)
_LIB = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def _lib():
    """The ``flashattn`` kernel library, bound; the first call builds every
    library of the package."""
    global _LIB
    if _LIB is None:
        lib = _build.load_all(_build.SOURCES)["flashattn"]
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for entry in _ENTRY.values():
            fn = getattr(lib, entry)
            fn.argtypes = [P, P, P, P, I, I, I, I, I, P, F, I, P]
            fn.restype = I
        _LIB = lib
    return _LIB


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
                          q_positions=None, kv_positions=None, scale=None):
    """Plain PyTorch version: the reference's scan over KV blocks of
    ``block`` rows (all of Skv when None), transcribed.  q (B, Sq, H, Dq),
    k (B, Skv, H, Dq), v (B, Skv, H, Dv) -> (B, Sq, H, Dv) in q's type."""
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
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)


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
    D, Dv = q.shape[3], v.shape[3]
    if D not in HEAD_DIMS or Dv != D:
        raise ValueError(f"the flash attention kernel takes head dims "
                         f"{HEAD_DIMS} with Dq == Dv: {D}, {Dv}")


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
    K9 kernel on a CUDA tensor, the plain version on a CPU tensor."""
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
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if B * Sq * H == 0:
        return out
    # the kernel reads rows by their (batch, sequence, head) strides and
    # needs unit stride along D; the bf16 kernel's TMA copies also need a
    # 16-byte aligned start and strides of 16-byte multiples
    q, k, v = (x if _kernel_reads(x) else x.clone(
        memory_format=torch.contiguous_format) for x in (q, k, v))
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, out) for s in x.stride()[:3]))
    entry = _ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Sq, Skv, D, ctypes.addressof(strides), float(scale),
            int(bool(causal)), stream)
    if err != 0:
        raise _build.KernelError(f"{entry} launch failed: CUDA error {err}")
    launches["flashattn"] += 1
    return out
