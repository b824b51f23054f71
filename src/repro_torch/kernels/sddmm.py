"""Sampled dense-dense matrix product: out = mask ⊙ (lhs @ rhsᵀ).

The wedge-closing product of tensorised pattern counting: count paths
between endpoints, keep only adjacent pairs.  ``sddmm`` replaces the
reference package's TPU kernel ``sddmm`` (``src/repro/kernels/sddmm.py``).
On a CUDA tensor it launches ``sddmm_f32`` / ``sddmm_bf16`` of
``csrc/matreduce.cu``, the K6 template with an epilogue that writes the
masked cells instead of summing them (compiled at first use, see
``kernels.build``; the source says what bounds it on the card).  On a CPU
tensor — and only because the tensor lies on the CPU — it takes the plain
PyTorch version ``sddmm_plain``.

**Arithmetic contract.**  lhs and rhs are f32 or bf16 (bf16 is widened to
f32 as the kernel loads it; any other dtype is cast to f32 first), the
mask is read as f32.  Products accumulate in plain f32 over K — no TF32 —
and the mask multiplies each cell once at the end, in f32, as the
reference does.  For 0/1 inputs every cell is an integer at most K, exact
while K <= 2^24.  Ragged M, N and K need no padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

# kernel launches, counted where the kernel is launched and nowhere else
# (plain-version calls do not count)
launches = {"sddmm": 0}

_ENTRY = {torch.float32: "sddmm_f32", torch.bfloat16: "sddmm_bf16"}
_LIB = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def _lib():
    """The ``matreduce`` kernel library, with the sddmm entries bound; the
    first call builds every library of the package."""
    global _LIB
    if _LIB is None:
        lib = _build.load_all(_build.SOURCES)["matreduce"]
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for entry in _ENTRY.values():
            fn = getattr(lib, entry)
            fn.argtypes = [P, P, P, I, I, I, L, L, L, P, L, P]
            fn.restype = I
        _LIB = lib
    return _LIB


def _operands(lhs, rhs, mask):
    lhs, rhs, mask = (torch.as_tensor(x) for x in (lhs, rhs, mask))
    if lhs.ndim != 2 or rhs.ndim != 2 or mask.ndim != 2:
        raise ValueError(f"sddmm takes 2-D operands: {tuple(lhs.shape)}, "
                         f"{tuple(rhs.shape)}, {tuple(mask.shape)}")
    (M, K), N = lhs.shape, rhs.shape[0]
    if rhs.shape[1] != K or tuple(mask.shape) != (M, N):
        raise ValueError(f"lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"mask {tuple(mask.shape)}: want (M, K), (N, K), "
                         f"(M, N)")
    if rhs.device != lhs.device or mask.device != lhs.device:
        raise ValueError("sddmm operands lie on different devices")
    # the kernel widens bf16 itself; lhs and rhs share one input type
    if lhs.dtype != rhs.dtype or lhs.dtype not in _ENTRY:
        lhs, rhs = lhs.float(), rhs.float()
    return lhs, rhs, mask if mask.dtype == torch.float32 else mask.float()


def sddmm_plain(lhs, rhs, mask) -> torch.Tensor:
    """Plain PyTorch version of ``sddmm``: the f32 product (on a card it
    follows ``torch.backends.cuda.matmul.allow_tf32``, which a caller
    comparing counts leaves False) times the f32 mask."""
    lhs, rhs, mask = _operands(lhs, rhs, mask)
    return (lhs.float() @ rhs.float().T) * mask


def sddmm(lhs, rhs, mask) -> torch.Tensor:
    """mask ⊙ (lhs @ rhsᵀ) for lhs (M, K), rhs (N, K), mask (M, N), as an
    f32 (M, N) tensor on the operands' device (see the module docstring
    for the arithmetic)."""
    lhs, rhs, mask = _operands(lhs, rhs, mask)
    if not lhs.is_cuda:
        return sddmm_plain(lhs, rhs, mask)
    (M, K), N = lhs.shape, rhs.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=lhs.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    # the kernel takes a row stride and unit column stride
    lhs, rhs, mask = (x if x.stride(1) == 1 and x.stride(0) >= x.shape[1]
                      else x.contiguous() for x in (lhs, rhs, mask))
    entry = _ENTRY[lhs.dtype]
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(
            lhs.data_ptr(), rhs.data_ptr(), mask.data_ptr(), M, N, K,
            lhs.stride(0), rhs.stride(0), mask.stride(0), out.data_ptr(),
            out.stride(0), stream)
    if err != 0:
        raise _build.KernelError(f"{entry} launch failed: CUDA error {err}")
    launches["sddmm"] += 1
    return out
