"""Sampled dense-dense matrix product: out = mask ⊙ (lhs @ rhsᵀ).

The wedge-closing product of tensorised pattern counting: count paths
between endpoints, keep only adjacent pairs.  ``sddmm`` replaces the
reference package's TPU kernel ``sddmm`` (``src/repro/kernels/sddmm.py``).
On a CUDA tensor it launches kernels of ``csrc/matreduce.cu`` (compiled
at first use, see ``kernels.build``; the source says what bounds each on
the card): ``sddmm_prep``, then ``sddmm_tc`` (TMA + ``wgmma`` on the bf16
tensor cores), then — for f32 operands — ``sddmm_f32`` (f32 FMAs, the
K6 template with an epilogue that writes the masked cells).  On a CPU
tensor — and only because the tensor lies on the CPU — it takes the
plain PyTorch version ``sddmm_plain``.

**Arithmetic contract.**  lhs and rhs are f32 or bf16 (any other dtype
is cast to f32 first), the mask is read as f32, and the mask multiplies
each cell once at the end, in f32, as the reference does.  Two routes,
chosen on the card by the data, with no host sync:

- **exact** (``sddmm_tc``): every lhs and rhs value is a finite integer
  with |v| <= 256 and K · max|lhs| · max|rhs| <= 2^24
  (``sddmm_exact_plain``).  bf16 holds such values, their products are
  exact and every f32 partial sum is an integer below 2^24, so the
  tensor cores' f32 result has the f32 product's bits.  bf16 operands
  take this kernel whatever their values: bf16 products with an f32
  accumulator, as the reference's MXU product.  Under the flag, with no
  operand of negative sign, the product of a 128 x 256 output tile (two
  128 x 128 tiles of ``sddmm_occupancy_plain``) whose mask holds no
  non-zero value (NaN counts) is skipped.
- **FMA** (``sddmm_f32``): f32 operands that fail the test; f32 sums
  over K in plain fused multiply-adds, no TF32.  For 0/1 inputs every
  cell is an integer at most K, exact while K <= 2^24.

``sddmm_prep`` finds the flag's inputs, writes bf16 copies of f32
operands (once when lhs and rhs are one tensor) and the mask's tile
occupancy into a small int32 state; the next two kernels read it and
each returns at once when the route is not its own.  ``last_exact``
holds the flag of the last call as a (1,) int32 tensor on the card and
``last_tiles`` the tile occupancy; only a caller that has synchronised
reads them.  ``buffers`` and ``launch`` are the call's two halves (its
allocations, then its launches), for a caller that times a step alone.
Ragged M, N and K need no padding.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

# kernel launches, counted where the kernel is launched and nowhere else
# (plain-version calls do not count): one per ``sddmm`` call on the card,
# and per C entry
launches = {"sddmm": 0}
entries = {"sddmm_prep": 0, "sddmm_tc": 0, "sddmm_f32": 0}

TILE = 128                  # output tile of the occupancy map, as the source
EXACT_VALUE = 256           # largest |value| of the exact route
EXACT_SUM = 1 << 24         # largest K · max|lhs| · max|rhs| of the exact route
_STATE_HEAD, _EXACT_SLOT = 8, 4     # csrc/matreduce.cu's ST_HEAD, ST_EXACT
_TMA_ALIGN = 8              # bf16 elements per 16 bytes (TMA's stride rule)
_LIB = None

last_exact = None           # the last call's flag, (1,) int32 on the card
last_tiles = None           # its tile occupancy, (M/128, N/128) int32


def reset_launches():
    for table in (launches, entries):
        for k in table:
            table[k] = 0


def _lib():
    """The ``matreduce`` kernel library, with the sddmm entries bound; the
    first call builds every library of the package."""
    global _LIB
    if _LIB is None:
        lib = _build.load_all(_build.SOURCES)["matreduce"]
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sddmm_prep.argtypes = [P, P, P, I, I, I, L, L, L, I, I, P, P, L,
                                   P, P]
        lib.sddmm_tc.argtypes = [P, L, P, L, P, L, P, L, I, I, I, P, I, I, P]
        lib.sddmm_f32.argtypes = [P, P, P, I, I, I, L, L, L, P, L, P, I, P]
        for entry in ("sddmm_prep", "sddmm_tc", "sddmm_f32",
                      "matreduce_tile", "sddmm_state_head",
                      "sddmm_exact_slot"):
            getattr(lib, entry).restype = I
        for entry in ("matreduce_tile", "sddmm_state_head",
                      "sddmm_exact_slot"):
            getattr(lib, entry).argtypes = []
        if (lib.matreduce_tile(), lib.sddmm_state_head(),
                lib.sddmm_exact_slot()) != (TILE, _STATE_HEAD, _EXACT_SLOT):
            raise _build.KernelError("csrc/matreduce.cu's tile or state "
                                     "layout is not kernels.sddmm's")
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
    # lhs and rhs share one input type, f32 or bf16
    if lhs.dtype != rhs.dtype or \
            lhs.dtype not in (torch.float32, torch.bfloat16):
        lhs, rhs = lhs.float(), rhs.float()
    return lhs, rhs, mask if mask.dtype == torch.float32 else mask.float()


def sddmm_plain(lhs, rhs, mask) -> torch.Tensor:
    """Plain PyTorch version of ``sddmm``: the f32 product (on a card it
    follows ``torch.backends.cuda.matmul.allow_tf32``, which a caller
    comparing counts leaves False) times the f32 mask."""
    lhs, rhs, mask = _operands(lhs, rhs, mask)
    return (lhs.float() @ rhs.float().T) * mask


def sddmm_exact_plain(lhs, rhs) -> bool:
    """Plain version of ``sddmm_prep``'s flag: True iff every value of lhs
    and rhs is a finite integer with |v| <= 256 and K · max|lhs| ·
    max|rhs| <= 2^24 (counted in integers)."""
    K = torch.as_tensor(lhs).shape[1]
    maxes = []
    for x in (lhs, rhs):
        x = torch.as_tensor(x).float()
        if not bool((torch.isfinite(x) & (x == torch.round(x))
                     & (x.abs() <= EXACT_VALUE)).all()):
            return False
        maxes.append(int(x.abs().max().item()) if x.numel() else 0)
    return K * maxes[0] * maxes[1] <= EXACT_SUM


def sddmm_occupancy_plain(mask) -> torch.Tensor:
    """Plain version of ``sddmm_prep``'s tile occupancy: for each 128 x
    128 tile of the mask (ragged at the edges), True iff a value in it is
    non-zero — NaN included."""
    mask = torch.as_tensor(mask)
    M, N = mask.shape
    tm, tn = -(-M // TILE), -(-N // TILE)
    nz = torch.zeros((tm * TILE, tn * TILE), dtype=torch.bool,
                     device=mask.device)
    nz[:M, :N] = mask != 0
    return nz.view(tm, TILE, tn, TILE).any(3).any(1)


def _tma_operand(x):
    """A bf16 operand as TMA reads it: unit column stride, a 16-byte
    aligned start and a row stride that is a multiple of 8 elements; a
    view without them is copied into a buffer whose row stride is."""
    if x.stride(1) == 1 and x.stride(0) % _TMA_ALIGN == 0 and \
            x.stride(0) >= x.shape[1] and x.data_ptr() % 16 == 0:
        return x
    rows, K = x.shape
    ld = -(-K // _TMA_ALIGN) * _TMA_ALIGN
    buf = torch.empty((rows, ld), dtype=x.dtype, device=x.device)[:, :K]
    return buf.copy_(x)


class Buffers(NamedTuple):
    """One ``sddmm`` call's operands as its kernels take them: lhs, rhs
    and mask with unit column strides, the f32 output (None where the
    caller needs none: K6 shares this prep), the bf16 operands of the
    tensor-core kernel (copies of f32 operands, which ``sddmm_prep``
    writes), and the zeroed int32 state."""
    lhs: torch.Tensor
    rhs: torch.Tensor
    mask: torch.Tensor
    out: torch.Tensor | None
    a: torch.Tensor
    b: torch.Tensor
    state: torch.Tensor
    bf16: bool
    same: bool


STEPS = ("sddmm_prep", "sddmm_tc", "sddmm_f32")


def buffers(lhs, rhs, mask, out: bool = True) -> Buffers:
    """The buffers of one call on card operands (M, N, K >= 1), as
    ``sddmm`` allocates them; ``out=False`` leaves the output out (K6's
    calls, ``kernels.matreduce``)."""
    lhs, rhs, mask = _operands(lhs, rhs, mask)
    (M, K), N = lhs.shape, rhs.shape[0]
    same = lhs.data_ptr() == rhs.data_ptr() and lhs.shape == rhs.shape \
        and lhs.stride() == rhs.stride()
    bf16 = lhs.dtype == torch.bfloat16
    # the kernels take row strides and unit column strides
    lhs, rhs, mask = (x if x.stride(1) == 1 and x.stride(0) >= x.shape[1]
                      else x.contiguous() for x in (lhs, rhs, mask))
    tm, tn = -(-M // TILE), -(-N // TILE)
    state = torch.zeros((_STATE_HEAD + tm * tn,), dtype=torch.int32,
                        device=lhs.device)
    if bf16:
        a = _tma_operand(lhs)
        b = a if same else _tma_operand(rhs)
    else:
        ld = -(-K // _TMA_ALIGN) * _TMA_ALIGN
        a = torch.empty((M, ld), dtype=torch.bfloat16,
                        device=lhs.device)[:, :K]
        b = a if same else torch.empty((N, ld), dtype=torch.bfloat16,
                                       device=lhs.device)[:, :K]
    dst = torch.empty((M, N), dtype=torch.float32, device=lhs.device) \
        if out else None
    return Buffers(lhs, rhs, mask, dst, a, b, state, bf16, same)


def prep_args(buf: Buffers, stream: int) -> tuple:
    """The arguments of ``sddmm_prep`` for a call's buffers: the first
    launch of K7 and of K6 (``kernels.matreduce``) alike."""
    lhs, rhs, mask, a, b, state = buf.lhs, buf.rhs, buf.mask, buf.a, \
        buf.b, buf.state
    (M, K), N = lhs.shape, rhs.shape[0]
    copies = (0, 0, 0) if buf.bf16 else (a.data_ptr(), b.data_ptr(),
                                         a.stride(0))
    return (lhs.data_ptr(), rhs.data_ptr(), mask.data_ptr(), M, N, K,
            lhs.stride(0), rhs.stride(0), mask.stride(0), int(buf.bf16),
            int(buf.same), *copies, state.data_ptr(), stream)


def launch(buf: Buffers, steps=STEPS):
    """Launch ``steps`` (entries of ``STEPS``, in that order) of one call
    on its buffers, on the current stream of their device; each launch
    adds one to its count in ``entries``.  A bf16 call has no FMA step."""
    lib = _lib()
    lhs, rhs, mask, out, a, b, state = buf[:7]
    (M, K), N = lhs.shape, rhs.shape[0]
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in steps:
            if step == "sddmm_prep":
                err = lib.sddmm_prep(*prep_args(buf, stream))
            elif step == "sddmm_tc":
                err = lib.sddmm_tc(
                    a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                    mask.data_ptr(), mask.stride(0), out.data_ptr(),
                    out.stride(0), M, N, K, state.data_ptr(),
                    int(not buf.bf16), int(buf.same), stream)
            elif step == "sddmm_f32" and not buf.bf16:
                err = lib.sddmm_f32(
                    lhs.data_ptr(), rhs.data_ptr(), mask.data_ptr(), M, N, K,
                    lhs.stride(0), rhs.stride(0), mask.stride(0),
                    out.data_ptr(), out.stride(0), state.data_ptr(),
                    int(buf.same), stream)
            else:
                raise ValueError(f"sddmm has no step {step!r} for "
                                 f"{'bf16' if buf.bf16 else 'f32'} operands")
            if err != 0:
                raise _build.KernelError(f"{step} launch failed: CUDA error "
                                         f"{err}")
            entries[step] += 1


def sddmm(lhs, rhs, mask) -> torch.Tensor:
    """mask ⊙ (lhs @ rhsᵀ) for lhs (M, K), rhs (N, K), mask (M, N), as an
    f32 (M, N) tensor on the operands' device (see the module docstring
    for the arithmetic and the routes)."""
    global last_exact, last_tiles
    lhs, rhs, mask = _operands(lhs, rhs, mask)
    if not lhs.is_cuda:
        return sddmm_plain(lhs, rhs, mask)
    (M, K), N = lhs.shape, rhs.shape[0]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.float32, device=lhs.device)
    buf = buffers(lhs, rhs, mask)
    launch(buf, STEPS if not buf.bf16 else STEPS[:2])
    launches["sddmm"] += 1
    last_exact = buf.state[_EXACT_SLOT:_EXACT_SLOT + 1]
    last_tiles = buf.state[_STATE_HEAD:].view(-(-M // TILE), -(-N // TILE))
    return buf.out
