"""Fused masked product-reduce kernels behind the compiler's ``CutJoin``.

``prod_reduce``  Σ_x Π_i F_i[x] over (n,) factors (|cut| = 1, no mask —
                 a single cut vertex is always injective), or
                 Σ_{x,y} [gx≠gy] · Π_i F_i[x,y] over (m, n) factors
                 (|cut| = 2; rectangular slices allowed).
``tri_reduce``   Σ_{x,y,z pairwise distinct} Π_i F_i, where factor i spans
                 a sorted subset ``axes[i]`` of the three cut axes —
                 (n,) vectors, (n, n) pair tensors or full (n, n, n)
                 tensors — and broadcasts over the rest.  Nothing is
                 expanded in memory and no O(n^|cut|) mask is built.
                 It takes one of three routes, which ``tri_route``
                 decides from ``axes`` alone: **dense** (a factor spans
                 all three axes: the n^3 walk, the mask an index compare
                 inside the kernel), **path** (at most two of the three
                 axis pairs spanned: an O(n^2) function, the sum over the
                 middle axis of row sums minus one back term) and
                 **triangle** (all three pairs: Σ C′ ⊙ (A′·B′), a matrix
                 product with a masked-reduce epilogue on the f64 tensor
                 cores).
``prod_reduce_keep`` / ``tri_reduce_keep``  the keep forms behind
                 ``LocalCount`` (the partial-embedding API): one cut axis
                 survives as the (n,) output, the others are reduced
                 under the same mask.  ``tri_reduce_keep`` takes the
                 dense route (the n^3 walk) on every mix, on the card
                 by one of two entries (``tri_keep_entry``): the slab
                 entry, whose lanes walk the lead factor's unit stride,
                 or the strided template where the kept axis has it.
``matreduce``    Σ mask ⊙ (lhs @ rhsᵀ) over f32 (M, K), (N, K), (M, N)
                 inputs — the fused triangle count behind ``Intersect``.
                 On the card three launches, as K7's (``kernels.sddmm``):
                 ``sddmm_prep`` (the exactness flag, one bf16 copy when
                 lhs is rhs, the mask's tile occupancy), ``matreduce_tc``
                 (bf16 ``wgmma`` with a reducing epilogue, gated on the
                 flag) and ``matreduce_f32`` (f32 FMAs, returns at once
                 when the flag admits); no host sync before the final
                 ``.item()``.
``matreduce_tilelist``  the same function summed over a list of tile
                 products per output tile of a (T, t, t) stack — the
                 block-sparse triangle count in one call: one prep of
                 the stack, one tensor-core launch (a CTA per output
                 tile walking its list), one gated FMA launch.

These replace the reference package's ``_vecjoin_tiles``,
``_pairjoin_tiles``, ``_pairjoin_keep_tiles``, ``_trijoin_tiles`` (also
behind ``tri_reduce_keep``) and ``matreduce``
(``src/repro/kernels/matreduce.py``).  On a CUDA tensor they launch the
hand-written kernels of ``csrc/cutjoin.cu``, ``csrc/trijoin.cu`` and
``csrc/matreduce.cu`` (compiled at first use, see ``kernels.build``); the
sources say what bounds each on the card and what its design does about
it.  On a CPU
tensor — and only because the tensor lies on the CPU — they take the
plain PyTorch versions ``prod_reduce_plain``, ``tri_reduce_plain``,
``prod_reduce_keep_plain``, ``tri_reduce_keep_plain``,
``matreduce_plain`` and ``matreduce_tilelist_plain`` in this module —
for the tri join, the plain version of the route it takes: ``_tri_partials_plain`` (dense),
``_tri_path_plain`` or ``_tri_triangle_plain``.  A CUDA tensor never
reaches a plain version through a wrapper.

**Arithmetic contract.**  Factors are integer-valued f64 (read directly,
converted to f32 in registers).  Products are f32; an f32 partial sum
accumulates at most ``block`` cells before it is folded into f64.  For
factors that ``exact_block`` admits with that ``block`` every f32 value
is an integer below 2^24, so the result is integer-equal to the f64
dense join.  ``block`` is a loop bound, not a tile shape.  The path and
triangle routes of the tri join multiply and sum in f64 throughout:
exact while every partial stays below 2^53, which the f64 fold of the
chunked routes already requires (n^3 · Π_i max|F_i| < 2^53); ``block``
does not change them.  ``prod_reduce`` on vectors and ``prod_reduce_keep``
also have an **f64 instance** (``f64=True``): f64 products and sums, no
chunks, exact while cells · Π_i max|F_i| <= 2^53 over the reduced length
(``exact_f64``) — the route the compiler takes on the card for the joins
``exact_block`` refuses.  ``matreduce`` and ``matreduce_tilelist`` take
f32 operands: an f32 product (exact on the tensor cores under the flag —
finite integers, |v| <= 256, K · max · max <= 2^24 — else on FMAs), each
cell times the mask in f64, f64 sums (equal to ``matreduce_plain`` at
difference 0 where every product cell is an exact integer).

**Global index offsets.**  ``offsets`` (one int per cut axis, default
zeros) is added to the local indices before the injectivity compare, so
a caller holding only a *slice* of the factors passes its global start
and the mask still compares global cut vertices.

**Tile-level entries.**  ``prod_reduce_tiles`` / ``tri_reduce_tiles``
return the f64 partials tensor on the factors' device without the final
sum — a sharded caller sums partials of per-rank slices itself; for
vectors on the card it is the (1,) result, which one launch finishes.
The keep forms' ``*_keep_tiles`` return (P, n_keep) partials; their sum
over dim 0 is the output vector (P = 1 where K3's row entry ran, see
``keep_entry``).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import sddmm as _ksd

EXACT_LIMIT = float(1 << 24)                 # f32 exact-integer range
EXACT_F64_LIMIT = 1 << 53                    # f64 exact-integer range

# kernel launches per tier, counted where the kernel is launched and
# nowhere else (plain-version calls do not count)
launches = {"vecjoin": 0, "pairjoin": 0, "trijoin": 0, "pairjoin_keep": 0,
            "trijoin_keep": 0, "matreduce": 0, "matreduce_tilelist": 0}

# scalar tri joins per route, counted where the route's kernels are
# launched; every one also counts in ``launches["trijoin"]`` (the keep form
# takes the dense route alone and counts in ``launches["trijoin_keep"]``)
tri_routes = {"trijoin_path": 0, "trijoin_triangle": 0, "trijoin_dense": 0}

# K1, K3 and K4-keep launches per C entry and arithmetic; every one also
# counts in ``launches["vecjoin"]``, ``launches["pairjoin_keep"]`` or
# ``launches["trijoin_keep"]``
join_entries = {"cutjoin_vec": 0, "cutjoin_vec_f64": 0,
                "cutjoin_pair_keep_rows": 0, "cutjoin_pair_keep_rows_f64": 0,
                "cutjoin_pair_keep": 0, "cutjoin_pair_keep_f64": 0,
                "cutjoin_tri_keep": 0, "cutjoin_tri_keep_slab": 0}

# K6's launches per C entry (its prep step launches ``sddmm_prep``, the
# tile list's ``matreduce_stack_prep``); a call launches all three of its
# entries and counts once in ``launches["matreduce"]`` or
# ``launches["matreduce_tilelist"]``
matreduce_entries = {"matreduce_prep": 0, "matreduce_tc": 0,
                     "matreduce_f32": 0, "tilelist_prep": 0,
                     "tilelist_tc": 0, "tilelist_f32": 0}
MATREDUCE_STEPS = ("matreduce_prep", "matreduce_tc", "matreduce_f32")
TILELIST_STEPS = ("tilelist_prep", "tilelist_tc", "tilelist_f32")
last_exact = None       # K6's last flag, (1,) int32 on the card: read after a sync
last_tiles = None       # the last dense call's tile occupancy, (M/128, N/128)

_ENTRY = {"pairjoin": "cutjoin_pair", "trijoin": "cutjoin_tri",
          "pairjoin_keep": "cutjoin_pair_keep",
          "trijoin_keep": "cutjoin_tri_keep"}
_TARGET_BLOCKS = 2048        # thread blocks wanted before axis 1 stops splitting
SLAB_MAX_U = 8192            # the slab entry's staged u row, as csrc/cutjoin.cu
_MIN_SPAN = 32               # fewest axis-1 cells one thread block walks
_PLAIN_SLAB = 1 << 27        # cells per slab of the plain tri version
_TC_COLUMNS = 256            # K6's output columns a tensor-core CTA (the source's)
_PREP_WIDTH = 1024           # a tile stack's values as prep reads them, per row


def reset_launches():
    for table in (launches, tri_routes, join_entries, matreduce_entries):
        for k in table:
            table[k] = 0


# -- the exactness guards -----------------------------------------------------------

def exact_block(factors, max_block: int = 1024, min_block: int = 8,
                maxes=None):
    """Largest power-of-two chunk size whose f32 partial sums stay exact
    for integer-valued ``factors``.  A chunk accumulates ``b`` cells, so
    every partial is an integer bounded by (Π_i max|F_i|) · b, and
    integers up to 2^24 are exactly representable in f32.  ``maxes``
    supplies precomputed per-factor max magnitudes (plans cache them)
    so repeated executions skip the scan; without it the maxima reduce
    on the factors' device and come back in one transfer.  Returns None
    when even a ``min_block`` chunk cannot guarantee exactness — callers
    should take an f64 path instead."""
    maxprod = 1.0
    if maxes is None:
        maxes = torch.stack([torch.as_tensor(F).abs().max().double()
                             for F in factors]).tolist() if factors else []
    for m in maxes:
        maxprod *= float(m)
    b = max_block
    while b >= min_block:
        if maxprod * b <= EXACT_LIMIT:
            return b
        b //= 2
    return None


def exact_f64(maxes, cells: int) -> bool:
    """True iff the f64 instance of the vector join and of the pair keep
    join (``f64=True``) is exact for integer-valued factors with max
    magnitudes ``maxes`` over ``cells`` reduced cells (n for a vector
    join, the reduced axis for a keep join): every product and every
    partial sum is then an integer of magnitude at most cells · Π_i
    max|F_i| <= 2^53.  Counted in integers, so the edge is exact."""
    bound = int(cells)
    for m in maxes:
        m = float(m)
        if not math.isfinite(m):
            return False
        bound *= math.ceil(abs(m))
    return bound <= EXACT_F64_LIMIT


# -- launch plumbing --------------------------------------------------------------

_LIB = None
_CONST: dict = {}       # the join library's constants, read once when it binds
_VEC_SCRATCH: dict = {}   # (device index, stream) -> K1's zeroed scratch


def _lib(name: str = "cutjoin"):
    """One compiled kernel library (``cutjoin``, ``trijoin`` or
    ``matreduce``); the first call builds and binds them all."""
    global _LIB
    if _LIB is None:
        libs = _build.load_all(_build.SOURCES)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        PL = ctypes.POINTER(L)
        cj = libs["cutjoin"]
        for entry in (*_ENTRY.values(), "cutjoin_pair_keep_f64"):
            fn = getattr(cj, entry)
            fn.argtypes = [P, P, I, I, I, I, I, I, I, I, I, I, I, I, P,
                           I, I, I, P]
            fn.restype = I
        cj.cutjoin_vec.argtypes = [PL, I, L, I, I, P, P, P]
        cj.cutjoin_tri_keep_slab.argtypes = [P, P] + [I] * 14 + [P, P]
        cj.cutjoin_tri_keep_slab.restype = I
        cj.cutjoin_pair_keep_rows.argtypes = [PL, I, I, I, I, I, I, I, I, P,
                                              P]
        for q in ("cutjoin_vec", "cutjoin_pair_keep_rows"):
            getattr(cj, q).restype = I
        for q in ("cutjoin_tx_tri", "cutjoin_max_factors",
                  "cutjoin_threads", "cutjoin_vec_scratch",
                  "cutjoin_slab_max_u"):
            getattr(cj, q).argtypes = []
            getattr(cj, q).restype = I
        _CONST.update(threads=cj.cutjoin_threads(), tx=cj.cutjoin_tx_tri(),
                      maxf=cj.cutjoin_max_factors(),
                      vec_scratch=cj.cutjoin_vec_scratch())
        if cj.cutjoin_slab_max_u() != SLAB_MAX_U:
            raise _build.KernelError("csrc/cutjoin.cu's SLAB_MAX_U is not "
                                     "kernels.matreduce.SLAB_MAX_U")
        tj = libs["trijoin"]
        tj.trijoin_path.argtypes = [P, P, I, I, I, I, I, I, I, I, I, I,
                                    P, P, P]
        tj.trijoin_triangle.argtypes = [P, P, I, I, I, I, I, I, I, I, I,
                                        I, P, P]
        for q in ("trijoin_path", "trijoin_triangle"):
            getattr(tj, q).restype = I
        for q in ("trijoin_path_tile", "trijoin_triangle_tile",
                  "trijoin_triangle_tile_z"):
            getattr(tj, q).argtypes = []
            getattr(tj, q).restype = I
        mm = libs["matreduce"]
        mm.sddmm_prep.argtypes = [P, P, P, I, I, I, L, L, L, I, I, P, P, L,
                                  P, P]
        mm.matreduce_tc.argtypes = [P, L, P, L, P, L, P, I, I, I, P, I, I,
                                    P]
        mm.matreduce_f32.argtypes = [P, P, P, I, I, I, L, L, L, P, P, I, P]
        mm.matreduce_stack_prep.argtypes = [P, I, I, L, P, L, P, P]
        mm.matreduce_tilelist_tc.argtypes = [P, I, P, P, P, P, P, I, I, P,
                                             P, P]
        mm.matreduce_tilelist_f32.argtypes = [P, I, P, P, P, P, I, I, P, P,
                                              P]
        for q in ("sddmm_prep", "matreduce_tc", "matreduce_f32",
                  "matreduce_stack_prep", "matreduce_tilelist_tc",
                  "matreduce_tilelist_f32"):
            getattr(mm, q).restype = I
        for q in ("matreduce_tile", "matreduce_tc_columns"):
            getattr(mm, q).argtypes = []
            getattr(mm, q).restype = I
        if (mm.matreduce_tile(), mm.matreduce_tc_columns()) != \
                (_ksd.TILE, _TC_COLUMNS):
            raise _build.KernelError("csrc/matreduce.cu's tiles are not "
                                     "kernels.matreduce's")
        _LIB = libs
    return _LIB[name]


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(dev) -> int:
    """The handle of ``dev``'s current stream (PyTorch's raw query where it
    has one: it builds no Stream object)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _entered(dev):
    """A launch runs on the runtime's current device: enter ``dev`` only
    when it is not that device already."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _vec_scratch(dev, stream: int):
    """K1's scratch on ``dev`` for launches on ``stream``, zeroed once:
    (its address, the address of a result slot after it, that slot as a
    (1,) tensor).  The kernel's ticket counter and per-CTA partials lie at
    the address, and every launch leaves the counter at 0; ``prod_reduce``
    reads its result from the slot.  One per stream, so that launches on
    two streams never share a counter or a slot."""
    key = (dev.index, stream)
    got = _VEC_SCRATCH.get(key)
    if got is None:
        size = _CONST["vec_scratch"]
        buf = torch.zeros((size + 1,), dtype=torch.float64, device=dev)
        got = (buf.data_ptr(), buf.data_ptr() + 8 * size, buf[size:])
        _VEC_SCRATCH[key] = got
    return got


def _offsets(offsets, naxes: int):
    if offsets is None:
        return (0,) * naxes
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.tolist()
    off = tuple(int(o) for o in offsets)
    if len(off) != naxes:
        raise ValueError(f"offsets {off} for {naxes} cut axes")
    return off


def _as_factors(factors):
    out = [F if isinstance(F, torch.Tensor) else torch.as_tensor(F)
           for F in factors]
    if not out:
        raise ValueError("a join needs at least one factor")
    if any(F.device != out[0].device for F in out):
        raise ValueError("factors lie on different devices")
    return out


def _fold_surplus(entries, cap: int):
    """More factors than the kernel's table holds: multiply two that span
    the same axes, elementwise in f64 — exact, the product of integer
    factors the guard admits is an integer far below 2^53.  Among more
    than seven factors two always share one of the seven axis subsets."""
    entries = list(entries)
    while len(entries) > cap:
        seen = {}
        for i, (F, ax) in enumerate(entries):
            if ax in seen:
                j = seen[ax]
                entries[j] = (entries[j][0] * F, ax)
                del entries[i]
                break
            seen[ax] = i
        else:
            raise ValueError("no two factors share an axis subset")
    return entries


def _launch(kind: str, entries, sizes, masked: bool, off3, block: int,
            f64: bool = False):
    """Launch one tier of the strided template on CUDA factors.
    ``entries``: (tensor, axes) with ``axes[d]`` the kernel axis (0, 1, 2)
    that dim d of the tensor maps to — any order: a keep form permutes the
    strides so that the kept cut axis is kernel axis 2, and nothing is
    transposed or copied.  ``sizes``: (n0, n1, n2).  ``f64``: the f64
    instance (the pair keep form only).  Returns the f64 partials:
    (blocks,), or (gz * gy, n2) for a keep form."""
    keep = kind.endswith("_keep")
    lib = _lib()
    threads, tx = _CONST["threads"], _CONST["tx"]
    entries = [(F if F.dtype == torch.float64 else F.double(), ax)
               for F, ax in entries]
    entries = _fold_surplus(entries, _CONST["maxf"])
    # group order the kernel expects: [A: no axis 0 | B: axes 0 and 1 |
    # C: axis 0 without axis 1]
    group = lambda ax: 0 if 0 not in ax else (1 if 1 in ax else 2)
    entries.sort(key=lambda e: group(e[1]))
    na = sum(group(ax) == 0 for _, ax in entries)
    nb = sum(group(ax) == 1 for _, ax in entries)
    nf = len(entries)
    strides = []
    for F, ax in entries:
        if not F.is_cuda or F.ndim != len(ax) or \
                any(F.shape[d] != sizes[a] for d, a in enumerate(ax)):
            raise ValueError(f"factor {tuple(F.shape)} on {F.device} does "
                             f"not span axes {ax} of {sizes} on the card")
        st = [0, 0, 0]
        for d, a in enumerate(ax):
            st[a] = F.stride(d)
        strides.extend(st)
    n0, n1, n2 = (int(s) for s in sizes)
    if not (1 <= min(n0, n1, n2) and max(n0, n1, n2) < (1 << 30)) \
            or int(block) < 1:
        raise ValueError(f"sizes {sizes} / block {block} out of range")
    gx = -(-n2 // threads)
    gy = -(-n0 // (tx if kind.startswith("trijoin") else 1))
    want_z = max(1, -(-_TARGET_BLOCKS // (gx * gy)))
    span1 = max(-(-n1 // want_z), min(_MIN_SPAN, n1))
    gz = -(-n1 // span1)
    if gy > 65535 or gz > 65535:
        raise ValueError(f"grid ({gx}, {gy}, {gz}) exceeds the launch limits")
    dev = entries[0][0].device
    partials = torch.empty((gz * gy, n2) if keep else (gx * gy * gz,),
                           dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_void_p * nf)(*[F.data_ptr() for F, _ in entries])
    strd = (ctypes.c_longlong * (3 * nf))(*strides)
    name = _ENTRY[kind] + ("_f64" if f64 else "")
    stream = _current_stream(dev)
    with _entered(dev):
        err = getattr(lib, name)(
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(strd, ctypes.c_void_p), nf, na, nb, n0, n1, n2,
            span1, int(block), int(bool(masked)), off3[0], off3[1], off3[2],
            partials.data_ptr(), gx, gy, gz, stream)
    if err != 0:
        raise _build.KernelError(f"{name} launch failed: CUDA error {err}")
    launches[kind] += 1
    if name in join_entries:
        join_entries[name] += 1
    return partials


def _line_factors(factors, cap: int):
    """f64 factors for a line kernel, surplus ones folded into its table
    (every factor spans the same axes)."""
    if len(factors) <= cap and all(F.dtype == torch.float64
                                   for F in factors):
        return factors
    fs = [F if F.dtype == torch.float64 else F.double() for F in factors]
    if len(fs) > cap:
        fs = [F for F, _ in _fold_surplus([(F, (0,)) for F in fs], cap)]
    return fs


# ctypes array types of the line kernels' factor tables (addresses, then
# two strides per factor), by factor count up to MAXF
_TABLES = [ctypes.c_longlong * (3 * k) for k in range(9)]


def _launch_vec(factors, block: int, f64: bool, fresh: bool = True):
    """K1 on CUDA (n,) factors: ``csrc/cutjoin.cu`` ``cutjoin_vec``, one
    launch to the final value.  Returns the (1,) f64 result: a new tensor,
    or with ``fresh=False`` the stream's result slot, which the next
    launch on the stream overwrites (``prod_reduce`` reads it at once)."""
    lib = _lib()
    fs = _line_factors(factors, _CONST["maxf"])
    nf, dev = len(fs), fs[0].device
    stream = _current_stream(dev)
    scratch, slot, out = _vec_scratch(dev, stream)
    if fresh:
        out = torch.empty((1,), dtype=torch.float64, device=dev)
        slot = out.data_ptr()
    table = _TABLES[nf](*[F.data_ptr() for F in fs],
                        *[s for F in fs for s in (F.stride(0), 0)])
    with _entered(dev):
        err = lib.cutjoin_vec(table, nf, fs[0].shape[0], block, f64,
                              scratch, slot, stream)
    name = "cutjoin_vec_f64" if f64 else "cutjoin_vec"
    if err != 0:
        raise _build.KernelError(f"{name} launch failed: CUDA error {err}")
    launches["vecjoin"] += 1
    join_entries[name] += 1
    return out


def keep_entry(F, keep: int) -> str:
    """The entry of K3 a pair keep join takes, from its lead factor's
    strides: ``"rows"`` (``cutjoin_pair_keep_rows``, a warp per kept row)
    when the reduced axis has unit stride — keep=0 on row-major factors —
    else ``"cols"`` (the strided template, a thread per kept index, which
    reads coalesced when the kept axis has unit stride)."""
    return "rows" if F.stride(1 - keep) == 1 else "cols"


def _launch_keep_rows(factors, keep: int, masked: bool, off, block: int,
                      f64: bool):
    """K3's row entry on CUDA (m, n) factors: ``csrc/cutjoin.cu``
    ``cutjoin_pair_keep_rows``, one launch, no partials.  Returns the
    (1, n_keep) output."""
    lib = _lib()
    fs = _line_factors(factors, _CONST["maxf"])
    nf, dev, red = len(fs), fs[0].device, 1 - keep
    stream = _current_stream(dev)
    m = fs[0].shape[keep]
    out = torch.empty((1, m), dtype=torch.float64, device=dev)
    table = _TABLES[nf](*[F.data_ptr() for F in fs],
                        *[s for F in fs
                          for s in (F.stride(red), F.stride(keep))])
    with _entered(dev):
        err = lib.cutjoin_pair_keep_rows(
            table, nf, m, fs[0].shape[red], int(block),
            int(bool(masked)), off[keep], off[red], int(f64),
            out.data_ptr(), stream)
    name = "cutjoin_pair_keep_rows" + ("_f64" if f64 else "")
    if err != 0:
        raise _build.KernelError(f"{name} launch failed: CUDA error {err}")
    launches["pairjoin_keep"] += 1
    join_entries[name] += 1
    return out


def _lead(factors, axes):
    """The lead factor of a tri join and its axes: the first factor over
    the most cut axes."""
    i = max(range(len(axes)), key=lambda j: (len(axes[j]), -j))
    return factors[i], tuple(axes[i])


def _slab_axes(factors, axes, keep: int):
    """(u, v) of the slab entry: u, the lanes' axis, is the reduced axis
    with the smallest stride in the lead factor (the later reduced axis
    where the lead factor spans neither), v the other reduced axis."""
    F, ax = _lead(factors, axes)
    red = [a for a in range(3) if a != keep]
    spanned = [(abs(F.stride(d)), a) for d, a in enumerate(ax) if a != keep]
    u = min(spanned)[1] if spanned else red[1]
    return u, red[0] if u == red[1] else red[1]


def tri_keep_entry(factors, axes, keep: int, sizes=None) -> str:
    """The entry of K4-keep a tri keep join takes, from its lead factor's
    strides: ``"template"`` (``cutjoin_tri_keep``, a thread per kept
    index) when the kept axis is the lead factor's unit-stride axis — it
    then reads coalesced — or when the slab's u row would not fit its
    shared-memory row (more than ``SLAB_MAX_U`` cells; ``sizes``, the
    three cut-axis lengths, default to the factors' shapes); else
    ``"slab"`` (``cutjoin_tri_keep_slab``, CTAs per kept index whose
    lanes walk the unit stride)."""
    F, ax = _lead(factors, axes)
    if any(a == keep and F.stride(d) == 1 for d, a in enumerate(ax)):
        return "template"
    u, _ = _slab_axes(factors, axes, keep)
    if sizes is None:
        sizes = [0, 0, 0]
        for G, ax_ in zip(factors, axes):
            for d, a in enumerate(ax_):
                sizes[a] = G.shape[d]
    return "template" if sizes[u] > SLAB_MAX_U else "slab"


def _slab_plan(factors, axes, sizes, keep: int, cap: int = 8,
               threads: int = 256):
    """What ``cutjoin_tri_keep_slab`` is handed: (entries, counts,
    strides, (u, v), (splits, span)).  ``entries``: (f64 factor, axes)
    with surplus factors beyond ``cap`` folded, ordered [over u and v |
    over u | over v | the rest]; ``counts``: the first three groups'
    sizes; ``strides``: per entry its (w, v, u) element strides, 0 on an
    axis it does not span; the v rows of every slab are split ``splits``
    ways of ``span`` rows so that the grid fills the card."""
    u, v = _slab_axes(factors, axes, keep)
    entries = [(F if F.dtype == torch.float64 else F.double(), tuple(ax))
               for F, ax in zip(factors, axes)]
    entries = _fold_surplus(entries, cap)
    group = lambda ax: (0 if u in ax and v in ax else 1 if u in ax
                        else 2 if v in ax else 3)
    entries.sort(key=lambda e: group(e[1]))
    counts = [sum(group(ax) == g for _, ax in entries) for g in range(3)]
    strides = []
    for F, ax in entries:
        st = {a: F.stride(d) for d, a in enumerate(ax)}
        strides.extend((st.get(keep, 0), st.get(v, 0), st.get(u, 0)))
    n_k, n_v = sizes[keep], sizes[v]
    splits = max(1, min(-(-_TARGET_BLOCKS // n_k), -(-n_v // (threads // 32)),
                        65535))
    span = -(-n_v // splits)
    return entries, counts, strides, (u, v), (-(-n_v // span), span)


def _launch_tri_keep_slab(factors, axes, sizes, keep: int, masked: bool,
                          off, block: int):
    """K4-keep's slab entry on CUDA factors: ``csrc/cutjoin.cu``
    ``cutjoin_tri_keep_slab``, laid out by ``_slab_plan``.  Returns the
    (splits, n_keep) f64 partials."""
    lib = _lib()
    entries, counts, strides, (u, v), (splits, span) = _slab_plan(
        factors, axes, sizes, keep, _CONST["maxf"], _CONST["threads"])
    n_k, n_u, n_v = sizes[keep], sizes[u], sizes[v]
    if max(n_k, n_u, n_v) >= (1 << 30) or n_u > SLAB_MAX_U:
        raise ValueError(f"sizes {sizes} out of the slab entry's range")
    dev = entries[0][0].device
    partials = torch.empty((splits, n_k), dtype=torch.float64, device=dev)
    nf = len(entries)
    ptrs = (ctypes.c_void_p * nf)(*[F.data_ptr() for F, _ in entries])
    strd = (ctypes.c_longlong * (3 * nf))(*strides)
    stream = _current_stream(dev)
    with _entered(dev):
        err = lib.cutjoin_tri_keep_slab(
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(strd, ctypes.c_void_p), nf, *counts, n_k, n_u, n_v,
            splits, span, int(block), int(bool(masked)), off[keep], off[u],
            off[v], partials.data_ptr(), stream)
    if err != 0:
        raise _build.KernelError(f"cutjoin_tri_keep_slab launch failed: "
                                 f"CUDA error {err}")
    launches["trijoin_keep"] += 1
    join_entries["cutjoin_tri_keep_slab"] += 1
    return partials


# -- the routes of the tri join ----------------------------------------------------

def tri_route(axes, keep=None) -> str:
    """The route of a tri join, from the axis sets of its factors and its
    kept axis alone: ``"dense"`` for the keep form and when a factor spans
    all three cut axes, ``"triangle"`` when the factors span all three
    axis pairs (0,1), (1,2) and (0,2), and ``"path"`` otherwise (at most
    two pairs spanned: vectors, uncovered axes and a lone pair
    included)."""
    axes = [tuple(ax) for ax in axes]
    if keep is not None or any(len(ax) == 3 for ax in axes):
        return "dense"
    pairs = {ax for ax in axes if len(ax) == 2}
    return "triangle" if len(pairs) == 3 else "path"


def _path_layout(axes):
    """(a, m, c) of a path mix: the middle axis m, shared by the spanned
    pairs, and the ends a and c, which no factor spans together.  Every
    factor then lies on (a, m) or on (m, c)."""
    pairs = sorted({tuple(ax) for ax in axes if len(ax) == 2})
    if len(pairs) == 2:
        m = (set(pairs[0]) & set(pairs[1])).pop()
    else:
        m = pairs[0][0] if pairs else 1
    a, c = (x for x in range(3) if x != m)
    return a, m, c


def _operand_strides(F, ax, rows, cols):
    """Element strides of ``F`` (spanning ``ax``) along the operand axes
    ``rows`` and ``cols``: 0 where it does not span them."""
    st = {a: F.stride(d) for d, a in enumerate(ax)}
    return st.get(rows, 0), st.get(cols, 0)


def _path_groups(factors, axes):
    """The path route's operands: A on (a, m) and B on (m, c), each a
    list of (factor, row stride, column stride); factors on m alone and
    scalars go to A.  Returns (a, m, c), A, B."""
    a, m, c = _path_layout(axes)
    A, B = [], []
    for F, ax in zip(factors, axes):
        if set(ax) <= {a, m}:
            A.append((F, *_operand_strides(F, ax, a, m)))
        else:
            B.append((F, *_operand_strides(F, ax, m, c)))
    return (a, m, c), A, B


def _triangle_groups(factors, axes):
    """The triangle route's operands, with x, y, z = 0, 1, 2 and the
    product over y: A′ on (x, y) — its pair factor first, then a vector
    on y or a second pair factor — B′ on (z, y), its pair factor first,
    and C′ on (x, z) with every vector on x or z and any scalar; each a
    list of (factor, row stride, column stride).  Returns A, B, C."""
    x, y, z = 0, 1, 2
    A, B, C = [], [], []
    for F, ax in zip(factors, axes):
        s = set(ax)
        if y in s and s <= {x, y}:
            A.append((F, *_operand_strides(F, ax, x, y)))
        elif y in s:
            B.append((F, *_operand_strides(F, ax, z, y)))
        else:
            C.append((F, *_operand_strides(F, ax, x, z)))
    for G in (A, B):                     # the pair factor leads its operand
        G.sort(key=lambda e: 0 if e[1] and e[2] else 1)
    return A, B, C


def _dense_operand(entries, shape, dev):
    """Plain version of an operand: the f64 product of its factors, read
    through their strides as the kernels read them."""
    X = torch.ones(shape, dtype=torch.float64, device=dev)
    for F, sr, sc in entries:
        X = X * torch.as_strided(F, shape, (sr, sc), F.storage_offset())
    return X


def _globals(n, off, dev):
    return torch.arange(n, device=dev) + off


def _tri_path_plain(factors, axes, sizes, distinct, offsets):
    """Plain PyTorch version of the path route, in f64: with A on (a, m)
    and B on (m, c), r_A[m] = Σ_{a≠m} A[a,m], r_B[m] = Σ_{c≠m} B[m,c] and
    the back term A[a,m]·B[m,c] at global c = global a,

        Σ_distinct = Σ_m [ r_A[m]·r_B[m] − Σ_{a≠m} A[a,m]·B[m,c(a)] ]

    Without ``distinct`` no term is excluded.  Returns the (n_m,)
    brackets, whose sum is the join."""
    sizes = _tri_sizes(sizes)
    factors, axes = _tri_check(factors, axes, sizes)
    factors = [F.double() for F in factors]
    off = _offsets(offsets, 3)
    (a, m, c), GA, GB = _path_groups(factors, axes)
    dev = factors[0].device
    A = _dense_operand(GA, (sizes[a], sizes[m]), dev)
    B = _dense_operand(GB, (sizes[m], sizes[c]), dev)
    ga, gm, gc = (_globals(sizes[q], off[q], dev) for q in (a, m, c))
    back = torch.zeros_like(A)
    if distinct:
        A = A.masked_fill(ga[:, None] == gm[None, :], 0.0)
        B = B.masked_fill(gm[:, None] == gc[None, :], 0.0)
        ca = ga - off[c]                      # the column of B at c = a
        inside = (ca >= 0) & (ca < sizes[c])
        back = (B.T[ca.clamp(0, sizes[c] - 1)]
                * inside[:, None].double())   # back[a, m] = B[m, c(a)]
    return A.sum(0) * B.sum(1) - (A * back).sum(0)


def _tri_triangle_plain(factors, axes, sizes, distinct, offsets):
    """Plain PyTorch version of the triangle route, in f64: A′ on (x, y),
    B′ on (z, y) and C′ on (x, z), each the product of its factors with
    its global diagonal zeroed under ``distinct``, then Σ C′ ⊙ (A′·B′ᵀ).
    Returns the (1,) partial."""
    sizes = _tri_sizes(sizes)
    factors, axes = _tri_check(factors, axes, sizes)
    factors = [F.double() for F in factors]
    off = _offsets(offsets, 3)
    GA, GB, GC = _triangle_groups(factors, axes)
    dev = factors[0].device
    ops = []
    for G, (r, q) in ((GA, (0, 1)), (GB, (2, 1)), (GC, (0, 2))):
        X = _dense_operand(G, (sizes[r], sizes[q]), dev)
        if distinct:
            gr, gq = _globals(sizes[r], off[r], dev), \
                _globals(sizes[q], off[q], dev)
            X = X.masked_fill(gr[:, None] == gq[None, :], 0.0)
        ops.append(X)
    A, B, C = ops
    return (C * (A @ B.T)).sum().reshape(1)


def _table(groups):
    """ctypes arrays of the factors' pointers and (row, column) strides,
    group after group, and their count."""
    entries = [e for G in groups for e in G]
    ptrs = (ctypes.c_void_p * len(entries))(*[F.data_ptr()
                                             for F, _, _ in entries])
    strides = (ctypes.c_longlong * (2 * len(entries)))(
        *[s for _, sr, sc in entries for s in (sr, sc)])
    return ptrs, strides, len(entries)


def _f64_entries(factors, axes, cap: int = 8):
    """f64 factors on the card, surplus ones folded into the capacity of
    ``csrc/trijoin.cu``'s factor table (MAXF); returns (factors, axes)."""
    entries = [(F if F.dtype == torch.float64 else F.double(), tuple(ax))
               for F, ax in zip(factors, axes)]
    for F, _ in entries:
        if not F.is_cuda:
            raise ValueError(f"factor on {F.device}: the tri join's kernels "
                             f"take CUDA tensors")
    entries = _fold_surplus(entries, cap)
    return [F for F, _ in entries], [ax for _, ax in entries]


_TARGET_PATH_BLOCKS = 2048    # thread blocks wanted per pass of the path route


def _count(route: str):
    launches["trijoin"] += 1
    tri_routes[f"trijoin_{route}"] += 1


def _launch_path(factors, axes, sizes, masked: bool, off3):
    """The path route on the card: ``csrc/trijoin.cu`` ``trijoin_path``.
    Returns the f64 partials: the (n_m,) brackets."""
    lib = _lib("trijoin")
    factors, axes = _f64_entries(factors, axes)
    (a, m, c), GA, GB = _path_groups(factors, axes)
    n_a, n_m, n_c = sizes[a], sizes[m], sizes[c]
    tile = lib.trijoin_path_tile()
    g_tiles = -(-(max(off3[a] + n_a, off3[c] + n_c)
                  - min(off3[a], off3[c])) // tile)
    split = max(1, min(g_tiles, -(-_TARGET_PATH_BLOCKS // -(-n_m // tile))))
    dev = factors[0].device
    scratch = torch.empty((split * 3 * n_m,), dtype=torch.float64,
                          device=dev)
    out = torch.empty((n_m,), dtype=torch.float64, device=dev)
    ptrs, strides, nf = _table((GA, GB))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trijoin_path(
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(strides, ctypes.c_void_p), nf, len(GA), n_a, n_m,
            n_c, off3[a], off3[m], off3[c], int(bool(masked)), split,
            scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise _build.KernelError(f"trijoin_path launch failed: CUDA "
                                 f"error {err}")
    _count("path")
    return out


def _tri_tma_operand(entries, rows: int, k: int):
    """One operand of the triangle route as its kernel reads it: a single
    f64 factor that TMA reads in place — unit stride along k or along the
    rows, the other stride even (16 bytes) and at least that axis's
    extent, a 16-byte aligned start.  The lead factor stays where it is
    one and the operand has no other factor; else the operand (its lead
    factor times its others — a vector on y, a second pair factor — in
    f64, exact for the integers the join takes) is written into a (rows,
    k) buffer of even row stride, as ``sddmm`` copies views TMA cannot
    read.  ``entries``: (factor, row stride, k stride) as
    ``_triangle_groups`` gives them; returns one such entry in a list."""
    if len(entries) == 1:
        F, sr, sk = entries[0]
        for unit, other, extent in ((sk, sr, k), (sr, sk, rows)):
            if unit == 1 and other % 2 == 0 and extent <= other < 1 << 37 \
                    and F.data_ptr() % 16 == 0:
                return entries
    dev = entries[0][0].device
    buf = torch.empty((rows, k + k % 2), dtype=torch.float64,
                      device=dev)[:, :k]
    buf.copy_(_dense_operand(entries, (rows, k), dev))
    return [(buf, buf.stride(0), buf.stride(1))]


def _triangle_partials(nx: int, nz: int, tile_x: int, tile_z: int) -> int:
    """The triangle route's partials for an (nx, nz) join: one per
    ``tile_x`` x ``tile_z`` tile of the (x, z) plane
    (``csrc/tri_order.cuh`` ``tiles``)."""
    return -(-nx // tile_x) * -(-nz // tile_z)


def _launch_triangle(factors, axes, sizes, masked: bool, off3):
    """The triangle route on the card: ``csrc/trijoin.cu``
    ``trijoin_triangle``.  Returns the f64 partials, one per (x, z)
    tile."""
    lib = _lib("trijoin")
    factors, axes = _f64_entries(factors, axes)
    GA, GB, GC = _triangle_groups(factors, axes)
    nx, ny, nz = sizes
    GA, GB = _tri_tma_operand(GA, nx, ny), _tri_tma_operand(GB, nz, ny)
    partials = _triangle_partials(nx, nz, lib.trijoin_triangle_tile(),
                                  lib.trijoin_triangle_tile_z())
    if partials >= 1 << 31:
        raise ValueError(f"sizes {sizes} exceed the launch limits")
    dev = factors[0].device
    out = torch.empty((partials,), dtype=torch.float64, device=dev)
    ptrs, strides, nf = _table((GA, GB, GC))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.trijoin_triangle(
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(strides, ctypes.c_void_p), nf, len(GA), len(GB),
            nx, ny, nz, *off3, int(bool(masked)), out.data_ptr(), stream)
    if err != 0:
        raise _build.KernelError(f"trijoin_triangle launch failed: CUDA "
                                 f"error {err}")
    _count("triangle")
    return out


# -- plain PyTorch versions --------------------------------------------------------

def _chunk_sums(prod, dim: int, block: int):
    """f32 sums of ``prod`` along ``dim`` in chunks of at most ``block``
    cells, in f64, with ``dim`` now indexing the chunks."""
    n = prod.shape[dim]
    full = (n // block) * block
    parts = []
    if full:
        head = prod.narrow(dim, 0, full)
        shape = list(head.shape)
        shape[dim:dim + 1] = [full // block, block]
        parts.append(head.reshape(shape).sum(dim + 1).double())
    if full < n:
        parts.append(prod.narrow(dim, full, n - full)
                     .sum(dim, keepdim=True).double())
    return torch.cat(parts, dim)


def _pair_product_plain(factors, distinct, offsets, dtype=torch.float32):
    """Product of (m, n) factors in ``dtype`` (f32, or f64 for the f64
    instance), masked where global row == column."""
    prod = factors[0].to(dtype)
    for F in factors[1:]:
        prod = prod * F.to(dtype)
    if distinct and prod.ndim == 2:
        off = _offsets(offsets, 2)
        gx = torch.arange(prod.shape[0], device=prod.device) + off[0]
        gy = torch.arange(prod.shape[1], device=prod.device) + off[1]
        prod = prod.masked_fill(gx[:, None] == gy[None, :], 0.0)
    return prod


def _prod_partials_plain(factors, distinct, block, offsets, f64=False):
    if f64:
        return _pair_product_plain(_as_factors(factors), distinct, offsets,
                                   torch.float64).sum().reshape(1)
    prod = _pair_product_plain(_as_factors(factors), distinct, offsets)
    if prod.ndim == 1:
        return prod.double()                 # one cell per partial
    return _chunk_sums(prod, 0, block).reshape(-1)


def prod_reduce_plain(factors, *, distinct: bool = True, block: int = 128,
                      offsets=None) -> float:
    """Plain PyTorch version of ``prod_reduce``: f32 product, f32 sums
    over at most ``block`` cells, mask from ``arange`` + offsets, f64
    finish."""
    return _prod_partials_plain(factors, distinct, block,
                                offsets).sum().item()


def prod_reduce_f64_plain(factors) -> float:
    """Plain PyTorch version of ``prod_reduce(f64=True)`` on (n,)
    factors: the f64 product, then its f64 sum."""
    return _prod_partials_plain(factors, False, 1, None, f64=True).item()


def _tri_sizes(n):
    return (n, n, n) if isinstance(n, int) else tuple(int(s) for s in n)


def _tri_check(factors, axes, sizes):
    factors = _as_factors(factors)
    axes = [tuple(ax) for ax in axes]
    if len(axes) != len(factors):
        raise ValueError(f"{len(factors)} factors but {len(axes)} axis sets")
    for F, ax in zip(factors, axes):
        if ax != tuple(sorted(set(ax))) or not set(ax) <= {0, 1, 2}:
            raise ValueError(f"axes {ax}: want a sorted subset of (0, 1, 2)")
        if F.ndim != len(ax) or \
                any(F.shape[d] != sizes[a] for d, a in enumerate(ax)):
            raise ValueError(f"factor {tuple(F.shape)} does not span axes "
                             f"{ax} of {sizes}")
    return factors, axes


def _tri_partials_plain(factors, axes, n, distinct, block, offsets,
                        keep=None):
    """Per-slab f64 sums of the tri join, or with ``keep`` the (1, n_keep)
    output row: the kept axis is moved to the front by permuting views
    (the mask is symmetric, so only the offsets move with it)."""
    sizes = _tri_sizes(n)
    factors, axes = _tri_check(factors, axes, sizes)
    off = _offsets(offsets, 3)
    if keep is not None:
        perm = (keep,) + tuple(a for a in range(3) if a != keep)
        rank = {a: i for i, a in enumerate(perm)}
        moved = []
        for F, ax in zip(factors, axes):
            new = tuple(sorted(rank[a] for a in ax))
            moved.append((F.permute([ax.index(perm[a]) for a in new]), new))
        factors = [F for F, _ in moved]
        axes = [ax for _, ax in moved]
        sizes = tuple(sizes[a] for a in perm)
        off = tuple(off[a] for a in perm)
    n0, n1, n2 = sizes
    dev = factors[0].device
    views = [F.to(torch.float32).reshape(
        tuple(sizes[a] if a in ax else 1 for a in range(3)))
        for F, ax in zip(factors, axes)]
    gy = (torch.arange(n1, device=dev) + off[1]).view(1, n1, 1)
    gz = (torch.arange(n2, device=dev) + off[2]).view(1, 1, n2)
    bx = max(1, min(n0, _PLAIN_SLAB // max(n1 * n2, 1)))
    parts = []
    for x0 in range(0, n0, bx):
        bw = min(bx, n0 - x0)
        prod = torch.ones((1, 1, 1), dtype=torch.float32, device=dev)
        for V, ax in zip(views, axes):
            prod = prod * (V.narrow(0, x0, bw) if 0 in ax else V)
        prod = prod.expand(bw, n1, n2)
        if distinct:
            gx = (torch.arange(x0, x0 + bw, device=dev) + off[0]) \
                .view(bw, 1, 1)
            prod = prod.masked_fill((gx == gy) | (gx == gz) | (gy == gz),
                                    0.0)
        sums = _chunk_sums(prod, 1, block)
        parts.append(sums.sum() if keep is None else sums.sum(dim=(1, 2)))
    if keep is None:
        return torch.stack(parts)
    return torch.cat(parts)[None, :]


def tri_reduce_plain(factors, axes, *, n, distinct: bool = True,
                     block: int = 128, offsets=None) -> float:
    """Plain PyTorch version of ``tri_reduce``: slabs of axis 0, f32
    broadcast product, f32 sums over at most ``block`` cells of axis 1,
    mask from ``arange`` + offsets, f64 finish."""
    return _tri_partials_plain(factors, axes, n, distinct, block,
                               offsets).sum().item()


def _pair_check(factors):
    factors = _as_factors(factors)
    if factors[0].ndim != 2 or any(F.shape != factors[0].shape
                                   for F in factors):
        raise ValueError("keep-axis factors must all be (m, n): "
                         f"{[tuple(F.shape) for F in factors]}")
    return factors


def _pair_keep_partials_plain(factors, keep, distinct, block, offsets,
                              f64=False):
    if f64:                                  # one row: (1, n_keep)
        return _pair_product_plain(factors, distinct, offsets,
                                   torch.float64).sum(1 - keep)[None, :]
    prod = _pair_product_plain(factors, distinct, offsets)
    if keep == 1:                            # reduce rows: (chunks, n)
        return _chunk_sums(prod, 0, block)
    return _chunk_sums(prod, 1, block).T     # reduce columns: (chunks, m)


def prod_reduce_keep_plain(factors, *, keep: int = 0, distinct: bool = True,
                           block: int = 128, offsets=None) -> torch.Tensor:
    """Plain PyTorch version of ``prod_reduce_keep``: f32 product, mask
    from ``arange`` + offsets, f32 sums over at most ``block`` cells of
    the reduced axis, f64 sum of those per kept index."""
    if keep not in (0, 1):
        raise ValueError(f"keep={keep}: a pair join keeps axis 0 or 1")
    return _pair_keep_partials_plain(_pair_check(factors), keep, distinct,
                                     block, offsets).sum(0)


def prod_reduce_keep_f64_plain(factors, *, keep: int = 0,
                               distinct: bool = True,
                               offsets=None) -> torch.Tensor:
    """Plain PyTorch version of ``prod_reduce_keep(f64=True)``: the f64
    product, mask from ``arange`` + offsets, f64 sums over the reduced
    axis."""
    if keep not in (0, 1):
        raise ValueError(f"keep={keep}: a pair join keeps axis 0 or 1")
    return _pair_keep_partials_plain(_pair_check(factors), keep, distinct,
                                     1, offsets, f64=True)[0]


def tri_reduce_keep_plain(factors, axes, *, keep: int, n,
                          distinct: bool = True, block: int = 128,
                          offsets=None) -> torch.Tensor:
    """Plain PyTorch version of ``tri_reduce_keep``: the kept axis moved
    to the front by permuted views, then as ``tri_reduce_plain`` with the
    f64 sums taken per kept index."""
    if keep not in (0, 1, 2):
        raise ValueError(f"keep={keep}: a tri join keeps axis 0, 1 or 2")
    return _tri_partials_plain(factors, axes, n, distinct, block, offsets,
                               keep=keep).sum(0)


def _mm_operands(lhs, rhs, mask):
    out = []
    for x in (lhs, rhs, mask):
        x = torch.as_tensor(x)
        if x.ndim != 2:
            raise ValueError(f"matreduce takes 2-D operands: {tuple(x.shape)}")
        out.append(x if x.dtype == torch.float32 else x.float())
    lhs, rhs, mask = out
    (M, K), N = lhs.shape, rhs.shape[0]
    if rhs.shape[1] != K or tuple(mask.shape) != (M, N):
        raise ValueError(f"lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"mask {tuple(mask.shape)}: want (M, K), (N, K), "
                         f"(M, N)")
    if rhs.device != lhs.device or mask.device != lhs.device:
        raise ValueError("matreduce operands lie on different devices")
    return lhs, rhs, mask


def _matreduce_plain(lhs, rhs, mask) -> torch.Tensor:
    return ((lhs @ rhs.T).double() * mask.double()).sum().reshape(1)


def matreduce_plain(lhs, rhs, mask) -> float:
    """Plain PyTorch version of ``matreduce``: the f32 product (on a card
    it follows ``torch.backends.cuda.matmul.allow_tf32``, which a caller
    comparing counts leaves False), each cell times the mask in f64, f64
    sum."""
    return _matreduce_plain(*_mm_operands(lhs, rhs, mask)).item()


def _tilelist_operands(stack, out_idx, k_ptr, lhs_idx, rhs_idx):
    """The f32 (T, t, t) stack and the four lists as int64 numpy arrays,
    checked: k_ptr (O + 1) runs from 0 to the lists' length without
    falling, and every index names a tile of the stack."""
    stack = torch.as_tensor(stack)
    if stack.ndim != 3 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"matreduce_tilelist takes a (T, t, t) stack of "
                         f"square tiles: {tuple(stack.shape)}")
    stack = stack if stack.dtype == torch.float32 else stack.float()
    out_idx, k_ptr, lhs_idx, rhs_idx = (
        np.asarray(x, dtype=np.int64).reshape(-1)
        for x in (out_idx, k_ptr, lhs_idx, rhs_idx))
    T = stack.shape[0]
    if len(k_ptr) != len(out_idx) + 1 or k_ptr[0] != 0 or \
            (np.diff(k_ptr) < 0).any() or \
            k_ptr[-1] != len(lhs_idx) or len(rhs_idx) != len(lhs_idx):
        raise ValueError("matreduce_tilelist: k_ptr must run from 0 to the "
                         "lists' length, one entry per output tile and one "
                         "more, without falling")
    for x in (out_idx, lhs_idx, rhs_idx):
        if len(x) and (x.min() < 0 or x.max() >= T):
            raise ValueError(f"matreduce_tilelist: a tile index outside "
                             f"the stack's {T} tiles")
    return stack, out_idx, k_ptr, lhs_idx, rhs_idx


def _tilelist_plain(stack, out_idx, k_ptr, lhs_idx, rhs_idx):
    """Per output tile o: Σ stack[out_idx[o]] ⊙ Σ_p stack[lhs_idx[p]] @
    stack[rhs_idx[p]]ᵀ over p in [k_ptr[o], k_ptr[o + 1]), the product
    summed in f32 (list position by list position, a batched product
    each), masked and summed in f64: the (O,) f64 partials."""
    dev = stack.device
    t = stack.shape[1]
    lengths = np.diff(k_ptr)
    acc = torch.zeros((len(out_idx), t, t), dtype=torch.float32,
                      device=dev)
    for q in range(int(lengths.max(initial=0))):
        outs = np.nonzero(lengths > q)[0]
        p = k_ptr[outs] + q
        lhs = stack[torch.from_numpy(lhs_idx[p]).to(dev)]
        rhs = stack[torch.from_numpy(rhs_idx[p]).to(dev)]
        rows = torch.from_numpy(outs).to(dev)
        acc[rows] += torch.bmm(lhs, rhs.transpose(1, 2))
    mask = stack[torch.from_numpy(out_idx).to(dev)]
    return (acc.double() * mask.double()).sum((1, 2))


def tilelist_exact_plain(stack, k_ptr) -> bool:
    """Plain version of the tile list's flag: every value of the stack a
    finite integer with |v| <= 256, and 128 × the longest list × max|v|²
    <= 2^24 (counted in integers)."""
    x = torch.as_tensor(stack).float()
    if not bool((torch.isfinite(x) & (x == torch.round(x))
                 & (x.abs() <= _ksd.EXACT_VALUE)).all()):
        return False
    top = int(x.abs().max().item()) if x.numel() else 0
    longest = int(np.diff(np.asarray(k_ptr, np.int64)).max(initial=0))
    return _ksd.TILE * longest * top * top <= _ksd.EXACT_SUM


def matreduce_tilelist_plain(stack, out_idx, k_ptr, lhs_idx,
                             rhs_idx) -> float:
    """Plain PyTorch version of ``matreduce_tilelist``."""
    return _tilelist_plain(*_tilelist_operands(
        stack, out_idx, k_ptr, lhs_idx, rhs_idx)).sum().item()


# -- the wrappers -------------------------------------------------------------------

def prod_reduce_tiles(factors, *, distinct: bool = True, block: int = 128,
                      offsets=None, f64: bool = False) -> torch.Tensor:
    """f64 partials of ``prod_reduce`` on the factors' device; their sum
    is the join.  Factors all (n,) or all (m, n); ``f64`` (vectors only)
    takes the f64 instance."""
    return _prod_tiles(factors, distinct, block, offsets, f64, True)


def _prod_tiles(factors, distinct, block, offsets, f64, fresh):
    factors = _as_factors(factors)
    ndim = factors[0].ndim
    if ndim not in (1, 2) or any(F.shape != factors[0].shape
                                 for F in factors):
        raise ValueError("factors must all be (n,) or all be (m, n): "
                         f"{[tuple(F.shape) for F in factors]}")
    if f64 and ndim != 1:
        raise ValueError("the f64 instance of prod_reduce takes (n,) "
                         "factors (the |cut| = 1 join)")
    if not factors[0].is_cuda:
        return _prod_partials_plain(factors, distinct, block, offsets, f64)
    if factors[0].numel() == 0:
        return torch.zeros((1,), dtype=torch.float64,
                           device=factors[0].device)
    if ndim == 1:                            # |cut| = 1: no mask, no offsets
        return _launch_vec(factors, block, f64, fresh)
    m, n = factors[0].shape
    off = _offsets(offsets, 2)
    return _launch("pairjoin", [(F, (1, 2)) for F in factors], (1, m, n),
                   distinct, (0, off[0], off[1]), block)


def prod_reduce(factors, *, distinct: bool = True, block: int = 128,
                offsets=None, f64: bool = False) -> float:
    """Σ over index tuples of Π_i F_i, factors all (n,) or all (m, n).

    ``distinct`` (2-D only) restricts the sum to cells whose global row
    and column differ — the |cut| = 2 injectivity constraint.  Exact for
    integer-valued factors that ``exact_block`` admits with ``block``, or
    with ``f64`` (vectors only: f64 products and sums) for factors that
    ``exact_f64`` admits.  ``offsets`` gives the factors' global start
    index per cut axis (sliced callers only; the 1-D path has no mask and
    ignores them).  One device→host transfer: the final scalar."""
    tiles = _prod_tiles(factors, distinct, block, offsets, f64, False)
    return (tiles if tiles.numel() == 1 else tiles.sum()).item()


def _tri_join(factors, axes, sizes, distinct, block, offsets):
    """The scalar tri join's partials by its route: on the CPU the route's
    plain version, on the card its kernel."""
    route = tri_route(axes)
    if not factors[0].is_cuda:
        if route == "dense":
            return _tri_partials_plain(factors, axes, sizes, distinct, block,
                                       offsets)
        plain = _tri_path_plain if route == "path" else _tri_triangle_plain
        return plain(factors, axes, sizes, distinct, offsets)
    if min(sizes) == 0:
        return torch.zeros((1,), dtype=torch.float64,
                           device=factors[0].device)
    off = _offsets(offsets, 3)
    if route == "path":
        return _launch_path(factors, axes, sizes, distinct, off)
    if route == "triangle":
        return _launch_triangle(factors, axes, sizes, distinct, off)
    out = _launch("trijoin", list(zip(factors, axes)), sizes, distinct, off,
                  block)
    tri_routes["trijoin_dense"] += 1
    return out


def tri_reduce_tiles(factors, axes, *, n, distinct: bool = True,
                     block: int = 128, offsets=None) -> torch.Tensor:
    """f64 partials of ``tri_reduce`` on the factors' device.  ``n`` is the
    cut-axis length, or a (n0, n1, n2) triple for a sliced caller."""
    sizes = _tri_sizes(n)
    factors, axes = _tri_check(factors, axes, sizes)
    return _tri_join(factors, axes, sizes, distinct, block, offsets)


def tri_reduce(factors, axes, *, n, distinct: bool = True, block: int = 128,
               offsets=None) -> float:
    """Σ over (pairwise-distinct) index triples of Π_i F_i, where factor
    i spans only the cut axes ``axes[i]`` (a sorted subset of (0, 1, 2))
    and broadcasts along the rest — the |cut| = 3 decomposition join.
    Axes no factor covers still count: every cell of the n^3 grid that
    passes the mask contributes the product.  On the dense route each f32
    partial accumulates at most ``block`` cells, so ``exact_block``
    certifies the same bound as for the pair tier; the path and triangle
    routes (``tri_route``) multiply and sum in f64."""
    return tri_reduce_tiles(factors, axes, n=n, distinct=distinct,
                            block=block, offsets=offsets).sum().item()


def prod_reduce_keep_tiles(factors, *, keep: int = 0, distinct: bool = True,
                           block: int = 128, offsets=None,
                           f64: bool = False) -> torch.Tensor:
    """(P, n_keep) f64 partials of ``prod_reduce_keep`` on the factors'
    device; their sum over dim 0 is the output vector.  On the card the
    lead factor's strides pick the entry (``keep_entry``): the row entry
    returns the output itself, P = 1.  ``f64`` takes the f64 instance."""
    factors = _pair_check(factors)
    if keep not in (0, 1):
        raise ValueError(f"keep={keep}: a pair join keeps axis 0 or 1")
    if not factors[0].is_cuda:
        return _pair_keep_partials_plain(factors, keep, distinct, block,
                                         offsets, f64)
    m, n = factors[0].shape
    if m == 0 or n == 0:
        return torch.zeros((1, (m, n)[keep]), dtype=torch.float64,
                           device=factors[0].device)
    off = _offsets(offsets, 2)
    if keep_entry(factors[0], keep) == "rows":
        return _launch_keep_rows(factors, keep, distinct, off, block, f64)
    if keep == 0:       # rows are kept: row axis -> thread axis 2
        return _launch("pairjoin_keep", [(F, (2, 1)) for F in factors],
                       (1, n, m), distinct, (0, off[1], off[0]), block, f64)
    return _launch("pairjoin_keep", [(F, (1, 2)) for F in factors],
                   (1, m, n), distinct, (0, off[0], off[1]), block, f64)


def prod_reduce_keep(factors, *, keep: int = 0, distinct: bool = True,
                     block: int = 128, offsets=None,
                     f64: bool = False) -> torch.Tensor:
    """Keep-axis masked product-reduce over (m, n) factors, as an f64
    vector on the factors' device:

        keep=0:  out[x] = Σ_y [gx≠gy] · Π_i F_i[x, y]
        keep=1:  out[y] = Σ_x [gx≠gy] · Π_i F_i[x, y]

    The anchored partial-embedding read off a |cut| = 2 join.  Exact for
    integer-valued factors that ``exact_block`` admits with ``block`` —
    each f32 partial folds the same ≤ ``block`` cells as ``prod_reduce``
    — or, with ``f64`` (f64 products and sums), for factors that
    ``exact_f64`` admits over the reduced axis.  ``offsets`` gives the
    factors' global start index per cut axis."""
    tiles = prod_reduce_keep_tiles(factors, keep=keep, distinct=distinct,
                                   block=block, offsets=offsets, f64=f64)
    return tiles[0] if tiles.shape[0] == 1 else tiles.sum(0)


def tri_reduce_keep_tiles(factors, axes, *, keep: int, n,
                          distinct: bool = True, block: int = 128,
                          offsets=None) -> torch.Tensor:
    """(P, n_keep) f64 partials of ``tri_reduce_keep`` on the factors'
    device; their sum over dim 0 is the output vector.  On the card the
    lead factor's strides pick the entry (``tri_keep_entry``)."""
    sizes = _tri_sizes(n)
    factors, axes = _tri_check(factors, axes, sizes)
    if keep not in (0, 1, 2):
        raise ValueError(f"keep={keep}: a tri join keeps axis 0, 1 or 2")
    if not factors[0].is_cuda:
        return _tri_partials_plain(factors, axes, sizes, distinct, block,
                                   offsets, keep=keep)
    if min(sizes) == 0:
        return torch.zeros((1, sizes[keep]), dtype=torch.float64,
                           device=factors[0].device)
    off = _offsets(offsets, 3)
    if tri_keep_entry(factors, axes, keep, sizes) == "slab":
        return _launch_tri_keep_slab(factors, axes, sizes, keep, distinct,
                                     off, block)
    # the template: the kept axis becomes kernel axis 2 (the thread axis),
    # the other two keep their order as kernel axes 0 and 1: only strides
    # move
    others = [a for a in range(3) if a != keep]
    kaxis = {others[0]: 0, others[1]: 1, keep: 2}
    ksizes, koff = [0] * 3, [0] * 3
    for a in range(3):
        ksizes[kaxis[a]], koff[kaxis[a]] = sizes[a], off[a]
    entries = [(F, tuple(kaxis[a] for a in ax))
               for F, ax in zip(factors, axes)]
    return _launch("trijoin_keep", entries, tuple(ksizes), distinct,
                   tuple(koff), block)


def tri_reduce_keep(factors, axes, *, keep: int, n, distinct: bool = True,
                    block: int = 128, offsets=None) -> torch.Tensor:
    """Keep-axis tri-join: out[w] = Σ over the other two (pairwise-
    distinct) cut axes of Π_i F_i, an f64 vector on the factors' device —
    the anchored partial-embedding vector of a |cut| = 3 plan.  Factors
    span axis subsets as in ``tri_reduce``; ``offsets`` are per original
    cut axis.  The same ``exact_block`` bound holds."""
    return tri_reduce_keep_tiles(factors, axes, keep=keep, n=n,
                                 distinct=distinct, block=block,
                                 offsets=offsets).sum(0)


class ReduceBuffers(NamedTuple):
    """One dense ``matreduce`` call's buffers: K7's prep buffers without
    an output (operands, bf16 copies, state), and the f64 partials — the
    tensor-core CTAs' (one per 128 x 256 tile), then the FMA blocks' (one
    per 128 x 128 tile); the route not taken writes zeros."""
    prep: _ksd.Buffers
    partials: torch.Tensor
    n_tc: int


def matreduce_buffers(lhs, rhs, mask) -> ReduceBuffers:
    """The buffers of one ``matreduce`` call on card operands (M, N, K >=
    1), as the wrapper allocates them."""
    prep = _ksd.buffers(*_mm_operands(lhs, rhs, mask), out=False)
    (M, _), N = prep.lhs.shape, prep.rhs.shape[0]
    tm = -(-M // _ksd.TILE)
    n_tc = tm * -(-N // _TC_COLUMNS)
    partials = torch.empty((n_tc + tm * -(-N // _ksd.TILE),),
                           dtype=torch.float64, device=prep.lhs.device)
    return ReduceBuffers(prep, partials, n_tc)


def matreduce_launch(buf: ReduceBuffers, steps=MATREDUCE_STEPS):
    """Launch ``steps`` (entries of ``MATREDUCE_STEPS``, in that order) of
    one call on its buffers; each launch adds one to its count in
    ``matreduce_entries``."""
    lib = _lib("matreduce")
    p, partials = buf.prep, buf.partials
    (M, K), N = p.lhs.shape, p.rhs.shape[0]
    with torch.cuda.device(p.lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in steps:
            if step == "matreduce_prep":
                err = lib.sddmm_prep(*_ksd.prep_args(p, stream))
            elif step == "matreduce_tc":
                err = lib.matreduce_tc(
                    p.a.data_ptr(), p.a.stride(0), p.b.data_ptr(),
                    p.b.stride(0), p.mask.data_ptr(), p.mask.stride(0),
                    partials.data_ptr(), M, N, K, p.state.data_ptr(), 1,
                    int(p.same), stream)
            elif step == "matreduce_f32":
                err = lib.matreduce_f32(
                    p.lhs.data_ptr(), p.rhs.data_ptr(), p.mask.data_ptr(), M,
                    N, K, p.lhs.stride(0), p.rhs.stride(0), p.mask.stride(0),
                    partials[buf.n_tc:].data_ptr(), p.state.data_ptr(),
                    int(p.same), stream)
            else:
                raise ValueError(f"matreduce has no step {step!r}")
            if err != 0:
                raise _build.KernelError(f"{step} launch failed: CUDA error "
                                         f"{err}")
            matreduce_entries[step] += 1


def matreduce_tiles(lhs, rhs, mask) -> torch.Tensor:
    """f64 per-thread-block partials of ``matreduce`` on the operands'
    device; their sum is the result."""
    global last_exact, last_tiles
    lhs, rhs, mask = _mm_operands(lhs, rhs, mask)
    if not lhs.is_cuda:
        return _matreduce_plain(lhs, rhs, mask)
    (M, K), N = lhs.shape, rhs.shape[0]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((1,), dtype=torch.float64, device=lhs.device)
    buf = matreduce_buffers(lhs, rhs, mask)
    matreduce_launch(buf)
    launches["matreduce"] += 1
    state = buf.prep.state
    last_exact = state[_ksd._EXACT_SLOT:_ksd._EXACT_SLOT + 1]
    last_tiles = state[_ksd._STATE_HEAD:].view(-(-M // _ksd.TILE),
                                               -(-N // _ksd.TILE))
    return buf.partials


def matreduce(lhs, rhs, mask) -> float:
    """Σ_{i,j} mask[i,j] · (lhs @ rhsᵀ)[i,j] for lhs (M, K), rhs (N, K),
    mask (M, N); other dtypes are cast to f32.  The product is exact f32
    (no TF32; on the tensor cores only where the flag makes bf16 exact);
    the masked cells are summed in f64, so 0/1 inputs give the exact
    integer while every product cell stays below 2^24."""
    return matreduce_tiles(lhs, rhs, mask).sum().item()


class TileListBuffers(NamedTuple):
    """One ``matreduce_tilelist`` call's buffers on the card: the f32
    stack as (T·128, 128) rows (tiles narrower than 128 zero-padded), its
    bf16 copy, the four lists as int32 views of one tensor, the f64
    partials (the tensor-core CTAs', then the FMA blocks', one each per
    output tile), the zeroed state, and the flag's K (128 × the longest
    list)."""
    rows: torch.Tensor
    x16: torch.Tensor
    out_idx: torch.Tensor
    k_ptr: torch.Tensor
    lhs_idx: torch.Tensor
    rhs_idx: torch.Tensor
    partials: torch.Tensor
    state: torch.Tensor
    kflag: int


def tilelist_buffers(stack, out_idx, k_ptr, lhs_idx,
                     rhs_idx) -> TileListBuffers:
    """The buffers of one ``matreduce_tilelist`` call on a card stack with
    at least one output tile, as the wrapper allocates them: the lists
    reach the card in one copy."""
    return _tilelist_buffers(*_tilelist_operands(stack, out_idx, k_ptr,
                                                 lhs_idx, rhs_idx))


def _tilelist_buffers(stack, out_idx, k_ptr, lhs_idx, rhs_idx):
    tile, t = _ksd.TILE, stack.shape[1]
    if t > tile:
        raise ValueError(f"matreduce_tilelist takes tiles of at most "
                         f"{tile} x {tile} on the card: {t} x {t}")
    if t < tile:
        stack = torch.nn.functional.pad(stack, (0, tile - t, 0, tile - t))
    rows = stack.contiguous().view(-1, tile)
    dev, O, P = rows.device, len(out_idx), len(lhs_idx)
    idx = torch.from_numpy(np.concatenate(
        [out_idx, k_ptr, lhs_idx, rhs_idx]).astype(np.int32)).to(dev)
    x16 = torch.empty(rows.shape, dtype=torch.bfloat16, device=dev)
    return TileListBuffers(
        rows, x16, idx[:O], idx[O:2 * O + 1], idx[2 * O + 1:2 * O + 1 + P],
        idx[2 * O + 1 + P:],
        torch.empty((2 * O,), dtype=torch.float64, device=dev),
        torch.zeros((_ksd._STATE_HEAD,), dtype=torch.int32, device=dev),
        tile * int(np.diff(k_ptr).max()))


def tilelist_launch(buf: TileListBuffers, steps=TILELIST_STEPS):
    """Launch ``steps`` (entries of ``TILELIST_STEPS``, in that order) of
    one call on its buffers; each launch adds one to its count in
    ``matreduce_entries``."""
    lib = _lib("matreduce")
    n_rows, O = buf.rows.shape[0], buf.out_idx.shape[0]
    lists = (buf.out_idx.data_ptr(), buf.k_ptr.data_ptr(),
             buf.lhs_idx.data_ptr(), buf.rhs_idx.data_ptr())
    with torch.cuda.device(buf.rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in steps:
            if step == "tilelist_prep":
                width = _PREP_WIDTH
                err = lib.matreduce_stack_prep(
                    buf.rows.data_ptr(), buf.rows.numel() // width, width,
                    width, buf.x16.data_ptr(), width, buf.state.data_ptr(),
                    stream)
            elif step == "tilelist_tc":
                err = lib.matreduce_tilelist_tc(
                    buf.x16.data_ptr(), n_rows, buf.rows.data_ptr(), *lists,
                    O, buf.kflag, buf.partials.data_ptr(),
                    buf.state.data_ptr(), stream)
            elif step == "tilelist_f32":
                err = lib.matreduce_tilelist_f32(
                    buf.rows.data_ptr(), n_rows, *lists, O, buf.kflag,
                    buf.partials[O:].data_ptr(), buf.state.data_ptr(),
                    stream)
            else:
                raise ValueError(f"matreduce_tilelist has no step {step!r}")
            if err != 0:
                raise _build.KernelError(f"{step} launch failed: CUDA error "
                                         f"{err}")
            matreduce_entries[step] += 1


def matreduce_tilelist_tiles(stack, out_idx, k_ptr, lhs_idx,
                             rhs_idx) -> torch.Tensor:
    """f64 partials of ``matreduce_tilelist`` on the stack's device;
    their sum is the result."""
    global last_exact
    stack, out_idx, k_ptr, lhs_idx, rhs_idx = _tilelist_operands(
        stack, out_idx, k_ptr, lhs_idx, rhs_idx)
    if not stack.is_cuda:
        return _tilelist_plain(stack, out_idx, k_ptr, lhs_idx, rhs_idx)
    if len(lhs_idx) == 0:
        return torch.zeros((1,), dtype=torch.float64, device=stack.device)
    buf = _tilelist_buffers(stack, out_idx, k_ptr, lhs_idx, rhs_idx)
    tilelist_launch(buf)
    launches["matreduce_tilelist"] += 1
    last_exact = buf.state[_ksd._EXACT_SLOT:_ksd._EXACT_SLOT + 1]
    return buf.partials


def matreduce_tilelist(stack, out_idx, k_ptr, lhs_idx, rhs_idx) -> float:
    """Σ_o Σ stack[out_idx[o]] ⊙ (Σ_p stack[lhs_idx[p]] @
    stack[rhs_idx[p]]ᵀ), p over [k_ptr[o], k_ptr[o + 1]), for a (T, t, t)
    f32 stack (other dtypes are cast; on the card t <= 128) and host
    integer lists: K6 over many output tiles in one call, each with its
    own list of tile products (``core.blocksparse``).  Arithmetic as
    ``matreduce``; the flag's K is 128 × the longest list."""
    return matreduce_tilelist_tiles(stack, out_idx, k_ptr, lhs_idx,
                                    rhs_idx).sum().item()
