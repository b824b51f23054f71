"""Packed-bitset neighbour intersection: per-row popcount(a & b).

The paper's set-intersection inner loop: for a batch of vertex pairs, AND
their packed neighbour bitsets and count the bits — common-neighbour
counts per edge (per-edge triangle counts).

``pack_bitsets``            (R, N) bool adjacency -> (R, ⌈N/32⌉) words,
                            bit j of word w = column 32·w + j.
``bitset_intersect``        (E, W) words × 2 -> (E,) int32 counts.
``bitset_intersect_edges``  (N, W) table and (E, 2) vertex pairs -> (E,)
                            int32 counts of the pairs' rows, gathered
                            inside the kernel (no (E, W) copies).

They replace the reference package's TPU kernel ``bitset_intersect``
(``src/repro/kernels/bitset.py``) and its host-side ``pack_bitsets``.  On
a CUDA tensor the entries launch ``bitset_pack`` / ``bitset_rows`` /
``bitset_edges`` of ``csrc/bitset.cu`` (compiled at first use, see
``kernels.build``; the source says what bounds them on the card).  On a
CPU tensor — and only because the tensor lies on the CPU — they take the
plain PyTorch versions ``pack_bitsets_plain`` /
``bitset_intersect_plain`` / ``bitset_intersect_edges_plain``.

**Pairs are checked where they lie, without a host sync.**  Pairs on the
host (numpy, as ``Graph.edges`` is, or a CPU tensor) are checked with
numpy and reach the card by a copy that does not block; pairs already on
the card are checked by the kernel, which gives an out-of-range pair 0
and raises a flag word that the wrapper reads once (4 bytes).  Either
way an out-of-range pair raises ``ValueError``.

**Words.**  PyTorch's ``uint32`` has few operators, so words are int32
tensors holding the uint32 bits (``.numpy().view(np.uint32)`` gives the
reference's words back).  The kernels read them as uint32; the plain
versions widen to int64 and mask to the low 32 bits before counting, since
a right shift of an int32 word with bit 31 set is arithmetic.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build as _build

# kernel launches per entry, counted where the kernel is launched and
# nowhere else (plain-version calls do not count)
launches = {"bitset": 0, "bitset_edges": 0, "bitset_pack": 0}
# launches of bitset_edges by the entry it takes (``edges_entry``)
edge_entries = {"vec": 0, "word": 0}

_LIB = None
_LOW32 = 0xFFFFFFFF


def reset_launches():
    for table in (launches, edge_entries):
        for k in table:
            table[k] = 0


def _lib():
    """The ``bitset`` kernel library, bound; the first call builds every
    library of the package."""
    global _LIB
    if _LIB is None:
        lib = _build.load_all(_build.SOURCES)["bitset"]
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bitset_rows.argtypes = [P, P, L, I, L, L, P, P]
        lib.bitset_rows.restype = I
        lib.bitset_edges.argtypes = [P, I, L, L, P, L, P, P, I, P]
        lib.bitset_edges.restype = I
        lib.bitset_pack.argtypes = [P, L, L, L, I, P, P]
        lib.bitset_pack.restype = I
        _LIB = lib
    return _LIB


def _words(x) -> torch.Tensor:
    """Packed words as an int32 tensor with the same bits (numpy uint32
    arrays are reinterpreted, not converted)."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint32:
        x = x.view(np.int32)
    x = torch.as_tensor(x)
    if x.dtype in (torch.uint32, torch.int64):
        # keep the low 32 bits, as uint32 words hold them
        x = x.to(torch.int64) & _LOW32
        x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    if x.dtype != torch.int32:
        raise ValueError(f"packed words must be 32-bit integers: {x.dtype}")
    return x


def _matrix(adj_bool) -> torch.Tensor:
    adj = torch.as_tensor(adj_bool)
    if adj.ndim != 2:
        raise ValueError(f"pack_bitsets takes an (R, N) matrix: "
                         f"{tuple(adj.shape)}")
    return adj


def pack_bitsets_plain(adj_bool) -> torch.Tensor:
    """Plain PyTorch version of ``pack_bitsets``: each entry's
    ``!= 0`` as an int64 bit, shifted to its place and summed per word."""
    adj = _matrix(adj_bool)
    R, n = adj.shape
    W = (n + 31) // 32
    bits = torch.zeros((R, W * 32), dtype=torch.int64, device=adj.device)
    bits[:, :n] = adj != 0
    shifts = torch.arange(32, dtype=torch.int64, device=adj.device)
    words = (bits.view(R, W, 32) << shifts).sum(dim=2)
    return _words(words)


def pack_bitsets(adj_bool) -> torch.Tensor:
    """(R, N) 0/1 (or bool) adjacency -> (R, ⌈N/32⌉) int32 words on its
    device, bit j of word w = [column 32·w + j != 0]: on 0/1 input the
    reference's layout, bit for bit.  Other input packs each entry's
    ``!= 0`` (a uint8 2, a 0.5 or a 256.0 sets its bit), where the
    reference multiplies its uint8 cast by 2^j (a 2 carries into the next
    bit; 0.5 and 256.0 cast to 0).  On the card a bool or uint8 matrix is
    read as it is (other dtypes go through one ``!= 0`` first) by
    ``bitset_pack``."""
    adj = _matrix(adj_bool)
    if not adj.is_cuda:
        return pack_bitsets_plain(adj)
    if adj.dtype not in (torch.bool, torch.uint8):
        adj = adj != 0
    R, n = adj.shape
    W = (n + 31) // 32
    out = torch.empty((R, W), dtype=torch.int32, device=adj.device)
    if R == 0 or n == 0:
        return out
    if not (adj.stride(1) == 1 and adj.stride(0) >= n):
        adj = adj.contiguous()
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bitset_pack(adj.data_ptr(), R, n, adj.stride(0), W,
                                 out.data_ptr(), stream)
    if err != 0:
        raise _build.KernelError(f"bitset_pack launch failed: CUDA error "
                                 f"{err}")
    launches["bitset_pack"] += 1
    return out


def _popcount32(words: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word, SWAR in int64 so no shift is
    arithmetic."""
    v = words.to(torch.int64) & _LOW32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _pair(rows_a, rows_b):
    a, b = _words(rows_a), _words(rows_b)
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"want two (E, W) word tables: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("word tables lie on different devices")
    return a, b


def bitset_intersect_plain(rows_a, rows_b) -> torch.Tensor:
    """Plain PyTorch version of ``bitset_intersect``: AND, SWAR popcount
    in int64, row sum."""
    a, b = _pair(rows_a, rows_b)
    return _popcount32(a & b).sum(dim=1).to(torch.int32)


def bitset_intersect(rows_a, rows_b) -> torch.Tensor:
    """rows_a, rows_b: (E, W) packed words -> (E,) int32 popcounts of the
    per-row intersection, on the words' device."""
    a, b = _pair(rows_a, rows_b)
    if not a.is_cuda:
        return bitset_intersect_plain(a, b)
    E, W = a.shape
    out = torch.empty((E,), dtype=torch.int32, device=a.device)
    if E == 0:
        return out
    a, b = (x if x.stride(1) == 1 and x.stride(0) >= W else x.contiguous()
            for x in (a, b))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bitset_rows(a.data_ptr(), b.data_ptr(), E, W,
                                 a.stride(0), b.stride(0), out.data_ptr(),
                                 stream)
    if err != 0:
        raise _build.KernelError(f"bitset_rows launch failed: CUDA error "
                                 f"{err}")
    launches["bitset"] += 1
    return out


def check_pairs_host(edges: np.ndarray, rows: int) -> None:
    """Raise ``ValueError`` unless every pair of an (E, 2) integer array
    lies in [0, rows) — numpy, no device involved."""
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"want (E, 2) pairs: {edges.shape}")
    if edges.dtype.kind not in "iu":
        raise ValueError(f"vertex pairs must be integers: {edges.dtype}")
    if edges.size and (edges.min() < 0 or edges.max() >= rows):
        raise ValueError(f"vertex pairs outside [0, {rows})")


def upload(x, device) -> torch.Tensor:
    """``x`` on ``device``, from the host by a copy that does not wait for
    the card: for pageable memory CUDA stages the bytes before the call
    returns and enqueues the transfer behind the stream's work, with no
    synchronisation (a blocking copy would wait for that work)."""
    return torch.as_tensor(x).to(device, non_blocking=True)


def _table_edges(table, edges):
    """The (N, W) word table and the (E, 2) int64 pairs on its device, and
    whether the pairs were checked on the host (else the kernel checks
    them)."""
    t = _words(table)
    if t.ndim != 2:
        raise ValueError(f"want an (N, W) table: {tuple(t.shape)}")
    host = not (isinstance(edges, torch.Tensor) and edges.is_cuda)
    if host:
        e = edges.numpy() if isinstance(edges, torch.Tensor) \
            else np.asarray(edges)
        check_pairs_host(e, t.shape[0])
        e = upload(e.astype(np.int64, copy=False), t.device)
    else:
        e = edges
        if e.ndim != 2 or e.shape[1] != 2:
            raise ValueError(f"want (E, 2) pairs: {tuple(e.shape)}")
        if e.dtype.is_floating_point or e.dtype == torch.bool:
            raise ValueError(f"vertex pairs must be integers: {e.dtype}")
        e = e.to(device=t.device, dtype=torch.int64)
    return t, e, host


def bitset_intersect_edges_plain(table, edges) -> torch.Tensor:
    """Plain PyTorch version of ``bitset_intersect_edges``: gather both
    rows of every pair, then as ``bitset_intersect_plain``."""
    t, e, host = _table_edges(table, edges)
    if not host:
        check_pairs_host(e.cpu().numpy(), t.shape[0])
    return bitset_intersect_plain(t[e[:, 0]], t[e[:, 1]])


def edges_entry(table: torch.Tensor) -> str:
    """The entry ``bitset_edges`` takes for this table: "vec" — row u held
    in registers along each run of consecutive edges, 16-byte loads —
    where W is a multiple of 4 and at most 1024 and every row starts on a
    16-byte boundary (the kernel refuses it otherwise); else "word"."""
    W = table.shape[1]
    return "vec" if (0 < W <= 1024 and W % 4 == 0
                     and table.stride(0) % 4 == 0
                     and table.data_ptr() % 16 == 0) else "word"


def bitset_intersect_edges(table, edges) -> torch.Tensor:
    """table: (N, W) packed words, edges: (E, 2) vertex pairs -> (E,)
    int32 popcounts of table[u] & table[v] per pair, on the table's
    device.  The kernel gathers the two rows itself.  Pairs on the host
    are checked there and reach the card without a host sync; pairs on
    the card cost one 4-byte read of the kernel's flag."""
    t, e, host = _table_edges(table, edges)
    if not t.is_cuda:
        return bitset_intersect_edges_plain(t, e)
    E, W = e.shape[0], t.shape[1]
    out = torch.empty((E,), dtype=torch.int32, device=t.device)
    if E == 0:
        return out
    if not (t.stride(1) == 1 and t.stride(0) >= W):
        t = t.contiguous()
    e = e.contiguous()
    flag = torch.zeros((1,), dtype=torch.int32, device=t.device)
    entry = edges_entry(t)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().bitset_edges(t.data_ptr(), W, t.stride(0), t.shape[0],
                                  e.data_ptr(), E, out.data_ptr(),
                                  flag.data_ptr(), int(entry == "vec"),
                                  stream)
    if err != 0:
        raise _build.KernelError(f"bitset_edges launch failed: CUDA error "
                                 f"{err}")
    launches["bitset_edges"] += 1
    edge_entries[entry] += 1
    if not host and flag.item():
        raise ValueError(f"vertex pairs outside [0, {t.shape[0]})")
    return out
