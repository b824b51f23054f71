"""The triangle route's tile walk and cell maps (``csrc/tri_order.cuh``,
the order in which ``tri_mma`` in ``csrc/trijoin.cu`` takes its tiles and
where it puts and reads each value), built from the kernel's own header
by the host C++ compiler.

The walk takes every (x, z) tile once, one partial each, as many as the
host allocates.  A stage's cells are where a TMA load with 128-byte
swizzle writes them; the fragments, assembled as the kernel assembles
them and multiplied as the PTX ISA's f64 ``mma.sync`` shapes lay out
their registers, give the warp's block of A′·B′ᵀ; no fragment load has
a shared-memory bank conflict; and the wrapper hands the kernel each of
A′ and B′ as one factor TMA reads in place."""
from __future__ import annotations

import ctypes
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as tbuild
from repro_torch.kernels import matreduce as mr

_HARNESS = r"""
#include "tri_order.cuh"
using namespace tri_order;
extern "C" {
int tile_x() { return TILE_X; }
int stage_k() { return BK; }
int warp_rows() { return WM; }
int warp_cols() { return WN; }
long long n_tiles(int nx, int nz, int tile_z) { return tiles(nx, nz, tile_z); }
// the tiles of the persistent CTAs of a launch with `slots` CTAs resident,
// CTA by CTA, each in the order it takes them, as tri_mma walks them
long long walk(int nx, int nz, int tile_z, int slots, int* tx, int* tz,
               long long* idx, int* cta) {
  const int txs = (nx + TILE_X - 1) / TILE_X;
  const int tzs = (nz + tile_z - 1) / tile_z;
  const long long n = tiles(nx, nz, tile_z);
  const int g = grid(n, slots);
  long long m = 0;
  for (int b = 0; b < g; ++b)
    for (long long i = b; i < n; i += g) {
      const Tile at = tile_at((int)i, txs, tzs);
      tx[m] = at.tx; tz[m] = at.tz; idx[m] = i; cta[m] = b; ++m;
    }
  return m;
}
int cell(int kin, int r, int k) { return offset(kin, r, k); }
int kap(int t, int q) { return kappa(t, q); }
int arow(int kin, int i, int h, int g) { return a_row(kin, i, h, g); }
int brow(int kin, int j, int g) { return b_row(kin, j, g); }
int accx(int kin, int i, int c, int g) { return acc_x(kin, i, c, g); }
int accz(int kin, int j, int c, int t) { return acc_z(kin, j, c, t); }
int fbase(int kin, int r0, int t) { return frag_base(kin, r0, t); }
int fxor(int kin, int d, int q) { return frag_xor(kin, d, q); }
int fadd(int kin, int d, int q) { return frag_add(kin, d, q); }
}
"""


@pytest.fixture(scope="module")
def header(tmp_path_factory):
    """``tri_order.cuh`` compiled for the host, its functions bound."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/tri_order.cuh")
    d = tmp_path_factory.mktemp("tri_order")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libtri_order.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{tbuild.CSRC}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    h = ctypes.CDLL(str(lib))
    I, P = ctypes.c_int, ctypes.c_void_p
    h.n_tiles.argtypes = [I, I, I]
    h.n_tiles.restype = ctypes.c_longlong
    h.walk.argtypes = [I, I, I, I, P, P, P, P]
    h.walk.restype = ctypes.c_longlong
    for name, n in (("cell", 3), ("kap", 2), ("arow", 4), ("brow", 3),
                    ("accx", 4), ("accz", 4), ("fbase", 3), ("fxor", 3),
                    ("fadd", 3)):
        getattr(h, name).argtypes = [I] * n
    return h


def walk(h, nx: int, nz: int, tile_z: int, slots: int):
    n = h.n_tiles(nx, nz, tile_z)
    tx, tz, cta = (np.empty(n, np.int32) for _ in range(3))
    idx = np.empty(n, np.int64)
    m = h.walk(nx, nz, tile_z, slots, tx.ctypes.data, tz.ctypes.data,
               idx.ctypes.data, cta.ctypes.data)
    assert m == n
    return tx, tz, idx, cta


# (nx, nz): the main path's n = 8192, the smoke's slices (1000 of 8192,
# 400 of 1024, the ragged mix (1000, 777, 333)), the mesh path's row
# blocks at 3 and 4 slots of 8192, and the tile edges and their neighbours
WALKS = [(8192, 8192), (1000, 8192), (400, 1024), (1000, 333), (2048, 8192),
         (2731, 8192), (2730, 8192), (128, 128), (127, 127), (129, 129),
         (127, 129), (129, 127), (128, 64), (129, 63), (127, 65), (1, 1),
         (257, 1)]


@pytest.mark.parametrize("nx,nz", WALKS)
@pytest.mark.parametrize("tile_z,slots", [(64, 3 * 132), (128, 132),
                                          (64, 7)])
def test_walk_takes_every_tile_once(header, nx, nz, tile_z, slots):
    """Every (x, z) tile once, at a partial index of its own, as many
    partials as the host allocates; each CTA's tiles in raster order, a
    grid apart; the raster grouped by GROUP x tiles."""
    tile_x = header.tile_x()
    tiles_x, tiles_z = -(-nx // tile_x), -(-nz // tile_z)
    n = mr._triangle_partials(nx, nz, tile_x, tile_z)
    assert header.n_tiles(nx, nz, tile_z) == n == tiles_x * tiles_z
    tx, tz, idx, cta = walk(header, nx, nz, tile_z, slots)
    assert np.array_equal(np.sort(idx), np.arange(n))
    assert np.array_equal(np.sort(tx.astype(np.int64) * tiles_z + tz),
                          np.arange(n))
    grid = min(n, slots)
    assert np.array_equal(cta, idx % grid)
    assert np.array_equal(np.sort(np.unique(cta)), np.arange(grid))
    for b in range(grid):
        assert np.array_equal(idx[cta == b], np.arange(b, n, grid))
    # the grouped raster: GROUP (8) x tiles, z tile by z tile, x fastest
    want = {}
    i = 0
    for first in range(0, tiles_x, 8):
        size = min(8, tiles_x - first)
        for z in range(tiles_z):
            for x in range(first, first + size):
                want[i] = (x, z)
                i += 1
    assert all(want[int(k)] == (int(x), int(z))
               for k, x, z in zip(idx, tx, tz))


def _swizzle128(byte: int) -> int:
    """The byte a 128-byte TMA swizzle moves `byte` of a 1024-aligned box
    to: the 16-byte chunk index XOR the 128-byte line's index mod 8."""
    return byte ^ (((byte >> 7) & 7) << 4)


@pytest.mark.parametrize("kin", [True, False])
def test_stage_cells_are_where_tma_writes_them(header, kin):
    """k-inner: one box of 16 k x 128 rows (128-byte lines of 16 k);
    row-inner: eight boxes of 16 rows x 16 k, 2 KB each.  Every cell of a
    stage at its own double; the pairs that a 16-byte cp.async copies
    (along the unit-stride axis) side by side."""
    tile, bk = header.tile_x(), header.stage_k()
    seen = set()
    for r in range(tile):
        for k in range(bk):
            got = header.cell(kin, r, k)
            dense = (r * 128 + k * 8 if kin
                     else (r // 16) * 2048 + k * 128 + (r % 16) * 8)
            assert got * 8 == _swizzle128(dense), (r, k)
            seen.add(got)
            if kin and k % 2 == 0:
                assert header.cell(kin, r, k + 1) == got + 1
            if not kin and r % 2 == 0:
                assert header.cell(kin, r + 1, k) == got + 1
    assert seen == set(range(tile * bk))


@pytest.mark.parametrize("kin", [True, False])
def test_fragment_cells_are_a_lane_base_xor_and_plus_constants(header, kin):
    """Every fragment cell the kernel reads, at a warp's first row r0 (a
    multiple of 16 plus rho(g)), a row step d (a multiple of 8) and q, is
    its lane's base XOR a constant plus a constant, both of (d, q) alone:
    a few registers a lane and an immediate a load.  The XOR stays inside
    the low 7 bits (a 128-byte line), which a 1024-aligned stage and the
    row part of the base leave clear."""
    h = header
    for w in range(0, h.tile_x(), 16):
        for g in range(8):
            r0 = w + h.arow(kin, 0, 0, g)
            for t in range(4):
                base = h.fbase(kin, r0, t)
                for d in range(0, h.tile_x() - w, 8):
                    for q in range(4):
                        x = h.fxor(kin, d, q)
                        assert x < 128 and (base & ~127) == \
                            ((base ^ x) & ~127)
                        assert 8 * h.cell(kin, r0 + d, h.kap(t, q)) == \
                            (base ^ x) + h.fadd(kin, d, q)


def _mma_registers(mma_k: int):
    """Per instruction of one 16 x 8 x 16 block, the (h, q) of the kernel's
    A fragment a[h][q] and the q of b[q] that each PTX register gets, with
    the (row, k) the PTX ISA lays that register at, for lane (g, t):
    m16n8k16: a_r at (g + 8 (r % 2), t + 4 (r // 2)), b_r at k = t + 4r;
    m16n8k8: a_r at (g + 8 (r % 2), t + 4 (r // 2)), b_r at t + 4r;
    m16n8k4: a_r at (g + 8r, t), b_0 at t."""
    steps = []
    if mma_k == 16:
        steps.append(([(r % 2, r // 2) for r in range(8)], list(range(4))))
    elif mma_k == 8:
        for s in (0, 2):
            steps.append(([(r % 2, s + r // 2) for r in range(4)],
                          [s, s + 1]))
    else:
        for s in range(4):
            steps.append(([(0, s), (1, s)], [s]))
    return steps


@pytest.mark.parametrize("kin_a,kin_b", list(itertools.product(
    [True, False], repeat=2)))
@pytest.mark.parametrize("mma_k", [4, 8, 16])
def test_fragments_give_the_warps_block_of_the_product(header, kin_a, kin_b,
                                                       mma_k):
    """Each warp's accumulators, as the kernel fills and reads them, are
    its 64 x 32 block of A·Bᵀ over a stage's 16 k, each cell once."""
    h = header
    tile, bk, wm_, wn_ = h.tile_x(), h.stage_k(), h.warp_rows(), \
        h.warp_cols()
    rng = np.random.default_rng(0)
    A = rng.integers(-9, 10, size=(tile, bk))
    B = rng.integers(-9, 10, size=(tile, bk))
    want = A @ B.T
    steps = _mma_registers(mma_k)
    for wm in range(0, tile, wm_):
        for wn in range(0, tile, wn_):
            got = np.zeros((wm_, wn_), np.int64)
            hits = np.zeros((wm_, wn_), np.int64)
            for i in range(wm_ // 16):
                for j in range(wn_ // 8):
                    D = np.zeros((16, 8), np.int64)
                    # the kernel's a[h][q] and b[q] of every lane
                    a = {(g, t): [[A[wm + h.arow(kin_a, i, hh, g),
                                     h.kap(t, q)] for q in range(4)]
                                  for hh in range(2)]
                         for g in range(8) for t in range(4)}
                    b = {(g, t): [B[wn + h.brow(kin_b, j, g), h.kap(t, q)]
                                  for q in range(4)]
                         for g in range(8) for t in range(4)}
                    for a_regs, b_regs in steps:
                        kk_n = 4 * len(b_regs)
                        Am = np.zeros((16, kk_n), np.int64)
                        Bm = np.zeros((kk_n, 8), np.int64)
                        for g in range(8):
                            for t in range(4):
                                for r, (hh, q) in enumerate(a_regs):
                                    m = g + 8 * (r % 2 if mma_k > 4 else r)
                                    kk = t + 4 * (r // 2 if mma_k > 4 else 0)
                                    Am[m, kk] = a[g, t][hh][q]
                                for r, q in enumerate(b_regs):
                                    Bm[t + 4 * r, g] = b[g, t][q]
                        D += Am @ Bm
                    for g in range(8):
                        for t in range(4):
                            for c in range(4):
                                x = h.accx(kin_a, i, c, g)
                                z = h.accz(kin_b, j, c, t)
                                got[x, z] = D[g + 8 * (c // 2), 2 * t + c % 2]
                                hits[x, z] += 1
            assert (hits == 1).all()
            assert np.array_equal(got, want[wm:wm + wm_, wn:wn + wn_])


@pytest.mark.parametrize("kin", [True, False])
@pytest.mark.parametrize("operand", ["a", "b"])
def test_fragment_loads_have_no_bank_conflict(header, kin, operand):
    """k-inner: two 16-byte loads a row, q = 0, 1 and q = 2, 3, each
    quarter warp on eight distinct 16-byte bank groups; row-inner: four
    8-byte loads a row, each half warp on sixteen distinct 8-byte bank
    pairs (32 banks of 4 bytes).  At every warp offset of the tile."""
    h = header
    tile, wm_, wn_ = h.tile_x(), h.warp_rows(), h.warp_cols()
    if operand == "a":
        bases = range(0, tile, wm_)
        rows = [lambda g, i=i, hh=hh: h.arow(kin, i, hh, g)
                for i in range(wm_ // 16) for hh in range(2)]
    else:
        bases = range(0, tile, wn_)
        rows = [lambda g, j=j: h.brow(kin, j, g) for j in range(wn_ // 8)]
    for base in bases:
        for row in rows:
            loads = [(0, 2), (2, 2)] if kin else [(q, 1) for q in range(4)]
            for q, width in loads:
                addr = [8 * h.cell(kin, base + row(lane >> 2),
                                   h.kap(lane & 3, q)) for lane in range(32)]
                group = 8 if width == 2 else 16
                for first in range(0, 32, group):
                    part = addr[first:first + group]
                    if width == 2:
                        assert all(a_ % 16 == 0 for a_ in part)
                        banks = [(a_ // 16) % 8 for a_ in part]
                    else:
                        banks = [(a_ // 8) % 16 for a_ in part]
                    assert len(set(banks)) == group, (base, q, part)


def _tma_reads(F, sr: int, sk: int, rows: int, k: int) -> bool:
    """What csrc/trijoin.cu's tma_reads asks of a factor."""
    return F.data_ptr() % 16 == 0 and any(
        unit == 1 and other % 2 == 0 and extent <= other < 1 << 37
        for unit, other, extent in ((sk, sr, k), (sr, sk, rows)))


@pytest.mark.parametrize("case", ["row-major", "transposed", "strided",
                                  "unaligned", "odd stride", "extra factors",
                                  "one row", "one column"])
def test_triangle_operands_reach_the_kernel_as_one_tma_factor(case):
    """``_tri_tma_operand`` hands the kernel each of A′ and B′ as one f64
    factor TMA reads in place: a factor TMA reads is passed as it is (the
    same tensor, no copy); any other, or an operand with other factors (a
    vector on y, a second pair factor), becomes a buffer holding the
    operand's product, equal to the plain version's operand."""
    rng = np.random.default_rng(7)
    rows, k = {"one row": (1, 37), "one column": (37, 1)}.get(case, (37, 29))

    def factor(shape):
        return torch.from_numpy(rng.integers(0, 9, size=shape).astype(
            np.float64))

    if case == "row-major":
        F = factor((rows, k + 1))[:, :k]                  # even row stride
    elif case == "transposed":
        F = factor((k, rows + 1))[:, :rows].T             # unit row stride
    elif case == "strided":
        F = factor((2 * rows, 3 * k))[::2, ::3]
    elif case == "unaligned":
        F = factor((rows * (k + 1) + 1,))[1:].view(rows, k + 1)[:, :k]
    elif case == "odd stride":
        F = factor((rows, k))                             # k = 29: odd
    else:
        F = factor((rows, k))
    entries = [(F, F.stride(0), F.stride(1))]
    if case == "extra factors":
        G, v = factor((rows, k)), factor((k,))
        entries += [(G, G.stride(0), G.stride(1)), (v, 0, 1)]
    got = mr._tri_tma_operand(entries, rows, k)
    assert len(got) == 1
    X, sr, sk = got[0]
    assert (sr, sk) == (X.stride(0), X.stride(1))
    assert _tma_reads(X, sr, sk, rows, k)
    want = mr._dense_operand(entries, (rows, k), torch.device("cpu"))
    assert torch.equal(torch.as_strided(X, (rows, k), (sr, sk),
                                        X.storage_offset()), want)
    passed = _tma_reads(F, F.stride(0), F.stride(1), rows, k) and \
        len(entries) == 1
    assert (X is F) == passed
    assert passed == (case in ("row-major", "transposed"))
