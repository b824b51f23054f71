"""K9's bf16 tile order (``csrc/tile_order.cuh``, the order ``flash_fwd``
takes its CTAs in and the group size its launch picks), built from the
kernel's own header by the host C++ compiler, and the C entries' argument
tables.  The order is held to the grid it replaced: with one group of
every (batch, head) pair it is a grid (B·H, tiles) with the pairs on x."""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as tbuild
from repro_torch.kernels import flashattn as tfa

_HARNESS = r"""
#include "tile_order.cuh"
extern "C" void order(int BH, int tiles, int group, int* bh, int* rank) {
  for (int i = 0; i < BH * tiles; ++i) {
    const tile_order::TileAt at = tile_order::tile_at(i, BH, tiles, group);
    bh[i] = at.bh;
    rank[i] = at.rank;
  }
}
extern "C" int group_of(int BH, int S, int Dq, int Dv) {
  return tile_order::heads_per_group(BH, S, Dq, Dv);
}
extern "C" long long l2_group_bytes() { return tile_order::L2_GROUP_BYTES; }
"""


@pytest.fixture(scope="module")
def header(tmp_path_factory):
    """``tile_order.cuh`` compiled for the host, its functions bound."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/tile_order.cuh")
    d = tmp_path_factory.mktemp("tile_order")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libtile_order.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{tbuild.CSRC}", "-o", str(lib),
                    str(d / "harness.cpp")], check=True)
    h = ctypes.CDLL(str(lib))
    h.order.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    h.order.restype = None
    h.group_of.argtypes = [ctypes.c_int] * 4
    h.group_of.restype = ctypes.c_int
    h.l2_group_bytes.restype = ctypes.c_longlong
    return h


def tile_order(h, BH: int, tiles: int, group: int):
    """The (pair, tile rank) of each CTA index of the linear grid, by the
    header's ``tile_at`` (rank 0 is a pair's heaviest tile)."""
    bh = np.empty(BH * tiles, np.int32)
    rank = np.empty(BH * tiles, np.int32)
    h.order(BH, tiles, group, bh.ctypes.data, rank.ctypes.data)
    return bh, rank


def _check_order(h, BH: int, tiles: int, group: int):
    bh, rank = tile_order(h, BH, tiles, group)
    # every (pair, tile rank) exactly once
    assert np.array_equal(np.sort(bh.astype(np.int64) * tiles + rank),
                          np.arange(BH * tiles))
    # groups of `group` consecutive pairs (the last may be smaller), each
    # group's CTAs together, rank by rank, the heaviest rank (0) first
    want_bh, want_rank = [], []
    for first in range(0, BH, group):
        n = min(group, BH - first)
        want_bh.append(first + np.tile(np.arange(n), tiles))
        want_rank.append(np.repeat(np.arange(tiles), n))
    assert np.array_equal(bh, np.concatenate(want_bh))
    assert np.array_equal(rank, np.concatenate(want_rank))


@pytest.mark.parametrize("BH,tiles,group", [
    (128, 32, 6),          # deepseek-v3's prefill: 6 does not divide 128
    (32, 32, 32),          # one group
    (48, 8, 5),            # dbrx-132b's heads, 5 does not divide 48
    (7, 3, 1),             # one pair a group
    (6, 1, 4),             # one tile a pair
    (5, 8, 9),             # a group larger than B·H: taken whole
    (65600, 2, 160),       # B·H past 65 535: still on grid axis x
    (65600, 1, 65600)])
def test_tile_order_visits_every_tile_once_heaviest_first(header, BH, tiles,
                                                          group):
    _check_order(header, BH, tiles, min(group, BH))


@pytest.mark.parametrize("S,block", [(1000, 128), (129, 128), (77, 128),
                                     (4096, 128)])
def test_tile_order_over_ragged_tile_counts(header, S, block):
    """Tile counts of sequences that are no multiple of the tile (the last
    tile partly past S), at the group the launch picks for them."""
    tiles = -(-S // block)
    BH = 2 * 3
    group = header.group_of(BH, S, 192, 128)
    _check_order(header, BH, tiles, group)


def test_one_group_is_the_grid_it_replaced(header):
    """With group = B·H the linear index takes the pairs fastest, then the
    tiles: blockIdx.x = pair, blockIdx.y = tile rank of a (B·H, tiles)
    grid, which is how K9's bf16 entry launched before the groups."""
    BH, tiles = 12, 5
    bh, rank = tile_order(header, BH, tiles, BH)
    assert list(zip(bh, rank)) == \
        [(x, y) for y in range(tiles) for x in range(BH)]


def test_heads_per_group_is_a_whole_divisor_within_the_l2_budget(header):
    """At deepseek-v3's (192, 128) a head streams 4096 · 320 bf16 values
    (2.6 MB) of K and V, so the budget holds 6 heads; the group is the
    largest divisor of B·H up to that, 4 of 128, so that no last group is
    short.  At least one pair however long the sequence, at most B·H."""
    budget = header.l2_group_bytes()
    assert budget == 16 << 20
    assert budget // (4096 * (192 + 128) * 2) == 6
    assert header.group_of(128, 4096, 192, 128) == 4
    assert header.group_of(96, 4096, 192, 128) == 6
    assert header.group_of(2, 64, 64, 64) == 2                # all of B·H
    assert header.group_of(4, 1 << 20, 192, 128) == 1         # one pair
    assert header.group_of(131, 4096, 128, 128) == 1          # a prime B·H
    for BH in (1, 6, 32, 48, 128, 65600):
        for S in (1, 77, 1000, 4096, 65536):
            for Dq, Dv in tfa.HEAD_DIM_PAIRS:
                g = header.group_of(BH, S, Dq, Dv)
                fits = max(1, budget // (S * (Dq + Dv) * 2))
                assert BH % g == 0 and 1 <= g <= min(BH, fits)
                assert not any(BH % d == 0
                               for d in range(g + 1, min(BH, fits) + 1))


def test_entry_tables_bind_one_type_per_argument():
    """The bf16 entries take the f32 entries' arguments; every argument has
    a name and a ctypes type."""
    for f32, bf16 in (("flashattn_f32", "flashattn_bf16"),
                      ("flashattn_bwd_f32", "flashattn_bwd_bf16")):
        assert tfa.ENTRY_ARGS[bf16] == tfa.ENTRY_ARGS[f32]
    for args in tfa.ENTRY_ARGS.values():
        names = [n for n, _ in args]
        assert len(set(names)) == len(names)
        assert all(issubclass(t, ctypes._SimpleCData) for _, t in args)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card (the wrappers' checks)."""

    @property
    def is_cuda(self):
        return True


def on_card(x):
    return torch.as_tensor(x).as_subclass(_OnCard)


class _NoContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def launched(monkeypatch):
    """The launches of a fake card, each entry with its named arguments."""
    calls = []

    class FakeLib:
        def __getattr__(self, entry):
            def launch(*args):
                names = [n for n, _ in tfa.ENTRY_ARGS[entry]]
                assert len(args) == len(names), (entry, args)
                calls.append((entry, dict(zip(names, args))))
                return 0
            return launch

    monkeypatch.setattr(tfa, "_lib", lambda: FakeLib())
    monkeypatch.setattr(tfa, "_bwd_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    before = dict(tfa.launches)
    yield calls
    tfa.launches.update(before)


@pytest.mark.parametrize("B,S,H,Dq,Dv", [(1, 64, 8, 192, 128),
                                         (2, 40, 3, 128, 128),
                                         (1, 33, 5, 64, 64)])
def test_bf16_entries_take_the_f32_arguments(launched, B, S, H, Dq, Dv):
    """K9's and K9-bwd's bf16 entries are handed what the f32 entries are
    (the order's group is the kernel's own choice): the same dims, scale,
    causal flag and stride count, by name."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k = (on_card(torch.zeros((B, S, H, Dq), dtype=dtype))
                for _ in range(2))
        v, do = (on_card(torch.zeros((B, S, H, Dv), dtype=dtype))
                 for _ in range(2))
        lse = on_card(torch.zeros((B, H, S)))
        tfa.flash_attention(q, k, v, causal=True)
        tfa.flash_attention_bwd(q, k, v, v, do, lse, causal=True)
    (fwd, f_args), (bwd, b_args), (fwd32, f32_args), (bwd32, b32_args) = \
        launched
    assert (fwd, bwd, fwd32, bwd32) == ("flashattn_bf16", "flashattn_bwd_bf16",
                                        "flashattn_f32", "flashattn_bwd_f32")
    same = ("B", "H", "Dq", "Dv", "scale", "causal")
    assert [f_args[n] for n in same + ("Sq", "Skv")] == \
        [f32_args[n] for n in same + ("Sq", "Skv")] == \
        [B, H, Dq, Dv, pytest.approx(Dq ** -0.5), 1, S, S]
    assert [b_args[n] for n in same + ("S",)] == \
        [b32_args[n] for n in same + ("S",)] == \
        [B, H, Dq, Dv, pytest.approx(Dq ** -0.5), 1, S]
