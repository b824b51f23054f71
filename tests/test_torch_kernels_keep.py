"""Keep-axis join kernels (K3, the keep form of K4) and the masked
matrix-product reduce (K6) of the port vs the reference's interpret-mode
kernels.

On the CPU the port's wrappers take the kernels' plain PyTorch versions
(the CUDA kernels are held against those on the card by
``chip_smoke.py``).  Here ``prod_reduce_keep_plain``,
``tri_reduce_keep_plain`` and ``matreduce_plain`` — and the wrappers
that reach them for CPU tensors — are held against
``repro.kernels.ops.cutjoin_reduce_keep`` / ``cutjoin_reduce3_keep`` /
``masked_matmul_reduce`` run with ``interpret=True``, and against a dense
f64 numpy oracle, on the same seeded inputs.  Tolerance is **0** for every
integer-valued input (each stays within the ``exact_block`` guard, or is
0/1 with product cells below 2^24); random float input to K6 uses the
reference's own tolerance, |got - want| < 3e-2 · |want| + 1
(``tests/test_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import compiler as tcompiler
from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import clique, tailed_triangle
from repro_torch.graph.generators import erdos_renyi
from repro_torch.kernels import matreduce as tmr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sddmm as tsd

from test_torch_kernels import (AXIS_MIXES, ROUTE_MIXES, ROUTE_TILE, _factors,
                                _hi, _hi_f64, _ref_dense_join, _route_case,
                                _t, ref_tri_tiles)
from test_torch_reference import reference  # noqa: F401  (shared fixture)

BLOCKS = (8, 128, 1024)


def _pair_keep_oracle(fs, keep, distinct, offsets=(0, 0)):
    prod = np.prod(np.stack(fs), axis=0)
    if distinct:
        gx = np.arange(prod.shape[0]) + offsets[0]
        gy = np.arange(prod.shape[1]) + offsets[1]
        prod = np.where(gx[:, None] == gy[None, :], 0.0, prod)
    return prod.sum(axis=1 - keep)


def _tri_keep_oracle(fs, axes, sizes, keep, distinct, offsets=(0, 0, 0)):
    prod = np.ones(sizes)
    for F, ax in zip(fs, axes):
        prod = prod * F.reshape(tuple(sizes[a] if a in ax else 1
                                      for a in range(3)))
    if distinct:
        x = (np.arange(sizes[0]) + offsets[0])[:, None, None]
        y = (np.arange(sizes[1]) + offsets[1])[None, :, None]
        z = (np.arange(sizes[2]) + offsets[2])[None, None, :]
        prod = np.where((x == y) | (x == z) | (y == z), 0.0, prod)
    return prod.sum(axis=tuple(a for a in range(3) if a != keep))


# -- K3: pair keep against the dense oracle -----------------------------------------

@pytest.mark.parametrize("distinct", (True, False))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("keep", (0, 1))
@pytest.mark.parametrize("k", (1, 2, 3))
@pytest.mark.parametrize("n", (24, 130))
def test_pair_keep_plain_and_wrapper_equal_dense(n, k, keep, block,
                                                 distinct):
    fs = _factors(3 * n + k + keep, [(n, n)] * k, _hi(k, block))
    want = _pair_keep_oracle(fs, keep, distinct)
    got = tmr.prod_reduce_keep_plain(_t(fs), keep=keep, distinct=distinct,
                                     block=block)
    assert got.dtype == torch.float64 and tuple(got.shape) == (n,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tops.cutjoin_reduce_keep(
        _t(fs), keep=keep, distinct=distinct, block=block).numpy(), want)
    tiles = tmr.prod_reduce_keep_tiles(_t(fs), keep=keep, distinct=distinct,
                                       block=block)
    assert tiles.shape[1] == n
    assert np.array_equal(tiles.sum(0).numpy(), want)


@pytest.mark.parametrize("keep", (0, 1))
@pytest.mark.parametrize("rows,start,col0", [(17, 5, 0), (40, 90, 3),
                                             (1, 129, 0)])
def test_pair_keep_rectangular_slice_with_offsets_equals_dense(rows, start,
                                                               col0, keep):
    n, block = 130, 128
    full = _factors(rows + start + keep, [(n, n)] * 2, _hi(2, block))
    sl = [F[start:start + rows, col0:] for F in full]
    want = _pair_keep_oracle(sl, keep, True, (start, col0))
    got = tmr.prod_reduce_keep(_t(sl), keep=keep, block=block,
                               offsets=(start, col0))
    assert np.array_equal(got.numpy(), want)


def test_pair_keep_row_slices_concatenate_to_the_whole():
    n, block = 130, 128
    fs = _factors(4, [(n, n)] * 2, _hi(2, block))
    whole = tmr.prod_reduce_keep(_t(fs), keep=0, block=block)
    parts = torch.cat([tmr.prod_reduce_keep(_t([F[s:s + 50] for F in fs]),
                                            keep=0, block=block,
                                            offsets=(s, 0))
                       for s in range(0, n, 50)])
    assert torch.equal(parts, whole)
    assert np.array_equal(whole.numpy(), _pair_keep_oracle(fs, 0, True))


# -- K3's f64 instance and its entries ---------------------------------------------

def _pair_keep_int64(fs, keep, distinct, offsets=(0, 0)):
    prod = np.prod(np.stack(fs).astype(np.int64), axis=0)
    if distinct:
        gx = np.arange(prod.shape[0]) + offsets[0]
        gy = np.arange(prod.shape[1]) + offsets[1]
        prod = np.where(gx[:, None] == gy[None, :], 0, prod)
    return prod.sum(axis=1 - keep)


@pytest.mark.parametrize("distinct", (True, False))
@pytest.mark.parametrize("keep", (0, 1))
@pytest.mark.parametrize("k", (1, 2, 3))
@pytest.mark.parametrize("n", (24, 130))
def test_pair_keep_f64_plain_equals_reference_dense_and_int64(
        reference, n, k, keep, distinct):
    """Factors whose Π max lies beyond the f32 guard and within the f64
    instance's bound over the reduced axis: the f64 plain version, the
    wrapper on the CPU (its tiles one row) and ``ops.cutjoin_reduce_keep_f64``
    equal an int64 numpy join and, masked, the reference's dense f64 keep
    join ``_join_keep``."""
    hi = _hi_f64(k, n)
    fs = _factors(600 + n + 3 * k + keep, [(n, n)] * k, hi)
    fs[0][1, 0] = hi
    maxes = [np.abs(F).max() for F in fs]
    assert tmr.exact_block((), maxes=maxes) is None
    assert tmr.exact_f64(maxes, n)
    want = _pair_keep_int64(fs, keep, distinct)
    got = tmr.prod_reduce_keep_f64_plain(_t(fs), keep=keep,
                                         distinct=distinct)
    assert got.dtype == torch.float64 and tuple(got.shape) == (n,)
    assert np.array_equal(got.numpy(), want.astype(np.float64))
    assert np.array_equal(got.numpy().astype(np.int64), want)
    assert torch.equal(tmr.prod_reduce_keep(_t(fs), keep=keep,
                                            distinct=distinct, f64=True), got)
    assert torch.equal(tops.cutjoin_reduce_keep_f64(
        _t(fs), keep=keep, distinct=distinct), got)
    tiles = tmr.prod_reduce_keep_tiles(_t(fs), keep=keep, distinct=distinct,
                                       f64=True)
    assert tuple(tiles.shape) == (1, n) and torch.equal(tiles[0], got)
    if distinct:
        assert np.array_equal(got.numpy(),
                              _ref_dense_join(reference, fs, 1 - keep))


@pytest.mark.parametrize("keep", (0, 1))
@pytest.mark.parametrize("rows,start,col0", [(17, 5, 0), (40, 90, 3)])
def test_pair_keep_f64_rectangular_slice_with_offsets_equals_int64(
        rows, start, col0, keep):
    n = 130
    full = _factors(rows + start + keep, [(n, n)] * 2, _hi_f64(2, n))
    sl = [F[start:start + rows, col0:] for F in full]
    want = _pair_keep_int64(sl, keep, True, (start, col0))
    got = tmr.prod_reduce_keep(_t(sl), keep=keep, offsets=(start, col0),
                               f64=True)
    assert np.array_equal(got.numpy(), want.astype(np.float64))
    assert torch.equal(got, tmr.prod_reduce_keep_f64_plain(
        _t(sl), keep=keep, offsets=(start, col0)))


def test_keep_entry_follows_the_reduced_axis_stride():
    """The row entry (a warp per kept row) where the reduced axis has unit
    stride in the lead factor, the strided template otherwise."""
    F = torch.zeros((6, 9), dtype=torch.float64)
    assert tmr.keep_entry(F, 0) == "rows"          # row-major, rows kept
    assert tmr.keep_entry(F, 1) == "cols"
    C = F.T.contiguous().T                         # column-major (6, 9)
    assert tmr.keep_entry(C, 0) == "cols"
    assert tmr.keep_entry(C, 1) == "rows"
    assert tmr.keep_entry(F[1:4, 2:7], 0) == "rows"     # a slice
    assert tmr.keep_entry(F[:, ::2], 0) == "cols"       # stride 2


def test_cuda_keep_join_picks_its_entry_by_stride(monkeypatch):
    """On tensors that claim to lie on the card: column-major factors go
    to the row entry for keep=1 and to the strided template for keep=0;
    the f64 flag and the slice's offsets reach either launcher."""
    called = []

    def fake_launch(kind, entries, sizes, masked, off3, block, f64=False):
        called.append(("cols", [ax for _, ax in entries], sizes, off3, f64))
        return torch.zeros((2, sizes[2]), dtype=torch.float64)

    def fake_rows(factors, keep, masked, off, block, f64):
        called.append(("rows", keep, tuple(factors[0].stride()), tuple(off),
                       f64))
        return torch.zeros((1, factors[0].shape[keep]), dtype=torch.float64)

    class OnCard(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(tmr, "_launch", fake_launch)
    monkeypatch.setattr(tmr, "_launch_keep_rows", fake_rows)
    monkeypatch.setattr(tmr, "_pair_keep_partials_plain",
                        lambda *a, **k: pytest.fail("plain version"))
    C = torch.ones((6, 4), dtype=torch.float64).T.contiguous().T \
        .as_subclass(OnCard)
    out0 = tmr.prod_reduce_keep([C, C], keep=0, block=8, offsets=(3, 1))
    out1 = tmr.prod_reduce_keep([C], keep=1, block=8, offsets=(3, 1),
                                f64=True)
    assert tuple(out0.shape) == (6,) and tuple(out1.shape) == (4,)
    assert called == [
        ("cols", [(2, 1), (2, 1)], (1, 4, 6), (0, 1, 3), False),
        ("rows", 1, (1, 6), (3, 1), True),
    ]


# -- K4 keep form against the dense oracle ------------------------------------------

@pytest.mark.parametrize("block", (8, 1024))
@pytest.mark.parametrize("keep", (0, 1, 2))
@pytest.mark.parametrize("mix", range(len(AXIS_MIXES)))
def test_tri_keep_plain_and_wrapper_equal_dense(mix, keep, block):
    axes = AXIS_MIXES[mix]
    n = 24 if mix % 2 else 37
    fs = _factors(mix + 10 * keep, [(n,) * len(ax) for ax in axes],
                  _hi(len(axes), block))
    want = _tri_keep_oracle(fs, axes, (n, n, n), keep, True)
    got = tmr.tri_reduce_keep_plain(_t(fs), axes, keep=keep, n=n,
                                    block=block)
    assert got.dtype == torch.float64 and tuple(got.shape) == (n,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tops.cutjoin_reduce3_keep(
        _t(fs), axes, keep=keep, n=n, block=block).numpy(), want)


@pytest.mark.parametrize("keep", (0, 1, 2))
def test_tri_keep_unmasked_and_sliced_with_offsets_equal_dense(keep):
    n, block = 40, 8
    axes = [(0, 1, 2), (0, 2), (1, 2)]
    fs = _factors(12 + keep, [(n,) * len(ax) for ax in axes], _hi(3, block))
    want = _tri_keep_oracle(fs, axes, (n, n, n), keep, False)
    assert np.array_equal(tmr.tri_reduce_keep(
        _t(fs), axes, keep=keep, n=n, distinct=False, block=block).numpy(),
        want)
    s, w = 16, 14
    sl = [fs[0][s:s + w], fs[1][s:s + w], fs[2]]
    want = _tri_keep_oracle(sl, axes, (w, n, n), keep, True, (s, 0, 0))
    got = tmr.tri_reduce_keep(_t(sl), axes, keep=keep, n=(w, n, n),
                              block=block, offsets=(s, 0, 0))
    assert np.array_equal(got.numpy(), want)


def test_keep_axis_out_of_range_raises():
    F = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        tmr.prod_reduce_keep([F], keep=2)
    with pytest.raises(ValueError):
        tmr.tri_reduce_keep([F], [(0, 1)], keep=3, n=4)


def test_cuda_tensor_never_reaches_a_keep_plain_version(monkeypatch):
    """As for the scalar forms: a tensor that claims to lie on the card
    goes to a launcher.  K3 keep=0 on a row-major factor, whose reduced
    axis has unit stride, goes to the row entry (a warp per kept row);
    keep=1 there goes to the strided template with the kept axis moved to
    kernel axis 2 by the axis map alone; the tri keep form goes to one of
    its two entries on every mix, path and triangle mixes too: the slab
    entry where the kept axis is not the lead factor's unit-stride axis,
    else the template."""
    called = []

    def fake_launch(kind, entries, sizes, masked, off3, block, f64=False):
        called.append((kind, [ax for _, ax in entries], sizes, off3))
        return torch.zeros((1, sizes[2]), dtype=torch.float64)

    def fake_rows(factors, keep, masked, off, block, f64):
        called.append(("pairjoin_keep_rows", keep,
                       tuple(factors[0].shape), tuple(off)))
        return torch.zeros((1, factors[0].shape[keep]), dtype=torch.float64)

    def fake_slab(factors, axes, sizes, keep, masked, off, block):
        called.append(("trijoin_keep_slab", keep, list(axes), sizes, off))
        return torch.zeros((1, sizes[keep]), dtype=torch.float64)

    class OnCard(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(tmr, "_launch", fake_launch)
    monkeypatch.setattr(tmr, "_launch_keep_rows", fake_rows)
    monkeypatch.setattr(tmr, "_launch_tri_keep_slab", fake_slab)
    for route in ("_launch_path", "_launch_triangle"):
        monkeypatch.setattr(tmr, route,
                            lambda *a, **k: pytest.fail("scalar route"))
    for plain in ("_pair_keep_partials_plain", "_tri_partials_plain",
                  "_tri_path_plain", "_tri_triangle_plain"):
        monkeypatch.setattr(tmr, plain,
                            lambda *a, **k: pytest.fail("plain version"))
    monkeypatch.setattr(tmr, "_as_factors", lambda fs: list(fs))
    F = torch.ones((4, 6), dtype=torch.float64).as_subclass(OnCard)
    tmr.prod_reduce_keep_tiles([F], keep=0, block=8, offsets=(2, 1))
    tmr.prod_reduce_keep_tiles([F], keep=1, block=8, offsets=(2, 1))
    G = torch.ones((5, 5), dtype=torch.float64).as_subclass(OnCard)
    tmr.tri_reduce_keep_tiles([G, G], [(0, 1), (1, 2)], keep=0, n=5,
                              block=8, offsets=(1, 2, 3))
    tmr.tri_reduce_keep_tiles([G, G, G], [(0, 1), (1, 2), (0, 2)], keep=1,
                              n=5, block=8)
    assert called == [
        ("pairjoin_keep_rows", 0, (4, 6), (2, 1)),
        ("pairjoin_keep", [(1, 2)], (1, 4, 6), (0, 2, 1)),
        ("trijoin_keep_slab", 0, [(0, 1), (1, 2)], (5, 5, 5), (1, 2, 3)),
        ("trijoin_keep", [(0, 2), (2, 1), (0, 1)], (5, 5, 5), (0, 0, 0)),
    ]


# -- K4-keep's two entries on the card ------------------------------------------------

def _row_major(n, order):
    """A (n, n, n) f64 factor whose dims lie in memory in ``order``
    (outermost first): its unit-stride axis is ``order[-1]``."""
    return torch.zeros([n] * 3, dtype=torch.float64).permute(order) \
        .contiguous().permute([order.index(a) for a in range(3)])


@pytest.mark.parametrize("order,keep,entry,u", [
    ((0, 1, 2), 0, "slab", 2), ((0, 1, 2), 1, "slab", 2),
    ((0, 1, 2), 2, "template", None), ((1, 2, 0), 0, "template", None),
    ((1, 2, 0), 1, "slab", 0), ((2, 0, 1), 2, "slab", 1),
])
def test_tri_keep_entry_follows_the_lead_factor_stride(order, keep, entry,
                                                       u):
    """The slab entry unless the kept axis is the unit-stride axis of the
    lead factor (the first over the most axes, here the 3-D one even
    where a pair factor comes first); the slab's lanes then walk the
    reduced axis of smallest stride."""
    F = _row_major(6, order)
    P = torch.zeros((6, 6), dtype=torch.float64)
    fs, axes = [P, F], [(0, 2), (0, 1, 2)]
    assert tmr.tri_keep_entry(fs, axes, keep) == entry
    if u is not None:
        assert tmr._slab_axes(fs, axes, keep)[0] == u


def test_tri_keep_entry_on_pair_mixes_and_wide_rows():
    """On a mix of pair factors the first is the lead; a u row beyond the
    slab's shared-memory row goes to the template."""
    P = torch.zeros((5, 5), dtype=torch.float64)
    assert tmr.tri_keep_entry([P, P], [(0, 1), (1, 2)], 0) == "slab"
    assert tmr.tri_keep_entry([P, P], [(0, 1), (1, 2)], 1) == "template"
    assert tmr.tri_keep_entry([P.T, P], [(0, 1), (1, 2)], 1) == "slab"
    wide = tmr.SLAB_MAX_U + 1
    assert tmr.tri_keep_entry([P], [(0, 1)], 0, sizes=(5, 5, 5)) == "slab"
    assert tmr.tri_keep_entry([P], [(0, 1)], 0,
                              sizes=(5, wide, 5)) == "template"


def _slab_emulation(fs, axes, sizes, keep, distinct, block, offsets):
    """``cutjoin_tri_keep_slab`` emulated in numpy on the layout
    ``_slab_plan`` hands it: per CTA (w, split) a warp per slab row (every
    eighth row of the split's span), its lanes along u (pairs of cells
    where the double2 rule holds), cells in the kernel's order, each
    lane's f32 partial folded into f64 every ``block`` cells counted over
    its rows; the masked row g_v == g_w is skipped, the masked cells add
    0.  Asserts that every slab cell is walked once and that no f32
    partial folds more than ``block`` cells or passes 2^24 in magnitude.
    Returns out[w]."""
    threads, warps = 256, 8
    entries, counts, strides, (u, v), (splits, span) = tmr._slab_plan(
        _t(fs), axes, sizes, keep)
    nc, nu, nv = counts
    n_k, n_u, n_v = sizes[keep], sizes[u], sizes[v]
    vals = [torch.as_strided(F, (n_k, n_v, n_u), strides[3 * f:3 * f + 3],
                             F.storage_offset()).numpy().astype(np.float32)
            for f, (F, _) in enumerate(entries)]
    row_u = np.ones((n_k, n_u), np.float32)
    for V in vals[nc:nc + nu]:
        row_u = row_u * V[:, 0, :]
    pin = np.ones((n_k, n_v), np.float32)
    for V in vals[nc + nu + nv:]:
        pin = pin * V[:, :1, 0]
    for V in vals[nc + nu:nc + nu + nv]:
        pin = pin * V[:, :, 0]
    prod = pin[:, :, None] * row_u[:, None, :]
    for V in vals[:nc]:
        prod = prod * V
    gw = np.arange(n_k)[:, None, None] + offsets[keep]
    gv = np.arange(n_v)[None, :, None] + offsets[v]
    gu = np.arange(n_u)[None, None, :] + offsets[u]
    skip_row = np.zeros((n_k, n_v), bool)
    if distinct:
        prod = np.where((gu == gw) | (gu == gv), np.float32(0), prod)
        skip_row = (gv == gw)[:, :, 0]
    v2 = all(strides[3 * f + 2] == 1 and strides[3 * f] % 2 == 0
             and strides[3 * f + 1] % 2 == 0 and F.data_ptr() % 16 == 0
             for f, (F, _) in enumerate(entries[:nc]))
    walked = np.zeros((n_v, n_u), int)
    partials = np.zeros((splits, n_k))
    for split in range(splits):
        for t in range(threads):
            lane, rows = t % 32, range(split * span + t // 32,
                                       min(split * span + span, n_v), warps)
            if v2:
                cells = [c for q in range(lane, n_u // 2, 32)
                         for c in (2 * q, 2 * q + 1)]
                cells += [n_u - 1] if n_u % 2 and lane == 0 else []
            else:
                cells = list(range(lane, n_u, 32))
            sv = np.repeat(np.asarray(rows, int), len(cells))
            su = np.tile(np.asarray(cells, int), len(rows))
            np.add.at(walked, (sv, su), 1)
            if not len(sv):
                continue
            seq = prod[:, sv, su]                          # (n_k, cells)
            present = ~skip_row[:, sv]
            chunk = (np.cumsum(present, axis=1) - 1) // block
            key = (np.arange(n_k)[:, None] * (len(sv) // block + 1)
                   + chunk)[present]
            cells_per = np.bincount(key)
            assert cells_per.max(initial=0) <= block
            mag = np.bincount(key, weights=np.abs(seq[present]))
            assert mag.max(initial=0) <= 2 ** 24
            partials[split] += np.where(present, seq, 0).astype(
                np.float64).sum(axis=1)
    assert (walked == 1).all()
    return partials.sum(axis=0)


SLAB_CASES = [
    # (axes, sizes, keep, memory order of 3-D factors, offsets)
    ([(0, 1, 2), (0, 2)], (6, 20, 150), 0, (0, 1, 2), (0, 0, 0)),
    ([(0, 1, 2), (0, 2)], (20, 6, 151), 1, (0, 1, 2), (3, 0, 5)),
    ([(0, 1, 2), (0, 2)], (20, 151, 6), 2, (0, 1, 2), (0, 0, 0)),
    ([(0, 1, 2), (0, 1, 2)], (7, 21, 333), 0, (0, 1, 2), (0, 9, 0)),
    ([(0, 1, 2), (0, 1), (1, 2), (2,)], (9, 17, 140), 1, (1, 0, 2),
     (2, 4, 6)),
    ([(0, 1, 2), (0,), (1,)], (150, 5, 19), 1, (2, 1, 0), (0, 0, 0)),
    ([(0, 1), (1, 2)], (140, 8, 13), 2, None, (0, 0, 0)),
    ([(0, 1), (1, 2), (0, 2)], (6, 16, 129), 0, None, (1, 1, 1)),
]


@pytest.mark.parametrize("block", (8, 128))
@pytest.mark.parametrize("distinct", (True, False))
@pytest.mark.parametrize("case", range(len(SLAB_CASES)))
def test_tri_keep_slab_fold_order_equals_plain_and_reference(
        reference, case, distinct, block):
    """The slab entry's fold order, emulated on integer factors at the
    guard's limit for ``block`` (rectangular slabs, odd u rows, offsets,
    per-cell, u-row, v-row and w-scalar factors, several splits): equal at
    difference 0 to ``tri_reduce_keep_plain`` and to the reference's
    interpret-mode kernel, every cell walked once, no f32 partial over
    ``block`` cells."""
    axes, sizes, keep, order, off = SLAB_CASES[case]
    hi = _hi(len(axes), block)
    fs = _factors(40 + case + block, [tuple(sizes[a] for a in ax)
                                      for ax in axes], hi)
    fs[0].flat[1] = hi
    if order is not None:
        fs[0] = np.ascontiguousarray(fs[0].transpose(order)).transpose(
            [order.index(a) for a in range(3)])
    got = _slab_emulation(fs, axes, sizes, keep, distinct, block, off)
    want = tmr.tri_reduce_keep_plain(_t(fs), axes, keep=keep, n=sizes,
                                     distinct=distinct, block=block,
                                     offsets=off)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got, ref_tri_tiles(
        reference, fs, axes, sizes, off, distinct, block, keep=keep))


@pytest.mark.parametrize("sliced", (False, True))
@pytest.mark.parametrize("distinct", (True, False))
@pytest.mark.parametrize("keep", (0, 1, 2))
@pytest.mark.parametrize("mix", range(len(ROUTE_MIXES)))
def test_tri_keep_route_plain_equals_plain_and_reference_interpret_kernel(
        reference, mix, keep, distinct, sliced):
    """The keep form's route is the dense one whatever the mix: on the
    scalar join's path and triangle mixes too, with their slices, its
    plain version equals ``tri_reduce_keep_plain``, the reference's
    interpret-mode kernel and the numpy oracle."""
    axes, fs, sizes, off = _route_case(mix, sliced, 50 + mix + 7 * keep)
    assert tmr.tri_route(axes, keep=keep) == "dense"
    got = tmr.tri_reduce_keep(_t(fs), axes, keep=keep, n=sizes,
                              distinct=distinct, block=ROUTE_TILE,
                              offsets=off)
    assert tuple(got.shape) == (sizes[keep],)
    assert torch.equal(got, tmr.tri_reduce_keep_plain(
        _t(fs), axes, keep=keep, n=sizes, distinct=distinct,
        block=ROUTE_TILE, offsets=off))
    assert np.array_equal(got.numpy(), ref_tri_tiles(
        reference, fs, axes, sizes, off, distinct, ROUTE_TILE, keep=keep))
    assert np.array_equal(got.numpy(), _tri_keep_oracle(
        fs, axes, sizes, keep, distinct, off))


# -- against the reference's interpret-mode kernels ----------------------------------

@pytest.mark.parametrize("n,k,block,keep", [
    (24, 1, 8, 0), (24, 3, 1024, 1), (130, 2, 128, 0), (130, 2, 8, 1),
    (200, 1, 1024, 0),
])
def test_pair_keep_equals_reference_interpret_kernel(reference, n, k, block,
                                                     keep):
    fs = _factors(n * k + block + keep, [(n, n)] * k, _hi(k, block))
    want = reference.ops.cutjoin_reduce_keep(fs, keep=keep, bm=block,
                                             bn=block, interpret=True)
    assert np.array_equal(tops.cutjoin_reduce_keep(
        _t(fs), keep=keep, block=block).numpy(), want)
    assert np.array_equal(tmr.prod_reduce_keep_plain(
        _t(fs), keep=keep, block=block).numpy(), want)


@pytest.mark.parametrize("keep", (0, 1))
def test_pair_keep_slice_offsets_equal_reference_interpret_kernel(reference,
                                                                  keep):
    n, rows, start, block = 130, 40, 64, 128
    full = _factors(98 + keep, [(n, n)] * 2, _hi(2, block))
    sl = [F[start:start + rows] for F in full]
    want = reference.ops.cutjoin_reduce_keep(sl, keep=keep, bm=block,
                                             bn=block, interpret=True,
                                             offsets=(start, 0))
    assert np.array_equal(tops.cutjoin_reduce_keep(
        _t(sl), keep=keep, block=block, offsets=(start, 0)).numpy(), want)


@pytest.mark.parametrize("n,mix,block,keep", [
    (24, 0, 8, 0), (24, 0, 8, 2), (24, 1, 1024, 1), (30, 4, 8, 2),
    (24, 6, 128, 1), (37, 2, 1024, 0),
])
def test_tri_keep_equals_reference_interpret_kernel(reference, n, mix, block,
                                                    keep):
    axes = AXIS_MIXES[mix]
    fs = _factors(n + mix + keep, [(n,) * len(ax) for ax in axes],
                  _hi(len(axes), block))
    want = reference.ops.cutjoin_reduce3_keep(fs, axes, keep=keep, n=n,
                                              block=block, interpret=True)
    assert np.array_equal(tops.cutjoin_reduce3_keep(
        _t(fs), axes, keep=keep, n=n, block=block).numpy(), want)
    assert np.array_equal(tmr.tri_reduce_keep_plain(
        _t(fs), axes, keep=keep, n=n, block=block).numpy(), want)


def test_tri_keep_offsets_equal_reference_interpret_kernel(reference):
    n, block = 24, 8
    axes = [(0, 1), (1, 2)]
    fs = _factors(6, [(n, n)] * 2, _hi(2, block))
    for keep in (0, 1, 2):
        want = reference.ops.cutjoin_reduce3_keep(
            fs, axes, keep=keep, n=n, block=block, interpret=True,
            offsets=(3, 0, 7))
        got = tops.cutjoin_reduce3_keep(_t(fs), axes, keep=keep, n=n,
                                        block=block, offsets=(3, 0, 7))
        assert np.array_equal(got.numpy(), want), keep


# -- K6: masked matrix-product reduce --------------------------------------------------

def _adjacency_like(seed, M, N, K, p=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.random(s) < p).astype(np.float32)
            for s in ((M, K), (N, K), (M, N))]


def _matreduce_oracle(lhs, rhs, mask):
    return float(((lhs.astype(np.float64) @ rhs.astype(np.float64).T)
                  * mask.astype(np.float64)).sum())


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (96, 64, 160),
                                   (200, 130, 70), (1, 7, 3), (129, 1, 257)])
def test_matreduce_on_01_inputs_equals_reference_exactly(reference, M, N, K):
    lhs, rhs, mask = _adjacency_like(M + N + K, M, N, K)
    want = float(reference.ops.masked_matmul_reduce(
        lhs, rhs, mask, bm=64, bn=64, bk=32, interpret=True))
    assert want == _matreduce_oracle(lhs, rhs, mask)
    got = tmr.matreduce_plain(*_t([lhs, rhs, mask]))
    assert got == want
    assert tops.masked_matmul_reduce(*_t([lhs, rhs, mask])) == want
    assert tmr.matreduce_tiles(*_t([lhs, rhs, mask])).sum().item() == want


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (96, 64, 160)])
def test_matreduce_on_random_floats_within_the_reference_tolerance(
        reference, M, N, K):
    rng = np.random.default_rng(M * K)
    lhs = rng.normal(size=(M, K)).astype(np.float32)
    rhs = rng.normal(size=(N, K)).astype(np.float32)
    mask = (rng.random((M, N)) < 0.5).astype(np.float32)
    ref = float(reference.ops.masked_matmul_reduce(
        lhs, rhs, mask, bm=64, bn=64, bk=32, interpret=True))
    got = tmr.matreduce(*_t([lhs, rhs, mask]))
    want = _matreduce_oracle(lhs, rhs, mask)
    assert abs(got - want) < abs(want) * 3e-2 + 1.0
    assert abs(ref - want) < abs(want) * 3e-2 + 1.0


def test_matreduce_casts_and_strides():
    """Non-f32 operands are cast; a transposed (strided) operand gives the
    same value as its contiguous copy."""
    lhs, rhs, mask = _adjacency_like(3, 50, 40, 30)
    want = _matreduce_oracle(lhs, rhs, mask)
    assert tmr.matreduce(*[torch.from_numpy(x.astype(np.float64))
                           for x in (lhs, rhs, mask)]) == want
    rhs_t = torch.from_numpy(np.ascontiguousarray(rhs.T)).T
    assert tmr.matreduce(torch.from_numpy(lhs), rhs_t,
                         torch.from_numpy(mask)) == want
    with pytest.raises(ValueError):
        tmr.matreduce(torch.from_numpy(lhs), torch.from_numpy(lhs),
                      torch.from_numpy(mask))


def _k6_tc_emulated(lhs, rhs, mask):
    """K6's tensor-core route as the card runs it, emulated: the flag must
    admit the operands; bf16 operands, f32 products and sums; with no
    operand of negative sign, the 128 x 256 output tiles whose two
    128 x 128 occupancy words are 0 left at 0; each cell times the mask
    in f64, one f64 partial per 128 x 256 tile, their f64 sum; and the
    number of tiles skipped."""
    assert tsd.sddmm_exact_plain(lhs, rhs)
    prod = lhs.bfloat16().float() @ rhs.bfloat16().float().T
    M, N = prod.shape
    skipped = 0
    if not (lhs.signbit().any() or rhs.signbit().any()):
        occ = tsd.sddmm_occupancy_plain(mask)
        pairs = torch.nn.functional.pad(occ, (0, occ.shape[1] % 2)) \
            .view(occ.shape[0], -1, 2).any(2)
        skipped = int((~pairs).sum())
        keep = pairs.repeat_interleave(128, 0) \
            .repeat_interleave(256, 1)[:M, :N]
        prod = prod.masked_fill(~keep, 0.0)
    cells = torch.zeros((-(-M // 128) * 128, -(-N // 256) * 256),
                        dtype=torch.float64)
    cells[:M, :N] = prod.double() * mask.double()
    partials = cells.view(-1, 128, cells.shape[1] // 256, 256).sum((1, 3))
    return partials.sum().item(), skipped


def _k6_edge_case(name):
    """Inputs of the tensor-core route: 0/1 operands under a 0/1 mask with
    empty 128 x 256 tiles and -0.0 cells (the tile skip runs), or the
    contract's edge, integers in [-256, 256] at K = 256 against rows of
    ±256 (K · max · max = 2^24; cells reach ±2^24; negative operands, no
    skip) under a sparse mask of small integers, so that every partial
    sum of the reference's f32 accumulator is a multiple of 256 below
    2^32 and exact too."""
    rng = np.random.default_rng(len(name))
    if name == "0/1":
        M, N, K = 300, 600, 200
        lhs, rhs = ((rng.random(s) < 0.3).astype(np.float32)
                    for s in ((M, K), (N, K)))
        mask = (rng.random((M, N)) < 0.2).astype(np.float32)
        mask[128:256, 256:512] = 0.0
        mask[256:, 512:] = 0.0
        mask[rng.random((M, N)) < 0.05] = -0.0
    else:
        M, N, K = 300, 260, 256
        lhs = rng.integers(-256, 257, size=(M, K)).astype(np.float32)
        rhs = rng.choice([-256.0, 256.0], size=(N, K)).astype(np.float32)
        lhs[0], lhs[1], rhs[0] = 256.0, -256.0, 256.0
        mask = np.where(rng.random((M, N)) < 0.001,
                        rng.integers(-2, 3, size=(M, N)), 0) \
            .astype(np.float32)
        mask[0, 0], mask[1, 0] = 1.0, 1.0
    return lhs, rhs, mask


@pytest.mark.parametrize("name", ["0/1", "+-256 at K=256"])
def test_matreduce_tc_route_emulated_equals_plain_and_reference(reference,
                                                                name):
    """The emulated tensor-core route of K6 equals ``matreduce_plain``,
    the numpy oracle and the reference's interpret-mode kernel at
    difference 0, on 0/1 inputs with skipped tiles and at the edge of the
    exact route's contract."""
    lhs, rhs, mask = _k6_edge_case(name)
    got, skipped = _k6_tc_emulated(*_t([lhs, rhs, mask]))
    want = _matreduce_oracle(lhs, rhs, mask)
    assert got == want == tmr.matreduce_plain(*_t([lhs, rhs, mask]))
    ref = float(reference.ops.masked_matmul_reduce(
        lhs, rhs, mask, bm=64, bn=64, bk=32, interpret=True))
    assert ref == want
    if name == "0/1":
        assert skipped == 2
    else:
        assert np.abs(lhs.astype(np.float64) @ rhs.T.astype(np.float64)) \
            .max() == 2 ** 24


def _tilelist_case(seed, T=7, t=16, O=5, values=(0.0, 1.0)):
    """A seeded (T, t, t) stack and ragged lists (one empty), as the
    kernel takes them."""
    rng = np.random.default_rng(seed)
    stack = rng.choice(values, size=(T, t, t)).astype(np.float32)
    lengths = rng.integers(0, 6, size=O)
    lengths[1] = 0
    k_ptr = np.concatenate([[0], np.cumsum(lengths)])
    P = int(k_ptr[-1])
    return (stack, rng.integers(0, T, size=O), k_ptr,
            rng.integers(0, T, size=P), rng.integers(0, T, size=P))


def _tilelist_oracle(stack, out_idx, k_ptr, lhs_idx, rhs_idx):
    s = stack.astype(np.float64)
    parts = []
    for o, a, b in zip(out_idx, k_ptr[:-1], k_ptr[1:]):
        acc = np.zeros(s.shape[1:])
        for p in range(a, b):
            acc += s[lhs_idx[p]] @ s[rhs_idx[p]].T
        parts.append((acc * s[o]).sum())
    return np.array(parts)


@pytest.mark.parametrize("seed,t,values", [
    (0, 16, (0.0, 1.0)), (1, 32, (0.0, 1.0, 2.5)), (2, 5, (-3.0, 0.0, 2.0)),
    (3, 128, (0.0, 1.0))])
def test_tilelist_plain_equals_numpy_oracle(seed, t, values):
    """K6's tile list, plain version: per output tile and summed, equal to
    a numpy f64 oracle over the same lists (ragged, one empty, repeated
    tiles), and to K6 on each output tile's concatenated operands."""
    case = _tilelist_case(seed, t=t, values=values)
    stack, out_idx, k_ptr, lhs_idx, rhs_idx = case
    want = _tilelist_oracle(*case)
    parts = tmr.matreduce_tilelist_tiles(torch.from_numpy(stack), *case[1:])
    assert parts.dtype == torch.float64
    assert np.array_equal(parts.numpy(), want)
    assert tmr.matreduce_tilelist(torch.from_numpy(stack), *case[1:]) == \
        tmr.matreduce_tilelist(stack, *case[1:]) == float(want.sum())
    for o, a, b, w in zip(out_idx, k_ptr[:-1], k_ptr[1:], want):
        if b > a:
            lhs = np.concatenate([stack[i] for i in lhs_idx[a:b]], axis=1)
            rhs = np.concatenate([stack[i] for i in rhs_idx[a:b]], axis=1)
            assert tmr.matreduce_plain(*_t([lhs, rhs, stack[o]])) == w


@pytest.mark.parametrize("values,longest,want", [
    ((0.0, 1.0), 64, True), ((0.0, 1.0, 256.0), 2, True),
    ((0.0, 256.0), 3, False), ((0.0, 2.5), 1, False),
    ((0.0, float("nan")), 1, False), ((-0.0, -3.0), 5, True)])
def test_tilelist_exact_plain_flag(values, longest, want):
    """The tile list's flag: finite integers, |v| <= 256, 128 × the
    longest list × max|v|² <= 2^24, at its edges."""
    stack = torch.tensor(values, dtype=torch.float32).repeat(2, 4, 1)
    k_ptr = [0, 1, 1 + longest]
    assert tmr.tilelist_exact_plain(stack, k_ptr) is want


def test_tilelist_rejects_bad_lists():
    stack, out_idx, k_ptr, lhs_idx, rhs_idx = _tilelist_case(4)
    st = torch.from_numpy(stack)
    for bad in ((out_idx, k_ptr[1:], lhs_idx, rhs_idx),
                (out_idx, k_ptr[::-1], lhs_idx, rhs_idx),
                (out_idx + 7, k_ptr, lhs_idx, rhs_idx),
                (out_idx, k_ptr, lhs_idx, rhs_idx[:-1])):
        with pytest.raises(ValueError):
            tmr.matreduce_tilelist(st, *bad)
    with pytest.raises(ValueError, match="square"):
        tmr.matreduce_tilelist(st[:, :3], out_idx, k_ptr, lhs_idx, rhs_idx)


class _OnCard(torch.Tensor):
    is_cuda = True


@pytest.fixture
def k6_card(monkeypatch):
    """Stand-ins for the card under K6: the library records its launches
    (entry, arguments), the plain versions fail."""
    calls = []

    class FakeLib:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(tmr, "_matreduce_plain",
                        lambda *a: pytest.fail("plain version taken"))
    monkeypatch.setattr(tmr, "_tilelist_plain",
                        lambda *a: pytest.fail("plain version taken"))
    monkeypatch.setattr(tmr, "_lib", lambda name="cutjoin": FakeLib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    before = (dict(tmr.launches), dict(tmr.matreduce_entries))
    yield calls
    tmr.launches.update(before[0])
    tmr.matreduce_entries.update(before[1])


def test_cuda_tensor_never_reaches_the_matreduce_plain_version(k6_card):
    """K6 on card tensors is three launches, no plain version: prep (the
    flag, one bf16 copy when lhs is rhs, the mask's tile occupancy), the
    tensor-core kernel (gated) and the FMA kernel with the state passed;
    the partials hold one slot per 128 x 256 tile, then one per 128 x 128
    tile.  One call counts once in ``launches["matreduce"]`` and once per
    entry."""
    a = torch.ones((3, 5), dtype=torch.float32).as_subclass(_OnCard)
    m = torch.ones((3, 3), dtype=torch.float32).as_subclass(_OnCard)
    before = (tmr.launches["matreduce"], dict(tmr.matreduce_entries))
    partials = tmr.matreduce_tiles(a, a, m)
    assert [c[0] for c in k6_card] == ["sddmm_prep", "matreduce_tc",
                                       "matreduce_f32"]
    prep, tc, fma = (c[1] for c in k6_card)
    assert prep[3:11] == (3, 3, 5, 5, 5, 3, 0, 1)   # M N K, strides, f32, same
    assert prep[11] == prep[12] and prep[13] == 8   # one bf16 copy, ld 8
    assert tc[0] == tc[2] == prep[11] and tc[1] == tc[3] == 8
    assert tc[6] == partials.data_ptr()
    assert tc[7:10] == (3, 3, 5) and tc[10] == prep[14]     # the state
    assert tc[11:13] == (1, 1)                      # gated, one tensor
    assert fma[3:9] == (3, 3, 5, 5, 5, 3)
    assert fma[9] == partials.data_ptr() + 8        # after the one tc slot
    assert fma[10] == prep[14] and fma[11] == 1     # the state, one tensor
    assert partials.shape == (2,) and partials.dtype == torch.float64
    assert tmr.launches["matreduce"] == before[0] + 1
    assert {k: tmr.matreduce_entries[k] - before[1][k]
            for k in tmr.MATREDUCE_STEPS} == dict.fromkeys(
                tmr.MATREDUCE_STEPS, 1)


def test_cuda_matreduce_two_tensors_and_steps_alone(k6_card):
    """lhs and rhs apart: two bf16 copies, and the kernels are told so;
    ``matreduce_launch`` on ``matreduce_buffers`` runs only the steps it
    is given, with the call's arguments, and counts each."""
    on = lambda x: torch.as_tensor(x).as_subclass(_OnCard)  # noqa: E731
    lhs, rhs = on(torch.ones((130, 7))), on(torch.ones((300, 7)))
    mask = on(torch.ones((130, 300)))
    partials = tmr.matreduce_tiles(lhs, rhs, mask)
    prep, tc, fma = (c[1] for c in k6_card)
    assert prep[10] == 0 and prep[11] != prep[12]   # two copies
    assert tc[12] == 0 and fma[11] == 0
    # 2 x 2 tensor-core tiles of 128 x 256, then 2 x 3 FMA tiles
    assert partials.shape == (4 + 6,)
    assert fma[9] == partials.data_ptr() + 4 * 8
    whole = dict(k6_card)
    k6_card.clear()
    before = dict(tmr.matreduce_entries)
    buf = tmr.matreduce_buffers(lhs, rhs, mask)
    tmr.matreduce_launch(buf, ("matreduce_tc",))
    assert [c[0] for c in k6_card] == ["matreduce_tc"]
    small = [a for a in k6_card[0][1] if isinstance(a, int) and a < 1 << 20]
    assert small == [a for a in whole["matreduce_tc"]
                     if isinstance(a, int) and a < 1 << 20]
    assert tmr.matreduce_entries["matreduce_tc"] == \
        before["matreduce_tc"] + 1
    with pytest.raises(ValueError, match="no step"):
        tmr.matreduce_launch(buf, ("sddmm_tc",))


@pytest.mark.parametrize("t", [128, 16])
def test_cuda_tilelist_is_three_launches(k6_card, t):
    """K6's tile list on a card stack: the stack's prep (its values as
    rows of 1024), one tensor-core launch and one gated FMA launch over
    every output tile, the lists in one int32 tensor; tiles narrower than
    128 are zero-padded to 128, and the flag's K is 128 × the longest
    list."""
    stack, out_idx, k_ptr, lhs_idx, rhs_idx = _tilelist_case(5, t=t)
    st = torch.from_numpy(stack).as_subclass(_OnCard)
    before = (tmr.launches["matreduce_tilelist"], dict(tmr.matreduce_entries))
    partials = tmr.matreduce_tilelist_tiles(st, out_idx, k_ptr, lhs_idx,
                                            rhs_idx)
    assert [c[0] for c in k6_card] == ["matreduce_stack_prep",
                                       "matreduce_tilelist_tc",
                                       "matreduce_tilelist_f32"]
    prep, tc, fma = (c[1] for c in k6_card)
    T, O, P = len(stack), len(out_idx), len(lhs_idx)
    assert prep[1:4] == (T * 128 * 128 // 1024, 1024, 1024)
    assert prep[5] == 1024 and tc[0] == prep[4]      # the bf16 copy
    assert tc[1] == fma[1] == T * 128                # rows of the stack
    assert tc[2] == prep[0] == fma[0]
    kflag = 128 * int(np.diff(k_ptr).max())
    assert tc[7:9] == fma[6:8] == (O, kflag)
    assert tc[9] == partials.data_ptr() and fma[8] == tc[9] + 8 * O
    assert tc[10] == fma[9]                          # one state
    idx = tc[3]
    assert tc[3:7] == fma[2:6] == (idx, idx + 4 * O, idx + 4 * (2 * O + 1),
                                   idx + 4 * (2 * O + 1 + P))
    assert partials.shape == (2 * O,)
    assert tmr.launches["matreduce_tilelist"] == before[0] + 1
    assert {k: tmr.matreduce_entries[k] - before[1][k]
            for k in tmr.TILELIST_STEPS} == dict.fromkeys(
                tmr.TILELIST_STEPS, 1)
    buf = tmr.tilelist_buffers(st, out_idx, k_ptr, lhs_idx, rhs_idx)
    assert buf.rows.shape == (T * 128, 128)
    assert torch.equal(torch.Tensor(buf.rows).view(T, 128, 128)[:, :t, :t],
                       torch.from_numpy(stack))
    assert not torch.Tensor(buf.rows).view(T, 128, 128)[:, t:].any()
    for got, want in ((buf.out_idx, out_idx), (buf.k_ptr, k_ptr),
                      (buf.lhs_idx, lhs_idx), (buf.rhs_idx, rhs_idx)):
        assert got.dtype == torch.int32
        assert np.array_equal(torch.Tensor(got).numpy(), want)


def test_cuda_tilelist_refuses_wide_tiles(k6_card):
    stack, out_idx, k_ptr, lhs_idx, rhs_idx = _tilelist_case(6, t=130, T=3)
    st = torch.from_numpy(stack).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="at most 128"):
        tmr.matreduce_tilelist(st, out_idx, k_ptr, lhs_idx, rhs_idx)
    assert k6_card == []


class _NoContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_triangle_count_equals_engine_and_reference(reference):
    g = erdos_renyi(150, 10.0, seed=4)
    adj = g.dense_adjacency(np.float32, pad=False)
    want = CountingEngine(g, device="cpu").edge_induced(clique(3))
    assert tops.triangle_count(torch.from_numpy(adj)) == want
    assert float(reference.ops.triangle_count(adj, interpret=True)) == want


def test_use_pallas_triangle_route_equals_edge_induced(reference):
    """``compile(use_pallas=True)`` counts triangles through the K6 route
    (its plain version on the CPU); the count equals the engine's Möbius
    count and the reference's own ``use_pallas`` compile."""
    from test_torch_reference import port_graph, shared_apct
    from repro_torch.core.apct import APCT
    rg = reference.generators.erdos_renyi(60, 6.0, seed=1)
    tg = port_graph(rg)
    pats = [clique(3), tailed_triangle()]
    calls = []
    real = tops.triangle_count
    try:
        tops.triangle_count = lambda adj: calls.append(adj.shape) or \
            real(adj)
        cp = tcompiler.compile(pats, tg, cache=False, device="cpu",
                               use_pallas=True,
                               apct=shared_apct("port", tg, APCT))
        counts = [cp.count(p) for p in pats]
    finally:
        tops.triangle_count = real
    assert calls == [(60, 60)]
    eng = CountingEngine(tg, device="cpu")
    assert counts == [eng.edge_induced(p) for p in pats]
    RP = reference.pattern.Pattern
    rcp = reference.compiler.compile(
        [RP(p.n, sorted(p.edges)) for p in pats], rg, cache=False,
        use_pallas=True, apct=shared_apct("ref", rg, reference.APCT))
    assert rcp.counts() == cp.counts()
    assert rcp.plan.to_json() == cp.plan.to_json()
