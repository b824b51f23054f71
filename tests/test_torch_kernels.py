"""Join kernels of the port vs the reference's interpret-mode kernels.

On the CPU the port's wrappers take the kernels' plain PyTorch versions
(the CUDA kernels themselves are held against those on the card by
``chip_smoke.py``).  Here the plain versions and the ``ops`` wrappers are
held against ``repro.kernels.ops.cutjoin_reduce`` / ``cutjoin_reduce3``
run with ``interpret=True``, and against a dense f64 numpy oracle, on
the same seeded integer-valued factors.  Tolerance is **0**: exact
equality, since every quantity is an integer held in f64 and every case
stays within the ``exact_block`` guard.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs as tobs
from repro_torch.kernels import matreduce as tmr
from repro_torch.kernels import ops as tops

from test_torch_reference import counters_moved, reference  # noqa: F401

BLOCKS = (8, 128, 1024)
SIZES = (24, 130, 200)


def _hi(nf: int, block: int) -> int:
    """Largest factor magnitude the guard admits: hi^nf * block <= 2^24."""
    hi = int((tmr.EXACT_LIMIT / block) ** (1.0 / nf))
    while (hi + 1) ** nf * block <= tmr.EXACT_LIMIT:
        hi += 1
    while hi ** nf * block > tmr.EXACT_LIMIT:
        hi -= 1
    return hi


def _factors(seed, shapes, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(-hi, hi + 1, size=s).astype(np.float64)
            for s in shapes]


def _t(fs):
    return [torch.from_numpy(F) for F in fs]


def _pair_oracle(fs, distinct, offsets=(0, 0)):
    prod = np.prod(np.stack(fs), axis=0)
    if distinct and prod.ndim == 2:
        gx = np.arange(prod.shape[0]) + offsets[0]
        gy = np.arange(prod.shape[1]) + offsets[1]
        prod = np.where(gx[:, None] == gy[None, :], 0.0, prod)
    return float(prod.sum())


def _tri_oracle(fs, axes, sizes, distinct, offsets=(0, 0, 0)):
    prod = np.ones(sizes)
    for F, ax in zip(fs, axes):
        prod = prod * F.reshape(tuple(sizes[a] if a in ax else 1
                                      for a in range(3)))
    if distinct:
        x = (np.arange(sizes[0]) + offsets[0])[:, None, None]
        y = (np.arange(sizes[1]) + offsets[1])[None, :, None]
        z = (np.arange(sizes[2]) + offsets[2])[None, None, :]
        prod = np.where((x == y) | (x == z) | (y == z), 0.0, prod)
    return float(prod.sum())


# -- |cut| = 1 and 2 against the dense oracle (no reference needed) ----------------

@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("k", (1, 2, 3))
@pytest.mark.parametrize("n", SIZES)
def test_vec_plain_and_wrapper_equal_dense(n, k, block):
    fs = _factors(n + k, [(n,)] * k, _hi(k, block))
    want = _pair_oracle(fs, False)
    assert tmr.prod_reduce_plain(_t(fs), block=block) == want
    assert tmr.prod_reduce(_t(fs), block=block) == want
    assert tops.cutjoin_reduce(_t(fs), block=block) == want


@pytest.mark.parametrize("distinct", (True, False))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("k", (1, 2, 3))
@pytest.mark.parametrize("n", SIZES)
def test_pair_plain_and_wrapper_equal_dense(n, k, block, distinct):
    fs = _factors(7 * n + k, [(n, n)] * k, _hi(k, block))
    want = _pair_oracle(fs, distinct)
    assert tmr.prod_reduce_plain(_t(fs), distinct=distinct,
                                 block=block) == want
    assert tops.cutjoin_reduce(_t(fs), distinct=distinct,
                               block=block) == want
    assert tmr.prod_reduce_tiles(_t(fs), distinct=distinct,
                                 block=block).sum().item() == want


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("rows,start,col0", [(17, 5, 0), (40, 90, 3),
                                             (1, 129, 0)])
def test_pair_rectangular_slice_with_offsets_equals_dense(rows, start, col0,
                                                          block):
    n = 130
    full = _factors(rows + start, [(n, n)] * 2, _hi(2, block))
    sl = [F[start:start + rows, col0:] for F in full]
    want = _pair_oracle(sl, True, (start, col0))
    got = tmr.prod_reduce(_t(sl), block=block, offsets=(start, col0))
    assert got == want
    assert tmr.prod_reduce_plain(_t(sl), block=block,
                                 offsets=(start, col0)) == want


def test_row_slices_with_offsets_sum_to_the_whole():
    n, block = 130, 128
    fs = _factors(3, [(n, n)] * 2, _hi(2, block))
    whole = tmr.prod_reduce(_t(fs), block=block)
    parts = sum(tmr.prod_reduce(_t([F[s:s + 50] for F in fs]), block=block,
                                offsets=(s, 0)) for s in range(0, n, 50))
    assert parts == whole == _pair_oracle(fs, True)


# -- |cut| = 3 against the dense oracle ---------------------------------------------

AXIS_MIXES = [
    [(0, 1), (1, 2)],
    [(0, 1), (1, 2), (0, 2)],
    [(0, 1), (1, 2), (2,)],
    [(0, 1, 2)],
    [(0, 1, 2), (0, 2)],
    [(0,), (1,), (2,)],
    [(0, 2)],                            # axis 1 uncovered
    [(1,)],                              # axes 0 and 2 uncovered
]


@pytest.mark.parametrize("distinct", (True, False))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("mix", range(len(AXIS_MIXES)))
def test_tri_plain_and_wrapper_equal_dense(mix, block, distinct):
    axes = AXIS_MIXES[mix]
    n = 24 if mix % 2 else 37
    fs = _factors(mix, [(n,) * len(ax) for ax in axes],
                  _hi(len(axes), block))
    want = _tri_oracle(fs, axes, (n, n, n), distinct)
    assert tmr.tri_reduce_plain(_t(fs), axes, n=n, distinct=distinct,
                                block=block) == want
    assert tops.cutjoin_reduce3(_t(fs), axes, n=n, distinct=distinct,
                                block=block) == want


@pytest.mark.parametrize("block", (8, 128))
def test_tri_axis0_slice_with_offsets_equals_dense(block):
    n = 40
    axes = [(0, 1, 2), (0, 2), (1, 2)]
    fs = _factors(11, [(n,) * len(ax) for ax in axes], _hi(3, block))
    total = 0.0
    for s in range(0, n, 16):
        w = min(16, n - s)
        sl = [fs[0][s:s + w], fs[1][s:s + w], fs[2]]
        got = tmr.tri_reduce(_t(sl), axes, n=(w, n, n), block=block,
                             offsets=(s, 0, 0))
        assert got == _tri_oracle(sl, axes, (w, n, n), True, (s, 0, 0))
        total += got
    assert total == _tri_oracle(fs, axes, (n, n, n), True)


def test_surplus_factors_are_folded_exactly():
    fs = [(torch.from_numpy(F), (2,))
          for F in _factors(5, [(50,)] * 11, 2)]
    folded = tmr._fold_surplus(fs, 8)
    assert len(folded) == 8
    want = np.prod(np.stack([F.numpy() for F, _ in fs]), axis=0)
    got = np.prod(np.stack([F.numpy() for F, _ in folded]), axis=0)
    assert np.array_equal(got, want)


def test_cuda_tensor_never_reaches_a_plain_version(monkeypatch):
    """The wrapper picks the plain version only for CPU tensors: with a
    tensor that claims to lie on the card it goes to the launcher — for
    the tri join, to the launcher of the route its mix takes."""
    called = {}

    def fake_launch(kind, entries, sizes, masked, off3, block):
        called["kind"] = kind
        if kind.startswith("trijoin"):
            called.setdefault("tri", []).append(("dense", kind))
        return torch.zeros((1,), dtype=torch.float64)

    def fake_route(route):
        def launch(factors, axes, sizes, masked, off3):
            called.setdefault("tri", []).append((route, axes, sizes, off3))
            return torch.zeros((1,), dtype=torch.float64)
        return launch

    class OnCard(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(tmr, "_launch", fake_launch)
    monkeypatch.setattr(tmr, "_launch_path", fake_route("path"))
    monkeypatch.setattr(tmr, "_launch_triangle", fake_route("triangle"))
    for plain in ("_prod_partials_plain", "_tri_partials_plain",
                  "_tri_path_plain", "_tri_triangle_plain"):
        monkeypatch.setattr(tmr, plain,
                            lambda *a, **k: pytest.fail("plain version taken"))
    F = torch.ones((4, 4), dtype=torch.float64).as_subclass(OnCard)
    monkeypatch.setattr(tmr, "_as_factors", lambda fs: list(fs))
    tmr.prod_reduce_tiles([F, F], block=8)
    assert called["kind"] == "pairjoin"
    G = torch.ones((4, 4, 4), dtype=torch.float64).as_subclass(OnCard)
    tmr.tri_reduce_tiles([F, F], [(0, 1), (1, 2)], n=4, block=8,
                         offsets=(1, 0, 2))
    tmr.tri_reduce_tiles([F, F, F], [(0, 1), (1, 2), (0, 2)], n=4, block=8)
    tmr.tri_reduce_tiles([G, F], [(0, 1, 2), (0, 2)], n=4, block=8)
    assert called["tri"] == [
        ("path", [(0, 1), (1, 2)], (4, 4, 4), (1, 0, 2)),
        ("triangle", [(0, 1), (1, 2), (0, 2)], (4, 4, 4), (0, 0, 0)),
        ("dense", "trijoin"),
    ]


# -- the tri join's routes -----------------------------------------------------------

# AXIS_MIXES and a triangle mix with a vector and two factors on one pair
ROUTE_MIXES = AXIS_MIXES + [[(0, 1), (0, 1), (1, 2), (0, 2), (1,)]]
ROUTES = ["path", "triangle", "path", "dense", "dense", "path", "path",
          "path", "triangle"]
ROUTE_N, ROUTE_TILE = 12, 4
ROUTE_SLICE = (4, 8)                      # axis-0 rows of the sliced case


def _route_plain(axes):
    return {"path": tmr._tri_path_plain, "triangle": tmr._tri_triangle_plain,
            "dense": lambda fs, ax, sizes, distinct, off:
            tmr._tri_partials_plain(fs, ax, sizes, distinct, ROUTE_TILE,
                                    off)}[tmr.tri_route(axes)]


def _route_case(mix, sliced, seed):
    """Seeded factors of ``ROUTE_MIXES[mix]`` within the guard at the
    tile ``ROUTE_TILE``: whole (n, n, n), or their axis-0 rows
    ``ROUTE_SLICE`` with the global offsets of that slice."""
    axes = ROUTE_MIXES[mix]
    n = ROUTE_N
    fs = _factors(seed, [(n,) * len(ax) for ax in axes],
                  _hi(len(axes), ROUTE_TILE))
    if not sliced:
        return axes, fs, (n, n, n), (0, 0, 0)
    lo, hi = ROUTE_SLICE
    fs = [F[lo:hi] if 0 in ax else F for F, ax in zip(fs, axes)]
    return axes, fs, (hi - lo, n, n), (lo, 0, 0)


def ref_tri_tiles(reference, fs, axes, sizes, offsets, distinct, b,
                  keep=None):
    """The reference's interpret-mode tri kernel, ``_trijoin_tiles``, on
    rectangular sizes with global offsets, as ``tri_reduce``,
    ``tri_reduce_keep`` and the mesh tier call it: the kept axis moved
    first, factors as 3-D views with size-1 absent axes, present axes
    zero-padded to the tile, a zero-padded ones vector on an uncovered
    axis.  Returns the join, or the kept vector."""
    import jax.numpy as jnp
    perm = (0, 1, 2) if keep is None else \
        (keep,) + tuple(a for a in range(3) if a != keep)
    rank = {a: i for i, a in enumerate(perm)}
    psizes = [sizes[a] for a in perm]
    stack, present = [], []
    for F, ax in zip(fs, axes):
        new = tuple(sorted(rank[a] for a in ax))
        G = np.transpose(F, [ax.index(perm[a]) for a in new])
        stack.append(G.reshape([psizes[i] if i in new else 1
                                for i in range(3)]))
        present.append(new)
    for a in sorted({0, 1, 2} - {i for p in present for i in p}):
        stack.append(np.ones([psizes[i] if i == a else 1 for i in range(3)]))
        present.append((a,))
    stack = [np.pad(S, [(0, -S.shape[i] % b) for i in range(3)])
             for S in stack]
    tiles = reference.matreduce._trijoin_tiles(
        *[jnp.asarray(S, jnp.float32) for S in stack],
        offsets=jnp.asarray([offsets[a] for a in perm], jnp.int32),
        present=tuple(present), distinct=distinct, bm=b, bn=b, bk=b,
        interpret=True)
    t = np.asarray(tiles, np.float64)
    return t.sum() if keep is None else t.sum(axis=(1, 2))[:psizes[0]]


def test_tri_route_of_each_mix():
    assert [tmr.tri_route(ax) for ax in ROUTE_MIXES] == ROUTES
    assert {tmr.tri_route(ax, keep=k) for ax in ROUTE_MIXES
            for k in (0, 1, 2)} == {"dense"}
    assert tmr.tri_route([(0, 2), (1, 2)]) == "path"
    assert tmr.tri_route([(0, 1), (0, 2), (1, 2), (0, 1, 2)]) == "dense"
    assert tmr.tri_route([]) == "path"


@pytest.mark.parametrize("sliced", (False, True))
@pytest.mark.parametrize("distinct", (True, False))
@pytest.mark.parametrize("mix", range(len(ROUTE_MIXES)))
def test_tri_route_plain_equals_plain_and_reference_interpret_kernel(
        reference, mix, distinct, sliced):
    axes, fs, sizes, off = _route_case(mix, sliced, 40 + mix)
    got = _route_plain(axes)(_t(fs), axes, sizes, distinct, off).sum().item()
    assert got == tmr.tri_reduce_plain(_t(fs), axes, n=sizes,
                                       distinct=distinct, block=ROUTE_TILE,
                                       offsets=off)
    assert got == ref_tri_tiles(reference, fs, axes, sizes, off, distinct,
                                ROUTE_TILE)
    assert got == tmr.tri_reduce(_t(fs), axes, n=sizes, distinct=distinct,
                                 block=ROUTE_TILE, offsets=off)
    assert got == _tri_oracle(fs, axes, sizes, distinct, off)


def test_route_counters_move_only_at_a_launch(monkeypatch):
    """A tri join on the CPU takes its route's plain version and counts
    nothing; a launch counts once in ``launches["trijoin"]`` and once in
    ``tri_routes`` under its route; ``reset_launches`` zeroes both."""
    monkeypatch.setattr(tmr, "launches", dict.fromkeys(tmr.launches, 0))
    monkeypatch.setattr(tmr, "tri_routes", dict.fromkeys(tmr.tri_routes, 0))
    axes, fs, sizes, off = _route_case(0, False, 3)
    tmr.tri_reduce(_t(fs), axes, n=sizes)
    tmr.tri_reduce_keep(_t(fs), axes, keep=1, n=sizes)
    assert not any(tmr.launches.values()) and \
        not any(tmr.tri_routes.values())
    tmr._count("path")
    tmr._count("triangle")
    assert tmr.launches["trijoin"] == 2 and tmr.launches["trijoin_keep"] == 0
    assert {k for k, v in tmr.tri_routes.items() if v} == \
        {"trijoin_path", "trijoin_triangle"}
    tmr.reset_launches()
    assert not any(tmr.launches.values()) and \
        not any(tmr.tri_routes.values())


@pytest.mark.parametrize("mix", range(len(ROUTE_MIXES)))
def test_tri_route_plain_reads_factors_through_their_strides(mix):
    """Transposed, expanded and f32 views reach the route's plain version
    (and the kernels) through their strides, as the kernels read them."""
    axes = ROUTE_MIXES[mix]
    n = 9
    fs = _factors(70 + mix, [(n,) * len(ax) for ax in axes], 3)
    want = _tri_oracle(fs, axes, (n, n, n), True)
    views = []
    for i, F in enumerate(fs):
        T = torch.from_numpy(F)
        if T.ndim == 2 and i % 2 == 0:
            T = T.T.contiguous().T               # column-major storage
        elif T.ndim == 1:
            T = T[:, None].expand(n, 3)[:, 1]     # stride 3
        views.append(T.float() if i == 1 else T)
    got = _route_plain(axes)(views, axes, (n, n, n), True, None)
    assert got.sum().item() == want


# -- against the reference's interpret-mode kernels ----------------------------------

@pytest.mark.parametrize("n,k,block,distinct", [
    (24, 1, 8, True), (24, 3, 1024, False), (130, 2, 128, True),
    (130, 3, 8, True), (200, 2, 1024, True), (200, 1, 128, False),
])
def test_pair_equals_reference_interpret_kernel(reference, n, k, block,
                                                distinct):
    fs = _factors(n * k + block, [(n, n)] * k, _hi(k, block))
    want = reference.ops.cutjoin_reduce(fs, distinct=distinct, bm=block,
                                        bn=block, interpret=True)
    assert tops.cutjoin_reduce(_t(fs), distinct=distinct,
                               block=block) == want
    assert tmr.prod_reduce_plain(_t(fs), distinct=distinct,
                                 block=block) == want


@pytest.mark.parametrize("n,k,block", [(24, 2, 8), (130, 3, 128),
                                       (200, 1, 1024)])
def test_vec_equals_reference_interpret_kernel(reference, n, k, block):
    fs = _factors(n + k + block, [(n,)] * k, _hi(k, block))
    want = reference.ops.cutjoin_reduce(fs, bm=block, bn=block,
                                        interpret=True)
    assert tops.cutjoin_reduce(_t(fs), block=block) == want


def test_pair_slice_offsets_equal_reference_interpret_kernel(reference):
    n, rows, start, block = 130, 40, 64, 128
    full = _factors(99, [(n, n)] * 2, _hi(2, block))
    sl = [F[start:start + rows] for F in full]
    want = reference.ops.cutjoin_reduce(sl, bm=block, bn=block,
                                        interpret=True, offsets=(start, 0))
    assert tops.cutjoin_reduce(_t(sl), block=block,
                               offsets=(start, 0)) == want


@pytest.mark.parametrize("n,mix,block", [
    (24, 0, 8), (24, 1, 8), (24, 4, 1024), (130, 0, 128), (130, 2, 128),
    (200, 1, 1024), (24, 6, 128),
])
def test_tri_equals_reference_interpret_kernel(reference, n, mix, block):
    axes = AXIS_MIXES[mix]
    fs = _factors(n + mix, [(n,) * len(ax) for ax in axes],
                  _hi(len(axes), block))
    want = reference.ops.cutjoin_reduce3(fs, axes, n=n, block=block,
                                         interpret=True)
    assert tops.cutjoin_reduce3(_t(fs), axes, n=n, block=block) == want
    assert tmr.tri_reduce_plain(_t(fs), axes, n=n, block=block) == want


def test_tri_offsets_equal_reference_interpret_kernel(reference):
    n, block = 24, 8
    axes = [(0, 1), (1, 2)]
    fs = _factors(5, [(n, n)] * 2, _hi(2, block))
    off = (3, 0, 7)
    want = reference.ops.cutjoin_reduce3(fs, axes, n=n, block=block,
                                         interpret=True, offsets=off)
    assert tops.cutjoin_reduce3(_t(fs), axes, n=n, block=block,
                                offsets=off) == want


# -- the guard ------------------------------------------------------------------------

@pytest.mark.parametrize("maxes", [(1.0,), (3.0, 5.0), (127.0, 129.0),
                                   (4096.0, 4096.0), (1449.0, 1449.0),
                                   (2.0 ** 12, 2.0 ** 9), (2.0 ** 22,),
                                   (5000.0, 5000.0), (0.0, 1e9)])
def test_exact_block_parity(reference, maxes):
    fs = [np.full((4,), m) for m in maxes]
    want = reference.matreduce.exact_block(fs, max_block=1024)
    assert tmr.exact_block(_t(fs), max_block=1024) == want
    assert tmr.exact_block((), max_block=1024, maxes=maxes) == want
    # interpret mode is where the reference uses the port's cap of 1024
    rbefore = reference.obs.snapshot()
    tobs.reset()
    want = reference.ops.cutjoin_exact_block(fs, interpret=True)
    assert tops.cutjoin_exact_block(_t(fs)) == want
    assert tobs.snapshot().get("kernel.exact_block") == counters_moved(
        reference.obs, rbefore, ("kernel.exact_block",))["kernel.exact_block"]


def test_exact_block_refusal_case(reference):
    fs = [np.full((3, 3), 2.0 ** 13), np.full((3, 3), 2.0 ** 9)]
    assert reference.matreduce.exact_block(fs) is None
    assert tmr.exact_block(_t(fs)) is None
    assert tops.cutjoin_exact_block(_t(fs)) is None


@pytest.mark.parametrize("block", (8, 64, 1024, 4096))
def test_runtime_block_parity(reference, block):
    assert tops.runtime_block(block) == \
        reference.ops.runtime_block(block, interpret=True)


# -- the f64 instance of K1 and its guard ---------------------------------------------

def _hi_f64(nf: int, cells: int) -> int:
    """Largest factor magnitude the f64 instance admits over ``cells``
    cells: hi^nf * cells <= 2^53."""
    hi = int((2.0 ** 53 / cells) ** (1.0 / nf))
    while (hi + 1) ** nf * cells <= 1 << 53:
        hi += 1
    while hi ** nf * cells > 1 << 53:
        hi -= 1
    return hi


def _ref_dense_join(reference, fs, reduce_axis=None):
    """The reference's dense f64 join (``_join_reduce`` under x64) of the
    stacked factors; with ``reduce_axis`` the masked keep form
    ``_join_keep`` keeping the other axis."""
    import jax.numpy as jnp
    from repro.compiler import lowering as rlowering
    with reference.x64():
        stack = jnp.stack([jnp.asarray(F, jnp.float64) for F in fs])
        if reduce_axis is None:
            return float(rlowering._join_reduce(stack))
        return np.asarray(rlowering._join_keep(stack, 1 - reduce_axis),
                          np.float64)


@pytest.mark.parametrize("k", (1, 2, 3))
@pytest.mark.parametrize("n", (24, 130, 1001))
def test_vec_f64_plain_equals_reference_dense_and_int64(reference, n, k):
    """Factors whose Π max lies beyond the f32 guard (2^24) and within
    the f64 instance's bound (n · Π max <= 2^53): the f64 plain version,
    the wrapper on the CPU and ``ops.cutjoin_reduce_f64`` equal the
    reference's dense f64 join and an int64 numpy join."""
    hi = _hi_f64(k, n)
    fs = _factors(500 + n + k, [(n,)] * k, hi)
    fs[0][0] = hi                          # reach the bound
    maxes = [np.abs(F).max() for F in fs]
    assert tmr.exact_block((), maxes=maxes) is None
    assert tmr.exact_f64(maxes, n)
    want = int(np.prod(np.stack(fs).astype(np.int64), axis=0).sum())
    got = tmr.prod_reduce_f64_plain(_t(fs))
    assert got == want == _ref_dense_join(reference, fs)
    assert tmr.prod_reduce(_t(fs), f64=True) == want
    assert tops.cutjoin_reduce_f64(_t(fs)) == want
    tiles = tmr.prod_reduce_tiles(_t(fs), f64=True)
    assert tiles.shape == (1,) and tiles.item() == want


def test_vec_f64_refuses_pair_factors():
    F = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        tmr.prod_reduce([F, F], f64=True)


@pytest.mark.parametrize("maxes,cells,admitted", [
    ((2.0 ** 26, 2.0 ** 14), 2 ** 13, True),          # 2^53 exactly
    ((2.0 ** 26, 2.0 ** 14), 2 ** 13 + 1, False),     # 2^53 + 2^40
    ((3.0,), (1 << 53) // 3, True),                   # 2^53 - 2
    ((3.0,), (1 << 53) // 3 + 1, False),              # 2^53 + 1
    ((2.0 ** 53,), 1, True),
    ((2.0 ** 53 + 2.0,), 1, False),
    ((0.0, 1e300), 8192, True),
    ((float("inf"),), 1, False),
    ((), 1 << 53, True),
])
def test_exact_f64_at_its_edges(maxes, cells, admitted):
    """cells · Π max|F_i| <= 2^53, counted in integers: the edge is
    exact where f64 products would round (2^53 + 1)."""
    assert tmr.exact_f64(maxes, cells) is admitted
    tobs.reset()
    assert tops.cutjoin_exact_f64(maxes, cells) is admitted
    assert tobs.snapshot()["kernel.exact_f64"] == {
        f"outcome={'granted' if admitted else 'refused'}": 1.0}


def test_cuda_vector_join_takes_the_one_launch_entry(monkeypatch):
    """K1 on a tensor that claims to lie on the card goes to the one-launch
    entry, f32 or f64, and never to a plain version; ``prod_reduce``
    reads the stream's result slot, ``prod_reduce_tiles`` a new tensor."""
    calls = []

    def fake_vec(factors, block, f64, fresh=True):
        calls.append((len(factors), block, f64, fresh))
        return torch.full((1,), 7.0, dtype=torch.float64)

    class OnCard(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(tmr, "_launch_vec", fake_vec)
    monkeypatch.setattr(tmr, "_prod_partials_plain",
                        lambda *a, **k: pytest.fail("plain version taken"))
    F = torch.ones((5,), dtype=torch.float64).as_subclass(OnCard)
    assert tmr.prod_reduce([F, F], block=8) == 7.0
    assert tmr.prod_reduce([F], f64=True) == 7.0
    assert tmr.prod_reduce_tiles([F, F, F], block=16).item() == 7.0
    assert calls == [(2, 8, False, False), (1, 128, True, False),
                     (3, 16, False, True)]
