"""The two graph kernels of the port — SDDMM (K7) and the packed-bitset
intersection (K8) — vs the reference's interpret-mode kernels.

On the CPU the port's wrappers take the kernels' plain PyTorch versions
(the CUDA kernels are held against those on the card by
``chip_smoke.py``).  Here ``sddmm_plain``, ``bitset_intersect_plain``,
``bitset_intersect_edges_plain`` and the wrappers that reach them for CPU
tensors (``ops.sddmm``, ``ops.common_neighbors``) are held against
``repro.kernels.ops.sddmm`` / ``repro.kernels.bitset.bitset_intersect``
run with ``interpret=True`` and against the reference's oracles
(``ref.sddmm_ref``, ``ref.bitset_popcount_ref``), on the same inputs made
with numpy from a seed, the way ``tests/test_kernels.py`` runs them.

Tolerances: K7 on random normal input uses the reference's own, 2e-4
(f32) and 2e-2 (bf16) relative and absolute — the f32 sums run in another
order; on 0/1 input every cell is an integer below 2^24 and the tolerance
is **0**.  K8 counts bits: tolerance **0**.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.counting import CountingEngine
from repro_torch.core.pattern import clique
from repro_torch.kernels import bitset as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sddmm as tsd

from test_torch_reference import port_graph, reference  # noqa: F401

SHAPES = [(128, 128, 128), (256, 128, 384), (64, 96, 32), (200, 130, 70)]
DTYPES = {"f32": (torch.float32, 2e-4), "bf16": (torch.bfloat16, 2e-2)}
BITSETS = [(256, 4), (512, 16), (64, 7)]


def _sddmm_inputs(seed, M, N, K, binary=False):
    rng = np.random.default_rng(seed)
    if binary:
        lhs, rhs = ((rng.random(s) < 0.4).astype(np.float32)
                    for s in ((M, K), (N, K)))
    else:
        lhs, rhs = (rng.normal(size=s).astype(np.float32)
                    for s in ((M, K), (N, K)))
    mask = (rng.random((M, N)) < 0.3).astype(np.float32)
    return lhs, rhs, mask


def _ref_sddmm(reference, lhs, rhs, mask, dtype):
    import jax.numpy as jnp
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    l, r = jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt)
    m = jnp.asarray(mask)
    got = reference.ops.sddmm(l, r, m, bm=64, bn=64, bk=32, interpret=True)
    return np.asarray(got), np.asarray(reference.kref.sddmm_ref(l, r, m))


# -- K7 --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_sddmm_plain_matches_reference_kernel(reference, M, N, K, dtype):
    tdt, tol = DTYPES[dtype]
    lhs, rhs, mask = _sddmm_inputs(M + N + K, M, N, K)
    want, oracle = _ref_sddmm(reference, lhs, rhs, mask, tdt)
    l, r = (torch.from_numpy(x).to(tdt) for x in (lhs, rhs))
    m = torch.from_numpy(mask)
    got = tops.sddmm(l, r, m)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=tol, atol=tol)
    assert torch.equal(tsd.sddmm_plain(l, r, m), got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_sddmm_exact_on_binary_input(reference, M, N, K, dtype):
    tdt, _ = DTYPES[dtype]
    lhs, rhs, mask = _sddmm_inputs(7 * M + K, M, N, K, binary=True)
    want, oracle = _ref_sddmm(reference, lhs, rhs, mask, tdt)
    got = tops.sddmm(torch.from_numpy(lhs).to(tdt),
                     torch.from_numpy(rhs).to(tdt), torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), oracle)
    assert np.array_equal(got.numpy(), (lhs @ rhs.T) * mask)


def test_sddmm_numpy_input_follows_the_device_policy(monkeypatch):
    lhs, rhs, mask = _sddmm_inputs(3, 5, 4, 3, binary=True)
    got = tops.sddmm(lhs, rhs, mask, device="cpu")
    assert got.device.type == "cpu"
    assert np.array_equal(got.numpy(), (lhs @ rhs.T) * mask)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.sddmm(lhs, rhs, mask)
    with pytest.raises(ValueError):
        tops.sddmm(lhs, rhs[:, :2], mask, device="cpu")


EXACT_CASES = [
    # (name, lhs values, rhs values, K, the flag)
    ("0/1", (0.0, 1.0), (0.0, 1.0), 300, True),
    ("+-256 at K=256", (-256.0, 256.0, 3.0), (256.0, -7.0), 256, True),
    ("K max max = 2^24 + 2^16", (256.0,), (256.0,), 257, False),
    ("257", (257.0, 1.0), (1.0,), 4, False),
    ("0.5", (0.5, 1.0), (1.0,), 4, False),
    ("inf", (float("inf"), 1.0), (1.0,), 4, False),
    ("NaN", (1.0,), (float("nan"), 2.0), 4, False),
    ("K max max = 2^24", (64.0, -3.0), (128.0,), 2048, True),
    ("K max max = 2^24 + 1 K", (64.0,), (128.0,), 2049, False),
    ("-0.0", (-0.0, 2.0), (5.0,), 9, True),
    ("all zero", (0.0,), (0.0,), 5, True),
]


@pytest.mark.parametrize("case", range(len(EXACT_CASES)))
def test_sddmm_exact_plain_flag(case):
    """The plain version of ``sddmm_prep``'s flag: finite integers with
    |v| <= 256 and K · max|lhs| · max|rhs| <= 2^24, at the edges, on
    f32 operands and on their bf16 forms where those are the same
    values."""
    name, lv, rv, K, want = EXACT_CASES[case]
    rng = np.random.default_rng(case)
    lhs = torch.tensor(rng.choice(lv, size=(5, K)), dtype=torch.float32)
    rhs = torch.tensor(rng.choice(rv, size=(3, K)), dtype=torch.float32)
    lhs[0, 0], rhs[0, 0] = lv[0], rv[0]              # each value present
    assert tsd.sddmm_exact_plain(lhs, rhs) is want, name
    if name not in ("257",):                         # 257 rounds in bf16
        assert tsd.sddmm_exact_plain(lhs.bfloat16(), rhs.bfloat16()) \
            is want, name


@pytest.mark.parametrize("M,N", [(300, 260), (128, 128), (1, 129), (257, 3)])
def test_sddmm_occupancy_plain_equals_numpy(M, N):
    """The tile occupancy of the mask: 128 x 128 tiles, ragged at the
    edges, a tile occupied iff a value in it is non-zero, NaN included
    and -0.0 not."""
    rng = np.random.default_rng(M * N)
    mask = np.where(rng.random((M, N)) < 0.0005, 1.0, 0.0) \
        .astype(np.float32)
    mask[-1, -1] = np.nan
    mask[0, 0] = -0.0
    got = tsd.sddmm_occupancy_plain(torch.from_numpy(mask))
    tm, tn = -(-M // 128), -(-N // 128)
    want = np.zeros((tm, tn), bool)
    for i in range(tm):
        for j in range(tn):
            tile = mask[128 * i:128 * i + 128, 128 * j:128 * j + 128]
            want[i, j] = bool((tile != 0).any())
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert want[-1, -1]


@pytest.mark.parametrize("M,N,K", [(300, 260, 70), (129, 257, 130)])
def test_sddmm_exact_route_emulated_equals_plain(M, N, K):
    """The exact route as the tensor cores run it, emulated: operands
    rounded to bf16, f32 products and sums, the 128 x 256 output tiles
    whose two occupancy words are 0 left at 0, then times the mask.  On
    integer operands the flag admits (±256 included) it equals
    ``sddmm_plain`` value for value; on 0.5 the flag refuses."""
    rng = np.random.default_rng(K)
    lhs = torch.tensor(rng.integers(-2, 3, size=(M, K)), dtype=torch.float32)
    rhs = torch.tensor(rng.integers(0, 2, size=(N, K)), dtype=torch.float32)
    lhs[0, :4] = torch.tensor([256.0, -256.0, 255.0, 17.0])
    mask = torch.zeros((M, N))
    mask[5, 7], mask[-1, -1], mask[200 % M, 3] = 1.0, 2.0, float("nan")
    mask[-1, 0] = -0.0
    assert tsd.sddmm_exact_plain(lhs, rhs)
    occ = tsd.sddmm_occupancy_plain(mask)
    assert not occ.all()
    prod = lhs.bfloat16().float() @ rhs.bfloat16().float().T
    pairs = torch.nn.functional.pad(occ, (0, occ.shape[1] % 2)) \
        .view(occ.shape[0], -1, 2).any(2)
    keep = pairs.repeat_interleave(128, 0).repeat_interleave(256, 1)[:M, :N]
    emulated = prod.masked_fill(~keep, 0.0) * mask
    want = tsd.sddmm_plain(lhs, rhs, mask)
    assert torch.equal(emulated.isnan(), want.isnan())
    assert torch.equal(emulated.nan_to_num(), want.nan_to_num())
    half = lhs + 0.5
    assert not tsd.sddmm_exact_plain(half, rhs)


# -- K8 --------------------------------------------------------------------------------

def _words(seed, E, W):
    """Seeded uint32 words, half of them with bit 31 set, plus one row of
    all-ones words."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, size=(E, W), dtype=np.uint32)
    a[0] = np.uint32(0xFFFFFFFF)
    return a


@pytest.mark.parametrize("E,W", BITSETS)
def test_bitset_plain_matches_reference_kernel(reference, E, W):
    import jax.numpy as jnp
    a, b = _words(E, E, W), _words(E + W, E, W)
    b[0] = np.uint32(0x80000001)
    assert (a >> 31).any() and (b >> 31).any()
    blk = 64 if E % 64 == 0 else 1
    want = np.asarray(reference.bitset.bitset_intersect(
        jnp.asarray(a), jnp.asarray(b), block=blk, interpret=True))
    assert np.array_equal(want, reference.kref.bitset_popcount_ref(a, b))
    got = tbs.bitset_intersect(a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (E,)
    assert np.array_equal(got.numpy(), want)
    a32, b32 = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    assert torch.equal(tbs.bitset_intersect_plain(a32, b32), got)
    # the indexed entry: the same rows, gathered from one table
    table = np.concatenate([a, b])
    pairs = np.stack([np.arange(E), E + np.arange(E)], axis=1)
    assert np.array_equal(tbs.bitset_intersect_edges(table, pairs).numpy(),
                          want)
    assert np.array_equal(
        tbs.bitset_intersect_edges_plain(table, pairs[::-1].copy()).numpy(),
        want[::-1])


def test_bitset_rejects_pairs_outside_the_table():
    table = _words(1, 8, 2)
    with pytest.raises(ValueError):
        tbs.bitset_intersect_edges(table, np.array([[0, 8]]))
    with pytest.raises(ValueError):
        tbs.bitset_intersect_edges(table, np.array([[-1, 2]]))
    with pytest.raises(ValueError):
        tbs.bitset_intersect(table, table[:, :1])


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_pack_bitsets_equal_bit_for_bit(reference, n):
    rng = np.random.default_rng(n)
    adj = rng.random((n + 3, n)) < 0.5
    adj[0, :] = True                       # bit 31 of every full word
    want = reference.bitset.pack_bitsets(adj)
    got = tbs.pack_bitsets(torch.from_numpy(adj))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [7, 17, 45, 50, 77])
def test_pack_bitsets_plain_equal_bit_for_bit(reference, n):
    """The plain packing (the port's CPU path and the card's oracle) at n
    no multiple of 32 or of 16, where the kernel's scalar tail and its
    unaligned-row path run; uint8 entries other than 0/1 pack as their
    ``!= 0`` (the reference packs bool rows only)."""
    rng = np.random.default_rng(100 + n)
    adj = rng.random((n + 5, n)) < 0.4
    adj[0, :] = True
    want = reference.bitset.pack_bitsets(adj)
    got = tbs.pack_bitsets_plain(torch.from_numpy(adj))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)
    bytes_ = torch.from_numpy(adj.astype(np.uint8) * rng.integers(
        1, 256, size=adj.shape).astype(np.uint8))
    assert torch.equal(tbs.pack_bitsets_plain(bytes_), got)
    assert torch.equal(tbs.pack_bitsets(bytes_), got)


@pytest.mark.parametrize("row, ref_word, port_word", [
    (np.array([2, 1] + [0] * 30, np.uint8), 4, 3),
    (np.array([0.0] * 5 + [0.5] + [0.0] * 26), 0, 32),
    (np.array([0.0] * 2 + [256.0] + [0.0] * 29), 0, 4),
], ids=["uint8-2-carries", "float-half", "float-256"])
def test_pack_bitsets_non_binary_rows(reference, row, ref_word, port_word):
    """Input other than 0/1, which no path of either package passes: the
    reference multiplies its uint8 cast by 2^j (a 2 carries into the next
    bit, 0.5 and 256.0 cast to 0), the port sets the bit of every entry
    ``!= 0``.  Both are pinned, on the CPU path."""
    adj = row[None, :]
    assert reference.bitset.pack_bitsets(adj).tolist() == [[ref_word]]
    got = tbs.pack_bitsets_plain(torch.from_numpy(adj))
    assert got.tolist() == [[port_word]]
    assert torch.equal(tbs.pack_bitsets(torch.from_numpy(adj)), got)


@pytest.mark.parametrize("pairs", [
    np.array([[0, 8]]), np.array([[-1, 2]]), np.array([[3, 1], [2, -5]]),
    torch.tensor([[0, 8]]), torch.tensor([[4, 4], [-1, 0]]),
], ids=["numpy-high", "numpy-negative", "numpy-second-negative",
        "tensor-high", "tensor-negative"])
def test_bitset_host_pairs_checked_on_the_host(pairs):
    table = torch.from_numpy(_words(2, 8, 4).view(np.int32))
    with pytest.raises(ValueError, match="outside"):
        tbs.check_pairs_host(np.asarray(pairs), 8)
    with pytest.raises(ValueError, match="outside"):
        tbs.bitset_intersect_edges(table, pairs)
    with pytest.raises(ValueError, match="outside"):
        tbs.bitset_intersect_edges_plain(table, pairs)


def _edge_lists(rng, N):
    """Sorted (u, v) pairs with u-runs longer than a warp's 8-edge chunk
    and runs that straddle chunks; the same shuffled; one u repeated over
    the whole list."""
    star = np.stack([np.zeros(70, np.int64), rng.integers(1, N, 70)], 1)
    runs = np.concatenate([np.stack([np.full(k, u), rng.integers(0, N, k)],
                                    1) for u, k in ((3, 31), (5, 2), (7, 40),
                                                    (9, 33), (11, 1))])
    srt = np.concatenate([star, runs])
    srt = srt[np.lexsort((srt[:, 1], srt[:, 0]))]
    return {"sorted": srt, "unsorted": rng.permutation(srt),
            "repeated-u": np.stack([np.full(45, 6), rng.integers(0, N, 45)],
                                   1)}


def _vec_entry_emulated(table, edges, chunk=8, group=4):
    """The vector entry of ``bitset_edges`` in numpy (at W <= 128, one
    16-byte vector a lane): a warp per ``chunk`` consecutive edges, row u
    held and reloaded only when u changes, rows v of ``group`` edges
    loaded together.  Returns the counts and the number of row-u loads."""
    out, reloads = np.zeros(len(edges), np.int32), 0
    for e0 in range(0, len(edges), chunk):
        held, row = -1, None
        for j0 in range(e0, min(e0 + chunk, len(edges)), group):
            block = range(j0, min(j0 + group, e0 + chunk, len(edges)))
            rows_v = [table[edges[e, 1]] for e in block]
            for e, rv in zip(block, rows_v):
                if edges[e, 0] != held:
                    held, row = edges[e, 0], table[edges[e, 0]]
                    reloads += 1
                out[e] = np.bitwise_count(row & rv).sum()
    return out, reloads


@pytest.mark.parametrize("order", ["sorted", "unsorted", "repeated-u"])
def test_bitset_edge_entry_on_sorted_unsorted_and_repeated_u(reference,
                                                            order):
    rng = np.random.default_rng(5)
    N, W = 64, 8
    table = _words(6, N, W)
    edges = _edge_lists(rng, N)[order]
    want = reference.kref.bitset_popcount_ref(table[edges[:, 0]],
                                              table[edges[:, 1]])
    got = tbs.bitset_intersect_edges(table, edges)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tbs.bitset_intersect_edges_plain(
        torch.from_numpy(table.view(np.int32)),
        torch.from_numpy(edges)).numpy(), want)
    emulated, reloads = _vec_entry_emulated(table, edges)
    assert np.array_equal(emulated, want)
    runs = 1 + np.count_nonzero(np.diff(edges[:, 0]))
    chunks = -(-len(edges) // 8)
    assert reloads <= runs + chunks        # one load per run and chunk
    if order != "unsorted":
        assert reloads < len(edges) // 4


def test_edges_entry_follows_width_and_alignment():
    words = torch.zeros((10, 264), dtype=torch.int32)
    assert tbs.edges_entry(words[:, :256]) == "vec"
    assert tbs.edges_entry(words[:, :37]) == "word"
    assert tbs.edges_entry(words[:, 4:260]) == "vec"
    assert tbs.edges_entry(words[:, 1:257]) == "word"     # 4-byte offset
    assert tbs.edges_entry(torch.zeros((4, 1028), dtype=torch.int32)) \
        == "word"


def test_common_neighbors_equal_per_edge_and_sum_to_three_triangles(
        reference):
    rg = reference.generators.erdos_renyi(100, 8.0, seed=6)
    adj = rg.dense_adjacency(np.float32, pad=False) > 0.5
    want = np.asarray(reference.ops.common_neighbors(adj, rg.edges,
                                                     interpret=True))
    got = tops.common_neighbors(adj, rg.edges, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    tri = CountingEngine(port_graph(rg), device="cpu").edge_induced(clique(3))
    assert got.sum().item() == 3 * tri
    # sddmm(A, A, A) read at each edge is the same count
    A = torch.from_numpy(adj.astype(np.float32))
    closed = tops.sddmm(A, A, A)
    e = torch.from_numpy(np.asarray(rg.edges))
    assert torch.equal(closed[e[:, 0], e[:, 1]], got.float())
    assert closed.sum().item() == 6 * tri


def test_common_neighbors_tensor_device_decides(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adj = torch.tensor([[0, 1, 1], [1, 0, 1], [1, 1, 0]], dtype=torch.bool)
    edges = np.array([[0, 1], [1, 2], [0, 2]])
    before = dict(tbs.launches)
    assert tops.common_neighbors(adj, edges).tolist() == [1, 1, 1]
    assert tbs.launches == before          # plain versions launch nothing
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.common_neighbors(adj.numpy(), edges)


# -- a CUDA tensor never reaches a plain version ---------------------------------------

class _OnCard(torch.Tensor):
    is_cuda = True


class _NoContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_card(monkeypatch):
    """Stand-ins for the card: the libraries record their launches."""
    calls = []

    class FakeLib:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(tsd, "_lib", lambda: FakeLib())
    monkeypatch.setattr(tbs, "_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    for plain in ("sddmm_plain",):
        monkeypatch.setattr(tsd, plain, lambda *a: pytest.fail("plain"))
    for plain in ("bitset_intersect_plain", "bitset_intersect_edges_plain"):
        monkeypatch.setattr(tbs, plain, lambda *a: pytest.fail("plain"))
    before = (dict(tsd.launches), dict(tbs.launches))
    yield calls
    tsd.launches.update(before[0])
    tbs.launches.update(before[1])


def test_cuda_tensors_go_to_the_kernels(fake_card):
    """K7 on f32 operands launches prep, the tensor-core kernel (gated on
    the flag) and the FMA kernel, in that order; on bf16 prep and the
    tensor-core kernel (ungated); K8 its two entries."""
    on = lambda x: torch.as_tensor(x).as_subclass(_OnCard)  # noqa: E731
    n0 = (tsd.launches["sddmm"], tbs.launches["bitset"],
          tbs.launches["bitset_edges"], dict(tsd.entries))
    lhs = on(torch.ones((3, 5)))
    tsd.sddmm(lhs, on(torch.ones((4, 5))), on(torch.ones((3, 4))))
    tsd.sddmm(on(torch.ones((3, 5), dtype=torch.bfloat16)),
              on(torch.ones((4, 5), dtype=torch.bfloat16)),
              on(torch.ones((3, 4))))
    words = on(torch.zeros((6, 2), dtype=torch.int32))
    tbs.bitset_intersect(words, words)
    tbs.bitset_intersect_edges(words, on(torch.tensor([[0, 5], [1, 2]])))
    assert [c[0] for c in fake_card] == [
        "sddmm_prep", "sddmm_tc", "sddmm_f32", "sddmm_prep", "sddmm_tc",
        "bitset_rows", "bitset_edges"]
    assert fake_card[0][1][3:6] == (3, 4, 5)         # M, N, K
    assert fake_card[0][1][9:11] == (0, 0)           # f32, two tensors
    assert fake_card[1][1][8:11] == (3, 4, 5)        # M, N, K
    assert fake_card[1][1][12:14] == (1, 0)          # gated, two tensors
    assert fake_card[2][1][3:6] == (3, 4, 5)
    assert fake_card[3][1][9] == 1                   # bf16
    assert fake_card[4][1][12] == 0                  # bf16: not gated
    assert fake_card[5][1][2:4] == (6, 2)            # E, W
    assert (tsd.launches["sddmm"], tbs.launches["bitset"],
            tbs.launches["bitset_edges"]) == (n0[0] + 2, n0[1] + 1,
                                              n0[2] + 1)
    assert {k: tsd.entries[k] - n0[3][k] for k in tsd.entries} == {
        "sddmm_prep": 2, "sddmm_tc": 2, "sddmm_f32": 1}
    tsd.entries.update(n0[3])


def test_cuda_pack_and_the_pair_flag(fake_card, monkeypatch):
    """On a card, packing launches ``bitset_pack`` on bool or uint8 rows
    as they lie (other dtypes after one ``!= 0``); pairs on the card are
    checked by the kernel, whose flag the wrapper reads once and turns
    into ``ValueError``; pairs from the host were checked there, and the
    flag is not read."""
    import ctypes
    on = lambda x: torch.as_tensor(x).as_subclass(_OnCard)  # noqa: E731
    n0 = dict(tbs.launches)
    for adj in (torch.ones((5, 40), dtype=torch.bool),
                torch.ones((5, 40), dtype=torch.float32)):
        tbs.pack_bitsets(on(adj))
    assert [c[0] for c in fake_card] == ["bitset_pack"] * 2
    assert fake_card[0][1][1:5] == (5, 40, 40, 2)       # R, N, ld, W
    raise_flag = {"on": True}

    class FlagLib:
        def bitset_edges(self, *args):
            fake_card.append(("bitset_edges", args))
            if raise_flag["on"]:
                ctypes.c_int.from_address(args[7]).value = 1
            return 0

    monkeypatch.setattr(tbs, "_lib", lambda: FlagLib())
    words = on(torch.zeros((6, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        tbs.bitset_intersect_edges(words, on(torch.tensor([[0, 5]])))
    # host pairs: checked with numpy, the flag never read
    out = tbs.bitset_intersect_edges(words, np.array([[0, 5], [1, 2]]))
    assert tuple(out.shape) == (2,)
    assert fake_card[-1][1][3] == 6                     # N, the table rows
    assert fake_card[-1][1][8] == (tbs.edges_entry(words) == "vec")
    assert tbs.launches["bitset_pack"] == n0["bitset_pack"] + 2
    assert tbs.launches["bitset_edges"] == n0["bitset_edges"] + 2


def test_cuda_sddmm_reads_one_tensor_once_and_copies_what_tma_cannot_read(
        fake_card):
    """``sddmm(A, A, A)`` tells the kernels that lhs and rhs are one
    tensor (f32: one bf16 copy, written by prep); a bf16 operand whose row
    stride is no multiple of 8 elements is copied into a buffer whose row
    stride is, before the tensor-core kernel reads it."""
    on = lambda x: torch.as_tensor(x).as_subclass(_OnCard)  # noqa: E731
    before = dict(tsd.entries)
    A = on(torch.ones((6, 6)))
    tsd.sddmm(A, A, A)
    prep, tc = fake_card[0][1], fake_card[1][1]
    assert prep[10] == 1 and tc[13] == 1                  # same
    assert prep[11] == prep[12] and prep[13] == 8         # one copy, ld 8
    assert tc[0] == tc[2] == prep[11] and tc[1] == tc[3] == 8
    fake_card.clear()
    B = on(torch.ones((4, 13), dtype=torch.bfloat16))
    tsd.sddmm(B[:, :5], B[:, 2:7], on(torch.ones((4, 4))))
    tc = fake_card[1][1]
    assert tc[1] == 8 and tc[3] == 8                      # copied, ld 8
    tsd.entries.update(before)


@pytest.mark.parametrize("dtype,steps", [
    (torch.float32, ("sddmm_prep",)),
    (torch.float32, ("sddmm_tc",)),
    (torch.float32, ("sddmm_f32",)),
    (torch.float32, ("sddmm_tc", "sddmm_f32")),
    (torch.bfloat16, ("sddmm_prep", "sddmm_tc")),
])
def test_cuda_sddmm_launch_runs_the_steps_it_is_given(fake_card, dtype,
                                                      steps):
    """``launch`` on a call's ``buffers`` launches the named steps, in
    order, with the arguments the wrapper passes, and counts each; a bf16
    call has no FMA step."""
    on = lambda x: torch.as_tensor(x).as_subclass(_OnCard)  # noqa: E731
    before = dict(tsd.entries)
    lhs, rhs = (on(torch.ones(s, dtype=dtype)) for s in ((3, 5), (4, 5)))
    mask = on(torch.ones((3, 4)))
    tsd.sddmm(lhs, rhs, mask)
    whole = {entry: args for entry, args in fake_card}
    fake_card.clear()
    buf = tsd.buffers(lhs, rhs, mask)
    tsd.launch(buf, steps)
    assert [c[0] for c in fake_card] == list(steps)
    for entry, args in fake_card:
        # the same arguments but the buffers' addresses
        assert len(args) == len(whole[entry])
        assert [a for a in args if isinstance(a, int) and a < 1 << 20] == \
            [a for a in whole[entry] if isinstance(a, int) and a < 1 << 20]
    assert {k: tsd.entries[k] - before[k] for k in tsd.entries} == {
        k: int(k in steps) + int(k in whole) for k in tsd.entries}
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="no step"):
            tsd.launch(buf, ("sddmm_f32",))
    tsd.entries.update(before)
