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
    on = lambda x: torch.as_tensor(x).as_subclass(_OnCard)  # noqa: E731
    n0 = (tsd.launches["sddmm"], tbs.launches["bitset"],
          tbs.launches["bitset_edges"])
    lhs = on(torch.ones((3, 5)))
    tsd.sddmm(lhs, on(torch.ones((4, 5))), on(torch.ones((3, 4))))
    tsd.sddmm(on(torch.ones((3, 5), dtype=torch.bfloat16)),
              on(torch.ones((4, 5), dtype=torch.bfloat16)),
              on(torch.ones((3, 4))))
    words = on(torch.zeros((6, 2), dtype=torch.int32))
    tbs.bitset_intersect(words, words)
    tbs.bitset_intersect_edges(words, on(torch.tensor([[0, 5], [1, 2]])))
    assert [c[0] for c in fake_card] == ["sddmm_f32", "sddmm_bf16",
                                         "bitset_rows", "bitset_edges"]
    assert fake_card[0][1][3:6] == (3, 4, 5)         # M, N, K
    assert fake_card[2][1][2:4] == (6, 2)            # E, W
    assert (tsd.launches["sddmm"], tbs.launches["bitset"],
            tbs.launches["bitset_edges"]) == (n0[0] + 2, n0[1] + 1,
                                              n0[2] + 1)
