"""Flash attention (K9) of the port vs the reference package.

On the CPU the port's wrappers take the kernel's plain PyTorch version
(the CUDA kernel is held against that on the card by ``chip_smoke.py``).
Here ``ops.flash_attention`` and ``models.layers.flash_attention`` of the
port are held against the reference's ``ops.flash_attention`` run with
``interpret=True``, its oracle ``ref.flash_attention_ref`` and its XLA
scan ``models.layers.flash_attention``, on the same inputs made with
numpy from a seed, the shape and dtype sweep of ``tests/test_kernels.py``.

Tolerances are the reference's own: 2e-5 (f32) and 3e-2 (bf16), relative
and absolute — the f32 sums run in another order.  Then the wrapper's
refusals and its launch count, with stand-ins for the card.

The backward (K9-bwd): the reference has none for its kernel, so the
port's plain backward ``flash_attention_bwd_plain`` is held to what the
reference's training path differentiates, ``jax.vjp`` of its XLA scan,
and to autograd of the port's plain forward, within 1e-5 of max|want| per
gradient (f32 sums in another order); then its launches on a fake card,
through ``FlashAttention`` too.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import layers as rlayers

from repro_torch.kernels import flashattn as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers

DTYPES = {"f32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 3e-2)}
SWEEP = [(1, 128, 2, 64, True), (2, 256, 2, 64, True),
         (1, 128, 1, 128, False), (2, 64, 4, 32, True)]


def _qkv(seed, shape, dtype):
    """The same q, k, v for both packages: numpy f32 values, rounded to
    the working type by each framework (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    tdt, jdt, _ = DTYPES[dtype]
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _per_head(x):
    """(B, S, H, D) -> (B·H, S, D), the reference oracle's layout."""
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,D,causal", SWEEP)
def test_ops_flash_attention_matches_reference_kernel(B, S, H, D, causal,
                                                      dtype):
    (q, k, v), (jq, jk, jv) = _qkv(B * S + D, (B, S, H, D), dtype)
    tol = DTYPES[dtype][2]
    got = tops.flash_attention(q, k, v, causal=causal, bq=64, bk=64)
    assert got.dtype == q.dtype and got.shape == q.shape
    kernel = rops.flash_attention(jq, jk, jv, causal=causal, bq=64, bk=64,
                                  interpret=True)
    oracle = rref.flash_attention_ref(_per_head(jq), _per_head(jk),
                                      _per_head(jv), causal=causal)
    oracle = oracle.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("block", [16, 32, 64])
def test_layers_flash_attention_matches_reference_scan(block, dtype):
    """The port's model-level flash attention (its plain scan on the CPU)
    vs the reference's XLA scan and its interpret-mode kernel, as
    ``tests/test_kernels.py::test_flash_kernel_matches_model_layer``."""
    (q, k, v), (jq, jk, jv) = _qkv(block, (2, 128, 2, 32), dtype)
    tol = DTYPES[dtype][2]
    got = tlayers.flash_attention(q, k, v, causal=True, block=block)
    want = rlayers.flash_attention(jq, jk, jv, causal=True, block=block)
    kernel = rops.flash_attention(jq, jk, jv, causal=True, bq=32, bk=32,
                                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=tol, atol=tol)


def test_causal_attention_flash_branch_matches_dense():
    """``causal_attention`` past ``flash_block`` equals its dense branch,
    and both equal the reference's (``tests/test_models.py``)."""
    (q, k, v), (jq, jk, jv) = _qkv(7, (2, 64, 4, 16), "f32")
    dense = tlayers.causal_attention(q, k, v, flash_block=64)
    flash = tlayers.flash_attention(q, k, v, causal=True, block=16)
    via = tlayers.causal_attention(q, k, v, flash_block=16)
    np.testing.assert_allclose(_np(flash), _np(dense), rtol=1e-5, atol=1e-5)
    assert torch.equal(via, flash)
    want = rlayers.causal_attention(jq, jk, jv, flash_block=16)
    np.testing.assert_allclose(_np(via), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,Skv,causal", [(77, 77, True), (50, 77, False),
                                           (77, 50, True)])
def test_plain_version_on_ragged_and_unequal_lengths(Sq, Skv, causal):
    """The plain version with one KV block (the kernel's ragged cases on
    the card are held against it): equal to the reference oracle."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (rng.normal(size=(1, s, 3, 64)).astype(np.float32)
               for s in (Sq, Skv, Skv))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    want = rref.flash_attention_ref(*(_per_head(jnp.asarray(x))
                                      for x in (q, k, v)), causal=causal)
    want = np.asarray(want).reshape(1, 3, Sq, 64).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ops_flash_attention_keeps_the_reference_assertion():
    q = torch.zeros((1, 96, 1, 64))
    with pytest.raises(AssertionError):
        tops.flash_attention(q, q, q, bq=64, bk=64)
    with pytest.raises(AssertionError):
        tlayers.flash_attention(q, q, q, causal=True, block=64)


# -- a CUDA tensor never reaches the plain version -------------------------------------

class _OnCard(torch.Tensor):
    is_cuda = True


class _NoContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def on_card(x):
    return torch.as_tensor(x).as_subclass(_OnCard)


# the dims among K9's and K9-bwd's arguments, by name (``ENTRY_ARGS``)
DIMS = ("B", "H", "Sq", "Skv", "Dq", "Dv")
BWD_DIMS = ("B", "H", "S", "Dq", "Dv")


@pytest.fixture
def fake_card(monkeypatch):
    """Stand-ins for the card: the library records its launches."""
    calls = []

    class FakeLib:
        def __getattr__(self, entry):
            def launch(*args):
                # the arguments by their names in the entry's table; the
                # strides (12 for the forward, 24 for the backward) read
                # back from the address handed over
                names = [name for name, _ in tfa.ENTRY_ARGS[entry]]
                assert len(args) == len(names), (entry, args)
                named = dict(zip(names, args))
                n = 24 if entry.startswith("flashattn_bwd") else 12
                strides = (ctypes.c_longlong * n).from_address(
                    named["strides"])
                calls.append((entry, named, list(strides)))
                return 0
            return launch

    monkeypatch.setattr(tfa, "_lib", lambda: FakeLib())
    monkeypatch.setattr(tfa, "_bwd_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: pytest.fail("plain"))
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a, **kw: pytest.fail("plain backward"))
    before = dict(tfa.launches)
    yield calls
    tfa.launches.update(before)


def test_cuda_tensors_go_to_the_kernel(fake_card):
    n0 = tfa.launches["flashattn"]
    q = on_card(torch.zeros((2, 40, 3, 128)))
    tops.flash_attention(q, q, q, causal=True, bq=8, bk=8)
    # (B, H, S, D) storage read as (B, S, H, D) by strides: no copy
    base = torch.zeros((1, 4, 96, 64), dtype=torch.bfloat16)
    qs = on_card(base.transpose(1, 2))
    tlayers.flash_attention(qs, qs, qs, causal=False, block=32)
    assert [c[0] for c in fake_card] == ["flashattn_f32", "flashattn_bf16"]
    assert [fake_card[0][1][n] for n in DIMS] == [2, 3, 40, 40, 128, 128]
    assert fake_card[0][1]["causal"] == 1 and \
        fake_card[1][1]["causal"] == 0
    assert fake_card[1][1]["q"] == base.data_ptr()
    assert fake_card[1][2][:3] == [4 * 96 * 64, 64, 96 * 64]
    assert fake_card[1][2][9:] == [96 * 4 * 64, 4 * 64, 64]       # out
    assert tfa.launches["flashattn"] == n0 + 2


@pytest.mark.parametrize("what,shape,dtype", [
    ("head dims", (1, 8, 2, 32), torch.float32),
    ("head dims", (1, 8, 2, 256), torch.float32),
    ("f32 or bf16", (1, 8, 2, 64), torch.float16),
    ("f32 or bf16", (1, 8, 2, 64), torch.float64)])
def test_kernel_refuses_what_it_does_not_take(fake_card, what, shape, dtype):
    q = on_card(torch.zeros(shape, dtype=dtype))
    with pytest.raises(ValueError, match=what):
        tfa.flash_attention(q, q, q, causal=True)
    assert not fake_card


def test_kernel_refuses_mixed_devices_types_and_positions(fake_card):
    q = on_card(torch.zeros((1, 8, 2, 64)))
    with pytest.raises(ValueError, match="different devices"):
        tfa.flash_attention(q, torch.zeros((1, 8, 2, 64)), q, causal=True)
    with pytest.raises(ValueError, match="one type"):
        tfa.flash_attention(q, q.to(torch.bfloat16), q, causal=True)
    with pytest.raises(ValueError, match="positions"):
        tfa.flash_attention(q, q, q, causal=True,
                            q_positions=torch.arange(8))
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, on_card(torch.zeros((1, 8, 2, 128))),
                            causal=True)
    assert not fake_card


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dq,Dv", tfa.HEAD_DIM_PAIRS)
def test_head_dim_pairs_reach_the_entry(fake_card, Dq, Dv, dtype):
    """Each of K9's (Dq, Dv) instances: the entry gets both dims, and the
    output it is handed is (B, Sq, H, Dv), contiguous — at (192, 128) v's
    head dim, not q's."""
    n0 = tfa.launches["flashattn"]
    q, k = (on_card(torch.zeros((2, 40, 3, Dq), dtype=dtype))
            for _ in range(2))
    v = on_card(torch.zeros((2, 50, 3, Dv), dtype=dtype)[:, :40])
    out = tfa.flash_attention(q, k, v, causal=True)
    (entry, args, strides), = fake_card
    assert entry == tfa._ENTRY[dtype]
    assert [args[n] for n in DIMS] == [2, 3, 40, 40, Dq, Dv]
    assert tuple(out.shape) == (2, 40, 3, Dv) and out.dtype == dtype
    assert args["out"] == out.data_ptr()
    assert strides[6:9] == [50 * 3 * Dv, 3 * Dv, Dv]             # v in place
    assert strides[9:] == [40 * 3 * Dv, 3 * Dv, Dv]              # out
    assert tfa.launches["flashattn"] == n0 + 1


@pytest.mark.parametrize("Dq,Dv", [(192, 192), (128, 64), (96, 96),
                                   (128, 192), (64, 128)])
def test_other_head_dim_pairs_are_refused(fake_card, Dq, Dv):
    q = on_card(torch.zeros((1, 8, 2, Dq)))
    v = on_card(torch.zeros((1, 8, 2, Dv)))
    with pytest.raises(ValueError, match=r"head dims \(Dq, Dv\) in"):
        tfa.flash_attention(q, q, v, causal=True)
    assert not fake_card


def test_cpu_tensors_launch_nothing():
    n0 = tfa.launches["flashattn"]
    q = torch.zeros((1, 64, 1, 16))
    tops.flash_attention(q, q, q, bq=32, bk=32)
    tlayers.causal_attention(q, q, q, flash_block=16)
    assert tfa.launches["flashattn"] == n0


# -- K9-bwd: the backward (plain version on the CPU, launches on a fake card) ------------

BWD_TOL = 1e-5                    # relative to max|want|, per gradient


def _bwd_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


# (Dq, Dv): the kernel's pairs and reduced MLA's 16 + 8 / 16
BWD_PAIRS = [(64, 64), (192, 128), (24, 16)]


@pytest.mark.parametrize("Dq,Dv", BWD_PAIRS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64])
def test_bwd_plain_matches_reference_vjp(block, causal, Dq, Dv):
    """What the reference's training path differentiates: ``jax.vjp`` of
    its XLA scan ``models/layers.flash_attention`` at the scan's block
    size, against the port's plain backward from the plain forward's
    output and lse — within ``BWD_TOL`` of max|want| per gradient, each
    gradient at its input's shape (dq and dk at Dq, dv at Dv)."""
    import jax
    rng = np.random.default_rng(block + causal + Dq + Dv)
    q, k = (rng.normal(size=(2, 64, 3, Dq)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.normal(size=(2, 64, 3, Dv)).astype(np.float32)
             for _ in range(2))
    _, vjp = jax.vjp(lambda a, b, c: rlayers.flash_attention(
        a, b, c, causal=causal, block=block), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                       block=block, return_lse=True)
    assert lse.shape == (2, 3, 64) and lse.is_contiguous()
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse,
                                        causal=causal)
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.shape == x.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= BWD_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_autograd_of_the_plain_forward(causal):
    q, k, v, do = (torch.from_numpy(x) for x in _bwd_inputs(
        7 + causal, (1, 77, 2, 64)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_attention_plain(*leaves, causal=causal, block=7,
                                         return_lse=True)
    want = torch.autograd.grad(out, leaves, do)
    got = tfa.flash_attention_bwd_plain(q, k, v, out.detach(), do,
                                        lse.detach(), causal=causal)
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()) <= BWD_TOL
    # on the CPU the wrapper is the plain version
    via = tfa.flash_attention_bwd(q, k, v, out.detach(), do, lse.detach(),
                                  causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(via, got))


def test_lse_is_the_row_logsumexp_of_the_scaled_scores():
    q, k, v, _ = (torch.from_numpy(x) for x in _bwd_inputs(3, (2, 50, 3, 64)))
    _, lse = tfa.flash_attention_plain(q, k, v, causal=True, block=10,
                                       return_lse=True)
    s = torch.einsum("bqhd,bthd->bhqt", q, k) / 8.0
    s = s.masked_fill(~torch.ones(50, 50, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-5)


def test_bwd_plain_rounds_once_to_the_input_type():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _bwd_inputs(4, (1, 40, 2, 64)))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=True,
                                       return_lse=True)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True)
    exact = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                          o.float(), do.float(), lse,
                                          causal=True)
    for g, w in zip(got, exact):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_training_on_the_card_takes_both_kernels(fake_card):
    """A loss through ``flash_attention`` on (fake) card tensors that
    require grad: the forward launches K9 with a row-statistic buffer, the
    backward launches K9-bwd once (three kernels in one call) on the saved
    q, k, v, output and lse and on dO copied to unit D stride (autograd's
    dO of a sum is broadcast), and q, k and v get gradients.  Without grad
    mode the forward passes no buffer and nothing is saved."""
    n0, b0 = tfa.launches["flashattn"], tfa.launches["flashattn_bwd"]
    q, k, v = (on_card(torch.zeros((2, 40, 3, 64))).requires_grad_()
               for _ in range(3))
    out = tfa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert [c[0] for c in fake_card] == ["flashattn_f32", "flashattn_bwd_f32"]
    (_, fwd, _), (_, bwd, strides) = fake_card
    assert fwd["lse"] is not None                         # lse buffer
    assert [bwd[n] for n in BWD_DIMS] == [2, 3, 40, 64, 64]
    assert bwd["q"] == q.data_ptr() and bwd["lse"] == fwd["lse"]
    assert bwd["causal"] == 1
    assert bwd["scale"] == pytest.approx(1 / 8)
    assert strides[12:15] == [40 * 3 * 64, 3 * 64, 64]    # dO, copied
    assert all(x.grad is not None and x.grad.shape == x.shape
               for x in (q, k, v))
    assert tfa.launches["flashattn"] == n0 + 1
    assert tfa.launches["flashattn_bwd"] == b0 + 1
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v, causal=False)
    assert out.grad_fn is None and fake_card[-1][1]["lse"] is None


def test_bwd_reads_strided_operands_in_place(fake_card):
    """K9-bwd reads its operands by their (batch, sequence, head) strides
    where it can: a (B, H, S, D) storage goes in as it is in bf16 (TMA reads
    it: 16-byte aligned start and strides) and in f32; a dO broadcast over
    the heads (head stride 0) goes in as it is in f32 and is copied in bf16,
    where the kernel reads it by TMA; a view without unit D stride is
    copied in both."""
    base = torch.zeros((2, 3, 40, 64), dtype=torch.bfloat16)
    q = on_card(base.transpose(1, 2))
    lse = on_card(torch.zeros((2, 3, 40)))
    do = on_card(torch.zeros((2, 40, 1, 64), dtype=torch.bfloat16)
                 .expand(2, 40, 3, 64))
    dq, dk, dv = tfa.flash_attention_bwd(q, q, q, q, do, lse, causal=False)
    (entry, args, strides), = fake_card
    assert entry == "flashattn_bwd_bf16" and args["causal"] == 0
    assert args["q"] == base.data_ptr() and args["dout"] != do.data_ptr()
    assert strides[:3] == [3 * 40 * 64, 64, 40 * 64]
    assert strides[12:15] == [40 * 3 * 64, 3 * 64, 64]       # dO, copied
    assert strides[15:] == [40 * 3 * 64, 3 * 64, 64] * 3     # dq, dk, dv
    assert dq.shape == dk.shape == dv.shape == (2, 40, 3, 64)
    fake_card.clear()
    tfa.flash_attention_bwd(q, q, q, q, on_card(torch.zeros(
        (2, 40, 3, 128), dtype=torch.bfloat16))[..., ::2], lse, causal=True)
    (_, args, strides), = fake_card
    assert strides[12:15] == [40 * 3 * 64, 3 * 64, 64]
    fake_card.clear()
    base32 = torch.zeros((2, 3, 40, 64))
    q32 = on_card(base32.transpose(1, 2))
    do32 = on_card(torch.zeros((2, 40, 1, 64)).expand(2, 40, 3, 64))
    tfa.flash_attention_bwd(q32, q32, q32, q32, do32, lse, causal=True)
    (entry, args, strides), = fake_card
    assert entry == "flashattn_bwd_f32"
    assert args["q"] == base32.data_ptr() and \
        args["dout"] == do32.data_ptr()
    assert strides[12:15] == [40 * 64, 64, 0]


@pytest.mark.parametrize("operand", range(5))
def test_bwd_copies_a_bf16_operand_off_a_16_byte_boundary(fake_card,
                                                          operand):
    """q, k, v, o or dO starting 8 bytes past a 16-byte boundary: TMA
    cannot read it, so that operand alone is copied (to a contiguous
    tensor); the others go in where they lie."""
    lse = on_card(torch.zeros((1, 3, 40)))
    aligned = [torch.zeros((1, 40, 3, 64), dtype=torch.bfloat16)
               for _ in range(5)]
    ops = [on_card(x) for x in aligned]
    odd = torch.zeros((1, 40, 3, 128), dtype=torch.bfloat16)[..., 4:68]
    assert odd.data_ptr() % 16 == 8
    ops[operand] = on_card(odd)
    tfa.flash_attention_bwd(*ops, lse, causal=True)
    (entry, args, strides), = fake_card
    assert entry == "flashattn_bwd_bf16"
    for i, (name, x) in enumerate(zip(("q", "k", "v", "o", "dout"), ops)):
        assert (args[name] == x.data_ptr()) == (i != operand)
    assert strides[3 * operand:3 * operand + 3] == [40 * 3 * 64, 3 * 64, 64]
    assert args["stats"] != args["lse"]                    # stats scratch


def test_bwd_stats_scratch_holds_two_padded_planes(fake_card, monkeypatch):
    """The scratch handed to the kernel holds its two f32 planes of
    (B·H, S rounded up to 128): lse·log2 e and Dᵢ."""
    made = []
    real = torch.empty

    def empty(*shape, **kw):
        out = real(*shape, **kw)
        made.append((tuple(out.shape), out.dtype, out.data_ptr()))
        return out

    monkeypatch.setattr(torch, "empty", empty)
    q = on_card(torch.zeros((2, 129, 3, 64)))
    lse = on_card(torch.zeros((2, 3, 129)))
    tfa.flash_attention_bwd(q, q, q, q, q, lse, causal=True)
    (_, args, _), = fake_card
    stats = [m for m in made if m[2] == args["stats"]]
    assert stats == [((2, 6, 256), torch.float32, args["stats"])]


@pytest.mark.parametrize("what,change", [
    ("Sq == Skv", dict(k=(1, 30, 2, 64), v=(1, 30, 2, 64))),
    ("head dims", dict(q=(1, 40, 2, 32), k=(1, 40, 2, 32), v=(1, 40, 2, 32),
                       o=(1, 40, 2, 32), do=(1, 40, 2, 32))),
    ("one type", dict(dtype_do=torch.bfloat16)),
    ("f32 or bf16", dict(dtype=torch.float16)),
    ("lse must be", dict(lse=(1, 40, 2))),
    ("q's shape", dict(do=(1, 40, 3, 64)))])
def test_bwd_refuses_what_it_does_not_take(fake_card, what, change):
    shapes = dict(q=(1, 40, 2, 64), k=(1, 40, 2, 64), v=(1, 40, 2, 64),
                  o=(1, 40, 2, 64), do=(1, 40, 2, 64), lse=(1, 2, 40))
    shapes.update({n: x for n, x in change.items() if n in shapes})
    dtype = change.get("dtype", torch.float32)
    ts = {n: on_card(torch.zeros(x, dtype=torch.float32 if n == "lse" else
                                 change.get(f"dtype_{n}", dtype)))
          for n, x in shapes.items()}
    with pytest.raises(ValueError, match=what):
        tfa.flash_attention_bwd(ts["q"], ts["k"], ts["v"], ts["o"],
                                ts["do"], ts["lse"], causal=True)
    assert not fake_card


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_at_192_128_reaches_the_bwd_entry(fake_card, dtype):
    """A loss through ``flash_attention`` at deepseek-v3's (Dq, Dv) =
    (192, 128) on (fake) card tensors: K9, then K9-bwd's entry for the
    type with both head dims among its arguments, dv handed to it at Dv,
    and each gradient at its input's shape — no plain version."""
    n0, b0 = tfa.launches["flashattn"], tfa.launches["flashattn_bwd"]
    q, k = (on_card(torch.zeros((2, 40, 3, 192), dtype=dtype))
            .requires_grad_() for _ in range(2))
    v = on_card(torch.zeros((2, 40, 3, 128), dtype=dtype)).requires_grad_()
    tfa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert [c[0] for c in fake_card] == [tfa._ENTRY[dtype],
                                         tfa._BWD_ENTRY[dtype]]
    (_, fwd, _), (_, bwd, strides) = fake_card
    assert [bwd[n] for n in BWD_DIMS] == [2, 3, 40, 192, 128]
    assert bwd["lse"] == fwd["lse"]
    assert bwd["scale"] == pytest.approx(192 ** -0.5)
    assert strides[15:] == [40 * 3 * 192, 3 * 192, 192] * 2 + \
        [40 * 3 * 128, 3 * 128, 128]                      # dq, dk, dv
    assert [tuple(x.grad.shape) for x in (q, k, v)] == \
        [(2, 40, 3, 192)] * 2 + [(2, 40, 3, 128)]
    assert tfa.launches["flashattn"] == n0 + 1
    assert tfa.launches["flashattn_bwd"] == b0 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dq,Dv", tfa.HEAD_DIM_PAIRS)
def test_bwd_head_dim_pairs_reach_the_entry(fake_card, Dq, Dv, dtype):
    """Each of K9-bwd's (Dq, Dv) instances: the entry gets both dims;
    dq and dk are (B, S, H, Dq), dv (B, S, H, Dv), contiguous; o and dO
    are read at v's head dim."""
    q, k = (on_card(torch.zeros((1, 40, 2, Dq), dtype=dtype))
            for _ in range(2))
    v, o, do = (on_card(torch.zeros((1, 40, 2, Dv), dtype=dtype))
                for _ in range(3))
    lse = on_card(torch.zeros((1, 2, 40)))
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    (entry, args, strides), = fake_card
    assert entry == tfa._BWD_ENTRY[dtype]
    assert [args[n] for n in BWD_DIMS] == [1, 2, 40, Dq, Dv]
    assert args["causal"] == 0
    assert [tuple(x.shape) for x in (dq, dk, dv)] == \
        [(1, 40, 2, Dq)] * 2 + [(1, 40, 2, Dv)]
    assert all(x.dtype == dtype for x in (dq, dk, dv))
    assert [args[n] for n in ("dq", "dk", "dv")] == \
        [x.data_ptr() for x in (dq, dk, dv)]
    assert strides[9:15] == [40 * 2 * Dv, 2 * Dv, Dv] * 2       # o, dO
    assert strides[15:] == [40 * 2 * Dq, 2 * Dq, Dq] * 2 + \
        [40 * 2 * Dv, 2 * Dv, Dv]


@pytest.mark.parametrize("Dq,Dv", [(192, 192), (128, 64), (96, 96),
                                   (128, 192), (64, 128)])
def test_bwd_refuses_other_head_dim_pairs(fake_card, Dq, Dv):
    q = on_card(torch.zeros((1, 8, 2, Dq)))
    v = on_card(torch.zeros((1, 8, 2, Dv)))
    lse = on_card(torch.zeros((1, 2, 8)))
    with pytest.raises(ValueError, match=r"head dims \(Dq, Dv\) in"):
        tfa.flash_attention_bwd(q, q, v, v, v, lse, causal=True)
    assert not fake_card


def test_training_refuses_unequal_lengths_before_any_launch(fake_card):
    q = on_card(torch.zeros((1, 40, 2, 64))).requires_grad_()
    kv = on_card(torch.zeros((1, 50, 2, 64))).requires_grad_()
    with pytest.raises(ValueError, match="Sq == Skv"):
        tfa.flash_attention(q, kv, kv, causal=False)
    assert not fake_card


def test_bwd_on_the_cpu_launches_nothing():
    b0 = tfa.launches["flashattn_bwd"]
    q = torch.zeros((1, 64, 1, 16), requires_grad=True)
    tlayers.causal_attention(q, q, q, flash_block=16).sum().backward()
    assert q.grad is not None and tfa.launches["flashattn_bwd"] == b0


# -- the bf16 kernel's P·V: P = P_hi + P_lo, two bf16 tensor-core passes ----------------

ONE_ROUNDING = 2.0 ** -8          # one rounding to bf16, relative
F32_TOL = 2e-5                    # the reference's f32 tolerance
SPLIT_BOUND = 2.0 ** -17          # |P - P_hi - P_lo| / |P|: half an ulp of
#                                   the residual, 8 bits after the 8 of P_hi
KERNEL_BK = 128                   # the bf16 kernel's KV tile


def _split_attention(q, k, v, causal, terms):
    """The bf16 kernel's arithmetic in f32 on the CPU: per KV tile of
    ``KERNEL_BK`` rows the reference's online softmax, with P·V taken as
    Σ_t bf16-term_t(P)·V, each product of bf16 values exact in f32 and
    accumulated in f32 (``terms`` = 2: P_hi + P_lo; 1: P_hi alone, P
    rounded once to bf16).  Returns the output rounded to bf16 and the
    largest |P - Σ terms| / |P| over the cells with P > 0."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qf = q.float() / np.sqrt(D)
    m = torch.full((B, Sq, H), -1e30)
    l = torch.zeros((B, Sq, H))
    acc = torch.zeros((B, Sq, H, D))
    worst = 0.0
    rows = torch.arange(Sq)[:, None]
    for start in range(0, Skv, KERNEL_BK):
        kb = k[:, start:start + KERNEL_BK].float()
        vb = v[:, start:start + KERNEL_BK].float()
        cols = torch.arange(start, start + kb.shape[1])[None, :]
        mask = (rows >= cols if causal else torch.ones_like(rows >= cols))
        mask = mask[None, :, None, :]
        s = torch.where(mask, torch.einsum("bqhd,bthd->bqht", qf, kb), -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]) * mask
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        parts, rest = [], p
        for _ in range(terms):
            parts.append(rest.to(torch.bfloat16).float())
            rest = rest - parts[-1]
        on = p > 0
        worst = max(worst, ((p - sum(parts)).abs()[on] / p[on]).max().item())
        acc = acc * alpha[..., None]
        for part in parts:
            acc = acc + torch.einsum("bqht,bthd->bqhd", part, vb)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-20)[..., None]).to(torch.bfloat16)
    return out, worst


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 512, 4, 128), (1, 300, 3, 64)])
def test_two_term_split_keeps_p_to_f32_grade(shape, causal):
    """What the bf16 kernel is built to: P_hi + P_lo within 2^-17·|P| of
    the f32 P in every cell (and not within 2^-18: the bound is tight), the
    output of the two bf16 passes within one bf16 rounding of the f32 plain
    version in every cell — the check ``chip_smoke.py`` holds the kernel
    to — and P_hi alone (P rounded to bf16 once) over it in some cell."""
    (q, k, v), _ = _qkv(sum(shape) + causal, shape, "bf16")
    exact = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=causal)
    bound = (ONE_ROUNDING + F32_TOL) * exact.abs() + F32_TOL
    two, worst = _split_attention(q, k, v, causal, terms=2)
    assert 2.0 ** -18 < worst <= SPLIT_BOUND
    assert int(((two.float() - exact).abs() > bound).sum()) == 0
    one, _ = _split_attention(q, k, v, causal, terms=1)
    assert int(((one.float() - exact).abs() > bound).sum()) > 0


@pytest.mark.parametrize("what,make", [
    ("start off a 16-byte boundary",
     lambda: torch.zeros((1, 40, 3, 128), dtype=torch.bfloat16)[..., 4:68]),
    ("head stride of 136 bytes",
     lambda: torch.zeros((1, 40, 3, 68), dtype=torch.bfloat16)[..., :64]),
    ("sequence stride of 264 bytes",
     lambda: torch.zeros(40 * 132, dtype=torch.bfloat16).as_strided(
         (1, 40, 2, 64), (40 * 132, 132, 64, 1))),
    ("heads broadcast (stride 0)",
     lambda: torch.zeros((1, 40, 1, 64), dtype=torch.bfloat16).expand(
         1, 40, 4, 64))])
def test_bf16_views_tma_cannot_read_are_copied(fake_card, what, make):
    """The bf16 kernel loads q, k, v with TMA, which needs a 16-byte
    aligned start and nonzero 16-byte multiples for strides: a view that
    fails either is copied to a contiguous tensor, then launched (once,
    never the plain version)."""
    n0 = tfa.launches["flashattn"]
    x = make()
    q = on_card(x)
    tfa.flash_attention(q, q, q, causal=True)
    assert tfa.launches["flashattn"] == n0 + 1
    (entry, args, strides), = fake_card
    B, S, H, D = x.shape
    contiguous = [S * H * D, H * D, D]
    assert entry == "flashattn_bf16"
    assert all(args[n] != x.data_ptr() for n in ("q", "k", "v"))
    assert strides[:9] == contiguous * 3


def test_f32_views_are_read_in_place(fake_card):
    """The f32 kernel reads by strides without TMA: an odd start and odd
    strides are read where they lie."""
    x = torch.zeros((1, 40, 3, 67))[..., 1:65]
    q = on_card(x)
    tfa.flash_attention(q, q, q, causal=False)
    (entry, args, strides), = fake_card
    assert entry == "flashattn_f32" and args["q"] == x.data_ptr()
    assert strides[:3] == [40 * 3 * 67, 3 * 67, 67]
