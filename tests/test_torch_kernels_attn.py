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


@pytest.fixture
def fake_card(monkeypatch):
    """Stand-ins for the card: the library records its launches."""
    calls = []

    class FakeLib:
        def __getattr__(self, entry):
            def launch(*args):
                strides = (ctypes.c_longlong * 12).from_address(args[9])
                calls.append((entry, args, list(strides)))
                return 0
            return launch

    monkeypatch.setattr(tfa, "_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: pytest.fail("plain"))
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
    assert fake_card[0][1][4:9] == (2, 3, 40, 40, 128)    # B, H, Sq, Skv, D
    assert fake_card[0][1][11] == 1 and fake_card[1][1][11] == 0  # causal
    assert fake_card[1][1][0] == base.data_ptr()
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
    with pytest.raises(ValueError, match="Dq == Dv"):
        tfa.flash_attention(q, q, on_card(torch.zeros((1, 8, 2, 128))),
                            causal=True)
    assert not fake_card


def test_cpu_tensors_launch_nothing():
    n0 = tfa.launches["flashattn"]
    q = torch.zeros((1, 64, 1, 16))
    tops.flash_attention(q, q, q, bq=32, bk=32)
    tlayers.causal_attention(q, q, q, flash_block=16)
    assert tfa.launches["flashattn"] == n0
