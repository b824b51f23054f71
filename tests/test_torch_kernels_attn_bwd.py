"""The arithmetic of K9-bwd's two kernel designs, emulated on the CPU.

The CUDA kernels of ``csrc/flashattn_bwd.cu`` run only on the card, where
``chip_smoke.py`` holds them to the plain version.  Here their rounding is
emulated in PyTorch (test code only) and held to
``flash_attention_bwd_plain`` in f32 under the smoke's own bounds, so that
a design that cannot meet them shows here first:

- bf16 (``wgmma``): S and dP from the bf16 inputs in f32, P and dS split
  into bf16 hi + lo terms, each register-A product taken once per term and
  summed in f32, each output rounded once to bf16.  Bound per cell:
  2^-8·|w| + 1e-4·max|w| + 4 x the plain f32 version's own error against
  f64 (``FLASH_ONE_ROUNDING``, ``FLASH_BWD_TOL``, ``FLASH_BWD_FLOOR`` of
  ``chip_smoke.py``).
- f32 (split-TF32 ``mma.sync``): every operand split into TF32 hi + lo
  (the low 13 mantissa bits rounded to nearest, ties away, as
  ``cvt.rna.tf32.f32``), each product a_hi·b_hi + a_hi·b_lo + a_lo·b_hi in
  f32.  Bound: 1e-4·max|w| + 4 x the same floor.

Each at (Dq, Dv) = (64, 64), (128, 128) and deepseek-v3's (192, 128),
causal and full, S = 77 and 300.  Then what each split is for: without the
split of dS the bf16 emulation breaks its bound, and one TF32 pass without
the split breaks the f32 bound, in every case.  The kernels' tiles (64 or
32 streamed rows) change the order of the f32 sums only.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flashattn as tfa

ONE_ROUNDING = 2.0 ** -8          # one rounding to bf16, relative
BWD_TOL = 1e-4                    # relative to max|plain f32|
FLOOR = 4                         # times max|plain f32 - plain f64|
LOG2E = 1.4426950408889634
CASES = [(D, causal, S) for D in ((64, 64), (128, 128), (192, 128))
         for causal in (True, False) for S in (77, 300)]
IDS = [f"D{D[0]}{'' if D[0] == D[1] else f'-{D[1]}'}-"
       f"{'causal' if c else 'full'}-S{S}" for D, c, S in CASES]


def _inputs(D, causal, S, dtype):
    """q, k, v, dO from numpy (seeded by the case), rounded to ``dtype``,
    q and k at D = (Dq, Dv)'s Dq, v and dO at its Dv; o and lse from the
    plain forward, as K9 hands them to K9-bwd."""
    Dq, Dv = D
    rng = np.random.default_rng(Dq + (Dv != Dq) * Dv + 7 * S + causal)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, S, 2, d)).astype(
        np.float32)).to(dtype) for d in (Dq, Dq, Dv, Dv))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
    return q, k, v, o, do, lse


def _probabilities(s, lse, causal, scale):
    """P = exp2(S·scale·log2 e − lse·log2 e) in f32, 0 above the diagonal
    when causal: the kernels' form of exp(scale·S − lse)."""
    S = s.shape[-1]
    p = torch.exp2(s * np.float32(scale * LOG2E)
                   - (lse * np.float32(LOG2E))[..., None])
    if causal:
        p = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), p, 0.0)
    return p


def _bf16_terms(x, split: bool):
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _bf16_design(q, k, v, o, do, lse, causal, split_ds=True):
    """The bf16 kernels' rounding: exact products of bf16 values summed in
    f32; P (and dS unless ``split_ds`` is False) as two bf16 terms."""
    D = q.shape[3]
    scale = 1.0 / np.sqrt(D)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    p = _probabilities(torch.einsum("bqhd,bthd->bhqt", qf, kf), lse, causal,
                       scale)
    dp = torch.einsum("bqhd,bthd->bhqt", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dv = sum(torch.einsum("bhqt,bqhd->bthd", t, dof)
             for t in _bf16_terms(p, True))
    ds_terms = _bf16_terms(ds, split_ds)
    dk = sum(torch.einsum("bhqt,bqhd->bthd", t, qf) for t in ds_terms)
    dq = sum(torch.einsum("bhqt,bthd->bqhd", t, kf) for t in ds_terms)
    return tuple(x.to(torch.bfloat16) for x in (dq * np.float32(scale),
                                                dk * np.float32(scale), dv))


def _tf32(x):
    """x with its low 13 mantissa bits rounded to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(eq, a, b, passes: int):
    """einsum in f32 of TF32-split operands: three passes a_lo·b_hi +
    a_hi·b_lo + a_hi·b_hi, or one pass a_hi·b_hi."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _f32_design(q, k, v, o, do, lse, causal, passes=3):
    D = q.shape[3]
    scale = 1.0 / np.sqrt(D)
    p = _probabilities(_mm("bqhd,bthd->bhqt", q, k, passes), lse, causal,
                       scale)
    dp = _mm("bqhd,bthd->bhqt", do, v, passes)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dv = _mm("bhqt,bqhd->bthd", p, do, passes)
    dk = _mm("bhqt,bqhd->bthd", ds, q, passes) * np.float32(scale)
    dq = _mm("bhqt,bthd->bqhd", ds, k, passes) * np.float32(scale)
    return dq, dk, dv


def _cells_over(got, inputs, causal, rounding):
    """Cells of (dq, dk, dv) over the smoke's bound against the plain
    version in f32 on the kernels' inputs (bf16 widened), o and lse."""
    q, k, v, o, do, lse = inputs
    wide = [x.float() for x in (q, k, v, o, do)]
    exact = tfa.flash_attention_bwd_plain(*wide, lse, causal=causal)
    f64 = tfa.flash_attention_bwd_plain(*(x.double() for x in wide), lse,
                                        causal=causal)
    over = []
    for g, w, w64 in zip(got, exact, f64):
        floor = FLOOR * (w.double() - w64).abs().max().item()
        bound = rounding * w.abs() + BWD_TOL * w.abs().max() + floor
        over.append(int(((g.float() - w).abs() > bound).sum()))
    return over


@pytest.mark.parametrize("D,causal,S", CASES, ids=IDS)
def test_bf16_design_stays_within_one_rounding(D, causal, S):
    inputs = _inputs(D, causal, S, torch.bfloat16)
    got = _bf16_design(*inputs, causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert _cells_over(got, inputs, causal, ONE_ROUNDING) == [0, 0, 0]


@pytest.mark.parametrize("D,causal,S", CASES, ids=IDS)
def test_split_tf32_design_keeps_f32_grade(D, causal, S):
    inputs = _inputs(D, causal, S, torch.float32)
    got = _f32_design(*inputs, causal)
    assert _cells_over(got, inputs, causal, 0.0) == [0, 0, 0]


def test_bf16_design_needs_the_split_of_ds():
    """dS rounded once to bf16 inside the sums of dK and dQ: a second
    rounding beside the output's, over the bound in every case."""
    over = []
    for D, causal, S in CASES:
        inputs = _inputs(D, causal, S, torch.bfloat16)
        got = _bf16_design(*inputs, causal, split_ds=False)
        over.append(sum(_cells_over(got, inputs, causal, ONE_ROUNDING)))
    assert min(over) > 0, over


def test_f32_design_needs_the_split_of_its_operands():
    """One TF32 pass (operands rounded to 11 significant bits) misses the
    f32 bound in every case."""
    over = []
    for D, causal, S in CASES:
        inputs = _inputs(D, causal, S, torch.float32)
        got = _f32_design(*inputs, causal, passes=1)
        over.append(sum(_cells_over(got, inputs, causal, 0.0)))
    assert min(over) > 0, over


def test_tf32_rounds_the_low_mantissa_bits_to_nearest():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10),
                                 1.0 + 2.0 ** -10, 3.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - hi).abs() <= 2.0 ** -11 * y.abs()).all()
