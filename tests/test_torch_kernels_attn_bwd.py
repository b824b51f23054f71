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

Then the bf16 kernels' f32 sums on a model of tensor cores whose f32
sums round toward zero: every k-step of 16 products is added to its
accumulator and the sum truncated (``_rz_sum``).  K9 sums S in one
accumulator over its k-steps and writes lse = m·ln 2 + log l; K9-bwd
recomputes P = exp2(S·(scale·log2 e) − lse·log2 e).  The parent design
took both conversions of lse in f32 and summed every tile's register-A
products in one running accumulator; this design takes the conversions
in f64, rounded once, and sums each tile's products in a fresh
accumulator added in f32.  Held, by the mean relative bias
Σ(got − f64)·f64 / Σ f64² of the f32 sums before the output's rounding,
to the plain backward in f64 with lse taken in f64 (the forward and the
backward together):
  * at small scores (qwen3-4b's, under qk-norm) the running accumulator
    is low in every gradient, and this design keeps each under 1e-5;
  * at deepseek-v3's (192, 128) with scores in the thousands, K9's lse
    is low by the truncated S, so against f64 on that lse every design
    looks low by over 1e-4; a backward whose S is more exact than K9's
    (fresh sums per k-step) misses K9's softmax and is high by over 1e-4;
    the f32 log2 e puts the parent's dV high, and this design's is
    within 1e-5.  dQ and dK carry the noise of each row's f32 lse here
    (4096 rows); the card's 524 288 rows average it.
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


# -- the bf16 kernels' f32 sums, with truncating tensor cores -------------------

LN2 = 0.6931471805599453


def _rz(x64):
    """x (f64, in f32's normal range or 0) rounded to f32 toward zero: its
    mantissa cut to f32's 23 bits, then converted exactly."""
    return (x64.view(torch.int64) & -(1 << 29)).view(torch.float64).float()


def _rz_sum(partials, fresh_every):
    """The k-step partial products (exact, f64), in the kernel's order,
    each added to its accumulator and truncated: ``fresh_every`` k-steps a
    fresh accumulator, added to the sum in f32; None: one accumulator."""
    acc = torch.zeros(partials[0].shape, dtype=torch.float32)
    g = len(partials) if fresh_every is None else fresh_every
    for i in range(0, len(partials), g):
        part = torch.zeros_like(acc)
        for p in partials[i:i + g]:
            part = _rz(part.double() + p)
        acc = part if fresh_every is None else acc + part
    return acc


def _score_steps(a, b, eq, n):
    """A product over its last dim n, as 16-column k-steps."""
    return [torch.einsum(eq, a[..., k0:k0 + 16].double(),
                         b[..., k0:k0 + 16].double())
            for k0 in range(0, n, 16)]


def _tile_steps(terms, z, eq, n, dim):
    """A register-A product over the streamed rows (dim ``dim`` of each
    term, dim 1 of z): 64-row tiles, each term's 16-row k-steps in turn."""
    out = []
    for t0 in range(0, n, 64):
        for t in terms:
            for k0 in range(t0, min(t0 + 64, n), 16):
                w = min(16, n - k0)
                out.append(torch.einsum(eq, t.narrow(dim, k0, w).double(),
                                        z.narrow(1, k0, w).double()))
    return out


def _f32(x64):
    return x64.float()


def _k9_lse(s, scale_log2, f64: bool):
    """K9 bf16's row statistic from its f32 S, causal: m = max of
    S·(scale·log2 e) (log2 units), l = Σ exp2(S·(scale·log2 e) − m), and
    lse = m·ln 2 + log l, in f64 (``f64``) or with the f32 ln 2."""
    S = s.shape[-1]
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    t = _f32(s.double() * float(scale_log2))
    m = torch.where(mask, t, -torch.inf).max(-1).values
    p = torch.exp2(_f32(s.double() * float(scale_log2)
                        - m.double()[..., None]))
    l = torch.where(mask, p, 0.0).sum(-1)
    if f64:
        return _f32(m.double() * LN2 + torch.log(l.double()))
    return _f32(m.double() * float(np.float32(LN2)) + torch.log(l).double())


DESIGNS = {"parent": (False, False, False), "this": (True, True, False),
           "exact_s": (True, True, True)}
# (lse converted in f64, fresh tile sums, S summed fresh per k-step)


def _bf16_sums(q, k, v, o, do, design: str):
    """(dq, dk, dv) in f32 before the output's rounding, and K9's lse,
    for ``design`` (``DESIGNS``): "parent" the parent design, "this" this
    one (see the module docstring), "exact_s" this one with the backward's
    S summed in a fresh accumulator per k-step; causal."""
    f64_lse, fresh_tiles, fresh_s = DESIGNS[design]
    Dq, Dv, S = q.shape[3], v.shape[3], q.shape[1]
    scale = np.float32(1 / np.sqrt(Dq))
    scale_log2 = np.float32(scale * np.float32(LOG2E))
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    rows = [x.transpose(1, 2) for x in (qf, kf, vf, of, dof)]
    s = _rz_sum(_score_steps(rows[0], rows[1], "bhqd,bhtd->bhqt", Dq), None)
    lse = _k9_lse(s, scale_log2, f64_lse)
    if fresh_s:
        s = _rz_sum(_score_steps(rows[0], rows[1], "bhqd,bhtd->bhqt", Dq), 1)
    dp = _rz_sum(_score_steps(rows[4], rows[2], "bhqd,bhtd->bhqt", Dv), None)
    d = _rz_sum(_score_steps(rows[4], rows[3], "bhqd,bhqd->bhq", Dv),
                None)[..., None]
    lse2 = _f32(lse.double() * (LOG2E if f64_lse
                                else float(np.float32(LOG2E))))
    p = torch.exp2(_f32(s.double() * float(scale_log2)
                        - lse2.double()[..., None]))
    p = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (dp - d)
    tiles = 8 if fresh_tiles else None
    dv = _rz_sum(_tile_steps(_bf16_terms(p, True), dof,
                             "bhqt,bqhd->bthd", S, 2), tiles)
    dk = _rz_sum(_tile_steps(_bf16_terms(ds, True), qf,
                             "bhqt,bqhd->bthd", S, 2), tiles) * scale
    dq = _rz_sum(_tile_steps(_bf16_terms(ds, True), kf,
                             "bhqt,bthd->bqhd", S, 3), tiles) * scale
    return (dq, dk, dv), lse


def _bias(got, want):
    return np.array([float(((g.double() - w) * w).sum() / (w * w).sum())
                     for g, w in zip(got, want)])


def _sum_biases(D, S, H, sigma, designs):
    """Per design, each gradient's (dq, dk, dv) mean relative bias against
    the plain backward in f64 with lse taken in f64 ("chain") and on K9's
    lse ("kernel_lse"), and K9's lse less the f64 one, averaged
    ("lse_low"); seeded bf16 inputs, q and k of std ``sigma``, causal."""
    Dq, Dv = D
    rng = np.random.default_rng(Dq + S + H)
    q, k = (torch.from_numpy(rng.normal(scale=sigma, size=(1, S, H, Dq))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    v, do = (torch.from_numpy(rng.normal(size=(1, S, H, Dv)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    o = tfa.flash_attention_plain(q, k, v, causal=True)
    wide = [x.double() for x in (q, k, v, o, do)]
    s = torch.einsum("bqhd,bthd->bhqt", wide[0], wide[1]) / np.sqrt(Dq)
    lse64 = torch.logsumexp(s.masked_fill(
        ~torch.ones(S, S, dtype=torch.bool).tril(), -torch.inf), -1)
    chain = tfa.flash_attention_bwd_plain(*wide, lse64, causal=True)
    out = {}
    for design in designs:
        got, lse = _bf16_sums(q, k, v, o, do, design)
        out[design] = {
            "chain": _bias(got, chain),
            "kernel_lse": _bias(got, tfa.flash_attention_bwd_plain(
                *wide, lse, causal=True)),
            "lse_low": float((lse.double() - lse64).mean())}
    return out


@pytest.fixture
def one_thread():
    """The models' many small ops, on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rz_sum_truncates_toward_zero():
    x = torch.tensor([1.0, -1.0, 3.0]).double()
    tiny = torch.tensor([2.0 ** -30, -2.0 ** -30, 2.0 ** -30]).double()
    assert _rz_sum([x, tiny], None).tolist() == [1.0, -1.0, 3.0]
    assert _rz_sum([x, -tiny], None).tolist() == [
        1.0 - 2.0 ** -24, -1.0 + 2.0 ** -24, 3.0 - 2.0 ** -22]
    # fresh accumulators: each truncated alone, then added to nearest
    assert _rz_sum([x, -tiny], 1).tolist() == [1.0, -1.0, 3.0]


def test_fresh_tile_sums_lift_the_running_accumulators_bias(one_thread):
    """qwen3-4b's (128, 128) at small scores, 512 keys (8 tiles)."""
    b = _sum_biases((128, 128), 512, 1, 1.0, ("parent", "this"))
    parent, this = b["parent"]["chain"], b["this"]["chain"]
    assert (parent < 0).all(), b
    assert np.abs(this).max() <= np.abs(parent).max() / 2, b
    assert (np.abs(this) < 1e-5).all(), b


def test_at_scores_in_the_thousands_p_takes_k9s_own_sums(one_thread):
    """deepseek-v3's (192, 128), 16 heads of 256 keys, scores near 4000."""
    b = _sum_biases((192, 128), 256, 16, 30.0,
                    ("parent", "this", "exact_s"))
    assert all(x["lse_low"] < -1e-4 for x in b.values()), b
    assert all((b[x]["kernel_lse"] < -1e-4).all()
               for x in ("parent", "this")), b
    assert (b["exact_s"]["chain"] > 1e-4).all(), b
    assert b["parent"]["chain"][2] > 1e-5, b
    assert abs(b["this"]["chain"][2]) < 1e-5, b
