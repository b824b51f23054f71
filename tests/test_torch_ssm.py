"""The Mamba2 mixer of the port (``repro_torch.models.ssm``) and the
models built on it, reduced mamba2-1.3b and jamba-1.5-large-398b, vs the
reference package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
models run the reference's weights carried across with
``interop.params_from_numpy``, in f32.  Tolerances, relative and absolute
unless said otherwise:

* ``ssd_chunked`` and the mixer's pieces: ``SSD_TOL`` = 1e-5 against the
  reference (the largest difference seen is 1e-6 of the output's largest
  entry), 1e-4 against a step-by-step recurrence in f64 numpy (the
  counterpart of ``tests/test_models.py::test_ssd_chunked_matches_recurrent``,
  which allows 2e-4); the mixer in each mode and its gradients (``jax.vjp``
  against autograd) at weights of std 1/sqrt(fan_in): ``SSD_TOL``.
* Whole models, ``TOL`` = 1e-4 as in ``tests/test_torch_models.py``;
  cache leaves (an SSM state reaches some hundreds) and gradients within
  ``TOL`` of the leaf's largest entry.  Reduced jamba is held to
  ``JAMBA_TOL`` = 1e-3 of each quantity's largest entry and its gradients
  to ``JAMBA_GRAD_TOL`` = 5e-3 of the leaf's largest entry, because it is
  ill-conditioned in f32: each of its eight slots is stacked over one
  layer, so the reference's initialiser (std 1/sqrt(fan_in), fan_in the
  stacked layer axis) draws its weights with std 1, the residual stream
  reaches some thousands, and dt (softplus of x @ wdt) reaches about 25.
  Two f32 evaluations of the same ops then part by up to 1.3e-4 of the
  largest logit and 2.6e-3 of a gradient leaf's largest entry — the port
  and the reference do, and both packages run with f64 parameters and
  activations part as much, since the SSD, the norms and the softmaxes
  stay f32 in both.  The mixer alone at jamba's widths (8 groups) is held
  to ``SSD_TOL`` at weights of std 1/sqrt(fan_in).
* Decode against the full forward (the port alone): 2e-3, as the
  reference's own test.
* The batcher: logits of every prefill and decode step within ``TOL``,
  then the tokens exactly.

The reference sums the MoE aux of the last slot of each period only
(its loop over a period's slots overwrites ``aux``); the port copies that
(``transformer._run_segment``), and ``test_aux_counts_the_last_slot_of_each_period``
pins it on jamba, whose period has MoE slots 1, 3, 5 and 7.

A prompt shorter than ``d_conv - 1`` (1 or 2 tokens) leaves a conv cache
of fewer rows, in both packages (Python's slice from a negative start).
A decode step handed that cache raises in both; the batcher's splice
broadcasts the rows into the slot's cache, in both, and the two serve the
same tokens (``test_short_prompts_*``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.models import params as rparams
from repro.models import ssm as rssm
from repro.models import transformer as rtf
from repro.serve import engine as rengine
from repro.train import optimizer as ropt
from repro.train import train_step as rts

from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train import tree

from test_torch_serving import _TIMING, _cli_lines, _same_run, _serve
from test_torch_train import OPT, _batch, _ref_grads

SSD_TOL = 1e-5
RECURRENCE_TOL = 1e-4
TOL = 1e-4
JAMBA_TOL = 1e-3
JAMBA_GRAD_TOL = 5e-3
FORWARD_TOL = 2e-3
ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
KEY = jax.random.PRNGKey(0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=SSD_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_to_max(got, want, tol):
    """Within ``tol`` of ``want``'s largest entry, elementwise."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _model_tol(arch):
    return JAMBA_TOL if arch.startswith("jamba") else TOL


def _close_logits(arch, got, want):
    if arch.startswith("jamba"):
        return _close_to_max(got, want, JAMBA_TOL)
    return _close(got, want, TOL)


# -- the scan and its pieces -----------------------------------------------------------

def _scan_inputs(L, seed=0, Bb=2, H=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bb, L, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(Bb, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(Bb, L, H, N)).astype(np.float32),
            rng.normal(size=(Bb, L, H, N)).astype(np.float32),
            rng.normal(size=(Bb, H, P, N)).astype(np.float32))


def _recurrence(xs, dt, A, B_, C_, s0):
    """The SSM step by step in f64 numpy: (y, final state)."""
    Bb, _, H, P = xs.shape
    state = (np.zeros((Bb, H, P, B_.shape[-1])) if s0 is None
             else s0.astype(np.float64))
    ys = []
    for t in range(xs.shape[1]):
        dA = np.exp(dt[:, t].astype(np.float64) * A[None, :])
        state = state * dA[..., None, None] + np.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], xs[:, t], B_[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", state, C_[:, t]))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "init-state"])
@pytest.mark.parametrize("L", [32, 37])
def test_ssd_chunked_matches_reference_and_recurrence(L, with_state):
    """L = 32 is four chunks of 8; L = 37 is padded with dt = 0 steps to
    40.  Output and final state against the reference's ``ssd_chunked``
    and against the recurrence."""
    xs, dt, A, B_, C_, s0 = _scan_inputs(L)
    s0 = s0 if with_state else None
    want_y, want_s = rssm.ssd_chunked(
        *map(jnp.asarray, (xs, dt, A, B_, C_)), chunk=8,
        init_state=None if s0 is None else jnp.asarray(s0))
    got_y, got_s = tssm.ssd_chunked(
        *map(torch.from_numpy, (xs, dt, A, B_, C_)), chunk=8,
        init_state=None if s0 is None else torch.from_numpy(s0))
    assert got_y.shape == (2, L, 3, 4) and got_s.shape == (2, 3, 4, 8)
    assert got_y.dtype == got_s.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_s, want_s)
    rec_y, rec_s = _recurrence(xs, dt, A, B_, C_, s0)
    np.testing.assert_allclose(_np(got_y), rec_y, rtol=RECURRENCE_TOL,
                               atol=RECURRENCE_TOL)
    np.testing.assert_allclose(_np(got_s), rec_s, rtol=RECURRENCE_TOL,
                               atol=RECURRENCE_TOL)


def test_ssd_chunked_returns_the_inputs_dtype():
    xs, dt, A, B_, C_, _ = _scan_inputs(16)
    T = torch.from_numpy
    y, s = tssm.ssd_chunked(T(xs).bfloat16(), T(dt), T(A), T(B_).bfloat16(),
                            T(C_).bfloat16(), chunk=8)
    assert y.dtype == s.dtype == torch.bfloat16
    want_y, want_s = rssm.ssd_chunked(
        jnp.asarray(xs, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(B_, jnp.bfloat16), jnp.asarray(C_, jnp.bfloat16),
        chunk=8)
    assert want_y.dtype == jnp.bfloat16
    # the products run in f32 from the same bf16 inputs: one bf16 rounding
    np.testing.assert_allclose(_np(y), _np(want_y), rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(_np(want_y)).max())


def test_segsum_conv_and_groups_equal_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 6)).astype(np.float32)
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(rssm._segsum(jnp.asarray(x)))
    assert np.array_equal(got == tssm.NEG_INF, want == rssm.NEG_INF)
    _close(got, want)
    xc = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    T = torch.from_numpy
    _close(tssm._causal_conv(T(xc), T(w), T(b)),
           rssm._causal_conv(jnp.asarray(xc), jnp.asarray(w), jnp.asarray(b)))
    g = rng.normal(size=(2, 7, 2, 3)).astype(np.float32)
    assert np.array_equal(tssm._expand_groups(T(g), 6).numpy(),
                          np.asarray(rssm._expand_groups(jnp.asarray(g), 6)))


# -- the mixer -------------------------------------------------------------------------

def _pair(arch, **overrides):
    return (rbase.reduced_config(rreg.get_config(arch), **overrides),
            tbase.reduced_config(treg.get_config(arch), **overrides))


def _mixer_params(cfg, seed=0):
    """The mixer's leaves drawn with numpy: std 1/sqrt(fan_in) for
    matrices, the reference's a_log and dt_bias ranges, random norm,
    d_skip and conv bias."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in rssm.ssm_specs(cfg).items():
        if s.init == "a_log":
            v = np.log(rng.uniform(1, 16, s.shape))
        elif s.init == "dt_bias":
            v = np.log(np.expm1(rng.uniform(1e-3, 1e-1, s.shape)))
        elif len(s.shape) > 1:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        else:
            v = rng.normal(size=s.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_specs_equal_reference(arch):
    rcfg, tcfg = _pair(arch)
    want, got = rssm.ssm_specs(rcfg), tssm.ssm_specs(tcfg)
    assert list(got) == list(want)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_matches_reference_in_every_mode(arch):
    """Train and prefill on S = 37 (padded to three chunks of 16), then a
    decode step on random caches: outputs, the prefill's conv rows and
    state, and the decode step's caches, written in place."""
    rcfg, tcfg = _pair(arch)
    p = _mixer_params(rcfg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 37, rcfg.d_model)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for mode in ("train", "prefill"):
        want, wc = rssm.mamba_mixer(rp, jnp.asarray(x), rcfg, mode=mode)
        got, gc = tssm.mamba_mixer(tp, torch.from_numpy(x), tcfg, mode=mode)
        _close(got, want)
        assert sorted(gc) == sorted(wc)
        for k in wc:
            assert tuple(gc[k].shape) == wc[k].shape
            _close(gc[k], wc[k])
    s = rcfg.ssm
    conv = rng.normal(size=(2, s.d_conv - 1, rcfg.d_inner
                            + 2 * s.n_groups * s.d_state)).astype(np.float32)
    state = rng.normal(size=(2, rcfg.ssm_heads, s.head_dim,
                             s.d_state)).astype(np.float32)
    xd = x[:, :1]
    want, wc = rssm.mamba_mixer(rp, jnp.asarray(xd), rcfg, mode="decode",
                                cache={"conv": jnp.asarray(conv),
                                       "ssm": jnp.asarray(state)})
    cache = {"conv": torch.from_numpy(conv.copy()),
             "ssm": torch.from_numpy(state.copy())}
    held = dict(cache)
    got, gc = tssm.mamba_mixer(tp, torch.from_numpy(xd), tcfg, mode="decode",
                               cache=cache)
    assert gc is cache and all(gc[k] is held[k] for k in held)
    _close(got, want)
    _close(gc["conv"], wc["conv"])
    _close(gc["ssm"], wc["ssm"])


@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_gradients_match_reference(arch):
    """``jax.vjp`` of the reference's training mixer against autograd of
    the port's, for every leaf and the input (S = 37, padded)."""
    rcfg, tcfg = _pair(arch)
    p = _mixer_params(rcfg, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 37, rcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p_, x_: rssm.mamba_mixer(p_, x_, rcfg,
                                                     mode="train")[0],
                     {k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dy))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, _ = tssm.mamba_mixer(tp, tx, tcfg, mode="train")
    grads = torch.autograd.grad(y, [*tp.values(), tx], torch.from_numpy(dy))
    got = dict(zip([*tp, "x"], grads))
    for k, want in [*want_p.items(), ("x", want_x)]:
        _close_to_max(got[k], want, SSD_TOL)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompts_leave_short_conv_caches_in_both(S):
    """A prefill of S < d_conv - 1 tokens keeps the S rows there are (both
    slice from S - 3, a negative start), and a decode step on that cache
    raises in both packages."""
    rcfg, tcfg = _pair("mamba2-1.3b")
    p = _mixer_params(rcfg)
    x = np.random.default_rng(5).normal(
        size=(2, S + 1, rcfg.d_model)).astype(np.float32)
    _, wc = rssm.mamba_mixer({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x[:, :S]), rcfg, mode="prefill")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, gc = tssm.mamba_mixer(tp, torch.from_numpy(x[:, :S]), tcfg,
                             mode="prefill")
    assert wc["conv"].shape[1] == tuple(gc["conv"].shape)[1] == 1
    _close(gc["conv"], wc["conv"])
    with pytest.raises(ValueError, match="label 'k'"):
        rssm.mamba_mixer({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x[:, S:]), rcfg, mode="decode", cache=wc)
    with pytest.raises(RuntimeError, match="einsum"):
        tssm.mamba_mixer(tp, torch.from_numpy(x[:, S:]), tcfg, mode="decode",
                         cache=gc)


# -- whole models ----------------------------------------------------------------------

_WEIGHTS = {}


def _weights(arch):
    """The reference's parameters for reduced ``arch`` (remat off) and the
    same weights as the port's tensors, built once per module."""
    if arch not in _WEIGHTS:
        rcfg, tcfg = _pair(arch, remat=False)
        params = rtf.Model(rcfg).init(KEY)
        _WEIGHTS[arch] = (rcfg, tcfg, params, interop.params_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), "cpu"))
    return _WEIGHTS[arch]


def _ids(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


_FORWARD = {}


def _reference_forward(arch, S):
    """The reference's train-mode logits and aux at S (once per module)."""
    key = (arch, S)
    if key not in _FORWARD:
        rcfg, _, rp, _ = _weights(arch)
        x = _ids(rcfg, S, (2, S))
        logits, _, aux = rtf.Model(rcfg)(rp, jnp.asarray(x), mode="train")
        _FORWARD[key] = (x, np.asarray(logits), float(aux))
    return _FORWARD[key]


@pytest.mark.parametrize("S", [23, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, S):
    """S = 23 is one SSD chunk of 16 and a padded one; S = 64 four chunks
    and, in jamba's attention slot, the flash path (block 32)."""
    _, tcfg, _, tp = _weights(arch)
    x, want, want_aux = _reference_forward(arch, S)
    got, caches, aux = ttf.Model(tcfg)(tp, torch.from_numpy(x), mode="train")
    assert caches is None and got.shape == (2, S, tcfg.vocab_size)
    _close_logits(arch, got, want)
    assert abs(float(aux) - want_aux) <= 1e-6 * max(1.0, abs(want_aux))
    assert (float(aux) > 0) == (tcfg.moe is not None)


@pytest.mark.parametrize("S", [23, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, S):
    """The last logits and every cache leaf: the 'M' slots' conv rows and
    state, jamba's 'A' slot's K and V."""
    rcfg, tcfg, rp, tp = _weights(arch)
    x = _ids(rcfg, 50 + S, (2, S))
    r_last, r_caches = rengine.make_prefill_step(rcfg)(rp, jnp.asarray(x))
    t_last, t_caches = tengine.make_prefill_step(tcfg)(tp, torch.from_numpy(x))
    _close_logits(arch, t_last, r_last)
    r_leaves, t_leaves = jax.tree.leaves(r_caches), tparams.leaves(t_caches)
    assert [tuple(t.shape) for t in t_leaves] == [c.shape for c in r_leaves]
    for got, want in zip(t_leaves, r_leaves):
        _close_to_max(got, want, _model_tol(arch))


def _grow(r_caches, T):
    """The reference's prefill caches with every T-long axis grown by
    one, as numpy and as the port's tensors."""
    grown = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 1) if d == T else (0, 0) for d in c.shape]),
        r_caches)
    port = [{s: {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
             for s, leaves in seg.items()}
            for seg in jax.tree.map(np.asarray, grown)]
    return grown, port


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """prefill(x[:23]) in the reference, then one decode step at position
    23 in both from those caches: logits and every cache leaf, the port's
    written in place."""
    rcfg, tcfg, rp, tp = _weights(arch)
    T = 23
    x = _ids(rcfg, 123, (2, T + 1))
    _, r_caches, _ = rtf.Model(rcfg)(rp, jnp.asarray(x[:, :T]),
                                     mode="prefill")
    r_caches, t_caches = _grow(r_caches, T)
    held = tparams.leaves(t_caches)
    pos = np.full((2,), T, np.int32)
    r_logits, r_new = rengine.make_decode_step(rcfg)(
        rp, r_caches, jnp.asarray(x[:, T:]), jnp.asarray(pos))
    t_logits, t_new = tengine.make_decode_step(tcfg)(
        tp, t_caches, torch.from_numpy(x[:, T:]), torch.from_numpy(pos))
    _close_logits(arch, t_logits, r_logits)
    new = tparams.leaves(t_new)
    assert all(a is b for a, b in zip(new, held))
    for got, want in zip(new, jax.tree.leaves(r_new)):
        _close_to_max(got, want, _model_tol(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The port alone, as ``tests/test_models.py`` holds the reference:
    prefill(x[:23]) + decode(x[23]) logits == forward(x[:24])[:, 23]."""
    _, tcfg, _, tp = _weights(arch)
    T = 23
    x = torch.from_numpy(_ids(tcfg, 223, (2, T + 1)))
    full, _, _ = ttf.Model(tcfg)(tp, x, mode="train")
    last, caches = tengine.make_prefill_step(tcfg)(tp, x[:, :T])
    _close_to_max(last, full[:, T - 1], FORWARD_TOL)
    grown = ttf.init_cache(tcfg, 2, T + 1, device="cpu")
    _, axes = ttf.cache_specs(tcfg, 2, T + 1)
    for one, dst, ax in zip(tparams.leaves(caches), tparams.leaves(grown),
                            tparams.leaves(axes)):
        if "kv_seq" in ax:
            dst.narrow(ax.index("kv_seq"), 0, T).copy_(one)
        else:
            dst.copy_(one)
    logits, _ = tengine.make_decode_step(tcfg)(
        tp, grown, x[:, T:T + 1], torch.full((2,), T))
    _close_to_max(logits, full[:, T], FORWARD_TOL)


def test_aux_counts_the_last_slot_of_each_period():
    """jamba's period of eight has MoE slots 1, 3, 5 and 7; the aux both
    packages report is slot 7's alone (the reference's scan carry adds
    the ``aux`` its slot loop left), not the four slots' sum."""
    rcfg, tcfg, rp, tp = _weights("jamba-1.5-large-398b")
    x, _, want_aux = _reference_forward("jamba-1.5-large-398b", 23)
    seen = []
    real = ttf.moe_mod.moe_apply

    def recording(p, h, cfg):
        y, aux = real(p, h, cfg)
        seen.append(float(aux))
        return y, aux

    ttf.moe_mod.moe_apply = recording
    try:
        _, _, aux = ttf.Model(tcfg)(tp, torch.from_numpy(x), mode="train")
    finally:
        ttf.moe_mod.moe_apply = real
    assert len(seen) == 4 and abs(sum(seen) - seen[-1]) > 1.0
    assert float(aux) == pytest.approx(seen[-1], abs=0)
    assert abs(float(aux) - want_aux) <= 1e-6 * abs(want_aux)


# -- serving ---------------------------------------------------------------------------

def _serve_both(prompts, *, slots, capacity, max_new):
    """Both batchers on reduced mamba2-1.3b (``test_torch_serving``'s
    harness): every prefill's and decode step's logits, then the tokens;
    returns the port's batcher."""
    rcfg, tcfg, rp, tp = _weights("mamba2-1.3b")
    ref, port = _serve((rp, tp), prompts, slots=slots, capacity=capacity,
                       max_new=max_new, cfgs=(rcfg, tcfg))
    _same_run(ref, port)
    return port[0]


def test_batcher_serves_mamba2_like_the_reference():
    """Reduced mamba2-1.3b behind both batchers: two slots, prompts of
    5 to 40 tokens (one SSD chunk of 16 or several, padded), the 'M'
    caches spliced whole (they have no sequence axis) and reused."""
    prompts = [_ids(_weights("mamba2-1.3b")[1], 300 + i, (T,))
               for i, T in enumerate([5, 40, 16, 23, 9])]
    b = _serve_both(prompts, slots=2, capacity=64, max_new=6)
    assert len(b.finished) == 5
    assert all(len(r.generated) == 6 for r in b.finished)


def test_short_prompts_serve_the_reference_tokens():
    """Prompts of 1 and 2 tokens: both batchers broadcast the prefill's
    one conv row over the slot's d_conv - 1 rows and decode from there;
    logits and tokens equal."""
    cfg = _weights("mamba2-1.3b")[1]
    prompts = [_ids(cfg, 400 + T, (T,)) for T in (1, 2, 3)]
    b = _serve_both(prompts, slots=3, capacity=16, max_new=4)
    assert [len(r.prompt) for r in b.finished] == [1, 2, 3]


def test_serve_cli_serves_mamba2_like_the_reference(monkeypatch, capsys):
    """``launch.serve --arch mamba2-1.3b`` at its own flags (reduced)."""
    want, got, b = _cli_lines(monkeypatch, capsys, "mamba2-1.3b")
    assert len(got) == len(want) == 4
    assert [_TIMING.sub("", x) for x in got] == \
        [_TIMING.sub("", x) for x in want]
    assert b.cfg.family == "ssm" and b.device.type == "cpu"


# -- training --------------------------------------------------------------------------

_GRADS = {}


def _reference_grads(arch):
    """The reference's state, batch, gradient and one train step (f32,
    remat as configured), once per module."""
    if arch not in _GRADS:
        rcfg, tcfg = _pair(arch)
        opt_cfg = ropt.OptConfig(**OPT)
        state = rts.init_state(rcfg, opt_cfg, KEY)
        batch = _batch(rcfg)
        grads = _ref_grads(rcfg, state["params"], batch, 1)
        new, metrics = jax.jit(rts.make_train_step(rcfg, opt_cfg))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        _GRADS[arch] = dict(rcfg=rcfg, tcfg=tcfg, batch=batch, grads=grads,
                            host=jax.tree.map(np.asarray, state),
                            metrics={k: float(v) for k, v in metrics.items()},
                            new=jax.tree.map(np.asarray, new))
    return _GRADS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_and_step_match_reference(arch):
    """The port's gradient (``make_grad_fn``, remat on as in the config)
    against ``jax.value_and_grad`` of the reference's loss, leaf by leaf
    within ``TOL`` (jamba: ``JAMBA_GRAD_TOL``) of the leaf's largest
    entry; then one ``make_train_step`` from the same state: loss, ce and
    grad_norm within 1e-5 relative (jamba: ``JAMBA_TOL``)."""
    ref = _reference_grads(arch)
    tcfg = ref["tcfg"]
    state = interop.state_from_numpy(tcfg, topt.OptConfig(**OPT),
                                     ref["host"], "cpu")
    _, _, grads = tts.make_grad_fn(tcfg)(state["params"], ref["batch"])
    want, got = jax.tree.leaves(ref["grads"]), tree.leaves(grads)
    assert len(want) == len(got)
    tol = JAMBA_GRAD_TOL if arch.startswith("jamba") else TOL
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=tol * np.abs(w).max())
    _, metrics = tts.make_train_step(tcfg, topt.OptConfig(**OPT))(
        state, ref["batch"])
    scalar_tol = JAMBA_TOL if arch.startswith("jamba") else 1e-5
    for k in ("loss", "ce", "lr", "grad_norm"):
        want_k = ref["metrics"][k]
        assert abs(float(metrics[k]) - want_k) <= scalar_tol * abs(want_k), \
            (k, float(metrics[k]), want_k)


def test_param_counts_of_the_new_leaves():
    """``a_log``, ``dt_bias``, ``d_skip``, ``conv_w`` and ``conv_b`` carry
    across with the reference's shapes, and the port's ``init`` draws
    a_log in log [1, 16] and dt_bias as softplus^-1 of [1e-3, 1e-1]."""
    rcfg, tcfg, rp, tp = _weights("mamba2-1.3b")
    mixer = tp["segments"][0]["slot0"]["mixer"]
    for k in ("a_log", "dt_bias", "d_skip", "conv_w", "conv_b"):
        assert np.array_equal(_np(mixer[k]), np.asarray(
            rp["segments"][0]["slot0"]["mixer"][k]))
    assert rparams.count_params(rtf.param_specs(rcfg)) == \
        tparams.count_params(ttf.param_specs(tcfg)) == tcfg.param_count()
    drawn = ttf.Model(tcfg).init(0, device="cpu")["segments"][0]["slot0"][
        "mixer"]
    assert float(drawn["a_log"].min()) >= 0.0
    assert float(drawn["a_log"].max()) <= np.log(16.0) + 1e-6
    dt = torch.nn.functional.softplus(drawn["dt_bias"])
    assert 1e-3 - 1e-7 <= float(dt.min()) and float(dt.max()) <= 1e-1 + 1e-6
    assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(rcfg.ssm)
