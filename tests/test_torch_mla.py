"""Multi-head latent attention of the port (``models.mla``, deepseek-v3's
'A' slots) and reduced deepseek-v3-671b vs the reference package on the
CPU.

Inputs are made with numpy from a seed and handed to both packages.  Two
configs: ``reduced_config`` as it is (qk head dim 16 + 8, v head dim 16)
and the same with deepseek-v3's published head dims (``PUBLISHED_MLA``:
128 + 64 for q and k, 128 for v, the (Dq, Dv) = (192, 128) that K9 takes
on the card), at the reduced width (4 heads, d_model 64).  Prompts of 23
tokens take the dense branch of ``causal_attention``, 64 the flash branch
(``flash_block`` is 32).  Tolerances, relative and absolute:

* the layer and the plain flash attention: ``LAYER_TOL`` = 1e-5 (f32 sums
  in another order);
* the model's logits: ``TOL`` = 1e-4, as ``tests/test_torch_models.py``;
* decode against the full forward, the port alone: 2e-3, as the
  reference's own test;
* the decode step's latent attention in bf16: ``BF16_ACC_TOL`` = 1e-5 of
  the largest output against the reference's ``preferred_element_type``
  products (see ``test_decode_accumulates_in_f32``);
* the model cut to its dense prefix, which the reference cannot build,
  against the reference's dense twin: logits ``TOL``, gradients ``TOL`` of
  each leaf's largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.models import layers as rlayers
from repro.models import mla as rmla
from repro.models import params as rparams
from repro.models import transformer as rtf
from repro.serve import engine as rengine

from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels import flashattn as tfa
from repro_torch.models import layers as tlayers
from repro_torch.models import mla as tmla
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

from test_torch_serving import _TIMING, _cli_lines, _same_run, _serve

ARCH = "deepseek-v3-671b"
LAYER_TOL = 1e-5
TOL = 1e-4
FORWARD_TOL = 2e-3
BF16_ACC_TOL = 1e-5
KEY = jax.random.PRNGKey(0)
PUBLISHED_MLA = dict(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=128,
                     qk_rope_dim=64, v_dim=128)
CONFIGS = {"reduced": None, "published-head-dims": PUBLISHED_MLA}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_to_max(got, want, tol=TOL):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _pair(which="reduced", **overrides):
    """(reference config, port config) for reduced deepseek-v3, with
    ``CONFIGS[which]``'s MLA head dims (None: the reduced ones)."""
    mla = CONFIGS[which]
    return tuple(base.reduced_config(reg.get_config(ARCH), **overrides, **(
        {} if mla is None else {"mla": base.MLAConfig(**mla)}))
        for base, reg in ((rbase, rreg), (tbase, treg)))


_WEIGHTS = {}


def _weights(which="reduced"):
    """The reference's parameters for reduced deepseek-v3 (``which`` head
    dims) and the same weights as the port's tensors, once per module."""
    if which not in _WEIGHTS:
        rcfg, tcfg = _pair(which, remat=False)
        params = rtf.Model(rcfg).init(KEY)
        _WEIGHTS[which] = (rcfg, tcfg, params, interop.params_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), "cpu"))
    return _WEIGHTS[which]


def _ids(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _layer_params(cfg, seed):
    """The layer's weights at std 1/sqrt(fan_in), norms at 1 + noise."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in rmla.mla_specs(cfg).items():
        if spec.init == "ones":
            out[name] = (1 + 0.1 * rng.normal(size=spec.shape)).astype(
                np.float32)
        else:
            out[name] = (rng.normal(size=spec.shape)
                         / np.sqrt(spec.shape[0])).astype(np.float32)
    return out


# -- the layer -------------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_mla_specs_equal_reference(which):
    rcfg, tcfg = _pair(which)
    want, got = rmla.mla_specs(rcfg), tmla.mla_specs(tcfg)
    assert list(got) == list(want)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("S", [23, 64])
@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_mla_attention_matches_reference_in_every_mode(which, S):
    """Train, prefill (which returns the latent cache ``ckv`` and the
    rotated ``kpe``) and one decode step at position S from the prefill's
    cache grown by a row, which the step writes in place."""
    rcfg, tcfg = _pair(which)
    p = _layer_params(rcfg, S)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(S + 1)
    x = rng.normal(size=(2, S + 1, rcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    for mode in ("train", "prefill"):
        want, wc = rmla.mla_attention(rp, jnp.asarray(x[:, :S]), rcfg,
                                      positions=jnp.asarray(pos), mode=mode)
        got, gc = tmla.mla_attention(tp, torch.from_numpy(x[:, :S]), tcfg,
                                     positions=torch.from_numpy(pos),
                                     mode=mode)
        _close(got, want, LAYER_TOL)
        assert sorted(gc) == sorted(wc)
        for k in wc:
            assert tuple(gc[k].shape) == wc[k].shape
            _close(gc[k], wc[k], LAYER_TOL)
    assert sorted(wc) == ["ckv", "kpe"]
    grown = {k: np.pad(np.asarray(v), [(0, 0), (0, 1), (0, 0)])
             for k, v in wc.items()}
    dpos = np.full((2,), S, np.int32)
    want, wnew = rmla.mla_attention(
        rp, jnp.asarray(x[:, S:]), rcfg, positions=jnp.asarray(dpos),
        mode="decode", cache={k: jnp.asarray(v) for k, v in grown.items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in grown.items()}
    held = dict(cache)
    got, gnew = tmla.mla_attention(tp, torch.from_numpy(x[:, S:]), tcfg,
                                   positions=torch.from_numpy(dpos),
                                   mode="decode", cache=cache)
    _close(got, want, LAYER_TOL)
    for k in wnew:
        assert gnew[k] is held[k]                        # written in place
        _close(gnew[k], wnew[k], LAYER_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64])
def test_flash_attention_plain_at_192_128_matches_reference_scan(block,
                                                                 causal):
    """K9's plain version at (Dq, Dv) = (192, 128), the reference's XLA
    scan ``models/layers.flash_attention`` with the same blocks (the
    reference's Pallas kernel takes Dq == Dv only), through the port's
    model-level wrapper too.  Output (B, S, H, 128)."""
    rng = np.random.default_rng(block + causal)
    q, k = (rng.normal(size=(2, 64, 3, 192)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(2, 64, 3, 128)).astype(np.float32)
    want = rlayers.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, block=block)
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, block=block)
    assert tuple(got.shape) == (2, 64, 3, 128)
    _close(got, want, LAYER_TOL)
    via = tlayers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, block=block)
    assert torch.equal(via, got)


def _reference_latent_attention(q_abs, q_pe, cc, ck, positions, scale):
    """The reference's decode lines (``src/repro/models/mla.py:75-84``),
    with their ``preferred_element_type``."""
    f32 = jnp.float32
    s = (jnp.einsum("bqhr,btr->bqht", q_abs, cc, preferred_element_type=f32)
         + jnp.einsum("bqhe,bte->bqht", q_pe, ck,
                      preferred_element_type=f32)) * scale
    valid = jnp.arange(cc.shape[1])[None, :] <= positions[:, None]
    s = jnp.where(valid[:, None, None, :], s, rlayers.NEG_INF)
    probs = jax.nn.softmax(s, axis=-1).astype(cc.dtype)
    return jnp.einsum("bqht,btr->bqhr", probs, cc,
                      preferred_element_type=f32)


def test_decode_accumulates_in_f32():
    """bf16 q_abs, q_pe and caches at deepseek-v3's latent widths (rank
    512, rope 64; scores reaching about ±5): the port's
    ``latent_attention`` against the reference's ``preferred_element_type``
    result within ``BF16_ACC_TOL`` of its largest output.  Rounding the
    score products to bf16 instead (what a bf16 einsum would do) misses
    that bound: the check tells the two apart."""
    rng = np.random.default_rng(5)
    B, H, Sc, r, e = 2, 4, 40, 512, 64
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, 1, H, r), (B, 1, H, e), (B, Sc, r), (B, Sc, e))]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    pos = np.array([Sc - 1, 17], np.int32)
    scale = 1 / np.sqrt(192)
    got = tmla.latent_attention(*t, torch.from_numpy(pos), scale)
    want = np.asarray(_reference_latent_attention(*j, jnp.asarray(pos),
                                                  scale))
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, r)
    bound = BF16_ACC_TOL * np.abs(want).max()
    assert np.abs(_np(got) - want).max() <= bound
    # the same steps with the score products rounded to bf16
    s = (torch.einsum("bqhr,btr->bqht", t[0], t[2])
         + torch.einsum("bqhe,bte->bqht", t[1], t[3])).float() * scale
    valid = torch.arange(Sc)[None, :] <= torch.from_numpy(pos)[:, None]
    s = torch.where(valid[:, None, None, :], s, tfa.NEG_INF)
    probs = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    bf16_products = torch.einsum("bqht,btr->bqhr", probs, t[2].float())
    assert np.abs(_np(bf16_products) - want).max() > bound


# -- the model -------------------------------------------------------------------------

@pytest.mark.parametrize("S", [23, 64])
@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_model_forward_prefill_and_decode_match_reference(which, S):
    """Reduced deepseek-v3 (one dense-prefix layer, one MoE layer with a
    shared expert, MLA in both): train logits and aux, prefill logits and
    its ``ckv`` / ``kpe`` caches, and a decode step at position S."""
    rcfg, tcfg, rp, tp = _weights(which)
    x = _ids(rcfg, S, (2, S + 1))
    want, _, want_aux = rtf.Model(rcfg)(rp, jnp.asarray(x[:, :S]),
                                        mode="train")
    got, _, aux = ttf.Model(tcfg)(tp, torch.from_numpy(x[:, :S]),
                                  mode="train")
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    r_last, r_caches = rengine.make_prefill_step(rcfg)(rp,
                                                       jnp.asarray(x[:, :S]))
    t_last, t_caches = tengine.make_prefill_step(tcfg)(
        tp, torch.from_numpy(x[:, :S]))
    _close(t_last, r_last)
    r_leaves = jax.tree.leaves(r_caches)
    t_leaves = tparams.leaves(t_caches)
    assert [tuple(t.shape) for t in t_leaves] == [c.shape for c in r_leaves]
    for g, w in zip(t_leaves, r_leaves):
        _close_to_max(g, w)
    # (layers, B, S, ...): the sequence axis grows by a row
    r_caches = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 1) if i == 2 else (0, 0)
                              for i in range(c.ndim)]), r_caches)
    t_grown = [{s: {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
                for s, c in seg.items()}
               for seg in jax.tree.map(np.asarray, r_caches)]
    dpos = np.full((2,), S, np.int32)
    r_logits, r_new = rengine.make_decode_step(rcfg)(
        rp, r_caches, jnp.asarray(x[:, S:]), jnp.asarray(dpos))
    t_logits, t_new = tengine.make_decode_step(tcfg)(
        tp, t_grown, torch.from_numpy(x[:, S:]), torch.from_numpy(dpos))
    _close(t_logits, r_logits)
    for g, w in zip(tparams.leaves(t_new), jax.tree.leaves(r_new)):
        _close_to_max(g, w)


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_dense_prefix_alone_matches_its_dense_twin(which):
    """deepseek-v3 cut to its dense prefix (``num_layers =
    dense_prefix``, as ``chip_smoke.py`` trains it at published widths)
    is one segment of MLA layers with the prefix's dense MLP in the port.
    The reference's ``build_segments`` raises on it (its empty MoE segment
    indexes past the pattern), so it is held to the reference's dense twin
    — the same layers as a config without MoE whose ``d_ff`` is the
    prefix's — on one set of weights: parameter count, train logits, aux
    0, and the gradients of the loss."""
    from repro.train import train_step as rts
    from repro_torch.train import train_step as tts
    from repro_torch.train import tree as ttree
    rcut, tcfg = _pair(which, remat=False)
    rcut, tcfg = (dataclasses.replace(c, num_layers=c.dense_prefix)
                  for c in (rcut, tcfg))
    with pytest.raises(IndexError):
        rtf.build_segments(rcut)
    rcfg = dataclasses.replace(rcut, moe=None, dense_prefix=0,
                               d_ff=rcut.dense_prefix_ff)
    assert rcfg.param_count() == tcfg.param_count()
    assert [s.slots for s in ttf.build_segments(tcfg)] == \
        [s.slots for s in rtf.build_segments(rcfg)]
    rp = rtf.Model(rcfg).init(KEY)
    tp = interop.params_from_numpy(tcfg, jax.tree.map(np.asarray, rp), "cpu")
    assert sum(x.numel() for x in tparams.leaves(tp)) == tcfg.param_count()
    x = _ids(rcfg, 5, (2, 64))
    want, _, want_aux = rtf.Model(rcfg)(rp, jnp.asarray(x), mode="train")
    got, _, aux = ttf.Model(tcfg)(tp, torch.from_numpy(x), mode="train")
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0
    batch = {"inputs": x, "labels": _ids(rcfg, 6, (2, 64))}
    _, want_g = jax.value_and_grad(rts.make_loss_fn(rcfg, rtf.Model(rcfg)),
                                   has_aux=True)(rp, jax.tree.map(
                                       jnp.asarray, batch))
    params = ttree.map(lambda t: t.detach().requires_grad_(), tp)
    _, _, got_g = tts.make_grad_fn(tcfg)(params, batch)
    for g, w in zip(ttree.leaves(got_g), jax.tree.leaves(want_g)):
        assert tuple(g.shape) == w.shape
        _close_to_max(g, w)


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_decode_matches_full_forward(which):
    """The port alone: prefill(x[:64]) (flash branch) + decode(x[64])
    logits == forward(x[:65])[:, 64] on the dense branch (flash block
    above 65); the MoE drops nothing (reduced capacity factor 5)."""
    _, tcfg, _, tp = _weights(which)
    T = 64
    x = torch.from_numpy(_ids(tcfg, 300, (2, T + 1)))
    dense = ttf.Model(dataclasses.replace(tcfg, flash_block=128))
    full, _, _ = dense(tp, x, mode="train")
    last, caches = tengine.make_prefill_step(tcfg)(tp, x[:, :T])
    _close(last, full[:, T - 1], FORWARD_TOL)
    grown = ttf.init_cache(tcfg, 2, T + 1, device="cpu")
    for one, dst in zip(tparams.leaves(caches), tparams.leaves(grown)):
        dst[:, :, :T] = one
    logits, _ = tengine.make_decode_step(tcfg)(tp, grown, x[:, T:],
                                               torch.full((2,), T))
    _close(logits, full[:, T], FORWARD_TOL)


def test_mla_cache_specs_equal_reference():
    """The latent cache: ``ckv`` (B, S, kv_lora_rank) on ("batch",
    "kv_seq", "lora") and ``kpe`` (B, S, qk_rope_dim) on ("batch",
    "kv_seq", None), per segment, stacked over its layers."""
    rcfg, tcfg = _pair("published-head-dims")
    r_shapes, r_axes = rtf.cache_specs(rcfg, 3, 9)
    t_shapes, t_axes = ttf.cache_specs(tcfg, 3, 9)
    assert t_axes == r_axes
    assert [{s: {k: shape for k, (shape, _) in c.items()}
             for s, c in seg.items()} for seg in t_shapes] == \
        [{s: {k: tuple(v.shape) for k, v in c.items()}
          for s, c in seg.items()} for seg in r_shapes]
    assert t_axes[0]["slot0"] == {"ckv": ("layers", "batch", "kv_seq", "lora"),
                                  "kpe": ("layers", "batch", "kv_seq", None)}
    assert t_shapes[0]["slot0"]["ckv"][0] == (1, 3, 9, 32)
    assert t_shapes[0]["slot0"]["kpe"][0] == (1, 3, 9, 64)
    assert tparams.axes_tree(ttf.param_specs(tcfg)) == \
        rparams.axes_tree(rtf.param_specs(rcfg))


# -- serving ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_batcher_serves_deepseek_like_the_reference(which):
    """Both batchers on reduced deepseek-v3: the ``ckv`` / ``kpe`` leaves
    are spliced by their ``kv_seq`` axis as attention K and V are (nothing
    new in the batcher); every prefill's and decode step's logits, then
    the tokens.  Prompts of 64 and 96 tokens take the flash branch."""
    rcfg, tcfg, rp, tp = _weights(which)
    prompts = [_ids(tcfg, 500 + i, (T,))
               for i, T in enumerate([5, 64, 12, 96, 20])]
    ref, port = _serve((rp, tp), prompts, slots=2, capacity=128, max_new=6,
                       cfgs=(rcfg, tcfg))
    _same_run(ref, port)
    assert len(port[0].finished) == 5
    assert all(len(r.generated) == 6 for r in port[0].finished)


def test_serve_cli_serves_deepseek_like_the_reference(monkeypatch, capsys):
    """``launch.serve --arch deepseek-v3-671b`` at its own flags (the
    reduced config; prompts of 4-16 tokens, under its flash block)."""
    want, got, b = _cli_lines(monkeypatch, capsys, ARCH)
    assert len(got) == len(want) == 4
    assert [_TIMING.sub("", x) for x in got] == \
        [_TIMING.sub("", x) for x in want]
    assert b.cfg.mla is not None and b.device.type == "cpu"
