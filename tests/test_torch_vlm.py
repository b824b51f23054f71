"""Gated cross-attention of the port (``models.layers.cross_attention``,
the 'X' slots of ``models.transformer``) and reduced
llama-3.2-vision-11b vs the reference package on the CPU.

Inputs, image embeddings included, are made with numpy from a seed and
handed to both packages; the model runs the reference's weights carried
across with ``interop.params_from_numpy``, in f32.  The reference draws
the X slots' gates as zeros, and tanh(0) = 0, so at init an X slot adds
nothing: every model comparison here first sets the gates to values drawn
from the seed (``_gated``), and ``test_the_gates_open_the_cross_attention``
shows the logits move with them.  Tolerances, relative and absolute:

* the layer alone: ``LAYER_TOL`` = 1e-5 (the largest difference seen is
  below 1e-6);
* the model's logits: ``TOL`` = 1e-4, as ``tests/test_torch_models.py``;
  cache leaves within ``TOL`` of their largest entry (the attention
  slots have no qk-norm, as dbrx-132b's);
* decode against the full forward, the port alone: 2e-3, as the
  reference's own test;
* gradients: ``TOL`` of each leaf's largest entry plus twice how far the
  reference's own gradient moves when every weight moves one f32 ulp
  (``test_torch_train``'s floor for ill-conditioned configs): this config
  has no qk-norm and a one-ulp shift moves the reference's gradients by
  up to 9.4e-4 of a leaf's largest entry.

The reference's ``ContinuousBatcher`` passes no ``image_embeds``, so it
cannot serve this model: it fails at the first admission.  The port's
refuses the config in its constructor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.models import layers as rlayers
from repro.models import transformer as rtf
from repro.serve import engine as rengine
from repro.serve.batching import ContinuousBatcher as RBatcher
from repro.serve.batching import Request as RRequest

from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.serve.batching import ContinuousBatcher as TBatcher
from repro_torch.train import train_step as tts
from repro_torch.train import tree

from test_torch_train import FLOOR_TIMES, _batch, _ref_grads, _ulp_shifted

ARCH = "llama-3.2-vision-11b"
LAYER_TOL = 1e-5
TOL = 1e-4
FORWARD_TOL = 2e-3
KEY = jax.random.PRNGKey(0)


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


def _pair(**overrides):
    return (rbase.reduced_config(rreg.get_config(ARCH), **overrides),
            tbase.reduced_config(treg.get_config(ARCH), **overrides))


def _image(cfg, seed, B=2):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _ids(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# -- the layer -------------------------------------------------------------------------

def test_cross_attn_specs_equal_reference_without_qk_norm():
    """The self-attention specs less q/k norms, also for a config with
    qk-norm on."""
    for qk in (False, True):
        rcfg, tcfg = _pair(qk_norm=qk)
        want = rlayers.cross_attn_specs(rcfg)
        got = tlayers.cross_attn_specs(tcfg)
        assert list(got) == list(want) == ["wq", "wk", "wv", "wo"]
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


def test_cross_attention_matches_reference_in_every_mode():
    """Train, prefill (which returns the (B, T, KV, hd) image K and V) and
    a decode step that reads them back unchanged."""
    rcfg, tcfg = _pair()
    rng = np.random.default_rng(1)
    p = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(
        np.float32) for k, s in rlayers.cross_attn_specs(rcfg).items()}
    x = rng.normal(size=(2, 5, rcfg.d_model)).astype(np.float32)
    img = _image(rcfg, 2)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    caches = {}
    for mode in ("train", "prefill"):
        want, wc = rlayers.cross_attention(rp, jnp.asarray(x),
                                           jnp.asarray(img), rcfg, mode=mode)
        got, gc = tlayers.cross_attention(tp, torch.from_numpy(x),
                                          torch.from_numpy(img), tcfg,
                                          mode=mode)
        _close(got, want, LAYER_TOL)
        assert sorted(gc) == sorted(wc)
        for k in wc:
            assert tuple(gc[k].shape) == wc[k].shape == (
                2, rcfg.num_image_tokens, rcfg.num_kv_heads, rcfg.head_dim)
            _close(gc[k], wc[k], LAYER_TOL)
        caches = (wc, gc)
    wc, gc = caches
    xd = x[:, :1]
    want, _ = rlayers.cross_attention(rp, jnp.asarray(xd), None, rcfg,
                                      mode="decode", cache=wc)
    held = dict(gc)
    got, new = tlayers.cross_attention(tp, torch.from_numpy(xd), None, tcfg,
                                       mode="decode", cache=gc)
    assert new is gc and all(new[k] is held[k] for k in held)
    _close(got, want, LAYER_TOL)


# -- the model -------------------------------------------------------------------------

def _gated(params, seed=7):
    """``params`` (the reference's tree) with every X slot's gates drawn
    from ``seed``, uniform in ±[0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith(("['gate_attn']",
                                                "['gate_ffn']")):
            mag = rng.uniform(0.5, 1.5, leaf.shape)
            sign = rng.choice([-1.0, 1.0], leaf.shape)
            return jnp.asarray((mag * sign).astype(np.float32))
        return leaf
    return jax.tree_util.tree_map_with_path(draw, params)


_WEIGHTS = {}


def _weights():
    """The reference's parameters for reduced llama-vision (remat off),
    gates drawn, and the same weights as the port's tensors."""
    if not _WEIGHTS:
        rcfg, tcfg = _pair(remat=False)
        params = _gated(rtf.Model(rcfg).init(KEY))
        _WEIGHTS["w"] = (rcfg, tcfg, params, interop.params_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), "cpu"))
    return _WEIGHTS["w"]


def test_gates_are_stacked_scalars_carried_across():
    rcfg, tcfg, rp, tp = _weights()
    slots = [ttf.build_segments(tcfg)[0].slots[j].kind for j in range(5)]
    assert slots == ["A", "A", "A", "A", "X"]
    x_slot = tp["segments"][0]["slot4"]
    for g in ("gate_attn", "gate_ffn"):
        assert tuple(x_slot[g].shape) == (1,)
        assert np.array_equal(_np(x_slot[g]),
                              np.asarray(rp["segments"][0]["slot4"][g]))
        assert abs(float(x_slot[g][0])) >= 0.5
    fresh = ttf.Model(tcfg).init(0, device="cpu")["segments"][0]["slot4"]
    assert float(fresh["gate_attn"].abs().sum()) == 0.0
    assert tparams.count_params(ttf.param_specs(tcfg)) == tcfg.param_count()


@pytest.mark.parametrize("S", [23, 64])
def test_forward_matches_reference(S):
    """S = 23 takes the dense attention path, S = 64 the flash one (block
    32); the image embeddings feed the X slot."""
    rcfg, tcfg, rp, tp = _weights()
    x, img = _ids(rcfg, S, (2, S)), _image(rcfg, 100 + S)
    want, _, want_aux = rtf.Model(rcfg)(rp, jnp.asarray(x), mode="train",
                                        image_embeds=jnp.asarray(img))
    got, caches, aux = ttf.Model(tcfg)(tp, torch.from_numpy(x), mode="train",
                                       image_embeds=torch.from_numpy(img))
    assert caches is None and float(aux) == float(want_aux) == 0.0
    _close(got, want)


def test_the_gates_open_the_cross_attention():
    """With the gates at 0 (the reference's init) the X slot adds
    nothing, and the image does not reach the logits; with the drawn
    gates it moves them far beyond the tolerance."""
    rcfg, tcfg, rp, tp = _weights()
    x = torch.from_numpy(_ids(rcfg, 5, (2, 23)))
    img = [torch.from_numpy(_image(rcfg, s)) for s in (6, 8)]
    closed = {k: v for k, v in tp.items()}
    closed["segments"] = [{s: dict(leaves) for s, leaves in seg.items()}
                          for seg in tp["segments"]]
    for g in ("gate_attn", "gate_ffn"):
        closed["segments"][0]["slot4"][g] = torch.zeros(1)
    model = ttf.Model(tcfg)
    a = model(closed, x, mode="train", image_embeds=img[0])[0]
    b = model(closed, x, mode="train", image_embeds=img[1])[0]
    assert torch.equal(a, b)
    c = model(tp, x, mode="train", image_embeds=img[0])[0]
    d = model(tp, x, mode="train", image_embeds=img[1])[0]
    assert float((c - d).abs().max()) > 1000 * TOL
    assert float((c - a).abs().max()) > 1000 * TOL


@pytest.mark.parametrize("S", [23, 64])
def test_prefill_matches_reference(S):
    """``serve.engine``'s prefill step with ``image_embeds``: the last
    logits, the 'A' slots' K and V and the X slot's image K and V."""
    rcfg, tcfg, rp, tp = _weights()
    x, img = _ids(rcfg, 50 + S, (2, S)), _image(rcfg, 150 + S)
    r_last, r_caches = rengine.make_prefill_step(rcfg)(
        rp, jnp.asarray(x), image_embeds=jnp.asarray(img))
    t_last, t_caches = tengine.make_prefill_step(tcfg)(
        tp, torch.from_numpy(x), image_embeds=torch.from_numpy(img))
    _close(t_last, r_last)
    r_leaves, t_leaves = jax.tree.leaves(r_caches), tparams.leaves(t_caches)
    assert [tuple(t.shape) for t in t_leaves] == [c.shape for c in r_leaves]
    assert tuple(t_caches[0]["slot4"]["xk"].shape) == (
        1, 2, rcfg.num_image_tokens, rcfg.num_kv_heads, rcfg.head_dim)
    for got, want in zip(t_leaves, r_leaves):
        _close_to_max(got, want)


def test_decode_matches_reference():
    """The reference's prefill caches of 23 tokens grown by one position,
    then one decode step in both (which reads the image K and V from the
    cache and takes no ``image_embeds``): logits and caches, the port's
    written in place."""
    rcfg, tcfg, rp, tp = _weights()
    T = 23
    x, img = _ids(rcfg, 123, (2, T + 1)), _image(rcfg, 124)
    _, r_caches, _ = rtf.Model(rcfg)(rp, jnp.asarray(x[:, :T]),
                                     mode="prefill",
                                     image_embeds=jnp.asarray(img))
    r_caches = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 1) if d == T else (0, 0) for d in c.shape]),
        r_caches)
    t_caches = [{s: {k: torch.from_numpy(np.array(v))
                     for k, v in leaves.items()} for s, leaves in seg.items()}
                for seg in jax.tree.map(np.asarray, r_caches)]
    held = tparams.leaves(t_caches)
    pos = np.full((2,), T, np.int32)
    r_logits, r_new = rengine.make_decode_step(rcfg)(
        rp, r_caches, jnp.asarray(x[:, T:]), jnp.asarray(pos))
    t_logits, t_new = tengine.make_decode_step(tcfg)(
        tp, t_caches, torch.from_numpy(x[:, T:]), torch.from_numpy(pos))
    _close(t_logits, r_logits)
    new = tparams.leaves(t_new)
    assert all(a is b for a, b in zip(new, held))
    for got, want in zip(new, jax.tree.leaves(r_new)):
        _close_to_max(got, want)


def test_decode_matches_full_forward():
    """The port alone, as ``tests/test_models.py`` holds the reference:
    prefill(x[:23]) + decode(x[23]) logits == forward(x[:24])[:, 23],
    the same image embeddings on both sides."""
    _, tcfg, _, tp = _weights()
    T = 23
    x = torch.from_numpy(_ids(tcfg, 223, (2, T + 1)))
    img = torch.from_numpy(_image(tcfg, 224))
    full, _, _ = ttf.Model(tcfg)(tp, x, mode="train", image_embeds=img)
    last, caches = tengine.make_prefill_step(tcfg)(tp, x[:, :T],
                                                   image_embeds=img)
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


def test_batchers_of_both_packages_refuse_the_vlm():
    """Neither ``ContinuousBatcher`` passes image embeddings: the
    reference's fails at its first admission (the X slot projects
    ``None``), the port's refuses the config when it is built."""
    rcfg, tcfg, rp, tp = _weights()
    rb = RBatcher(rcfg, rp, slots=1, capacity=16)
    rb.submit(RRequest(uid=0, prompt=_ids(rcfg, 9, (5,)), max_new_tokens=2))
    with pytest.raises(AttributeError, match="astype"):
        rb.step()
    with pytest.raises(ValueError, match="image_embeds"):
        TBatcher(tcfg, tp, slots=1, capacity=16, device="cpu")


# -- training --------------------------------------------------------------------------

def test_gradients_match_reference_with_image_embeds():
    """The port's gradient (``make_grad_fn``, remat on) with
    ``image_embeds`` in the batch and the gates drawn, against
    ``jax.value_and_grad`` of the reference's loss: per leaf ``TOL`` of
    its largest entry plus ``FLOOR_TIMES`` times the reference's own
    one-ulp shift of that leaf."""
    rcfg, tcfg = _pair()
    params = _gated(rtf.Model(rcfg).init(KEY))
    batch = dict(_batch(rcfg), image_embeds=_image(rcfg, 11, B=4))
    want = _ref_grads(rcfg, params, batch, 1)
    shifted = _ref_grads(rcfg, _ulp_shifted(params), batch, 1)
    tp = interop.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                   "cpu")
    for p in tree.leaves(tp):
        p.requires_grad_(True)
    _, _, grads = tts.make_grad_fn(tcfg)(tp, batch)
    got = tree.leaves(grads)
    assert len(got) == len(jax.tree.leaves(want))
    gate_grads = 0
    for w, s, g in zip(jax.tree.leaves(want), jax.tree.leaves(shifted), got):
        floor = FLOOR_TIMES * np.abs(np.asarray(s) - w).max()
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=TOL * np.abs(w).max() + floor)
        gate_grads += w.shape == (1,) and abs(float(w[0])) > 0
    # the two gates and the cross-attention weights learn
    assert gate_grads == 2
    wq = grads["segments"][0]["slot4"]["mixer"]["wk"]
    assert float(wq.abs().max()) > 0
