"""The LM scaffold of the port (configs, params, layers, transformer,
serving steps) vs the reference package.

Configs are pure data: every registry id must give the same config, the
same segments and the same parameter counts in both packages.  The
forward passes run the reference's weights carried across with
``interop.params_from_numpy``, on the same token ids (frame embeddings
for musicgen-large) made with numpy from a seed, for reduced configs in
f32.  S = 64 takes the flash path
(``flash_block`` is 32 in ``reduced_config``), S = 23 the dense one.
Tolerance 1e-4, relative and absolute: f32 sums in another order over two
layers (the largest difference seen is below 1e-6).
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
from repro.models import params as rparams
from repro.models import transformer as rtf
from repro.serve import engine as rengine

from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
PORTED = ("qwen3-4b", "deepseek-7b", "command-r-35b", "granite-20b",
          "musicgen-large", "repro-100m", "dbrx-132b", "mamba2-1.3b",
          "jamba-1.5-large-398b", "llama-3.2-vision-11b", "deepseek-v3-671b")
# families whose mixers ('M', 'X') were ported after the constructor
# refused them; the models themselves are held in test_torch_ssm.py and
# test_torch_vlm.py
SSM_AND_VLM = ("mamba2-1.3b", "jamba-1.5-large-398b", "llama-3.2-vision-11b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_cache(cfg, got, want):
    """A KV cache leaf within ``TOL``, elementwise.  dbrx-132b has no
    qk-norm: at the reduced config's weights (std 1/sqrt(2), the stacked
    layer axis being fan_in) its attention scores span about 30, and the
    softmax carries two f32 summation orders apart by about 5e-6 of a
    layer's largest activation (the MoE layer alone: 2e-7), so its caches
    are held within ``TOL`` of their largest entry (the logits stay
    elementwise); so are deepseek-v3-671b's (MoE, no qk-norm).  The dense
    configs without qk-norm (deepseek-7b, granite-20b, command-r-35b,
    musicgen-large) meet ``TOL`` elementwise and are held so."""
    if cfg.qk_norm or cfg.moe is None:
        return _close(got, want)
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def _pair(arch, **overrides):
    """(reference config, port config) for ``arch``, reduced."""
    return (rbase.reduced_config(rreg.get_config(arch), **overrides),
            tbase.reduced_config(treg.get_config(arch), **overrides))


_WEIGHTS = {}


def _weights(arch, **overrides):
    """The reference's parameters for the reduced ``arch`` and the same
    weights as the port's tensors (built once per module)."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _WEIGHTS:
        rcfg, tcfg = _pair(arch, **overrides)
        params = rtf.Model(rcfg).init(KEY)
        tree = jax.tree.map(np.asarray, params)
        _WEIGHTS[key] = (rcfg, tcfg, params,
                         interop.params_from_numpy(tcfg, tree, "cpu"))
    return _WEIGHTS[key]


def _inputs(cfg, seed, shape):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


# -- configs and parameter counts ------------------------------------------------------

@pytest.mark.parametrize("arch", rreg.ALL_IDS)
def test_config_segments_and_counts_equal(arch):
    rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(tbase.reduced_config(tcfg)) == \
        dataclasses.asdict(rbase.reduced_config(rcfg))
    assert [(tuple(map(tuple, s.slots)), s.n)
            for s in ttf.build_segments(tcfg)] == \
        [(tuple(map(tuple, s.slots)), s.n) for s in rtf.build_segments(rcfg)]
    assert tcfg.param_count() == rcfg.param_count()
    assert tcfg.active_param_count() == rcfg.active_param_count()
    assert {n: tbase.cell_is_applicable(tcfg, s)
            for n, s in tbase.SHAPES.items()} == \
        {n: rbase.cell_is_applicable(rcfg, s) for n, s in rbase.SHAPES.items()}
    assert arch in PORTED
    specs = ttf.param_specs(tcfg)
    assert tparams.count_params(specs) == \
        rparams.count_params(rtf.param_specs(rcfg)) == tcfg.param_count()
    assert tparams.axes_tree(specs) == \
        rparams.axes_tree(rtf.param_specs(rcfg))


def test_registry_ids_and_shapes_equal():
    assert treg.ARCH_IDS == rreg.ARCH_IDS and treg.ALL_IDS == rreg.ALL_IDS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


def test_mla_family_constructs():
    """deepseek-v3-671b constructs at its published config (it raised
    before MLA was ported), and the reduced config's MLA specs, cache
    specs and zero caches have the reference's leaves, shapes and axes:
    ``ckv`` (B, S, kv_lora_rank) and ``kpe`` (B, S, qk_rope_dim) per 'A'
    slot, on the ``kv_seq`` axis the batcher splices by."""
    arch = "deepseek-v3-671b"
    full = ttf.Model(treg.get_config(arch))
    assert tparams.count_params(full.specs) == 671_026_404_352
    assert list(full.specs["segments"][0]["slot0"]["mixer"]) == [
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"]
    rcfg, tcfg = _pair(arch)
    model = ttf.Model(tcfg)
    assert tparams.axes_tree(model.specs) == \
        rparams.axes_tree(rtf.param_specs(rcfg))
    r_shapes, r_axes = rtf.cache_specs(rcfg, 2, 7)
    t_shapes, t_axes = ttf.cache_specs(tcfg, 2, 7)
    assert [shape for shape, _ in tparams.leaves(
        [{s: list(leaf.values()) for s, leaf in seg.items()}
         for seg in t_shapes])] == \
        [tuple(x.shape) for x in jax.tree.leaves(r_shapes)]
    assert t_axes == r_axes
    assert all(sorted(slot) == ["ckv", "kpe"] and
               slot["ckv"] == ("layers", "batch", "kv_seq", "lora") and
               slot["kpe"] == ("layers", "batch", "kv_seq", None)
               for seg in t_axes for slot in seg.values())
    caches = ttf.init_cache(tcfg, 2, 7, device="cpu")
    assert all(float(c.abs().sum()) == 0 for c in tparams.leaves(caches))


@pytest.mark.parametrize("arch", SSM_AND_VLM)
def test_ssm_and_vlm_families_construct(arch):
    """The Mamba ('M') and cross-attention ('X') slots construct: the
    reduced config's specs, cache specs and zero caches have the
    reference's leaves, shapes and axes."""
    rcfg, tcfg = _pair(arch)
    model = ttf.Model(tcfg)
    assert tparams.axes_tree(model.specs) == \
        rparams.axes_tree(rtf.param_specs(rcfg))
    r_shapes, r_axes = rtf.cache_specs(rcfg, 2, 7)
    t_shapes, t_axes = ttf.cache_specs(tcfg, 2, 7)
    assert [shape for shape, _ in tparams.leaves(
        [{s: list(leaf.values()) for s, leaf in seg.items()}
         for seg in t_shapes])] == \
        [tuple(x.shape) for x in jax.tree.leaves(r_shapes)]
    assert t_axes == r_axes
    caches = ttf.init_cache(tcfg, 2, 7, device="cpu")
    assert all(float(c.abs().sum()) == 0 for c in tparams.leaves(caches))
    kinds = {slot.kind for seg in ttf.build_segments(tcfg)
             for slot in seg.slots}
    assert kinds & {"M", "X"}


def test_init_draws_every_leaf_on_the_device_asked_for(monkeypatch):
    cfg = tbase.reduced_config(treg.get_config("qwen3-4b"))
    model = ttf.Model(cfg)
    a, b = model.init(3, device="cpu"), model.init(3, device="cpu")
    specs = tparams.leaves(model.specs)
    flat_a = tparams.leaves(a)
    assert [tuple(t.shape) for t in flat_a] == [s.shape for s in specs]
    assert all(t.dtype == torch.float32 for t in flat_a)
    assert all(torch.equal(x, y) for x, y in zip(flat_a, tparams.leaves(b)))
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    # std 1/sqrt(fan_in), fan_in the spec's first axis: for a stacked
    # spec that is the layer count, as in the reference
    wq = a["segments"][0]["slot0"]["mixer"]["wq"]
    assert abs(wq.std().item() - 1 / np.sqrt(cfg.num_layers)) < 0.02
    assert abs(a["embed"].std().item() - 0.02) < 0.002
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_cache(cfg, 1, 8)


def test_large_normal_leaves_are_drawn_in_slices(monkeypatch):
    """A "normal" leaf over ``SLICED_DRAW_ELEMENTS`` is drawn slice by
    slice along its leading axis (a slice still over it, one axis down)
    straight into its dtype: right shape, dtype and std, the same bits
    for the same seed.  Leaves at or under the threshold keep the bits of
    one whole draw, so a config's weights under a seed do not move."""
    monkeypatch.setattr(tparams, "SLICED_DRAW_ELEMENTS", 1000)
    drawn = []
    real = torch.randn

    def counting(*a, **kw):
        out = real(*a, **kw)
        drawn.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", counting)
    cases = [(tparams.P((6, 40, 60), ("layers", "a", "b")), 1 / np.sqrt(6)),
             (tparams.P((3, 50, 50), ("layers", "a", "b"), scale=0.02),
              0.02),
             (tparams.P((5000,), ("a",), scale=0.5), 0.5)]
    for spec, std in cases:
        leaf = [tparams._init_leaf(spec, torch.Generator().manual_seed(7),
                                   torch.bfloat16, "cpu") for _ in range(2)]
        assert leaf[0].shape == spec.shape
        assert leaf[0].dtype == torch.bfloat16
        assert torch.equal(leaf[0], leaf[1])
        assert abs(leaf[0].float().std().item() / std - 1) < 0.05
        assert max(drawn) <= 1000 and len(drawn) >= 2 * 5
        drawn.clear()
    small = tparams.P((10, 100), ("a", "b"))           # exactly 1000
    got = tparams._init_leaf(small, torch.Generator().manual_seed(3),
                             torch.float32, "cpu")
    want = real((10, 100), generator=torch.Generator().manual_seed(3)) \
        * (1 / np.sqrt(10))
    assert torch.equal(got, want) and drawn == [1000]


def test_params_from_numpy_checks_shapes():
    rcfg, tcfg, params, _ = _weights("qwen3-4b", remat=False)
    tree = jax.tree.map(np.asarray, params)
    tree["final_norm"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        interop.params_from_numpy(tcfg, tree, "cpu")


# -- layers ----------------------------------------------------------------------------

def test_layer_functions_equal():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    T = torch.from_numpy
    x = f(2, 5, 4, 16)
    pos = np.array([[0, 3, 9, 1, 2], [7, 7, 0, 4, 5]], np.int32)
    _close(tlayers.apply_rope(T(x), T(pos), 1e6),
           rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    dpos = np.array([3, 11], np.int32)
    xd = f(2, 1, 4, 16)
    _close(tlayers.apply_rope(T(xd), T(dpos)[:, None], 1e4),
           rlayers.apply_rope(jnp.asarray(xd), jnp.asarray(dpos)[:, None],
                              1e4))
    k = f(2, 5, 2, 16)
    assert np.array_equal(_np(tlayers.expand_kv(T(k), 4)),
                          np.asarray(rlayers.expand_kv(jnp.asarray(k), 4)))
    sc = f(16)
    _close(tlayers.rms_norm(T(x), T(sc), 1e-6),
           rlayers.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-6))
    q, ck, cv = f(2, 1, 4, 16), f(2, 12, 4, 16), f(2, 12, 4, 16)
    _close(tlayers.decode_attention(T(q), T(ck), T(cv), T(dpos)),
           rlayers.decode_attention(*map(jnp.asarray, (q, ck, cv, dpos))))
    ckf, cvf = f(2, 12, 32), f(2, 12, 32)
    _close(tlayers.decode_attention_gqa(T(q), T(ckf), T(cvf), T(dpos),
                                        groups=2),
           rlayers.decode_attention_gqa(*map(jnp.asarray,
                                             (q, ckf, cvf, dpos)), groups=2))
    p = {"wi": f(16, 24), "wo": f(24, 16)}
    _close(tlayers.mlp_apply({k_: T(v) for k_, v in p.items()}, T(x)),
           rlayers.mlp_apply({k_: jnp.asarray(v) for k_, v in p.items()},
                             jnp.asarray(x)))
    p["wg"] = f(16, 24)
    _close(tlayers.mlp_apply({k_: T(v) for k_, v in p.items()}, T(x)),
           rlayers.mlp_apply({k_: jnp.asarray(v) for k_, v in p.items()},
                             jnp.asarray(x)))


def test_cache_update_in_place_equals_the_masked_update():
    rng = np.random.default_rng(1)
    cache = rng.normal(size=(3, 6, 8)).astype(np.float32)
    new = rng.normal(size=(3, 1, 8)).astype(np.float32)
    pos = np.array([2, 6, 5], np.int32)            # 6 lies outside: no write
    want = rlayers.cache_update(jnp.asarray(cache), jnp.asarray(new),
                                jnp.asarray(pos))
    mine = torch.from_numpy(cache.copy())
    got = tlayers.cache_update(mine, torch.from_numpy(new),
                               torch.from_numpy(pos))
    assert got is mine
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_cross_attention_is_ported():
    """``cross_attn_specs`` and ``cross_attention`` run (they raised
    before the port of the 'X' slots): specs as the reference's, and a
    prefill whose image K and V the layer's decode reads back (the layer
    is held against the reference in ``test_torch_vlm.py``)."""
    rcfg, cfg = _pair("llama-3.2-vision-11b")
    specs = tlayers.cross_attn_specs(cfg)
    assert tparams.axes_tree(specs) == rparams.axes_tree(
        rlayers.cross_attn_specs(rcfg))
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
         for k, v in specs.items()}
    x = torch.from_numpy(rng.normal(size=(1, 3, cfg.d_model)).astype(
        np.float32))
    img = torch.from_numpy(rng.normal(
        size=(1, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    y, cache = tlayers.cross_attention(p, x, img, cfg, mode="prefill")
    assert y.shape == x.shape and sorted(cache) == ["xk", "xv"]
    y1, again = tlayers.cross_attention(p, x[:, -1:], None, cfg,
                                        mode="decode", cache=cache)
    assert again is cache
    torch.testing.assert_close(y1, y[:, -1:], rtol=TOL, atol=TOL)


# -- the decoder -----------------------------------------------------------------------

# full multi-head attention (KV = H), as deepseek-7b's and musicgen-large's
# published configs have: ``reduced_config`` cuts KV to 2 of 4 heads, so
# these cases put it back, and attention takes ``expand_kv``'s early
# return and decode ``groups = 1``
KV_IS_H = {"num_kv_heads": 4}


def _case(arch, S, kv_is_h=False):
    """A (arch, S, overrides) case, its id "<arch>-<S>" or
    "<arch>-kv-is-h-<S>"."""
    return pytest.param(arch, S, KV_IS_H if kv_is_h else {},
                        id=f"{arch}-kv-is-h-{S}" if kv_is_h else f"{arch}-{S}")


_FORWARD_CASES = [_case(a, S) for a, S in (
    ("qwen3-4b", 64), ("qwen3-4b", 23), ("granite-20b", 64),
    ("musicgen-large", 64), ("dbrx-132b", 64), ("dbrx-132b", 23),
    ("deepseek-v3-671b", 64), ("deepseek-v3-671b", 23),
    ("deepseek-7b", 64), ("deepseek-7b", 23), ("command-r-35b", 64),
    ("command-r-35b", 23), ("granite-20b", 23), ("musicgen-large", 23))] + [
    _case("deepseek-7b", 64, kv_is_h=True),
    _case("musicgen-large", 64, kv_is_h=True)]


@pytest.mark.parametrize("arch,S,over", _FORWARD_CASES)
def test_forward_train_matches_reference(arch, S, over):
    """Logits within ``TOL``; aux (the MoE layers' load-balance metric
    summed over layers, 0 without MoE) within 1e-6."""
    rcfg, tcfg, rp, tp = _weights(arch, remat=False, **over)
    assert (tcfg.num_kv_heads == tcfg.num_heads) == bool(over)
    x = _inputs(rcfg, S, (2, S))
    want, _, want_aux = rtf.Model(rcfg)(rp, jnp.asarray(x), mode="train")
    got, caches, aux = ttf.Model(tcfg)(tp, torch.from_numpy(x), mode="train")
    assert caches is None and aux.dtype == torch.float32
    if tcfg.moe is None:
        assert float(aux) == float(want_aux) == 0.0
    else:
        assert abs(float(aux) - float(want_aux)) <= 1e-6 and float(aux) > 0
    assert got.shape == (2, S, tcfg.vocab_size)
    _close(got, want)


# qwen3-4b's cases keep their ids from before dbrx-132b was ported.  The
# dense configs: deepseek-7b (KV = H in its published config), granite-20b
# (one KV head: multi-query decode at groups = H; GELU MLP; tied head),
# command-r-35b (tied head, RoPE theta 4e6) and musicgen-large (frame
# embeddings in, through prefill and decode)
_SERVE_CASES = [pytest.param("qwen3-4b", 64, {}, id="64"),
                pytest.param("qwen3-4b", 23, {}, id="23"),
                pytest.param("dbrx-132b", 64, {}, id="dbrx-132b-64"),
                pytest.param("dbrx-132b", 23, {}, id="dbrx-132b-23"),
                pytest.param("deepseek-v3-671b", 64, {},
                             id="deepseek-v3-671b-64"),
                pytest.param("deepseek-v3-671b", 23, {},
                             id="deepseek-v3-671b-23")] + [
    _case(a, S) for a in ("deepseek-7b", "granite-20b", "command-r-35b",
                          "musicgen-large") for S in (64, 23)] + [
    _case("deepseek-7b", 64, kv_is_h=True),
    _case("musicgen-large", 64, kv_is_h=True)]


@pytest.mark.parametrize("arch,S,over", _SERVE_CASES)
def test_prefill_matches_reference(arch, S, over):
    rcfg, tcfg, rp, tp = _weights(arch, remat=False, **over)
    x = _inputs(rcfg, S, (2, S))
    r_last, r_caches = rengine.make_prefill_step(rcfg)(rp, jnp.asarray(x))
    t_last, t_caches = tengine.make_prefill_step(tcfg)(tp, torch.from_numpy(x))
    _close(t_last, r_last)
    r_leaves = jax.tree.leaves(r_caches)
    t_leaves = tparams.leaves(t_caches)
    assert [tuple(t.shape) for t in t_leaves] == [c.shape for c in r_leaves]
    for got, want in zip(t_leaves, r_leaves):
        _close_cache(tcfg, got, want)


@pytest.mark.parametrize("arch,T,over", _SERVE_CASES)
def test_decode_matches_reference(arch, T, over):
    """prefill(x[:T]) with every sequence axis grown by one, then one
    decode step at position T: logits and caches as the reference's.  An
    embeddings model (musicgen-large) decodes a (2, 1, d) frame."""
    rcfg, tcfg, rp, tp = _weights(arch, remat=False, **over)
    x = _inputs(rcfg, 100 + T, (2, T + 1))
    _, r_caches, _ = rtf.Model(rcfg)(rp, jnp.asarray(x[:, :T]),
                                     mode="prefill")
    # every leaf is (layers, B, T, ...): grow axis 2 alone (with KV = H at
    # T = 64 the last axis, KV * head_dim, is 64 as well)
    assert all(c.shape[2] == T for c in jax.tree.leaves(r_caches))
    r_caches = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 1) if i == 2 else (0, 0)
                              for i in range(c.ndim)]), r_caches)
    t_caches = [{s: {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
                 for s, leaves in seg.items()}
                for seg in jax.tree.map(np.asarray, r_caches)]
    pos = np.full((2,), T, np.int32)
    tok = x[:, T:T + 1]
    r_logits, r_new = rengine.make_decode_step(rcfg)(
        rp, r_caches, jnp.asarray(tok), jnp.asarray(pos))
    t_logits, t_new = tengine.make_decode_step(tcfg)(
        tp, t_caches, torch.from_numpy(tok), torch.from_numpy(pos))
    _close(t_logits, r_logits)
    for got, want in zip(tparams.leaves(t_new), jax.tree.leaves(r_new)):
        _close(got, want)


@pytest.mark.parametrize("arch,T,over", _SERVE_CASES)
def test_decode_matches_full_forward(arch, T, over):
    """The port alone, as ``tests/test_models.py`` holds the reference:
    prefill(x[:T]) + decode(x[T]) logits == forward(x[:T+1])[:, T]; with
    T = 64 the prefill takes the flash path and the full forward (65
    positions, no multiple of the flash block) is given a flash block
    above 65, so that it takes the dense one.  Reduced dbrx's and
    deepseek-v3's capacity factor (5) drops no pair at T, T + 1 or at
    decode, so routing is the same on both sides."""
    _, tcfg, _, tp = _weights(arch, remat=False, **over)
    x = torch.from_numpy(_inputs(tcfg, 200 + T, (2, T + 1)))
    dense = ttf.Model(dataclasses.replace(tcfg, flash_block=128))
    full, _, _ = dense(tp, x, mode="train")
    last, caches = tengine.make_prefill_step(tcfg)(tp, x[:, :T])
    _close(last, full[:, T - 1], 2e-3)
    grown = ttf.init_cache(tcfg, 2, T + 1, device="cpu")
    for one, dst in zip(tparams.leaves(caches), tparams.leaves(grown)):
        dst[:, :, :T] = one
    logits, _ = tengine.make_decode_step(tcfg)(
        tp, grown, x[:, T:T + 1], torch.full((2,), T))
    _close(logits, full[:, T], 2e-3)


def test_greedy_sample_takes_the_first_maximum():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]],
                          dtype=torch.bfloat16)
    got = tengine.greedy_sample(logits)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(rengine.greedy_sample(
        jnp.asarray(logits.float().numpy(), jnp.bfloat16))).tolist() == [1, 0]
