"""The training path of the port (``repro_torch.train``,
``launch/train.py``) vs the reference package, on the CPU.

One state made by the reference (``repro.train.train_step.init_state``)
is carried across with ``interop.state_from_numpy``, and both packages
take a step from it on the same batch (``TokenPipeline``, numpy): reduced
qwen3-4b and reduced repro-100m, S = 64 past their ``flash_block`` of 32
(the flash path: the port's plain scan differentiated by autograd, the
reference's XLA scan by ``jax.value_and_grad``), microbatches 1 and 2.

Tolerances (f32 sums in another order over two layers):
  * loss, ce, lr and grad_norm: 1e-5 relative (``SCALAR_TOL``);
  * every gradient leaf: 1e-4 · max|g_ref| (``GRAD_TOL``);
  * updated parameters: 1e-4 relative to max(|p_ref|, lr)
    (``PARAM_TOL``), plus the gradient tolerance carried through Adam's
    first step (``param_bound``).  That step moves a leaf by
    lr·u/(|u| + eps), u = g·s (s the clip scale): about ±lr·sign(g) where
    |u| ≫ eps, but where |g_ref| lies within the gradient tolerance δ of 0
    the two packages may see opposite signs, so there the allowance is the
    sign allowance 2·lr + wd·lr·|p|; in between, where |u| is within a few
    hundred eps, the move still follows the gradient's rounding, by at
    most lr·δ·eps/(max(|u| − δ, 0) + eps)² (the largest slope of
    u/(|u| + eps) within δ of u), capped at the sign allowance;
  * moments m and v: 1e-4 · max|m_ref|, 1e-4 · max|v_ref|.

Reduced dbrx-132b (the MoE step) and reduced deepseek-v3-671b (MLA,
a dense and an MoE layer) — ``ILL_CONDITIONED`` — are held to the same
tolerances plus a floor taken from the reference alone: twice how far
the reference's own step moves when every weight is moved by at most one
f32 ulp (``_ulp_shifted``).  Its attention has no qk-norm, and at the reduced
config's weights (std 1/sqrt(2)) its scores span about 30, so a one-ulp
shift of the weights moves the reference's gradients by up to 1.9e-4 of
a leaf's largest entry (qwen3-4b's: 1.4e-6); a second f32 summation
order — the port's — lands within that, and the fixed 1e-4 alone would
ask for more than f32 resolves there.  deepseek-v3 has no qk-norm
either: its port step lies up to 1.38e-4 of a leaf's largest entry from
the reference's (a (256, 64) leaf: 7.17e-4 against 1e-4 · max = 5.21e-4),
where one ulp moves the reference by 6.5e-5 of it (floor 6.81e-4).  Each bound adds the floor of its
own quantity (a gradient leaf's, a metric's, a moment's largest shift;
for parameters the gradient floor carried through ``param_bound``).

Then the substrate of ``tests/test_train_substrate.py`` ported: schedule,
loss descent, data, compression (int8 and top-k equal to the reference's
on the same arrays; top-k on data without ties, since ``torch.topk`` and
``lax.top_k`` may break ties differently), the preemption guard, the
straggler watchdog (on given durations: ``time.perf_counter`` of the
port's module is replaced), and checkpoints in both directions, bf16
included.  The reference's jitted steps are built once per module.
"""
import dataclasses
import io
import json
import re
import signal
import os
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.launch import train as rlaunch
from repro.train import checkpoint as rckpt
from repro.train import compression as rcomp
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro.train.data import TokenPipeline as RPipeline

from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import train as tlaunch
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train import tree
from repro_torch.train.data import TokenPipeline as TPipeline

SCALAR_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-4
MOMENT_TOL = 1e-4
ARCHS = ("qwen3-4b", "repro-100m", "dbrx-132b", "deepseek-v3-671b")
ILL_CONDITIONED = ("dbrx-132b", "deepseek-v3-671b")
FLOOR_TIMES = 2
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50)
SEQ, BATCH = 64, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, **overrides):
    return (rbase.reduced_config(rreg.get_config(arch), **overrides),
            tbase.reduced_config(treg.get_config(arch), **overrides))


def _batch(cfg, step=0, batch=BATCH, seq=SEQ, seed=1):
    return RPipeline(cfg.vocab_size, seq, batch, seed=seed).batch_at(step)


def _ref_grads(rcfg, params, batch, microbatches):
    """The reference's gradient, as its train step forms it: one
    ``value_and_grad`` or a sum over microbatch slices divided by their
    count (f32 configs: the sum starts at f32 zeros)."""
    loss_fn = rts.make_loss_fn(rcfg, rts.Model(rcfg))
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    rows = batch["inputs"].shape[0] // microbatches
    total = None
    for i in range(microbatches):
        mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
              for k, v in batch.items()}
        _, g = vg(params, mb)
        total = g if total is None else jax.tree.map(jnp.add, total, g)
    return jax.tree.map(lambda g: np.asarray(g / microbatches), total)


_STEPS = {}


def _ulp_shifted(params, seed=0):
    """Every f32 weight moved one ulp up, one down, or left, at random."""
    rng = np.random.default_rng(seed)

    def shift(a):
        a = np.asarray(a)
        way = rng.integers(-1, 2, size=a.shape)
        toward = np.where(way > 0, np.inf, -np.inf).astype(a.dtype)
        return jnp.asarray(np.where(way == 0, a, np.nextafter(a, toward)))
    return jax.tree.map(shift, params)


def _floors(arch, rcfg, state, batch, microbatches, grads, new, metrics,
            step):
    """Per quantity, ``FLOOR_TIMES`` (2) times how far the reference's
    own step moves when its weights are moved by one ulp: each of two
    runs carries rounding of about one such shift, so they may lie two
    apart (``ILL_CONDITIONED`` archs; zeros for the others)."""
    zero = {"grads": [0.0] * len(jax.tree.leaves(grads)),
            "metrics": {k: 0.0 for k in metrics},
            "m": [0.0] * len(jax.tree.leaves(new["opt"]["m"])),
            "v": [0.0] * len(jax.tree.leaves(new["opt"]["v"]))}
    if arch not in ILL_CONDITIONED:
        return zero
    shifted = dict(state, params=_ulp_shifted(state["params"]))
    g2 = _ref_grads(rcfg, shifted["params"], batch, microbatches)
    new2, metrics2 = step(shifted, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    far = lambda a, b: [FLOOR_TIMES * float(np.abs(
        np.asarray(x) - np.asarray(y)).max()) for x, y in zip(
            jax.tree.leaves(a), jax.tree.leaves(b))]  # noqa: E731
    return {"grads": far(grads, g2),
            "metrics": {k: FLOOR_TIMES * abs(float(metrics2[k]) - v)
                        for k, v in metrics.items()},
            "m": far(new["opt"]["m"], new2["opt"]["m"]),
            "v": far(new["opt"]["v"], new2["opt"]["v"])}


def reference_step(arch, microbatches):
    """The reference's state, batch, gradient and one jitted step from
    that state, and the floors of ``_floors`` (computed once per
    module)."""
    key = (arch, microbatches)
    if key not in _STEPS:
        rcfg, tcfg = _pair(arch)
        ropt_cfg = ropt.OptConfig(**OPT)
        state = rts.init_state(rcfg, ropt_cfg, jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, state)
        batch = _batch(rcfg)
        grads = _ref_grads(rcfg, state["params"], batch, microbatches)
        step = jax.jit(rts.make_train_step(rcfg, ropt_cfg, microbatches))
        new, metrics = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        new = jax.tree.map(np.asarray, new)
        metrics = {k: float(v) for k, v in metrics.items()}
        _STEPS[key] = dict(rcfg=rcfg, tcfg=tcfg, host=host, batch=batch,
                           grads=grads, new=new, metrics=metrics,
                           floor=_floors(arch, rcfg, state, batch,
                                         microbatches, grads, new, metrics,
                                         step))
    return _STEPS[key]


def _port_state(ref):
    return interop.state_from_numpy(ref["tcfg"], topt.OptConfig(**OPT),
                                    ref["host"], "cpu")


def _leaf_pairs(ref_tree, port_tree):
    want = jax.tree.leaves(ref_tree)
    got = tree.leaves(port_tree)
    assert len(want) == len(got)
    return list(zip(want, got))


def param_bound(p_ref, g_ref, lr, scale, wd=0.1, eps=1e-8, floor=0.0,
                p_got=None):
    """How far an updated parameter of the port may lie from the
    reference's after Adam's first step (see the module docstring):
    ``PARAM_TOL`` relative, plus the gradient tolerance δ = s·(GRAD_TOL ·
    max|g| + floor) carried through lr·u/(|u| + eps), capped at the sign
    allowance 2·lr + wd·lr·|p|.  Returns (bound, a mask of the cells
    where the cap binds — with a floor, of those where ``p_got`` needs
    it)."""
    delta = scale * (GRAD_TOL * np.abs(g_ref).max() + floor)
    u = np.abs(g_ref) * scale
    moved = lr * delta * eps / (np.maximum(u - delta, 0.0) + eps) ** 2
    sign_allowance = 2 * lr + wd * lr * np.abs(p_ref)
    capped = moved >= sign_allowance
    bound = PARAM_TOL * np.maximum(np.abs(p_ref), lr) + \
        np.minimum(moved, sign_allowance)
    if floor:
        # the floor widens δ, so the cap binds on more cells (6 % on
        # reduced dbrx); count only those whose difference needs it
        return bound, capped & (np.abs(p_got - p_ref) > bound - np.where(
            capped, sign_allowance, 0.0))
    return bound, capped


def _close_scalar(got, want, what, floor=0.0):
    assert abs(float(got) - want) <= SCALAR_TOL * abs(want) + floor, \
        (what, float(got), want, floor)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, microbatches):
    ref = reference_step(arch, microbatches)
    state = _port_state(ref)
    loss, ce, grads = tts.make_grad_fn(ref["tcfg"], microbatches)(
        state["params"], ref["batch"])
    floor = ref["floor"]
    _close_scalar(ce, ref["metrics"]["ce"], "ce", floor["metrics"]["ce"])
    _close_scalar(loss, ref["metrics"]["loss"], "loss",
                  floor["metrics"]["loss"])
    for (want, got), fl in zip(_leaf_pairs(ref["grads"], grads),
                               floor["grads"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max() + fl)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_embedding_inputs_leave_the_token_table_a_zero_gradient(
        microbatches):
    """Reduced musicgen-large on (B, S, d) embedding inputs never reads
    its token table: ``jax.grad`` gives it zeros, and so must the port
    (``torch.autograd.grad`` alone refuses a leaf the loss does not use);
    the other leaves within ``GRAD_TOL``."""
    rcfg, tcfg = _pair("musicgen-large")
    params = rts.Model(rcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"inputs": rng.standard_normal(
                 (BATCH, SEQ, rcfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, rcfg.vocab_size,
                                    (BATCH, SEQ)).astype(np.int32)}
    want = _ref_grads(rcfg, params, batch, microbatches)
    port = interop.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                     "cpu")
    for p in tree.leaves(port):
        p.requires_grad_(True)
    _, _, got = tts.make_grad_fn(tcfg, microbatches)(port, batch)
    assert not np.any(want["embed"])
    assert got["embed"].shape == want["embed"].shape
    assert not torch.any(got["embed"])
    for w, g in _leaf_pairs(want, got):
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    """One step of both packages from one state: metrics, the updated
    parameters (within ``param_bound``; the sign allowance binds on under
    1 % of them — with a floor, is needed on under 1 %), the moments and
    the step."""
    ref = reference_step(arch, microbatches)
    step = tts.make_train_step(ref["tcfg"], topt.OptConfig(**OPT),
                               microbatches)
    new, metrics = step(_port_state(ref), ref["batch"])
    floor = ref["floor"]
    for k in ("loss", "ce", "lr", "grad_norm"):
        _close_scalar(metrics[k], ref["metrics"][k], k, floor["metrics"][k])
    lr = ref["metrics"]["lr"]
    scale = min(1.0, 1.0 / ref["metrics"]["grad_norm"])       # clip_norm 1
    grads = jax.tree.leaves(ref["grads"])
    pairs = _leaf_pairs(ref["new"]["params"], new["params"])
    capped = 0
    for (want, got), g, fl in zip(pairs, grads, floor["grads"]):
        got = _np(got)
        bound, cells = param_bound(want, g, lr, scale, floor=fl, p_got=got)
        assert (np.abs(got - want) <= bound).all(), \
            float((np.abs(got - want) / bound).max())
        capped += int(cells.sum())
    assert capped < sum(g.size for g in grads) // 100
    for name in ("m", "v"):
        for (want, got), fl in zip(_leaf_pairs(ref["new"]["opt"][name],
                                               new["opt"][name]),
                                   floor[name]):
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=MOMENT_TOL * np.abs(want).max()
                                       + fl)
    assert int(new["opt"]["step"]) == int(ref["new"]["opt"]["step"]) == 1
    assert new["opt"]["step"].dtype == torch.int32
    # the update is in place: the step returns the tensors it was given
    assert all(p.requires_grad for p in tree.leaves(new["params"]))


def test_remat_gives_the_gradients_of_the_plain_forward():
    ref = reference_step("qwen3-4b", 1)
    tcfg = ref["tcfg"]
    assert tcfg.remat
    params = _port_state(ref)["params"]
    _, _, with_remat = tts.make_grad_fn(tcfg)(params, ref["batch"])
    _, _, without = tts.make_grad_fn(dataclasses.replace(
        tcfg, remat=False))(params, ref["batch"])
    for a, b in zip(tree.leaves(with_remat), tree.leaves(without)):
        assert torch.equal(a, b)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With remat, every attention layer runs once in the forward and once
    more in the backward; without it, once."""
    from repro_torch.models import layers as tlayers
    ref = reference_step("qwen3-4b", 1)
    calls = []
    real = tlayers.attention

    def counting(*a, **kw):
        calls.append(kw["mode"])
        return real(*a, **kw)

    monkeypatch.setattr(tlayers, "attention", counting)
    params = _port_state(ref)["params"]
    for remat, want in ((True, 2), (False, 1)):
        calls.clear()
        cfg = dataclasses.replace(ref["tcfg"], remat=remat)
        tts.make_grad_fn(cfg)(params, ref["batch"])
        assert calls == ["train"] * (want * cfg.num_layers)


def test_loss_decreases():
    _, tcfg = _pair("qwen3-4b", num_layers=2)
    oc = topt.OptConfig(**OPT)
    state = tts.init_state(tcfg, oc, 0, device="cpu")
    step = tts.make_train_step(tcfg, oc, 1)
    pipe = TPipeline(tcfg.vocab_size, 16, 4, seed=1)
    losses = []
    for i in range(25):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::6]
    assert np.isfinite(losses).all()


def test_microbatching_matches_full_batch():
    _, tcfg = _pair("qwen3-4b", num_layers=2)
    oc = topt.OptConfig(**OPT)
    b = TPipeline(tcfg.vocab_size, 16, 4, seed=1).batch_at(0)
    s1, m1 = tts.make_train_step(tcfg, oc, 1)(
        tts.init_state(tcfg, oc, 0, device="cpu"), b)
    s2, m2 = tts.make_train_step(tcfg, oc, 2)(
        tts.init_state(tcfg, oc, 0, device="cpu"), b)
    assert abs(float(m1["ce"]) - float(m2["ce"])) < 5e-3
    np.testing.assert_allclose(_np(tree.leaves(s1["params"])[0]),
                               _np(tree.leaves(s2["params"])[0]),
                               rtol=1e-2, atol=1e-4)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 99, 100, 150])
def test_schedule_equals_reference(step):
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100), OPT, {}):
        want = float(ropt.schedule(ropt.OptConfig(**kw), jnp.asarray(step)))
        got = topt.schedule(topt.OptConfig(**kw), torch.tensor(step))
        assert got.dtype == torch.float32
        assert float(got) == want, (kw, step)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_update_equals_reference_and_stays_in_place(state_dtype, monkeypatch):
    """AdamW on random leaves (a stacked 3-D one, a matrix, a vector) with
    f32 or bf16 moments vs the reference's ``update``, on whole leaves and
    in chunks of 7 elements; the tensors passed in are the ones updated
    and returned.  bf16 moments within one bf16 rounding (2^-7 relative:
    the f32 values may differ in their last bit before the rounding)."""
    rng = np.random.default_rng(3)
    shapes = {"stack": (3, 5, 6), "w": (9, 4), "b": (11,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: rng.normal(size=s).astype(np.float32) * 0.3
             for k, s in shapes.items()}
    m = {k: rng.normal(size=s).astype(np.float32) * 0.01
         for k, s in shapes.items()}
    v = {k: rng.random(size=s).astype(np.float32) * 0.01
         for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=50, clip_norm=0.5,
              state_dtype=state_dtype)
    jdt = jnp.dtype(state_dtype)
    rstate = {"m": jax.tree.map(lambda x: jnp.asarray(x, jdt), m),
              "v": jax.tree.map(lambda x: jnp.asarray(x, jdt), v),
              "step": jnp.asarray(4, jnp.int32)}
    rp, rs, rstats = ropt.update(ropt.OptConfig(**kw),
                                 jax.tree.map(jnp.asarray, grads), rstate,
                                 jax.tree.map(jnp.asarray, params))
    tdt = getattr(torch, state_dtype)
    for chunk in (topt.CHUNK, 7):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        tp = {k: torch.from_numpy(x.copy()) for k, x in params.items()}
        tstate = {"m": {k: torch.from_numpy(x.copy()).to(tdt)
                        for k, x in m.items()},
                  "v": {k: torch.from_numpy(x.copy()).to(tdt)
                        for k, x in v.items()},
                  "step": torch.tensor(4, dtype=torch.int32)}
        ids = [id(x) for x in tree.leaves((tp, tstate["m"], tstate["v"]))]
        out_p, out_s, stats = topt.update(
            topt.OptConfig(**kw), {k: torch.from_numpy(x)
                                   for k, x in grads.items()}, tstate, tp)
        assert [id(x) for x in tree.leaves(
            (out_p, out_s["m"], out_s["v"]))] == ids
        assert int(out_s["step"]) == 5
        _close_scalar(stats["lr"], float(rstats["lr"]), "lr")
        _close_scalar(stats["grad_norm"], float(rstats["grad_norm"]),
                      "grad_norm")
        for want, got in _leaf_pairs(rp, out_p):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        for name in ("m", "v"):
            for want, got in _leaf_pairs(rs[name], out_s[name]):
                assert got.dtype == tdt
                np.testing.assert_allclose(
                    _np(got), np.asarray(want, np.float32),
                    **(dict(rtol=1e-5, atol=1e-7) if state_dtype == "float32"
                       else dict(rtol=2.0 ** -7, atol=0)))


def test_chunks_never_span_more_than_chunk(monkeypatch):
    monkeypatch.setattr(topt, "CHUNK", 16)
    x = torch.zeros((3, 5, 7))
    parts = list(topt._chunks(x))
    assert [p.numel() for p in parts] == [16] * 6 + [9]
    assert all(p.untyped_storage().data_ptr() ==
               x.untyped_storage().data_ptr() for p in parts)


def test_init_state_marks_parameters_and_zero_moments():
    _, tcfg = _pair("qwen3-4b")
    state = tts.init_state(tcfg, topt.OptConfig(state_dtype="bfloat16"), 0,
                           device="cpu")
    params = tree.leaves(state["params"])
    assert params and all(p.requires_grad for p in params)
    for name in ("m", "v"):
        moments = tree.leaves(state["opt"][name])
        assert [x.shape for x in moments] == [p.shape for p in params]
        assert all(x.dtype == torch.bfloat16 and not x.any()
                   for x in moments)
    assert state["opt"]["step"].dtype == torch.int32


def test_serving_parameters_build_no_graph():
    """``Model.init`` (serving) keeps plain tensors: a prefill builds no
    autograd graph, so on the card it takes K9's plain launch, never
    ``FlashAttention``."""
    from repro_torch.models.transformer import Model
    _, tcfg = _pair("qwen3-4b")
    params = Model(tcfg).init(0, device="cpu")
    assert not any(p.requires_grad for p in tree.leaves(params))
    logits, _, _ = Model(tcfg)(params, np.zeros((1, 64), np.int32),
                               mode="prefill")
    assert logits.grad_fn is None


def test_init_state_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _pair("qwen3-4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tts.init_state(tcfg, topt.OptConfig(), 0)


# -- data, compression, fault tolerance --------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (1000, 32, 4, 3, 5), (256, 64, 4, 1, 0), (50304, 128, 8, 0, 17),
    (151936, 16, 2, 7, 123)])
def test_data_batches_equal_reference(vocab, seq, batch, seed, step):
    want = RPipeline(vocab, seq, batch, seed=seed).batch_at(step)
    got = TPipeline(vocab, seq, batch, seed=seed).batch_at(step)
    assert sorted(got) == sorted(want) == ["inputs", "labels"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_deterministic_and_seekable():
    p1 = TPipeline(1000, 32, 4, seed=3)
    p2 = TPipeline(1000, 32, 4, seed=3)
    b5 = p1.batch_at(5)
    np.testing.assert_array_equal(b5["inputs"], p2.batch_at(5)["inputs"])
    assert not np.array_equal(b5["inputs"], p1.batch_at(6)["inputs"])
    it = iter(p1)
    np.testing.assert_array_equal(next(it)["labels"],
                                  p2.batch_at(0)["labels"])


@pytest.mark.parametrize("shape,block", [((64, 64), 256), ((1000,), 256),
                                         ((7, 9, 5), 16), ((3,), 256)])
def test_int8_quantization_equals_reference(shape, block):
    rng = np.random.default_rng(sum(shape) + block)
    x = rng.normal(size=shape).astype(np.float32) * 3
    x.reshape(-1)[::17] = np.round(x.reshape(-1)[::17])   # halves, integers
    want = rcomp.quantize_int8(jnp.asarray(x), block)
    got = tcomp.quantize_int8(torch.from_numpy(x), block)
    assert got.shape == want.shape == shape
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tcomp.dequantize_int8(got).numpy(),
                                  np.asarray(rcomp.dequantize_int8(want)))


def test_round_half_to_even_as_jnp():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


@pytest.mark.parametrize("n,frac", [(1024, 0.01), (5000, 0.05), (10, 0.01)])
def test_topk_equals_reference_without_ties(n, frac):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    assert len(np.unique(np.abs(x))) == n              # no ties
    want = rcomp.topk_sparsify(jnp.asarray(x), frac)
    got = tcomp.topk_sparsify(torch.from_numpy(x), frac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_with_feedback_equals_reference(scheme):
    rng = np.random.default_rng(5)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": [rng.normal(size=(300,)).astype(np.float32)]}
    r = {"w": rng.normal(size=(64, 64)).astype(np.float32) * 0.01,
         "b": [np.zeros((300,), np.float32)]}
    wg, wr = rcomp.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                          jax.tree.map(jnp.asarray, r),
                                          scheme)
    tg, trr = tcomp.compress_with_feedback(
        tree.map(torch.from_numpy, g), tree.map(torch.from_numpy, r), scheme)
    for want, got in _leaf_pairs(wg, tg) + _leaf_pairs(wr, trr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [x.shape for x in tree.leaves(tcomp.init_residuals(tg))] == \
        [tuple(x.shape) for x in jax.tree.leaves(rcomp.init_residuals(wg))]


def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    r = tcomp.init_residuals(g)
    approx, r = tcomp.compress_with_feedback(g, r, "int8")
    rel = float(torch.linalg.norm(approx["w"] - g["w"])
                / torch.linalg.norm(g["w"]))
    assert rel < 0.02
    np.testing.assert_allclose(r["w"].numpy(),
                               (g["w"] - approx["w"]).numpy(), atol=1e-6)
    total = torch.zeros_like(g["w"])
    r = tcomp.init_residuals(g)
    for _ in range(8):
        a, r = tcomp.compress_with_feedback(g, r, "int8")
        total = total + a["w"]
    np.testing.assert_allclose((total / 8).numpy(), g["w"].numpy(),
                               atol=5e-3)


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
@pytest.mark.parametrize("n", [1, 255, 1024, 100_001])
def test_wire_bytes_equal_reference(scheme, n):
    want = rcomp.wire_bytes(jnp.zeros((n,)), scheme)
    assert tcomp.wire_bytes(torch.zeros((n,)), scheme) == want
    if n == 1024:
        assert tcomp.wire_bytes(torch.zeros(n), "int8") < \
            0.3 * tcomp.wire_bytes(torch.zeros(n), "none")


def test_preemption_guard():
    g = tft.PreemptionGuard(signals=(signal.SIGUSR1,))
    assert not g.requested
    os.kill(os.getpid(), signal.SIGUSR1)
    assert g.requested
    g.restore_handlers()


def test_step_watchdog_flags_stragglers_on_given_durations(monkeypatch):
    """Durations are given, not slept: ``perf_counter`` of the port's
    module returns a scripted clock."""
    clock = iter(np.cumsum([0.0, 0.003] * 8 + [0.0, 0.1] + [0.0, 0.004]))
    monkeypatch.setattr(tft.time, "perf_counter", lambda: float(next(clock)))
    w = tft.StepWatchdog(threshold_x=3.0, window=16)
    for i in range(8):
        w.start()
        w.stop(i)
    assert not w.straggler_events
    w.start()
    assert w.stop(99) == pytest.approx(0.1)
    w.start()
    w.stop(100)
    assert [e[0] for e in w.straggler_events] == [99]
    assert w.straggler_events[0][2] == pytest.approx(0.003)


# -- checkpoints --------------------------------------------------------------------------

def _bits(x):
    """The leaf's bytes as numpy: bf16 as int16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same_bits(ref_tree, port_tree):
    for want, got in _leaf_pairs(ref_tree, port_tree):
        w, g = _bits(want), _bits(got)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _stepped(arch="qwen3-4b", **overrides):
    """A reference state after one step (nonzero moments) and the port's
    copy of it."""
    state_dtype = overrides.pop("state_dtype", "float32")
    rcfg, tcfg = _pair(arch, **overrides)
    kw = dict(OPT, state_dtype=state_dtype)
    state = rts.init_state(rcfg, ropt.OptConfig(**kw), jax.random.PRNGKey(2))
    state, _ = jax.jit(rts.make_train_step(rcfg, ropt.OptConfig(**kw)))(
        state, {k: jnp.asarray(v) for k, v in _batch(rcfg, seq=16).items()})
    return rcfg, tcfg, kw, state


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    rcfg, tcfg, kw, state = _stepped()
    rckpt.save(tmp_path, 3, state)
    like = tts.init_state(tcfg, topt.OptConfig(**kw), 5, device="cpu")
    got, s = tckpt.restore_latest(tmp_path, like)
    assert s == 3
    _assert_same_bits(state, got)
    assert all(p.requires_grad for p in tree.leaves(got["params"]))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rcfg, tcfg, kw, state = _stepped()
    port = interop.state_from_numpy(tcfg, topt.OptConfig(**kw),
                                    jax.tree.map(np.asarray, state), "cpu")
    port, _ = tts.make_train_step(tcfg, topt.OptConfig(**kw))(
        port, _batch(rcfg, step=1, seq=16))
    tckpt.save(tmp_path, 4, port)
    like = rts.init_state(rcfg, ropt.OptConfig(**kw), jax.random.PRNGKey(9))
    got, s = rckpt.restore_latest(tmp_path, like)
    assert s == 4
    _assert_same_bits(got, port)


def test_checkpoint_files_are_byte_equal_in_both_packages(tmp_path):
    """The same state written by each package: the manifest (tree
    structure as ``jax.tree.structure`` prints it, shapes, dtypes) and
    every ``arr_<i>.npy`` are the same bytes."""
    rcfg, tcfg, kw, state = _stepped(param_dtype="bfloat16",
                                     state_dtype="bfloat16")
    port = interop.state_from_numpy(tcfg, topt.OptConfig(**kw),
                                    jax.tree.map(np.asarray, state), "cpu")
    rckpt.save(tmp_path / "ref", 2, state, extra={"note": "x"})
    tckpt.save(tmp_path / "port", 2, port, extra={"note": "x"})
    ref_dir, port_dir = tmp_path / "ref" / "step_2", tmp_path / "port" / "step_2"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    for name in names:
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(), \
            name
    meta = json.loads((port_dir / "manifest.json").read_text())
    assert {x["dtype"] for x in meta["leaves"]} == {"bfloat16", "int32"}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_state_restores_in_the_port_and_not_in_the_reference(
        tmp_path, writer):
    """bf16 parameters and moments: the files of either package restore in
    the port bit for bit; the reference's own restore raises on the same
    files (numpy loads ``<V2`` as 2-byte voids and cannot cast them to
    ml_dtypes' bf16: ROADMAP queue 3)."""
    rcfg, tcfg, kw, state = _stepped(param_dtype="bfloat16",
                                     state_dtype="bfloat16")
    assert {str(x.dtype) for x in jax.tree.leaves(state["params"])} == \
        {"bfloat16"}
    if writer == "reference":
        rckpt.save(tmp_path, 1, state)
    else:
        tckpt.save(tmp_path, 1, interop.state_from_numpy(
            tcfg, topt.OptConfig(**kw), jax.tree.map(np.asarray, state),
            "cpu"))
    like = tts.init_state(tcfg, topt.OptConfig(**kw), 0, device="cpu")
    got, s = tckpt.restore_latest(tmp_path, like)
    assert s == 1
    assert tree.leaves(got["params"])[0].dtype == torch.bfloat16
    _assert_same_bits(state, got)
    with pytest.raises(ValueError, match="No cast function available"):
        rckpt.restore_latest(tmp_path, state)


def test_v2_bits_do_not_restore_into_a_non_bf16_leaf(tmp_path):
    rcfg, tcfg, kw, state = _stepped(param_dtype="bfloat16",
                                     state_dtype="bfloat16")
    rckpt.save(tmp_path, 1, state)
    like = tts.init_state(tcfg, topt.OptConfig(**OPT), 0, device="cpu")
    with pytest.raises(TypeError, match="bf16 leaf only"):
        tckpt.restore(tmp_path, 1, like)


def test_restore_refuses_a_state_of_another_structure(tmp_path):
    tckpt.save(tmp_path, 1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="2 leaves"):
        tckpt.restore(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaf 1 has shape"):
        tckpt.restore(tmp_path, 1, {"a": torch.zeros(3), "b": torch.zeros(4)})


def test_crash_mid_save_keeps_previous(tmp_path):
    _, tcfg = _pair("qwen3-4b")
    state = tts.init_state(tcfg, topt.OptConfig(**OPT), 0, device="cpu")
    tckpt.save(tmp_path, 1, state)
    (tmp_path / "step_2.tmp").mkdir()
    (tmp_path / "step_2.tmp" / "arr_0.npy").write_bytes(b"garbage")
    assert tckpt.latest_step(tmp_path) == 1
    restored, s = tckpt.restore_latest(tmp_path, state)
    assert s == 1
    _assert_same_bits(state, restored)
    # a save of step 2 replaces the stale directory and commits
    tckpt.save(tmp_path, 2, state)
    assert tckpt.latest_step(tmp_path) == 2
    assert not (tmp_path / "step_2.tmp").exists()


def test_resume_or_init(tmp_path):
    _, tcfg = _pair("qwen3-4b")
    state = tts.init_state(tcfg, topt.OptConfig(**OPT), 0, device="cpu")
    got, start = tft.resume_or_init(tmp_path, lambda: state)
    assert start == 0 and got is state
    tckpt.save(tmp_path, 7, state)
    got, start = tft.resume_or_init(tmp_path, lambda: state)
    assert start == 7
    _assert_same_bits(state, got)


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    _, tcfg = _pair("qwen3-4b")
    state = tts.init_state(tcfg, topt.OptConfig(**OPT), 0, device="cpu")
    want = [x.detach().clone() for x in tree.leaves(state)]
    w = tckpt.AsyncCheckpointer(tmp_path)
    w.save(5, state)
    with torch.no_grad():                  # the train loop steps in place
        for x in tree.leaves(state["params"]):
            x.add_(1.0)
    w.save(10, state)                      # waits for the previous
    w.wait()
    assert tckpt.latest_step(tmp_path) == 10
    at5 = tckpt.restore(tmp_path, 5, state)
    for a, b in zip(tree.leaves(at5), want):
        assert torch.equal(a.detach(), b)


def test_async_checkpointer_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    w = tckpt.AsyncCheckpointer(blocker)        # not a directory
    w.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        w.wait()


def test_restore_onto_shardings_and_elastic_reshard_place_shards(
        tmp_path):
    """A reduced qwen3-4b state saved, then ``elastic_reshard`` onto a
    (2, 2) CPU slot mesh and ``restore(shardings=)`` onto a (1, 4) one:
    each leaf a ``ShardedTensor`` whose slots hold their blocks of the
    saved leaf, views of one tensor."""
    from repro_torch.distributed import meshes
    from repro_torch.launch import mesh as tmesh
    cfg = tbase.reduced_config(treg.get_config("qwen3-4b"))
    state = tts.init_state(cfg, topt.OptConfig(), 0, device="cpu")
    tckpt.save(tmp_path, 1, state)
    want = tree.leaves(state)
    grid = tmesh.make_host_mesh((2, 2), ("data", "model"), device="cpu")
    line = tmesh.make_host_mesh((1, 4), ("data", "model"), device="cpu")
    got = [tft.elastic_reshard(tmp_path, 1, state, tts.state_axes(cfg),
                               grid),
           tckpt.restore(tmp_path, 1, state, shardings=meshes.tree_shardings(
               tts.state_axes(cfg), state, line))]
    for placed, mesh in zip(got, (grid, line)):
        for leaf, w in zip(tree.leaves(placed), want):
            assert isinstance(leaf, meshes.ShardedTensor)
            base = leaf.shards[0].untyped_storage().data_ptr()
            for slot, shard in enumerate(leaf.shards):
                assert shard.untyped_storage().data_ptr() == base
                assert torch.equal(shard, w.detach()[meshes.shard_slices(
                    tuple(w.shape), leaf.spec, mesh, slot)])
            assert torch.equal(leaf.gather(), w.detach())


def test_tree_order_and_description_are_jax_s():
    t = {"b": [1, (2, 3)], "a": {"x": 4, "c": None}, "opt": {"step": 5}}
    leaves, structure = tree.flatten(t)
    assert leaves == jax.tree.leaves(t)
    assert tree.describe(structure) == str(jax.tree.structure(t))
    assert tree.unflatten(structure, leaves) == t


# -- the training CLI ---------------------------------------------------------------------

_NUMBER = re.compile(r"\d+(\.\d+)?(e[-+]\d+)?")


def _run_cli(main, argv):
    """(losses, stdout lines) of a CLI run; the watchdog's straggler line
    depends on the host's timing and is dropped."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = main(argv)
    return losses, [x for x in buf.getvalue().splitlines()
                    if not x.startswith("straggler steps:")]


def test_train_cli_prints_the_reference_lines_and_resumes(tmp_path):
    """``repro_torch.launch.train.main`` on the CPU beside the reference's
    CLI at the same flags: the same lines with their numbers masked (and
    the same ``arch=… params=…`` line), then a restart in the same
    directory that resumes from the last checkpoint."""
    argv = ["--reduced", "--steps", "6", "--batch", "2", "--seq", "64",
            "--ckpt-every", "3", "--log-every", "2"]
    ref_losses, ref_lines = _run_cli(
        rlaunch.main, argv + ["--ckpt-dir", str(tmp_path / "ref")])
    losses, lines = _run_cli(
        tlaunch.main, argv + ["--ckpt-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    assert len(losses) == len(ref_losses) == 6
    assert np.isfinite(losses).all()
    assert lines[0] == ref_lines[0] == \
        "arch=repro-100m params=0.1M tokens/step=128"
    assert [_NUMBER.sub("#", x) for x in lines] == \
        [_NUMBER.sub("#", x) for x in ref_lines]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["step_3", "step_6"]
    losses, lines = _run_cli(
        tlaunch.main, argv[:1] + ["--steps", "8"] + argv[3:]
        + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert lines[0] == "resumed from step 6" and len(losses) == 2
    assert lines[-1].startswith("final loss ")


def test_train_cli_trains_dbrx_like_the_reference(tmp_path):
    """``--arch dbrx-132b --reduced``: the MoE model through both CLIs, the
    same line skeletons and the same ``arch=… params=…`` line, and a
    finite loss with the aux term in it."""
    argv = ["--arch", "dbrx-132b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "64", "--log-every", "1"]
    ref_losses, ref_lines = _run_cli(rlaunch.main, argv)
    losses, lines = _run_cli(tlaunch.main, argv + ["--device", "cpu"])
    assert len(losses) == len(ref_losses) == 3 and np.isfinite(losses).all()
    assert lines[0] == ref_lines[0]
    assert lines[0].startswith("arch=dbrx-132b params=")
    assert [_NUMBER.sub("#", x) for x in lines] == \
        [_NUMBER.sub("#", x) for x in ref_lines]


def test_train_cli_without_device_raises_where_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--reduced", "--steps", "1"])
