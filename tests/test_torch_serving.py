"""The port's continuous batcher and serving CLI vs the reference's.

Both packages serve the same prompts (numpy, from a seed) with the same
weights (the reference's, carried across with
``interop.params_from_numpy``) on reduced qwen3-4b in f32, two layers, as
``tests/test_serving.py`` does.  The logits of every prefill and every
decode step are compared first (tolerance 1e-4, relative and absolute:
f32 sums in another order), then the generated tokens (exactly).  Prompts
of 64 and 96 tokens take the flash path of the prefill (``flash_block``
is 32), the others the dense one.  The serving CLIs are compared line for
line at qwen3-4b, dbrx-132b, deepseek-7b, granite-20b and command-r-35b;
musicgen-large takes frame embeddings, which both batchers refuse.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import reduced_config as r_reduced
from repro.configs.registry import get_config as r_get
from repro.launch import serve as rserve
from repro.models.transformer import Model as RModel
from repro.serve.batching import ContinuousBatcher as RBatcher
from repro.serve.batching import Request as RRequest

from repro_torch import interop
from repro_torch.configs.base import reduced_config as t_reduced
from repro_torch.configs.registry import get_config as t_get
from repro_torch.launch import serve as tserve
from repro_torch.models.transformer import Model as TModel
from repro_torch.serve.batching import ContinuousBatcher as TBatcher
from repro_torch.serve.batching import GraphedDecode
from repro_torch.serve.batching import Request as TRequest

RCFG = r_reduced(r_get("qwen3-4b"), num_layers=2, remat=False)
TCFG = t_reduced(t_get("qwen3-4b"), num_layers=2, remat=False)
# the MoE model: reduced dbrx-132b (4 experts, top-2, capacity factor 5,
# which drops nothing at these prompts)
MOE_CFGS = (r_reduced(r_get("dbrx-132b"), num_layers=2, remat=False),
            t_reduced(t_get("dbrx-132b"), num_layers=2, remat=False))
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    params = RModel(RCFG).init(jax.random.PRNGKey(0))
    return params, interop.params_from_numpy(
        TCFG, jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def moe_weights():
    params = RModel(MOE_CFGS[0]).init(jax.random.PRNGKey(0))
    return params, interop.params_from_numpy(
        MOE_CFGS[1], jax.tree.map(np.asarray, params), "cpu")


class _Recorded:
    """Wraps a batcher's prefill model and decode step so that every
    logit row it hands the sampler is kept, in order."""

    def __init__(self, batcher):
        self.prefill, self.decode = [], []
        model, decode = batcher.model, batcher.decode

        def prefill_call(params, prompt, **kw):
            out = model(params, prompt, **kw)
            self.prefill.append(np.asarray(out[0][0, -1], np.float32))
            return out

        def decode_call(*args):
            out = decode(*args)
            self.decode.append(np.asarray(out[0], np.float32))
            return out

        batcher.model, batcher.decode = prefill_call, decode_call


def _serve(weights, prompts, *, slots, capacity, max_new, eos=None,
           cfgs=(RCFG, TCFG)):
    """Serve ``prompts`` with both packages; returns both batchers and
    their recorded logits."""
    out = []
    for Batcher, Request, params, kw in (
            (RBatcher, RRequest, weights[0], {}),
            (TBatcher, TRequest, weights[1], {"device": "cpu"})):
        cfg = cfgs[0] if Batcher is RBatcher else cfgs[1]
        b = Batcher(cfg, params, slots=slots, capacity=capacity, **kw)
        rec = _Recorded(b)
        for i, p in enumerate(prompts):
            b.submit(Request(uid=i, prompt=p, max_new_tokens=max_new,
                             eos_id=-1 if eos is None else eos[i]))
        steps = b.run_to_completion()
        out.append((b, rec, steps))
    return out


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TCFG.vocab_size, T).astype(np.int32)
            for T in lengths]


def _same_run(ref, port):
    (rb, rrec, rsteps), (tb, trec, tsteps) = ref, port
    assert len(trec.prefill) == len(rrec.prefill)
    for got, want in zip(trec.prefill, rrec.prefill):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert len(trec.decode) == len(rrec.decode) and tsteps == rsteps
    for got, want in zip(trec.decode, rrec.decode):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert [(r.uid, r.generated, r.done) for r in tb.finished] == \
        [(r.uid, r.generated, r.done) for r in rb.finished]
    assert not tb.active and not tb.queue


def test_batcher_matches_reference_with_flash_prefills(weights):
    prompts = _prompts(1, [5, 64, 8, 96, 20])
    ref, port = _serve(weights, prompts, slots=2, capacity=128, max_new=6)
    _same_run(ref, port)
    assert len(port[0].finished) == 5
    assert all(len(r.generated) == 6 for r in port[0].finished)


def test_batcher_serves_moe_like_the_reference(moe_weights):
    """Reduced dbrx-132b behind both batchers: every prefill's and
    decode step's logits, then the tokens.  Three slots decode together,
    each example routed on its own (an idle slot's stale token routes too,
    as in the reference, and moves no other slot's output)."""
    prompts = _prompts(7, [5, 64, 12, 96, 20, 3, 31])
    ref, port = _serve(moe_weights, prompts, slots=3, capacity=128,
                       max_new=6, cfgs=MOE_CFGS)
    _same_run(ref, port)
    assert len(port[0].finished) == 7
    assert all(len(r.generated) == 6 for r in port[0].finished)


def test_batcher_retires_at_admission_like_the_reference(weights):
    """max_new_tokens == 1 retires at admission, never occupying a slot;
    so does a first token equal to EOS (``tests/test_serving.py``)."""
    prompts = _prompts(3, [6, 5])
    ref, port = _serve(weights, prompts, slots=2, capacity=32, max_new=1)
    _same_run(ref, port)
    firsts = [r.generated[0] for r in port[0].finished]
    ref, port = _serve(weights, prompts, slots=2, capacity=32, max_new=8,
                       eos=firsts)
    _same_run(ref, port)
    assert [r.generated for r in port[0].finished] == [[t] for t in firsts]
    assert port[2] == 1 and not port[1].decode


def test_freed_slot_readmits_in_the_same_step(weights):
    prompts = _prompts(5, [5, 5, 5])
    for Batcher, Request, params, kw in (
            (RBatcher, RRequest, weights[0], {}),
            (TBatcher, TRequest, weights[1], {"device": "cpu"})):
        b = Batcher(RCFG if Batcher is RBatcher else TCFG, params, slots=1,
                    capacity=32, **kw)
        for i, p in enumerate(prompts):
            b.submit(Request(uid=i, prompt=p, max_new_tokens=1))
        b.step()
        assert len(b.finished) == 3
        assert all(len(r.generated) == 1 for r in b.finished)


def test_slot_reuse_matches_reference(weights):
    prompts = _prompts(2, [5] * 6)
    ref, port = _serve(weights, prompts, slots=2, capacity=48, max_new=4)
    _same_run(ref, port)
    assert len(port[0].finished) == 6 and port[2] >= 9


def test_capacity_retires_a_slot_like_the_reference(weights):
    prompts = _prompts(6, [30, 9])
    ref, port = _serve(weights, prompts, slots=2, capacity=34, max_new=20)
    _same_run(ref, port)
    assert [len(r.generated) for r in port[0].finished] == [4, 20]


def test_batcher_device_none_raises_without_cuda(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TBatcher(TCFG, weights[1], slots=1, capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--requests", "1"])


def test_decode_step_is_eager_on_the_cpu_and_graphed_on_cuda(weights):
    """The CPU runs the decode step eagerly (the device's own path); on a
    CUDA device the batcher wraps the same step in a ``GraphedDecode``,
    which replays only on the parameters and caches it captured."""
    b = TBatcher(TCFG, weights[1], slots=2, capacity=8, device="cpu")
    assert not isinstance(b.decode, GraphedDecode)
    graphed = GraphedDecode(b.decode)
    assert graphed.step is b.decode and graphed.graph is None
    graphed.graph, graphed._params, graphed._caches = object(), b.params, \
        b.cache
    toks, pos = torch.zeros((2, 1), dtype=torch.long), torch.zeros(2)
    with pytest.raises(ValueError, match="captured"):
        graphed(b.params, [dict(c) for c in b.cache], toks, pos)
    with pytest.raises(ValueError, match="captured"):
        graphed(dict(b.params), b.cache, toks, pos)


_TIMING = re.compile(r", [0-9.]+s \([0-9.]+ tok/s\)$")


def _cli_lines(monkeypatch, capsys, arch):
    """Both serving CLIs at ``--arch arch``, the reference's weights for
    ``--seed`` carried into the port's: (reference lines, port lines,
    the port's batcher)."""
    argv = ["--arch", arch, "--reduced", "--requests", "6",
            "--max-new", "5", "--seed", "2"]
    rserve.main(argv)
    want = capsys.readouterr().out.splitlines()

    class CarriedModel(TModel):
        def init(self, seed=0, device=None):
            params = RModel(r_reduced(r_get(arch))).init(
                jax.random.PRNGKey(seed))
            return interop.params_from_numpy(
                self.cfg, jax.tree.map(np.asarray, params), device)

    monkeypatch.setattr(tserve, "Model", CarriedModel)
    b = tserve.main(argv + ["--device", "cpu"])
    return want, capsys.readouterr().out.splitlines(), b


def test_serve_cli_matches_reference_line_for_line(monkeypatch, capsys):
    """``repro_torch.launch.serve.main([... "--device", "cpu"])`` prints
    the reference's lines (timing dropped), with the reference's weights
    for ``--seed`` carried across."""
    want, got, b = _cli_lines(monkeypatch, capsys, "qwen3-4b")
    assert len(got) == len(want) == 4
    assert [_TIMING.sub("", x) for x in got] == \
        [_TIMING.sub("", x) for x in want]
    assert got[0].startswith("served 6/6 requests, 30 tokens in ")
    assert b.device.type == "cpu"


def test_serve_cli_serves_dbrx_like_the_reference(monkeypatch, capsys):
    """The same at ``--arch dbrx-132b`` (reduced: the MoE model)."""
    want, got, b = _cli_lines(monkeypatch, capsys, "dbrx-132b")
    assert len(got) == len(want) == 4
    assert [_TIMING.sub("", x) for x in got] == \
        [_TIMING.sub("", x) for x in want]
    assert got[0].startswith("served 6/6 requests, 30 tokens in ")
    assert b.cfg.moe is not None and b.device.type == "cpu"


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-20b",
                                  "command-r-35b"])
def test_serve_cli_serves_dense_configs_like_the_reference(monkeypatch,
                                                           capsys, arch):
    """The same at the dense configs' ``--arch`` (reduced): deepseek-7b,
    granite-20b (one KV head, GELU MLP, tied head) and command-r-35b
    (tied head, RoPE theta 4e6)."""
    want, got, b = _cli_lines(monkeypatch, capsys, arch)
    assert len(got) == len(want) == 4
    assert [_TIMING.sub("", x) for x in got] == \
        [_TIMING.sub("", x) for x in want]
    assert got[0].startswith("served 6/6 requests, 30 tokens in ")
    assert b.cfg.name == arch and b.device.type == "cpu"


def test_batcher_refuses_embedding_inputs_like_the_reference():
    """Both packages' ``ContinuousBatcher`` take token ids only, so both
    refuse musicgen-large (frame embeddings in), with the reference's
    assertion; such a model is served through ``serve.engine``'s steps."""
    rcfg = r_reduced(r_get("musicgen-large"), num_layers=2, remat=False)
    tcfg = t_reduced(t_get("musicgen-large"), num_layers=2, remat=False)
    assert rcfg.input_mode == tcfg.input_mode == "embeddings"
    params = RModel(rcfg).init(jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="token ids"):
        RBatcher(rcfg, params, slots=2, capacity=16)
    with pytest.raises(AssertionError, match="token ids"):
        TBatcher(tcfg, interop.params_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), "cpu"), slots=2,
            capacity=16, device="cpu")
