"""The port's MoE feed-forward (``repro_torch.models.moe``) vs the
reference's (``repro.models.moe``), on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
  * ``capacity`` equal over a grid (the reference test's cases, S < 8).
  * Top-k: on the same probabilities the indices and weights are equal
    bit for bit to ``jax.lax.top_k``'s, exact ties included (the lower
    index first); on the same logits (f32, bf16-rounded, coarse with many
    ties) through each package's own softmax, indices equal and weights
    within 1e-6.
  * The layer at reduced dbrx-132b against ``_moe_apply_einsum``: output
    within ``TOL`` = 1e-4 (relative and absolute), aux within 1e-6; with
    ``capacity_factor`` lowered until pairs drop (the keep masks, slots
    and one-hots equal to the reference's own routing lines); with
    ``num_shared=1``; in bf16 at the reference's bf16 tolerance.
  * The reference's expert-parallel path (``moe_apply_ep``, shard_map +
    all_to_all) on ``tests/test_moe_ep.py``'s two setups, in a subprocess
    with 8 forced host devices: against the port's einsum path on the
    same weights, logits within that test's 2e-3; against the port's own
    expert-parallel path under a (2, 4) CPU slot mesh ("ep" takes the
    "ff" variant, "full_mesh_ep" full-mesh EP; reduced dbrx-132b is f32),
    logits within ``TOL``, aux within ``AUX_TOL`` and the gradients of
    mean(logits²) within ``TOL`` of each leaf's largest.
  * ``moe_apply``'s choice of path against the reference's rule over
    meshes and token counts, on meta tensors (> 65 536 tokens included).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.distributed import meshes as rmeshes
from repro.models import moe as rmoe
from repro.models import params as rparams
from repro.models import transformer as rtf

from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.distributed import meshes as tmeshes
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.train import tree as ttree

TOL = 1e-4
AUX_TOL = 1e-6
BF16_TOL = 3e-2
EP_TOL = 2e-3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(**moe):
    """(reference, port) reduced dbrx-132b, with MoE fields replaced."""
    r = rbase.reduced_config(rreg.get_config("dbrx-132b"))
    t = tbase.reduced_config(treg.get_config("dbrx-132b"))
    if moe:
        r = dataclasses.replace(r, moe=dataclasses.replace(r.moe, **moe))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe))
    return r, t


# -- capacity ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 5, 7, 8, 9, 12, 23, 64, 511, 512,
                               2048, 2049, 4096])
def test_capacity_equals_reference(S):
    for k in (1, 2, 4, 8):
        for E in (4, 8, 16, 256):
            for factor in (0.5, 1.0, 1.25, 5.0, 8.0):
                assert tmoe.capacity(S, k, E, factor) == \
                    rmoe.capacity(S, k, E, factor), (S, k, E, factor)


def test_capacity_reference_cases_and_dbrx_prompts():
    assert tmoe.capacity(1, 8, 256, 1.25) == 1
    assert tmoe.capacity(4096, 2, 16, 1.25) == 640
    # dbrx-132b (16 experts, top-4, factor 1.25) at the smoke's prompts
    assert [tmoe.capacity(S, 4, 16, 1.25) for S in (2048, 512, 12, 1)] == \
        [640, 160, 8, 1]


# -- top-k and routing -------------------------------------------------------------

def _tied_logits():
    """Rows with exact ties among the top k and at the k-th place."""
    rows = [[1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 3.0, -1.0],
            [0.0] * 8,
            [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0],
            [-5.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0],
            [0.5, 0.25, 0.5, 0.25, 0.5, 0.25, 0.5, 0.25]]
    return np.asarray(rows, np.float32)[None]


def _logits(kind, seed=0, shape=(3, 300, 16)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "bf16":
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if kind == "coarse":
        return (np.round(x * 2) / 2).astype(np.float32)
    if kind == "tied":
        return _tied_logits()
    return x


@pytest.mark.parametrize("k", [1, 2, 4, 7])
@pytest.mark.parametrize("kind", ["f32", "bf16", "coarse", "tied"])
def test_top_k_on_the_same_probabilities_equals_lax_top_k(kind, k):
    probs = jax.nn.softmax(jnp.asarray(_logits(kind)), axis=-1)
    want_w, want_i = jax.lax.top_k(probs, k)
    got_w, got_i = tmoe.top_k(torch.from_numpy(np.array(probs)), k)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_w.numpy(), np.asarray(want_w))


def test_ties_go_to_the_lower_index():
    w, idx = tmoe.top_k(torch.from_numpy(_tied_logits()[0]), 4)
    assert idx.tolist() == [[1, 2, 4, 6], [0, 1, 2, 3], [0, 1, 6, 7],
                            [1, 2, 3, 4], [0, 2, 4, 6]]
    assert w[0].tolist() == [3.0] * 4


@pytest.mark.parametrize("kind", ["f32", "bf16", "coarse", "tied"])
def test_routing_on_the_same_logits_equals_reference(kind):
    """Each package's own softmax of the same logits (an identity router
    makes ``x @ router`` the logits): top-k indices equal, weights within
    1e-6, and the one-hots, slots and keep masks of the reference's
    dispatch lines equal."""
    logits = _logits(kind)
    E = logits.shape[-1]
    rcfg, tcfg = _cfgs(num_experts=E, top_k=2, capacity_factor=1.0)
    eye = np.eye(E, dtype=np.float32)
    got = tmoe.routing({"router": torch.from_numpy(eye)},
                       torch.from_numpy(np.array(logits)), tcfg)
    want = _reference_routing({"router": jnp.asarray(eye)},
                              jnp.asarray(logits), rcfg)
    for name in ("idx", "oh", "pos", "keep"):
        assert np.array_equal(np.asarray(getattr(got, name)),
                              np.asarray(want[name])), name
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want["w"]),
                               rtol=AUX_TOL, atol=AUX_TOL)
    assert got.C == want["C"]


def _reference_routing(p, x, cfg):
    """The reference's routing, its own lines (``moe.py:102-116``)."""
    e = cfg.moe
    B, S, _ = x.shape
    E, k = e.num_experts, e.top_k
    C = rmoe.capacity(S, k, E, e.capacity_factor)
    logits = jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    w, idx = jax.lax.top_k(probs, k)
    w = (w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9)).astype(x.dtype)
    idx_f = idx.reshape(B, S * k)
    oh = jax.nn.one_hot(idx_f, E, dtype=jnp.int32)
    pos = ((jnp.cumsum(oh, axis=1) - oh) * oh).sum(-1)
    return {"idx": idx_f, "w": w.reshape(B, S * k), "oh": oh, "pos": pos,
            "keep": pos < C, "C": C}


# -- the layer ---------------------------------------------------------------------

def _layer_inputs(rcfg, seed=0, B=2, S=40, dtype=np.float32):
    """The reference's initialiser for the MoE specs alone, and x."""
    specs = rmoe.moe_specs(rcfg)
    p = rparams.init_tree(specs, jax.random.PRNGKey(seed), jnp.float32)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["router"] = p["router"] * 25.0        # logits of order 1: real routing
    x = np.random.default_rng(seed).normal(
        size=(B, S, rcfg.d_model)).astype(np.float32)
    if dtype != np.float32:
        p = {k: np.asarray(jnp.asarray(v, dtype)) for k, v in p.items()}
        x = np.asarray(jnp.asarray(x, dtype))
    return p, x


def _to_torch(a, dtype=None):
    t = interop._tensor(a, torch.float32, "cpu")
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("case", ["lossless", "drops", "shared", "S1",
                                  "S7"])
def test_layer_matches_reference(case):
    moe = {"drops": dict(capacity_factor=0.5),
           "shared": dict(num_shared=1)}.get(case, {})
    S = {"S1": 1, "S7": 7}.get(case, 40)
    rcfg, tcfg = _cfgs(**moe)
    p, x = _layer_inputs(rcfg, seed=len(case), S=S)
    want_y, want_aux = rmoe._moe_apply_einsum(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcfg)
    tp = {k: _to_torch(v) for k, v in p.items()}
    got_y, got_aux = tmoe.moe_apply(tp, _to_torch(x), tcfg)
    assert got_y.dtype == torch.float32 and got_aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), rtol=TOL,
                               atol=TOL)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL
    got = tmoe.routing(tp, _to_torch(x), tcfg)
    want = _reference_routing({"router": jnp.asarray(p["router"])},
                              jnp.asarray(x), rcfg)
    assert np.array_equal(got.keep.numpy(), np.asarray(want["keep"]))
    assert np.array_equal(got.pos.numpy(), np.asarray(want["pos"]))
    drops, margin, idx, logits = tmoe.routing_report(tp, _to_torch(x), tcfg)
    assert drops.tolist() == (~np.asarray(want["keep"])).sum(-1).tolist()
    assert margin.shape == x.shape[:2] and (margin >= 0).all()
    np.testing.assert_allclose(logits.numpy(), x @ p["router"], rtol=TOL,
                               atol=TOL)
    assert np.array_equal(idx.numpy().reshape(want["idx"].shape),
                          np.asarray(want["idx"]))
    if case == "drops":
        assert (drops > 0).all(), drops    # the case must drop pairs
    else:
        assert (drops == 0).all(), drops


def test_layer_matches_reference_in_bf16():
    rcfg, tcfg = _cfgs()
    rcfg = dataclasses.replace(rcfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    p, x = _layer_inputs(rcfg, seed=3, dtype=jnp.bfloat16)
    want_y, want_aux = rmoe._moe_apply_einsum(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcfg)
    tp = {k: _to_torch(v, torch.bfloat16) for k, v in p.items()}
    got_y, got_aux = tmoe.moe_apply(tp, _to_torch(x, torch.bfloat16), tcfg)
    assert got_y.dtype == torch.bfloat16 and got_aux.dtype == torch.float32
    want = np.asarray(want_y.astype(jnp.float32))
    np.testing.assert_allclose(_np(got_y), want, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(want).max())
    assert abs(float(got_aux) - float(want_aux)) <= BF16_TOL


def test_layer_gradients_match_reference():
    """The gradient of a scalar of the layer's output and aux, with
    respect to x and every weight, as ``jax.grad`` gives it."""
    rcfg, tcfg = _cfgs(capacity_factor=0.5)
    p, x = _layer_inputs(rcfg, seed=5)

    def ref_loss(pp, xx):
        y, aux = rmoe._moe_apply_einsum(pp, xx, rcfg)
        return jnp.sum(y * y) * 1e-3 + aux

    want = jax.grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: _to_torch(v).requires_grad_() for k, v in p.items()}
    tx = _to_torch(x).requires_grad_()
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    (torch.sum(y * y) * 1e-3 + aux).backward()
    for k in p:
        g = np.asarray(want[0][k])
        np.testing.assert_allclose(_np(tp[k].grad), g, rtol=0,
                                   atol=TOL * np.abs(g).max())
    g = np.asarray(want[1])
    np.testing.assert_allclose(_np(tx.grad), g, rtol=0,
                               atol=TOL * np.abs(g).max())


def test_moe_apply_takes_expert_parallelism_under_a_model_axis(
        monkeypatch):
    """Under a (2, 4) ``("data", "model")`` CPU slot mesh the layer runs
    ``moe_apply_ep``; with no mesh, the einsum path; the module says so."""
    _, cfg = _cfgs()
    taken = []
    real = tmoe.moe_apply_ep
    monkeypatch.setattr(tmoe, "moe_apply_ep",
                        lambda *a: taken.append(1) or real(*a))
    rng = np.random.default_rng(0)
    e, d = cfg.moe, cfg.d_model
    p = {"router": rng.normal(size=(d, e.num_experts)),
         "wi": rng.normal(size=(e.num_experts, d, e.d_expert)) * 0.1,
         "wg": rng.normal(size=(e.num_experts, d, e.d_expert)) * 0.1,
         "wo": rng.normal(size=(e.num_experts, e.d_expert, d)) * 0.1}
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    x = torch.from_numpy(rng.normal(size=(4, 16, d)).astype(np.float32))
    want, aux_want = tmoe.moe_apply(p, x, cfg)
    assert not taken
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    with tmeshes.sharding_ctx(mesh):
        got, aux = tmoe.moe_apply(p, x, cfg)
    assert taken == [1]
    # capacity factor 5: no pair drops on either path
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    assert abs(float(aux) - float(aux_want)) <= AUX_TOL
    assert "13f" not in tmoe.__doc__ and "moe_apply_ep" in tmoe.__doc__


# -- the reference's expert-parallel path ------------------------------------------

_EP_SETUPS = {
    # tests/test_moe_ep.py::test_ep_matches_einsum_and_grads
    "ep": {"moe": {}, "rules": None},
    # tests/test_moe_ep.py::test_full_mesh_ep_when_experts_divide_mesh
    "full_mesh_ep": {"moe": {"num_experts": 8, "top_k": 2,
                             "capacity_factor": 8.0},
                     "rules": {"experts": ("data", "model")}},
}

_EP_REFERENCE = """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import reduced_config
    from repro.configs.registry import get_config
    from repro.models.transformer import Model
    from repro.distributed.meshes import sharding_ctx
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe
    mesh = make_host_mesh((2, 4), ("data", "model"))
    taken = []
    real_ep = moe.moe_apply_ep

    def counting(*a, **kw):
        taken.append(1)
        return real_ep(*a, **kw)

    moe.moe_apply_ep = counting
    out = {}
    for name, setup in SETUPS.items():
        cfg = reduced_config(get_config("dbrx-132b"))
        if setup["moe"]:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **setup["moe"]))
        model = Model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        x = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                               cfg.vocab_size)
        taken.clear()
        with sharding_ctx(mesh, setup["rules"]):
            got, _, aux = jax.jit(lambda p, t: model(p, t, mode="train"))(
                params, x)
        assert taken, name + ": the EP path was not taken"

        def loss(p):
            with sharding_ctx(mesh, setup["rules"]):
                logits, _, _ = model(p, x, mode="train")
            return jnp.mean(logits.astype(jnp.float32) ** 2)

        taken.clear()
        grads = jax.jit(jax.grad(loss))(params)
        assert taken, name + ": the EP path was not differentiated"
        out[name + "/logits"] = np.asarray(got, np.float32)
        out[name + "/aux"] = np.asarray(aux, np.float32)
        out[name + "/x"] = np.asarray(x)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{name}/leaf{i}"] = np.asarray(leaf)
        for i, leaf in enumerate(jax.tree.leaves(grads)):
            out[f"{name}/grad{i}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("OK")
"""


@pytest.fixture(scope="module")
def reference_ep(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_ep") / "ep.npz")
    code = f"SETUPS = {_EP_SETUPS!r}\n" + textwrap.dedent(_EP_REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code, path],
                       capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0 and "OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", sorted(_EP_SETUPS))
def test_einsum_path_matches_the_reference_expert_parallel_path(
        reference_ep, name):
    rcfg, tcfg = _cfgs(**_EP_SETUPS[name]["moe"])
    specs = rtf.param_specs(rcfg)
    treedef = jax.tree.structure(specs, is_leaf=rparams.is_spec)
    n = treedef.num_leaves
    tree = jax.tree.unflatten(
        treedef, [reference_ep[f"{name}/leaf{i}"] for i in range(n)])
    params = interop.params_from_numpy(tcfg, tree, "cpu")
    x = torch.from_numpy(reference_ep[f"{name}/x"])
    got, _, aux = ttf.Model(tcfg)(params, x, mode="train")
    np.testing.assert_allclose(_np(got), reference_ep[f"{name}/logits"],
                               rtol=EP_TOL, atol=EP_TOL)
    assert abs(float(aux) - float(reference_ep[f"{name}/aux"])) <= EP_TOL


def _reference_params(reference_ep, name, tcfg, rcfg):
    specs = rtf.param_specs(rcfg)
    treedef = jax.tree.structure(specs, is_leaf=rparams.is_spec)
    n = treedef.num_leaves
    tree = jax.tree.unflatten(
        treedef, [reference_ep[f"{name}/leaf{i}"] for i in range(n)])
    return interop.params_from_numpy(tcfg, tree, "cpu"), n


@pytest.mark.parametrize("name,variant", [("ep", "ff"),
                                          ("full_mesh_ep", "full")])
def test_expert_parallel_path_matches_the_reference(reference_ep, name,
                                                    variant, monkeypatch):
    """The port's ``moe_apply_ep`` under a (2, 4) CPU slot mesh against
    the reference's shard_map path under its 8-device mesh: logits, aux
    and the gradients of mean(logits²), in f32 at ``TOL``."""
    rcfg, tcfg = _cfgs(**_EP_SETUPS[name]["moe"])
    params, n = _reference_params(reference_ep, name, tcfg, rcfg)
    flat, _ = ttree.flatten(params)
    for leaf in flat:
        leaf.requires_grad_(True)
    x = torch.from_numpy(reference_ep[f"{name}/x"])
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    specs = []
    real = tmoe.moe_apply_ep

    def recording(p, xx, cfg, m):
        specs.append(tmoe._ep_specs(m, cfg, xx.shape[1], xx.shape[0]))
        return real(p, xx, cfg, m)

    monkeypatch.setattr(tmoe, "moe_apply_ep", recording)
    with tmeshes.sharding_ctx(mesh, _EP_SETUPS[name]["rules"]):
        logits, _, aux = ttf.Model(tcfg)(params, x, mode="train")
    assert specs and all(
        (sp[2] == ("data", "model")) == (variant == "full") and
        (sp[3] == "ff") == (variant == "ff") for sp in specs), specs
    np.testing.assert_allclose(_np(logits), reference_ep[f"{name}/logits"],
                               rtol=TOL, atol=TOL)
    assert abs(float(aux.detach()) - float(reference_ep[f"{name}/aux"])) \
        <= AUX_TOL
    grads = torch.autograd.grad(torch.mean(logits.float() ** 2), flat)
    assert len(grads) == n
    for i, g in enumerate(grads):
        want = reference_ep[f"{name}/grad{i}"]
        np.testing.assert_allclose(_np(g), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=f"grad leaf {i}")


# (mesh shape, axes or None for no mesh, experts, batch, sequence)
_RULE_CASES = [
    ((2, 4), ("data", "model"), 4, 4, 16),         # "ff"
    ((2, 4), ("data", "model"), 4, 2, 40_000),     # > 65 536 tokens: einsum
    ((2, 4), ("data", "model"), 8, 2, 40_000),     # full-mesh at any count
    ((2, 3), ("data", "model"), 4, 4, 16),         # 3 does not divide 4
    ((4,), ("data",), 4, 4, 16),                   # no "model" axis
    (None, None, 4, 4, 16),                        # no mesh
    ((1, 1), ("data", "model"), 4, 4, 16),
    ((16, 16), ("data", "model"), 16, 8, 8192),    # 65 536 tokens: "ff"
    ((16, 16), ("data", "model"), 16, 8, 8200),    # 65 600: einsum
    ((16, 16), ("data", "model"), 256, 256, 4096),  # deepseek-v3 train_4k
    ((2, 16, 16), ("pod", "data", "model"), 256, 32, 64),
]


@pytest.mark.parametrize("shape,axes,E,B,S", _RULE_CASES)
def test_moe_apply_chooses_its_path_by_the_reference_rule(
        shape, axes, E, B, S, monkeypatch):
    """Both packages' ``moe_apply`` under the same mesh (the port's device
    free ``AbstractMesh``; the reference's rule reads only its shape),
    with each path stubbed in the reference and recorded in the port,
    which runs it on meta tensors."""
    _, cfg = _cfgs(num_experts=E, top_k=2)
    mesh = None if shape is None else tmesh.make_host_mesh(shape, axes)
    chose = {}
    monkeypatch.setattr(rmoe, "moe_apply_ep",
                        lambda *a: chose.setdefault("ref", "ep"))
    monkeypatch.setattr(rmoe, "_moe_apply_einsum",
                        lambda *a: chose.setdefault("ref", "einsum"))
    x = torch.empty((B, S, cfg.d_model), device="meta")
    with (rmeshes.sharding_ctx(mesh) if mesh is not None
          else rmeshes.sharding_ctx(None)):
        rmoe.moe_apply(None, x, cfg)
    real_ep, real_einsum = tmoe.moe_apply_ep, tmoe._moe_apply_einsum
    monkeypatch.setattr(tmoe, "moe_apply_ep", lambda *a: chose.setdefault(
        "port", "ep") and real_ep(*a))
    monkeypatch.setattr(tmoe, "_moe_apply_einsum", lambda *a: chose.setdefault(
        "port", "einsum") and real_einsum(*a))
    e, d = cfg.moe, cfg.d_model
    p = {"router": torch.empty((d, E), device="meta"),
         "wi": torch.empty((E, d, e.d_expert), device="meta"),
         "wg": torch.empty((E, d, e.d_expert), device="meta"),
         "wo": torch.empty((E, e.d_expert, d), device="meta")}
    with tmeshes.sharding_ctx(mesh):
        y, aux = tmoe.moe_apply(p, x, cfg)
    assert tuple(y.shape) == (B, S, d) and aux.shape == ()
    assert chose["port"] == chose["ref"], chose
    assert tmoe.takes_ep(cfg, mesh, B * S) == (chose["port"] == "ep")
