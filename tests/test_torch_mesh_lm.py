"""The LM side of the port's mesh (``distributed.meshes``, ``launch.mesh``,
``train.checkpoint``, ``train.fault_tolerance``) against the reference's,
on the CPU.

  * ``constrain``: under a ``("data", "model")`` mesh every call the
    port's models make resolves, through ``sharding_for``, to the spec the
    reference's ``spec_for`` gives the same axes and shape (reduced
    qwen3-4b, dbrx-132b on the einsum and the expert-parallel path,
    mamba2-1.3b, deepseek-v3-671b, llama-3.2-vision-11b, in train,
    prefill and decode, and a train step in microbatches); the calls
    cover the reference's call sites.  Dims a mesh axis does not divide
    resolve to the reference's spec too; the tensor comes back as it is;
    without a mesh nothing is resolved; a wrong rank is refused by both.
  * Live slot meshes: ``make_host_mesh(..., device=)`` and ``place``,
    each slot's block by ``shard_slices`` (slots of one device share one
    tensor), ``gather`` giving the leaf back.
  * ``elastic_reshard`` onto (4, 2) and (2, 4) CPU slot meshes, from the
    checkpoint the reference writes in ``test_elastic_reshard_to_new_mesh``'s
    setup (reduced qwen3-4b, 2 layers, ``init_state`` at key 0), in a
    subprocess with 8 forced host devices: each slot's shard equal, bit for
    bit, to the reference's shard on the device at the slot's position in
    the reference mesh's ``devices``.
  * ``restore(shardings=)`` keeps the file's dtype (bf16 bits read back as
    bf16 where the like leaf is f32), and ``resume_or_init(shardings=)``
    passes the shardings through.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.distributed import meshes as rmeshes

from repro_torch.configs.base import reduced_config
from repro_torch.configs.registry import get_config
from repro_torch.distributed import meshes
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import Model
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import tree
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (abstract_state, make_grad_fn,
                                          state_axes)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the reference's constrain call sites, by their logical axes
# (src/repro/models/layers.py:50,212-233,249-263,286-287, moe.py:121-137,
# 259, ssm.py:128,169, mla.py:44,60-77, transformer.py:238,259,
# train/train_step.py:46)
CALL_SITE_AXES = {
    ("batch", None, "heads", None), ("batch", "seq", "heads", None),
    ("batch", "kv_seq", "kv"), ("batch", "seq", None),
    ("batch", "seq", "mlp"), ("batch", "experts", None, None),
    ("batch", "experts", None, "expert_mlp"), ("batch", "kv_seq", "lora"),
    ("batch", "kv_seq", None), ("batch", "seq", "vocab"),
    (None, "batch", None)}


def _reference_spec(axes, shape, mesh, rules):
    return tuple(rmeshes.spec_for(tuple(axes), tuple(shape), mesh, rules))


@pytest.fixture
def resolved(monkeypatch):
    """Every (axes, shape, spec) that ``constrain`` resolves."""
    log = []
    real = meshes.sharding_for

    def recording(axes, shape, mesh=None, rules=None):
        out = real(axes, shape, mesh, rules)
        log.append((tuple(axes), tuple(shape), out))
        return out

    monkeypatch.setattr(meshes, "sharding_for", recording)
    return log


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))


def _run_modes(cfg, params, image=None):
    """train, prefill, then one decode step of a reduced model."""
    model = Model(cfg)
    B, S = 2, 8
    toks = _tokens(cfg, B, S)
    kw = {} if image is None else {"image_embeds": image}
    model(params, toks, mode="train", **kw)
    _, caches, _ = model(params, toks, mode="prefill", **kw)
    model(params, toks[:, :1], mode="decode",
          positions=torch.full((B,), S - 1, dtype=torch.long), caches=caches)


ARCHS = ("qwen3-4b", "dbrx-132b", "mamba2-1.3b", "deepseek-v3-671b",
         "llama-3.2-vision-11b")


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_constrain_specs_equal_the_reference(resolved, shape):
    mesh = tmesh.make_host_mesh(shape, ("data", "model"), device="cpu")
    rules = dict(meshes.DEFAULT_RULES)
    with meshes.sharding_ctx(mesh):
        for arch in ARCHS:
            cfg = reduced_config(get_config(arch))
            params = Model(cfg).init(0, device="cpu")
            image = None
            if arch.startswith("llama-3.2-vision"):
                image = torch.randn(2, 4, cfg.d_model,
                                    generator=torch.Generator()
                                    .manual_seed(1))
            _run_modes(cfg, params, image)
        # experts the model axis does not divide: the einsum path
        cfg = reduced_config(get_config("dbrx-132b"))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=shape[1] + 1))
        _run_modes(cfg, Model(cfg).init(0, device="cpu"))
        cfg = reduced_config(get_config("qwen3-4b"))
        grad_fn = make_grad_fn(cfg, microbatches=2)
        toks = _tokens(cfg, 4, 8)
        params = Model(cfg).init(0, device="cpu")
        for leaf in tree.leaves(params):
            leaf.requires_grad_(True)
        grad_fn(params, {"inputs": toks, "labels": toks})
    assert resolved
    for axes, shp, got in resolved:
        assert got.mesh is mesh
        assert got.spec == _reference_spec(axes, shp, mesh, rules), \
            (axes, shp)
    seen = {axes for axes, _, _ in resolved}
    assert CALL_SITE_AXES <= seen, CALL_SITE_AXES - seen


@pytest.mark.parametrize("axes,shape", [
    (("batch", "seq", "heads", None), (3, 5, 6, 7)),    # nothing divides
    (("batch", "seq", "heads", None), (4, 8, 12, 16)),
    (("batch", "kv_seq", "kv"), (6, 10, 8)),
    (("batch", "experts", None, "expert_mlp"), (2, 12, 5, 9)),
    (("batch", "seq", "vocab"), (8, 3, 1001)),
    ((None, "batch", None), (2, 3, 7)),
    (("experts", "expert_embed", "expert_mlp"), (16, 6144, 10752)),
])
@pytest.mark.parametrize("mesh_shape,mesh_axes", [
    ((2, 4), ("data", "model")), ((3, 2), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model")), ((4,), ("data",))])
def test_constrain_resolves_as_the_reference(axes, shape, mesh_shape,
                                             mesh_axes):
    mesh = tmesh.make_host_mesh(mesh_shape, mesh_axes, device="cpu")
    rules = {"experts": ("data", "model")}
    x = torch.zeros(shape, device="meta")
    with meshes.sharding_ctx(mesh, rules):
        assert meshes.constrain(x, *axes) is x
        got = meshes.sharding_for(axes, shape).spec
    want = _reference_spec(axes, shape, mesh,
                           dict(rmeshes.DEFAULT_RULES, **rules))
    assert got == want


def test_constrain_without_a_mesh_resolves_nothing(resolved):
    x = torch.ones(2, 3)
    assert meshes.active_mesh() is None
    assert meshes.constrain(x, "batch") is x     # no rank check either
    assert resolved == []


def test_constrain_refuses_a_wrong_rank_as_the_reference():
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    with meshes.sharding_ctx(mesh), pytest.raises(AssertionError):
        meshes.constrain(torch.zeros(2, 3), "batch")
    with pytest.raises(AssertionError):
        rmeshes.spec_for(("batch",), (2, 3), mesh, rmeshes.DEFAULT_RULES)


# -- live slot meshes ---------------------------------------------------------------

def test_live_host_mesh_and_its_slots():
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    assert isinstance(mesh, meshes.DataMesh)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert set(mesh.devices) == {torch.device("cpu")}
    assert meshes.num_chips(mesh) == 1
    abstract = tmesh.make_host_mesh((2, 4), ("data", "model"))
    assert isinstance(abstract, meshes.AbstractMesh)
    one = meshes.data_mesh(3, device="cpu")
    assert one.shape == {"data": 3} and one.axis_names == ("data",)
    with pytest.raises(ValueError):
        meshes.DataMesh((torch.device("cpu"),) * 6, ("data", "model"),
                        (2, 4))


@pytest.mark.parametrize("spec", [
    ("data", "model"), ("model", None), (("data", "model"), None),
    (None, None), (None, ("model", "data"))])
def test_place_gives_each_slot_its_block_as_a_view(spec):
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    x = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    placed = meshes.place(x, meshes.NamedSharding(mesh, spec))
    want = meshes.shard_shape(x.shape, spec, mesh)
    base = placed.shards[0].untyped_storage().data_ptr()
    coords = [(i, j) for i in range(2) for j in range(4)]
    for slot, shard in enumerate(placed.shards):
        assert tuple(shard.shape) == want
        assert shard.untyped_storage().data_ptr() == base     # one tensor
        blocks = {"data": coords[slot][0], "model": coords[slot][1]}
        index = []
        for dim, entry in enumerate(spec):
            b = 0
            for ax in meshes.entry_axes(entry):
                b = b * mesh.shape[ax] + blocks[ax]
            index.append(slice(b * want[dim], (b + 1) * want[dim]))
        assert torch.equal(shard, x[tuple(index)])
    assert torch.equal(placed.gather(), x)


# -- elastic resharding against the reference -------------------------------------

_RESHARD_REFERENCE = """
    import sys
    import jax, numpy as np
    from repro.configs.base import reduced_config
    from repro.configs.registry import get_config
    from repro.train import checkpoint as ckpt
    from repro.train.fault_tolerance import elastic_reshard
    from repro.train.optimizer import OptConfig
    from repro.train.train_step import init_state, state_axes
    from repro.launch.mesh import make_host_mesh
    directory, out_path = sys.argv[1], sys.argv[2]
    cfg = reduced_config(get_config("qwen3-4b"), num_layers=2)
    state = init_state(cfg, OptConfig(), jax.random.PRNGKey(0))
    ckpt.save(directory, 5, state)
    out = {}
    for shp in ((4, 2), (2, 4)):
        mesh = make_host_mesh(shp, ("data", "model"))
        slots = list(mesh.devices.flat)
        restored = elastic_reshard(directory, 5, state, state_axes(cfg),
                                   mesh)
        for i, leaf in enumerate(jax.tree.leaves(restored)):
            for shard in leaf.addressable_shards:
                slot = slots.index(shard.device)
                out[f"{shp[0]}x{shp[1]}/{i}/{slot}"] = np.asarray(shard.data)
    np.savez(out_path, **out)
    print("OK")
"""


@pytest.fixture(scope="module")
def reference_reshard(tmp_path_factory):
    root = tmp_path_factory.mktemp("reshard")
    out = str(root / "shards.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c",
                        textwrap.dedent(_RESHARD_REFERENCE),
                        str(root / "ckpt"), out],
                       capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0 and "OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    return str(root / "ckpt"), dict(np.load(out))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_elastic_reshard_equals_the_reference_shard_for_shard(
        reference_reshard, shape):
    directory, ref = reference_reshard
    cfg = reduced_config(get_config("qwen3-4b"), num_layers=2)
    like = abstract_state(cfg, OptConfig())
    mesh = tmesh.make_host_mesh(shape, ("data", "model"), device="cpu")
    got = tft.elastic_reshard(directory, 5, like, state_axes(cfg), mesh)
    leaves = tree.leaves(got)
    assert len(leaves) == len(tree.leaves(like))
    for i, leaf in enumerate(leaves):
        assert isinstance(leaf, meshes.ShardedTensor)
        assert len(leaf.shards) == mesh.size == 8
        base = leaf.shards[0].untyped_storage().data_ptr()
        for slot, shard in enumerate(leaf.shards):
            want = ref[f"{shape[0]}x{shape[1]}/{i}/{slot}"]
            assert shard.untyped_storage().data_ptr() == base
            assert tuple(shard.shape) == want.shape, (i, slot)
            assert torch.equal(shard, torch.from_numpy(np.array(want))), \
                (i, slot)


# -- restore onto shardings --------------------------------------------------------

def _mixed_state():
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(8, 6, generator=g).to(torch.bfloat16),
            "m": torch.randn(8, 6, generator=g),
            "step": torch.tensor(7, dtype=torch.int32)}


_MIXED_AXES = {"w": ("embed", "mlp"), "m": ("embed", "mlp"), "step": ()}


def test_restore_onto_shardings_keeps_the_file_dtype(tmp_path):
    state = _mixed_state()
    tckpt.save(tmp_path, 3, state)
    like = {"w": torch.zeros(8, 6),
            "m": torch.zeros(8, 6, dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int64)}
    mesh = tmesh.make_host_mesh((2, 2), ("data", "model"), device="cpu")
    sh = meshes.tree_shardings(_MIXED_AXES, like, mesh)
    got = tckpt.restore(tmp_path, 3, like, shardings=sh)
    for name in state:
        leaf = got[name]
        assert isinstance(leaf, meshes.ShardedTensor)
        assert leaf.dtype == state[name].dtype      # the file's, not like's
        assert leaf.spec == sh[name].spec
        assert torch.equal(leaf.gather(), state[name])
    assert got["w"].spec == ("data", "model")
    assert tuple(got["w"].shards[0].shape) == (4, 3)
    # without shardings the like leaf's dtype is taken, and bf16 bits go
    # into a bf16 leaf only
    with pytest.raises(TypeError, match="bf16 leaf only"):
        tckpt.restore(tmp_path, 3, like)
    plain = tckpt.restore(tmp_path, 3, dict(like, w=torch.zeros(
        8, 6, dtype=torch.bfloat16)))
    assert plain["m"].dtype == torch.bfloat16
    assert torch.equal(plain["w"], state["w"])


def test_resume_or_init_passes_the_shardings_through(tmp_path):
    state = _mixed_state()
    mesh = tmesh.make_host_mesh((1, 2), ("data", "model"), device="cpu")
    sh = meshes.tree_shardings(_MIXED_AXES, state, mesh)
    fresh, step = tft.resume_or_init(tmp_path, _mixed_state, shardings=sh)
    assert step == 0 and isinstance(fresh["w"], torch.Tensor)
    tckpt.save(tmp_path, 4, state)
    got, step = tft.resume_or_init(tmp_path, _mixed_state, shardings=sh)
    assert step == 4
    for name in state:
        assert isinstance(got[name], meshes.ShardedTensor)
        assert got[name].sharding == sh[name]
        assert torch.equal(got[name].gather(), state[name])


def test_ep_runs_on_the_slots_device_only():
    """A live mesh whose slots lie elsewhere than x is refused by name."""
    cfg = reduced_config(get_config("dbrx-132b"))
    mesh = meshes.DataMesh((torch.device("meta"),) * 4, ("data", "model"),
                           (1, 4))
    e = cfg.moe
    moe_p = {"router": torch.zeros(cfg.d_model, e.num_experts),
             "wi": torch.zeros(e.num_experts, cfg.d_model, e.d_expert),
             "wg": torch.zeros(e.num_experts, cfg.d_model, e.d_expert),
             "wo": torch.zeros(e.num_experts, e.d_expert, cfg.d_model)}
    with pytest.raises(NotImplementedError, match="across devices"):
        tmoe.moe_apply_ep(moe_p, torch.zeros(2, 8, cfg.d_model), cfg, mesh)
