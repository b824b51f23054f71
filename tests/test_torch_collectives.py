"""The collective term of the port's dry run (``distributed.collectives``
and the layouts ``launch.dryrun``'s meter carries), on the CPU, counts at
tolerance 0.

  * The ring model: ``_ring_traffic`` equal to the reference's
    ``hlo_parse._ring_traffic`` on ``tests/test_hlo_parse.py``'s four
    cases and on a grid of every op (and its ``-start`` form) x group x
    bytes; the record of identical collectives, its top-15 summary and
    the transposes the backward runs (a psum's a psum, as JAX
    transposes it under the reference's ``check_vma=False``).
  * Closed forms for y = x @ W on a (2, 4) ``("data", "model")`` host
    mesh, x (B, d) with its rows over data: W with its rows (``embed``)
    over data is gathered once; W with its columns over model moves
    nothing; a contraction split over model on both sides is a sum
    settled where ``constrain`` pins y — an all-reduce when y's layout is
    not split over model, a reduce-scatter when it is.  FLOPs per device
    are the product's divided by the devices that split it.

The reference's HLO text parser (the rest of ``tests/test_hlo_parse.py``:
scan trip counts, fusion bytes) has no counterpart: PyTorch writes no HLO.
"""
import itertools

import pytest
import torch

from repro.distributed import hlo_parse
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import meshes
from repro_torch.launch import dryrun, mesh as tmesh

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")
B, D, F = 8, 16, 32
F32 = 4


def test_ring_traffic_model_cases():
    assert coll._ring_traffic("all-reduce", 1000, 2) == 1000
    assert coll._ring_traffic("all-gather", 1600, 16) == 1500
    assert coll._ring_traffic("collective-permute", 77, 4) == 77
    assert coll._ring_traffic("reduce-scatter", 100, 4) == 300


@pytest.mark.parametrize("op", [o + s for o in OPS for s in ("", "-start")])
def test_ring_traffic_equals_the_reference(op):
    for g, nbytes in itertools.product((1, 2, 4, 8, 16, 256),
                                       (0, 1, 7, 1000, 4096, 123_456_789)):
        assert coll._ring_traffic(op, nbytes, g) == \
            hlo_parse._ring_traffic(op, nbytes, g), (op, g, nbytes)


def test_record_summary_and_transposes():
    c = coll.Collectives()
    c.add("all-reduce", 4, 1)                  # one device: nothing moves
    for i in range(20):
        c.add("all-gather", 1000 + i, 2)
    c.add("all-gather", 1000, 2)
    assert c.count == 21
    recs = c.records()
    assert recs[0] == {"op": "all-gather", "result_bytes": 1000, "group": 2,
                       "traffic": 500, "mult": 2}
    assert c.traffic == sum(r["traffic"] * r["mult"] for r in recs)
    assert len(c.summary()) == coll.SUMMARY_TOP == 15
    assert coll.transposed("all-to-all", 96, 4) == ("all-to-all", 96, 4)
    assert coll.transposed("all-gather", 96, 4) == ("reduce-scatter", 24, 4)
    assert coll.transposed("all-reduce", 96, 4) == ("all-reduce", 96, 4)


def test_psum_transposes_to_psum_under_check_vma_false():
    """The reference's expert-parallel body runs under ``shard_map`` with
    ``check_vma=False``; there JAX's backward of a psum is a psum of the
    cotangent (one in the forward, one in the backward), which is what
    ``transposed("all-reduce", ...)`` prices."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    body = jax.shard_map(lambda x: jax.lax.psum(x * x, "data"), mesh=mesh,
                         in_specs=P("data"), out_specs=P(),
                         check_vma=False)
    text = str(jax.make_jaxpr(jax.grad(lambda x: body(x).sum()))(
        jnp.ones(8)))
    assert text.count("psum[") == 2, text


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _product(x_spec, w_spec, rules=None, pin=None):
    """y = x @ W traced on the (2, 4) host mesh: (counts, records)."""
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    args = (_meta(B, D), _meta(D, F))
    in_sh = tuple(meshes.NamedSharding(mesh, s) for s in (x_spec, w_spec))

    def f(x, w):
        y = x @ w
        return meshes.constrain(y, *pin) if pin else y

    with meshes.sharding_ctx(mesh, rules):
        _, c = dryrun.trace(f, args, mesh=mesh, in_shardings=in_sh)
    return c, c["collectives"]


def test_fsdp_weight_is_gathered_once():
    c, recs = _product(("data", None), ("data", None))
    w_bytes = D * F * F32
    assert recs == [{"op": "all-gather", "result_bytes": w_bytes,
                     "group": 2, "traffic": w_bytes // 2, "mult": 1}]
    assert c["flops_pd"] == 2 * B * D * F / 2
    assert c["flops"] == 2 * B * D * F


def test_weight_split_over_model_moves_nothing():
    c, recs = _product(("data", None), (None, "model"))
    assert recs == [] and c["num_collectives"] == 0
    assert c["flops_pd"] == 2 * B * D * F / 8


def test_split_contraction_is_all_reduced_where_y_is_whole_over_model():
    c, recs = _product(("data", "model"), ("model", None),
                       rules={"batch": ("data",)}, pin=("batch", None))
    y_bytes = B * F * F32 // 2                 # per device: rows over data
    assert recs == [{"op": "all-reduce", "result_bytes": y_bytes,
                     "group": 4, "traffic": 2 * y_bytes * 3 // 4,
                     "mult": 1}]
    assert c["flops_pd"] == 2 * B * D * F / 8


def test_split_contraction_is_reduce_scattered_where_y_is_split_over_it():
    c, recs = _product(("data", "model"), ("model", None),
                       rules={"batch": ("data", "model")},
                       pin=("batch", None))
    shard = B * F * F32 // 8
    assert recs == [{"op": "reduce-scatter", "result_bytes": shard,
                     "group": 4, "traffic": shard * 3, "mult": 1}]
    assert c["flops_pd"] == 2 * B * D * F / 8


def test_without_a_recorder_constrain_is_the_identity():
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"))
    x = torch.zeros(B, D)
    with meshes.sharding_ctx(mesh):
        assert meshes.constrain(x, "batch", None) is x
        assert meshes.pin(x, ("data", None)) is x
        assert meshes.exchange(x, ("data", None), []) is x
        assert meshes.slot_local(x) is x
    assert meshes.active_ctx() == (None, None, None)
