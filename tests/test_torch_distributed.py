"""Distributed counting of the port (``repro_torch.core.distributed``) vs
the reference, on the CPU.

``sharded_inj`` over an adjacency split into row blocks across a
``data_mesh`` of CPU slots equals the reference engine's ``inj``;
``blockwise_hom_count`` resumes after an injected failure from its JSON
checkpoint, and either package resumes from the other's checkpoint
(their files are byte-equal).  Tolerance is **0**.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import (blockwise_hom_count,
                                          shard_adjacency, sharded_inj)
from repro_torch.core.pattern import chain, clique
from repro_torch.distributed import meshes

from test_torch_reference import port_graph, reference  # noqa: F401


@pytest.mark.parametrize("slots", (1, 3, 8))
def test_sharded_counting_matches_local(reference, slots):
    rg = reference.generators.erdos_renyi(64, 6.0, seed=1)
    eng = reference.counting.CountingEngine(rg)
    tg = port_graph(rg)
    mesh = meshes.data_mesh(slots, device="cpu")
    A = shard_adjacency(tg.dense_adjacency(np.float64, pad=False), mesh)
    assert A.n == 64 and len(A.parts) == slots
    for p, rp in ((chain(4), reference.pattern.chain(4)),
                  (clique(3), reference.pattern.clique(3))):
        assert sharded_inj(p, A, mesh) == eng.inj(rp), p


@pytest.fixture(scope="module")
def blockwise(reference):
    """The graph both sides count, the reference's hom(chain(4)) and its
    adjacency as each side's counters take it."""
    import jax.numpy as jnp
    rg = reference.generators.erdos_renyi(48, 5.0, seed=3)
    dense = rg.dense_adjacency(np.float64, pad=False)
    mesh = meshes.data_mesh(3, device="cpu")
    return dict(
        want=reference.counting.CountingEngine(rg).hom(
            reference.pattern.chain(4)),
        ref_A=jnp.asarray(dense), ref_p=reference.pattern.chain(4),
        tensor_A=torch.from_numpy(dense),
        sliced_A=shard_adjacency(dense, mesh), mesh=mesh)


def _port_run(bw, sliced: bool, **kw):
    A = bw["sliced_A"] if sliced else bw["tensor_A"]
    return blockwise_hom_count(chain(4), A, bw["mesh"] if sliced else None,
                               num_blocks=4, **kw)


@pytest.mark.parametrize("sliced", (False, True))
def test_blockwise_resume_after_failure(blockwise, tmp_path, sliced):
    ck = tmp_path / "count.json"
    with pytest.raises(RuntimeError, match="injected failure at block 2"):
        _port_run(blockwise, sliced, checkpoint=str(ck), fail_at_block=2)
    assert sorted(json.loads(ck.read_text())) == ["0", "1"]
    total = _port_run(blockwise, sliced, checkpoint=str(ck))
    assert total == blockwise["want"]
    assert len(json.loads(ck.read_text())) == 4


def test_blockwise_resumes_from_the_other_packages_checkpoint(
        reference, blockwise, tmp_path):
    """Each package resumes from the checkpoint the other wrote after an
    injected failure, and the finished files are byte-equal."""
    from repro.core.distributed import blockwise_hom_count as ref_blockwise

    def ref_run(**kw):
        return ref_blockwise(blockwise["ref_p"], blockwise["ref_A"], None,
                             num_blocks=4, **kw)

    port_ck, ref_ck = tmp_path / "port.json", tmp_path / "ref.json"
    with pytest.raises(RuntimeError):
        _port_run(blockwise, True, checkpoint=str(port_ck), fail_at_block=1)
    assert ref_run(checkpoint=str(port_ck)) == blockwise["want"]
    with pytest.raises(RuntimeError):
        ref_run(checkpoint=str(ref_ck), fail_at_block=3)
    assert _port_run(blockwise, False, checkpoint=str(ref_ck)) == \
        blockwise["want"]
    fresh_port, fresh_ref = tmp_path / "p2.json", tmp_path / "r2.json"
    _port_run(blockwise, True, checkpoint=str(fresh_port))
    ref_run(checkpoint=str(fresh_ref))
    assert fresh_port.read_bytes() == fresh_ref.read_bytes()
