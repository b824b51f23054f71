"""Collectives of a partitioned step: the ring model that prices them and
the record the dry run keeps of them.

The counterpart of the reference's ``repro.distributed.hlo_analysis`` and
``repro.distributed.hlo_parse``.  Those read every collective of a cell
from XLA's optimized per-device HLO text and price it with the ring
model.  PyTorch writes no such program, so the port's dry run
(``launch.dryrun``) derives the collectives from the resolved specs it
carries through the meta trace and hands each one to ``Collectives.add``;
nothing here reads HLO text.

``_ring_traffic`` is the reference's ``hlo_parse._ring_traffic``, op
names included (an ``-start`` op's result is (operands, outputs), so its
bytes are halved).  A record is ``{"op", "result_bytes", "group",
"traffic", "mult"}``, as ``hlo_parse.analyze_text`` appends them, with
``mult`` the number of identical collectives (same op, result bytes and
group) of the step; ``summary`` keeps the 15 that move the most.

``LINK_BW`` is the bytes per second one card sends to the others: one
400 Gb/s NDR InfiniBand NIC per H100 in a DGX H100, NVIDIA's published
figure, not measured here.  Every axis of both production meshes (16 x 16
and 2 x 16 x 16, ``launch.mesh``) spans more than one 8-card NVLink node,
so a ring over any axis crosses the network; groups that lie inside one
node are priced at this figure too.
"""
from __future__ import annotations

LINK_BW = 50e9               # bytes/s per card: one 400 Gb/s NIC (published)
SUMMARY_TOP = 15


def _ring_traffic(op: str, result_bytes: int, g: int) -> int:
    base = op[:-6] if op.endswith("-start") else op
    rb = result_bytes // 2 if op.endswith("-start") else result_bytes
    if base == "all-reduce":
        return int(2 * rb * (g - 1) / max(g, 1))
    if base == "all-gather":
        return int(rb * (g - 1) / max(g, 1))
    if base == "reduce-scatter":
        return int(rb * (g - 1))
    if base == "all-to-all":
        return int(rb * (g - 1) / max(g, 1))
    return rb                                     # collective-permute


def transposed(op: str, result_bytes: int, group: int):
    """The collective the backward of ``op`` runs on its cotangent, as
    JAX transposes it in the reference's expert-parallel body (a
    ``shard_map`` with ``check_vma=False``): an all-to-all's is an
    all-to-all of the same bytes, an all-gather's a reduce-scatter onto
    the gathered operand's shard, a psum's (all-reduce) a psum of the
    cotangent at the same bytes (``check_vma=True`` would make it a free
    ``pvary``; ``tests/test_torch_collectives.py`` reads the reference's
    transpose from its jaxpr)."""
    if op in ("all-to-all", "all-reduce"):
        return op, result_bytes, group
    if op == "all-gather":
        return "reduce-scatter", result_bytes // group, group
    raise ValueError(f"no transpose for {op}")


class Collectives:
    """The collectives of one traced step, identical ones counted once
    with their multiplicity.  A group of one device moves nothing and is
    not kept."""

    def __init__(self):
        self._mult: dict = {}

    def add(self, op: str, result_bytes: int, group: int, mult: int = 1):
        if group <= 1:
            return
        key = (op, int(result_bytes), int(group))
        self._mult[key] = self._mult.get(key, 0) + mult

    def records(self) -> list:
        """Every distinct collective as a record, largest traffic first."""
        out = [{"op": op, "result_bytes": rb, "group": g,
                "traffic": _ring_traffic(op, rb, g), "mult": m}
               for (op, rb, g), m in self._mult.items()]
        out.sort(key=lambda c: (-(c["traffic"] * c["mult"]), c["op"],
                                c["result_bytes"], c["group"]))
        return out

    @property
    def traffic(self) -> int:
        """Link bytes per device over the step."""
        return sum(_ring_traffic(op, rb, g) * m
                   for (op, rb, g), m in self._mult.items())

    @property
    def count(self) -> int:
        return sum(self._mult.values())

    def summary(self, top: int = SUMMARY_TOP) -> list:
        return self.records()[:top]
