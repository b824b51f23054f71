"""Partial-embedding API (paper §5): local counts, anchored vectors,
early-exit existence, and per-vertex counts read off the decomposition
join's cut tensors — see ``repro_torch.api.local`` for the full story."""
from repro_torch.api.local import (LocalCounts, exists, local_counts,
                                   pattern_domains, plan_vertex_counts,
                                   top_vertices, vertex_counts)

__all__ = ["LocalCounts", "local_counts", "exists", "vertex_counts",
           "plan_vertex_counts", "top_vertices", "pattern_domains"]
