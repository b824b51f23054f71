"""Connected k-vertex pattern (motif) generation by augmentation.

3-motif = {3-chain, triangle}; 6-motif has 112 patterns, 7-motif 853
(connected graphs on 7 vertices) — the application scales the paper
targets.  Patterns are deduplicated by canonical form.
"""
from __future__ import annotations

import itertools
from functools import lru_cache

from repro_torch.core.pattern import Pattern


@lru_cache(maxsize=None)
def connected_patterns(k: int) -> tuple:
    """All connected patterns with k vertices (canonical, deterministic)."""
    if k == 1:
        return (Pattern(1, []),)
    out = {}
    for base in connected_patterns(k - 1):
        for mask in range(1, 1 << (k - 1)):
            attach = [i for i in range(k - 1) if mask & (1 << i)]
            p = Pattern(k, list(base.edges) + [(i, k - 1) for i in attach])
            c = p.canonical()
            out[c] = True
    return tuple(sorted(out, key=lambda p: (p.m, sorted(p.edges))))


def motif_patterns(k: int) -> list:
    return list(connected_patterns(k))
