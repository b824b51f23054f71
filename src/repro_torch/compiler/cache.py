"""Plan cache: compile once, execute many.

Plans are keyed by (canonical pattern-set signature, graph signature):
the same application against the same graph — the serving steady state —
skips decomposition search and candidate costing entirely and goes
straight to lowering.  The cache is two-tier: a process-local dict plus
an optional on-disk directory of canonical-JSON plan files, so warmed
plans survive across processes (and can be shipped with a deployment).
The disk tier can be size-capped (``max_disk_entries``) with
LRU-by-mtime eviction for long-lived serving hosts.

Format note: plan files are stamped with ``ir.PLAN_FORMAT_VERSION`` and
drift is a clean miss (recompile + overwrite).  The morphing count
store (``compiler.morph.CountStore``) keeps its own per-graph files
(``counts-<graph signature>.json``) under the same discipline — atomic
tmp-write + ``os.replace``, ``morph.MORPH_FORMAT_VERSION``-stamped,
version drift a clean miss — so a deployment can ship both tiers
side by side and roll either format independently.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Iterable, Optional

from repro_torch import obs
from repro_torch.core.pattern import Pattern
from repro_torch.graph.storage import Graph
from repro_torch.compiler.ir import Plan, pattern_key


def graph_signature(g: Graph) -> str:
    """Content hash of the graph (vertices, canonical edge list, labels).
    Memoised on the instance so serving loops don't re-hash O(E) bytes
    per query.  Both the plan cache and the morph ``CountStore`` key
    exact results by this signature, so any caller that mutates a graph
    in place must call ``Graph.invalidate_signature()`` afterwards — a
    stale memo would serve the pre-mutation graph's plans and counts."""
    sig = getattr(g, "_plan_signature", None)
    if sig is None:
        h = hashlib.sha256()
        h.update(str(g.n).encode())
        h.update(g.edges.tobytes())
        if g.labels is not None:
            h.update(g.labels.tobytes())
        sig = g._plan_signature = h.hexdigest()[:16]
    return sig


def patterns_signature(patterns: Iterable[Pattern]) -> str:
    """Order-insensitive hash of the canonical pattern set."""
    keys = sorted(pattern_key(p) for p in patterns)
    return hashlib.sha256("|".join(keys).encode()).hexdigest()[:16]


def plan_key(patterns: Iterable[Pattern], graph: Graph) -> str:
    return f"{patterns_signature(patterns)}-{graph_signature(graph)}"


def config_compatible(plan: Plan, *, budget: int, max_cutjoin_cut: int,
                      mesh_devices: int = 1) -> bool:
    """True when a cached plan was selected under the caller's compile
    configuration.  A stored plan is only valid under the configuration
    that selected it: candidate eligibility depends on ``budget`` and
    ``max_cutjoin_cut`` (a cross-config hit could return a plan the
    executor must refuse), and route annotations baked at lowering
    depend on the execution mesh — a plan compiled against an 8-device
    mesh carries ``einsum-sharded``/``xla-sharded`` routes and per-device
    cost estimates a meshless executor can't honour, and vice versa, so
    the mesh *device count* is part of the compatibility check
    (``mesh_devices``; 1 means no mesh).  Entries written before the
    field existed default to 1 — compatible with meshless callers only."""
    meta = plan.meta
    return (meta.get("budget") == budget
            and meta.get("max_cutjoin_cut") == max_cutjoin_cut
            and int(meta.get("mesh_devices", 1)) == int(mesh_devices))


class PlanCache:
    """In-memory plan store with optional directory persistence.

    ``max_disk_entries`` caps the on-disk tier with LRU-by-mtime
    eviction: every successful disk read refreshes the entry's mtime,
    and every put that overflows the cap unlinks the stalest files
    (``evictions`` counts them).  The memory tier is never evicted —
    it lives only as long as the process."""

    def __init__(self, path: Optional[str] = None,
                 max_disk_entries: Optional[int] = None,
                 verify: bool = True):
        self.path = path
        self.max_disk_entries = max_disk_entries
        self.verify = verify
        self._mem: dict = {}
        # instance-exact counters that mirror into the process metrics
        # registry (``plancache.hits`` / ``.misses`` / ``.evictions`` /
        # ``.format_misses`` / ``.verify_rejects``); the attribute names
        # stay the public surface via properties below.  ``format_misses``
        # counts entries the parser rejected (truncated JSON, stale
        # version, dropped field), ``verify_rejects`` entries that parsed
        # but failed static verification (semantic corruption the version
        # check can't see) — both are clean misses on top of ``misses``.
        self.stats = obs.StatsView(
            "plancache", keys=("hits", "misses", "evictions",
                               "format_misses", "verify_rejects"),
            tier="disk" if path else "mem")
        if path:
            os.makedirs(path, exist_ok=True)

    @property
    def hits(self) -> int:
        return self.stats["hits"]

    @hits.setter
    def hits(self, v: int):
        self.stats["hits"] = v

    @property
    def misses(self) -> int:
        return self.stats["misses"]

    @misses.setter
    def misses(self, v: int):
        self.stats["misses"] = v

    @property
    def evictions(self) -> int:
        return self.stats["evictions"]

    @evictions.setter
    def evictions(self, v: int):
        self.stats["evictions"] = v

    @property
    def format_misses(self) -> int:
        return self.stats["format_misses"]

    @property
    def verify_rejects(self) -> int:
        return self.stats["verify_rejects"]

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"plan-{key}.json")

    def _load_disk(self, key: str) -> Optional[Plan]:
        """Parse and verify the on-disk entry into the memory tier, or
        None for a missing / truncated / stale-version / semantically
        corrupt file.  Parse failures (``PlanFormatError``, bad JSON,
        dropped fields) count as ``format_misses``; entries that parse
        but fail the static verifier — bit flips the schema can't see,
        like an out-of-range axis — count as ``verify_rejects``.  Either
        way the entry recompiles instead of half-loading.  A successful
        read refreshes the file's mtime (LRU recency for eviction)."""
        f = self._file(key)
        if not os.path.exists(f):
            return None
        try:
            with open(f) as fh:
                plan = Plan.from_json(fh.read())
        except (json.JSONDecodeError, KeyError, ValueError,
                OSError):                  # corrupt entry: recompile
            self.stats["format_misses"] += 1
            return None
        if self.verify:
            from repro_torch import analysis
            if not analysis.verify(plan).ok:
                self.stats["verify_rejects"] += 1
                return None
        try:
            os.utime(f)                    # mark recently used
        except OSError:
            # read-only cache dir (the shipped-with-deployment case):
            # the read still serves, recency just can't refresh
            obs.counter("plancache.utime_failures")
        self._mem[key] = plan
        return plan

    def _evict(self):
        """Unlink the stalest on-disk entries beyond the cap (LRU by
        mtime).  Racing processes may unlink the same file — missing
        files are skipped, not errors.  Every eviction emits the evicted
        entry's age and size to the metrics registry (histograms
        ``plancache.eviction.age_s`` / ``.bytes``), so LRU pressure on a
        serving host is visible instead of silent."""
        if not self.path or self.max_disk_entries is None:
            return
        try:
            files = [os.path.join(self.path, f)
                     for f in os.listdir(self.path)
                     if f.startswith("plan-") and f.endswith(".json")]
        except OSError:
            return
        excess = len(files) - self.max_disk_entries
        if excess <= 0:
            return
        def _mtime(f):
            try:
                return os.path.getmtime(f)
            except OSError:
                return 0.0
        # eviction ages compare against file mtimes, which are wall time
        now = time.time()              # lint: allow=no-time-time
        for f in sorted(files, key=_mtime)[:excess]:
            try:
                st = os.stat(f)
                age_s, size = max(0.0, now - st.st_mtime), st.st_size
            except OSError:
                age_s = size = None
            try:
                os.unlink(f)
                self.evictions += 1
                if age_s is not None:
                    obs.observe("plancache.eviction.age_s", age_s)
                    obs.observe("plancache.eviction.bytes", size)
            except OSError:
                pass

    def get(self, key: str) -> Optional[Plan]:
        plan = self._mem.get(key)
        if plan is not None and self.path \
                and self.max_disk_entries is not None:
            try:
                # a memory-tier hit must still count as disk recency:
                # without this a long-lived host's hottest plans (read
                # from disk once, then served from _mem for hours) look
                # stalest to the LRU and get evicted first
                os.utime(self._file(key))
            except OSError:
                obs.counter("plancache.utime_failures")
        if plan is None and self.path:
            plan = self._load_disk(key)
        if plan is None:
            self.misses += 1
            return None
        self.hits += 1
        return plan

    def put(self, key: str, plan: Plan):
        self._mem[key] = plan
        if self.path:
            # write-temp + rename: a writer killed mid-write must never
            # leave a truncated JSON at the final path (readers would
            # re-parse and discard it on every lookup).  os.replace is
            # atomic within a directory.
            final = self._file(key)
            tmp = f"{final}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as fh:
                    fh.write(plan.to_json())
                os.replace(tmp, final)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self._evict()

    def __contains__(self, key: str) -> bool:
        """Peek without touching hit/miss counters.  On-disk entries are
        actually parsed (a truncated or stale-version file must not
        report present only for get() to miss); a valid parse lands in
        the memory tier, so the peek's work isn't repeated."""
        return key in self._mem or bool(
            self.path and self._load_disk(key) is not None)

    def __len__(self):
        return len(self._mem)

    def clear(self):
        self._mem.clear()
        self.hits = self.misses = self.evictions = 0
        self.stats["format_misses"] = self.stats["verify_rejects"] = 0
