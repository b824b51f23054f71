"""Continuous batching: fixed-slot decode engine with per-slot admission.

Requests arrive with prompts; free slots are filled by prefilling the
prompt (single-request prefill) and splicing its KV into the batch cache
at the slot index; every engine step decodes all active slots at their
own positions; finished sequences (EOS or max_tokens) retire and free
their slot.  This is the vLLM-style serving loop reduced to its essential
batching mechanics on top of ``serve.engine``.

Ported half: ``Request`` and ``ContinuousBatcher`` (the LM serving loop).
The reference's ``jax.jit(..., donate_argnums=(1,))`` decode becomes, on
a CUDA device, the decode step captured once in a CUDA graph
(``GraphedDecode``) and replayed every step; on the CPU it is the eager
call.  Both update the batch cache in place, and the splice writes the
slot's rows in place: a cache leaf with a ``kv_seq`` axis (attention K
and V) is zero-padded to capacity, any other (a Mamba slot's conv rows
and state) is copied whole.  Like the reference's, the batcher passes no
``image_embeds``, so it does not serve a model with cross-attention
slots: its constructor refuses one (the reference fails at the first
admission); ``serve.engine``'s steps take ``image_embeds``.

``PatternQueryBatcher`` is the graph-mining counterpart: pattern-count
requests against one graph are drained in batches, grouped by canonical
pattern set, and served through ``repro_torch.compiler`` — the first
query of a pattern set pays compilation (candidate search + costing),
every later query hits the plan cache and goes straight to the lowered
executable.  Its names, fields, groups, fallbacks and ``stats`` are the
reference's; two things differ.  A ``KernelError`` (a CUDA kernel that
would not build or launch) propagates out of ``step()`` where the
reference would serve the group by the direct path, since that fallback
would hide the failure.  With ``mesh=`` its plans compile against the
mesh and a group's requests fan out over the mesh's slots
(``distributed.cutjoin.MeshExecutor``), as in the reference.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.build import KernelError
from repro_torch.models.params import leaves
from repro_torch.models.transformer import Model, cache_specs, init_cache
from repro_torch.serve.engine import greedy_sample, make_decode_step


class GraphedDecode:
    """``step(params, caches, inputs, positions) -> (logits, caches)``
    captured in a CUDA graph at its first call and replayed after that:
    the port's counterpart of the reference's ``jax.jit``.  The graph
    reads the (slots, 1) tokens and (slots,) positions from static
    buffers, which each call copies its arguments into, writes the caches
    in place (they must be the same tensors at every call, as the
    batcher's are) and leaves the logits in a static tensor, which every
    call returns: read it before the next call.  The first call runs the
    step once eagerly on a side stream, as capture requires; that run
    writes the same cache rows as the replay after it."""

    def __init__(self, step):
        self.step = step
        self.graph = None

    def __call__(self, params, caches, inputs, positions):
        if self.graph is None:
            self._capture(params, caches, inputs, positions)
        elif params is not self._params or caches is not self._caches:
            raise ValueError("a captured decode step replays on the "
                             "parameters and caches it was captured with")
        self._inputs.copy_(inputs)
        self._positions.copy_(positions)
        self.graph.replay()
        return self._logits, caches

    def _capture(self, params, caches, inputs, positions):
        self._params, self._caches = params, caches
        self._inputs, self._positions = inputs.clone(), positions.clone()
        side = torch.cuda.Stream(device=inputs.device)
        side.wait_stream(torch.cuda.current_stream(inputs.device))
        with torch.cuda.stream(side):
            self.step(params, caches, self._inputs, self._positions)
        torch.cuda.current_stream(inputs.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._logits, _ = self.step(params, caches, self._inputs,
                                        self._positions)
        self.graph = graph


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 16
    eos_id: int = -1
    generated: list = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Serves ``Request``s on ``slots`` decode slots of ``capacity``
    positions each, with the parameters ``params`` (tensors on one device,
    see ``Model.init`` / ``interop.params_from_numpy``).  ``device=None``
    means CUDA, and raises where there is none.  On CUDA the decode step
    is a ``GraphedDecode``; on the CPU it runs eagerly."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 capacity: int = 128, device=None):
        assert cfg.input_mode == "tokens", "batching driver uses token ids"
        if "X" in cfg.layer_pattern:
            raise ValueError(
                f"{cfg.name} has cross-attention layers, which need "
                "image_embeds, and ContinuousBatcher passes none; serve it "
                "with serve.engine's make_prefill_step / make_decode_step")
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.capacity = capacity
        self.model = Model(cfg)
        self.decode = make_decode_step(cfg)
        if self.device.type == "cuda":
            self.decode = GraphedDecode(self.decode)
        self.cache = init_cache(cfg, slots, capacity, device=self.device)
        self.positions = np.zeros(slots, np.int32)
        self.last_token = np.zeros(slots, np.int32)
        self.active: dict = {}
        self.queue: collections.deque = collections.deque()
        self.finished: list = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self, slot: int, req: Request) -> bool:
        """Prefill the prompt, sample the first token from the prefill
        logits, and splice the prompt KV into the batch cache.  A request
        already finished by its first token (EOS, or max_new_tokens == 1)
        retires immediately and leaves the slot free: returns False."""
        prompt = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                 device=self.device)
        logits, caches, _ = self.model(self.params, prompt, mode="prefill")
        T = req.prompt.shape[0]
        first = int(greedy_sample(logits[0, -1:])[0])
        req.generated.append(first)
        if first == req.eos_id or len(req.generated) >= req.max_new_tokens:
            req.done = True
            self.finished.append(req)
            return False
        _, ax_tree = cache_specs(self.cfg, 1, T)
        for one_c, batch_c, axes in zip(leaves(caches), leaves(self.cache),
                                        leaves(ax_tree)):
            # the slot's row of the batch cache becomes the prompt's cache,
            # zero-padded to capacity along the sequence axis
            row = batch_c.select(1, slot)
            one = one_c.select(1, 0)
            if "kv_seq" in axes:
                sa = axes.index("kv_seq") - 1
                row.narrow(sa, T, self.capacity - T).zero_()
                row = row.narrow(sa, 0, T)
            row.copy_(one)
        self.positions[slot] = T
        self.last_token[slot] = first
        self.active[slot] = req
        return True

    def step(self):
        # admissions: a request that finishes at prefill frees its slot
        # for the next queued request within the same step
        for slot in range(self.slots):
            while slot not in self.active and self.queue:
                if self._admit(slot, self.queue.popleft()):
                    break
        if not self.active:
            return False
        toks = torch.as_tensor(self.last_token[:, None], device=self.device)
        pos = torch.as_tensor(self.positions, device=self.device)
        logits, self.cache = self.decode(self.params, self.cache, toks, pos)
        nxt = greedy_sample(logits).cpu().numpy()
        for slot, req in list(self.active.items()):
            t = int(nxt[slot])
            req.generated.append(t)
            self.positions[slot] += 1
            self.last_token[slot] = t
            if (t == req.eos_id or len(req.generated) >= req.max_new_tokens
                    or self.positions[slot] >= self.capacity - 1):
                req.done = True
                self.finished.append(req)
                del self.active[slot]
        return True

    def run_to_completion(self, max_steps: int = 10_000):
        steps = 0
        while (self.active or self.queue) and steps < max_steps:
            self.step()
            steps += 1
        return steps


# -- graph-mining query serving ---------------------------------------------------

@dataclass
class PatternRequest:
    """One mining query: count every pattern of ``patterns`` in the
    batcher's graph (edge-induced), or — with ``support=True`` — their
    FSM MINI supports (labelled patterns, served off the same compiled
    plan via its domain nodes), or — with ``local=True`` — their
    partial-embedding local counts (the anchored (N,) completion-count
    vector when ``anchor`` names a pattern vertex, else the full local
    tensor over the plan's cutting set; patterns without a cutting set
    fill ``local_counts[p] = None`` for unanchored queries).  With
    ``top_k=K`` the request instead fills ``hotspots[p]`` with the K
    hottest vertices by per-vertex embedding participation as (value,
    vertex) pairs — served off the same partial-embedding plan, without
    ever handing the host a full (N,) vector.  Local counts are f64
    tensors on the batcher's device."""
    uid: int
    patterns: tuple
    support: bool = False               # MINI support instead of counts
    local: bool = False                 # partial-embedding tensors
    anchor: int | None = None           # pattern vertex pin (local=True)
    top_k: int | None = None            # hottest-vertex reader
    counts: dict = field(default_factory=dict)
    supports: dict = field(default_factory=dict)
    local_counts: dict = field(default_factory=dict)
    hotspots: dict = field(default_factory=dict)
    from_cache: bool = False
    done: bool = False
    error: bool = False                 # served neither compiled nor direct


class PatternQueryBatcher:
    """Compile-once-execute-many serving loop for pattern counts.

    Queued requests are drained up to ``max_batch`` per step and grouped
    by (canonical pattern-set signature, support flag, local flag); each
    group compiles (or cache-hits) one joint plan and executes it for
    every request in the group.  Labelled patterns ride the same path —
    decomposition joins included — ``support=True`` requests are served
    off the plan's MINI-domain nodes, and ``local=True`` requests off
    its partial-embedding ``LocalCount`` outputs (anchored vectors pin
    ``req.anchor``; different anchors share one plan — every orbit's
    vector is compiled).  ``top_k=K`` requests return only the K
    hottest vertices by embedding participation as (value, vertex)
    pairs, reduced off the same anchored orbit vectors.  A shared
    ``CountingEngine`` on ``device`` (None: the CUDA device, raising
    without one) keeps the hom memo warm across plans, so even distinct
    pattern sets reuse overlapping quotient contractions; every compile
    takes its device from that engine (with ``mesh=`` and no ``device``,
    the mesh's first slot).
    """

    def __init__(self, graph, *, cache=None, apct=None, max_batch: int = 8,
                 verify_plans: bool = True, mesh=None, morph=False,
                 device=None):
        from repro_torch.compiler import PlanCache
        from repro_torch.core.counting import CountingEngine
        self.graph = graph
        self.cache = cache if cache is not None else PlanCache()
        self.apct = apct
        self.max_batch = max_batch
        # morphing count algebra (compiler.morph): False off, True the
        # process store, or a CountStore instance — every compile this
        # batcher issues feeds and reads it, so clustered query traffic
        # (motif families) serves algebraically after a few warm plans
        self.morph = morph
        # layer-1 mesh execution: plans compile against the mesh (their
        # CutJoin/LocalCount routes shard over it) and each step's
        # requests fan out round-robin over the mesh's slots.  None keeps
        # the single-device serving loop unchanged.
        self.mesh = mesh
        self._executor = None
        if mesh is not None:
            from repro_torch.distributed.cutjoin import MeshExecutor
            self._executor = MeshExecutor(mesh)
            if device is None:
                device = mesh.home
        # statically verify every plan this batcher compiles (and, via
        # the cache's own verify pass, every plan it loads from disk) —
        # a malformed plan becomes a compile-phase fallback, never a
        # wrong count served to a request
        self.verify_plans = verify_plans
        self.counter = CountingEngine(graph, device=device)
        self.device = self.counter.device
        self.queue: collections.deque = collections.deque()
        self.finished: list = []
        self._plans: dict = {}          # pattern-set signature -> CompiledPlan
        # dict-shaped view backed by the metrics registry ("batcher.*"):
        # fallbacks/errors carry per-phase splits — "compile" means the
        # group never got a plan (compilation failed), "execute" means a
        # lowered plan refused at run time (e.g. PlanTooWide) — the
        # plain totals remain for every pre-existing consumer
        self.stats = obs.StatsView(
            "batcher", keys=("steps", "compiles", "cache_hits",
                             "fallbacks", "fallbacks_compile",
                             "fallbacks_execute", "errors",
                             "errors_compile", "errors_execute"))

    def submit(self, req: PatternRequest):
        self.queue.append(req)

    def _plan_for(self, sig, patterns: tuple, domains: bool, local: bool):
        """CompiledPlan for one group, memoised per (signature, domains,
        local) so repeat steps reuse the lowered plan (and its
        node-value memo) instead of re-lowering on every plan-cache hit.
        None when compilation fails — callers serve the group via the
        direct path — except for a ``KernelError``, which propagates.
        ``domains`` compiles MINI-domain nodes for support queries;
        ``local`` compiles partial-embedding outputs."""
        cp = self._plans.get((sig, domains, local))
        if cp is not None:
            self.stats["cache_hits"] += 1
            return cp
        from repro_torch import compiler
        key = compiler.plan_key(patterns, self.graph)
        if key not in self.cache and self.apct is None:
            from repro_torch.core.apct import APCT
            self.apct = APCT(self.graph)       # one profile, all compiles
        try:
            cp = compiler.compile(patterns, self.graph, apct=self.apct,
                                  counter=self.counter, cache=self.cache,
                                  domains=domains, local=local,
                                  verify=self.verify_plans,
                                  mesh=self.mesh, morph=self.morph)
        except KernelError:
            raise
        except Exception:
            return None
        self.stats["cache_hits" if cp.from_cache else "compiles"] += 1
        self._plans[(sig, domains, local)] = cp
        return cp

    def _local_direct(self, p, anchor):
        """Direct-path partial-embedding fallback over the shared
        engine; None for an unanchored query on a cut-less pattern."""
        from repro_torch.api import local_counts as api_local
        try:
            return api_local(p, self.graph, anchor=anchor,
                             counter=self.counter,
                             use_compiler=False).counts
        except ValueError:
            return None

    def _hotspots(self, p, cp, k: int) -> list:
        """Top-k (value, vertex) pairs of per-vertex embedding
        participation, read off the compiled plan's anchored orbit
        vectors through the shared reduction."""
        from repro_torch.api import plan_vertex_counts, top_vertices
        return top_vertices(plan_vertex_counts(cp, p), k)

    def _serve(self, req: PatternRequest, cp):
        """Fill one request: compiled plan first, legacy direct second;
        a request is always finished, never silently dropped, unless a
        ``KernelError`` propagates.  Fallbacks and errors are counted
        under the phase that failed: ``compile`` when no plan exists for
        the group, ``execute`` when the lowered plan raised —
        distinguishing "the compiler can't plan this" from "the plan
        refused this graph" (e.g. PlanTooWide)."""
        from repro_torch.core.fsm import mini_support
        phase = "compile" if cp is None else "execute"
        try:
            if cp is None:
                raise RuntimeError("no compiled plan")
            if req.support:
                req.supports = {p: cp.mini_support(p)
                                for p in req.patterns}
            elif req.top_k is not None:
                req.hotspots = {p: self._hotspots(p, cp, req.top_k)
                                for p in req.patterns}
            elif req.local:
                req.local_counts = {
                    p: (cp.local_counts(p, req.anchor)
                        if cp.has_local(p, req.anchor) else None)
                    for p in req.patterns}
            else:
                req.counts = {p: cp.count(p) for p in req.patterns}
            req.from_cache = cp.from_cache
        except KernelError:
            raise
        except Exception:
            try:                        # e.g. PlanTooWide at execution
                if req.support:
                    req.supports = {p: mini_support(self.counter, p)
                                    for p in req.patterns}
                elif req.top_k is not None:
                    from repro_torch.api import vertex_counts
                    req.hotspots = {
                        p: vertex_counts(p, self.graph,
                                         counter=self.counter,
                                         use_compiler=False,
                                         top_k=req.top_k)
                        for p in req.patterns}
                elif req.local:
                    req.local_counts = {
                        p: self._local_direct(p, req.anchor)
                        for p in req.patterns}
                else:
                    req.counts = {p: self.counter.edge_induced(p)
                                  for p in req.patterns}
                req.from_cache = False
                self.stats["fallbacks"] += 1
                self.stats[f"fallbacks_{phase}"] += 1
            except KernelError:
                raise
            except Exception:
                req.error = True
                self.stats["errors"] += 1
                self.stats[f"errors_{phase}"] += 1
        req.done = True
        self.finished.append(req)

    def step(self) -> bool:
        from repro_torch.compiler.cache import patterns_signature
        if not self.queue:
            return False
        batch = [self.queue.popleft()
                 for _ in range(min(self.max_batch, len(self.queue)))]
        groups: dict = {}
        for req in batch:
            # hottest-vertex requests ride the partial-embedding plan
            # (anchored orbit vectors), so they group with local=True
            groups.setdefault(
                (patterns_signature(req.patterns), req.support,
                 req.local or req.top_k is not None), []).append(req)
        for (sig, support, local), reqs in groups.items():
            cp = self._plan_for(sig, reqs[0].patterns, support, local)
            if self._executor is not None and len(reqs) > 1:
                self._executor.map(lambda req: self._serve(req, cp), reqs)
            else:
                for req in reqs:
                    self._serve(req, cp)
        self.stats["steps"] += 1
        return True

    def run_to_completion(self, max_steps: int = 10_000) -> int:
        steps = 0
        while self.queue and steps < max_steps:
            self.step()
            steps += 1
        return steps
