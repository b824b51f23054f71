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
slot's rows in place.  The graph-mining half, ``PatternQueryBatcher`` and
``PatternRequest``, is not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
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
