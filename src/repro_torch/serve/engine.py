"""Serving steps: prefill (build KV cache from a prompt batch) and decode
(one token against the cache).  PyTorch runs them eagerly: there is no
``jit``, and the decode step writes the caches it is given in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Model, cache_specs, init_cache


def make_prefill_step(cfg: ModelConfig):
    model = Model(cfg)

    def prefill_step(params, inputs, image_embeds=None):
        logits, caches, _ = model(params, inputs, mode="prefill",
                                  image_embeds=image_embeds)
        last = logits[:, -1, :]
        return last, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    model = Model(cfg)

    def decode_step(params, caches, inputs, positions, image_embeds=None):
        logits, new_caches, _ = model(params, inputs, mode="decode",
                                      positions=positions, caches=caches,
                                      image_embeds=image_embeds)
        return logits[:, 0, :], new_caches

    return decode_step


def greedy_sample(logits):
    """Index of the largest logit; ties go to the first, as in JAX."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


__all__ = ["make_prefill_step", "make_decode_step", "greedy_sample",
           "cache_specs", "init_cache"]
