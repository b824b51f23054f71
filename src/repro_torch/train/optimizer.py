"""AdamW with cosine schedule, global-norm clipping, and configurable
moment dtype (f32 / bf16) for memory-constrained very-large models.

The reference package's ``repro.train.optimizer``, with its arithmetic in
the same order: the gradient scaled by min(1, clip / max(‖g‖, 1e-9)), m and
v in f32 with bias corrections c1 and c2, step = m̂ / (√v̂ + eps) + wd·p,
the new p in p's dtype, m and v in ``state_dtype``.  States are trees of
the parameters' structure (``{"m", "v", "step"}``).

The reference maps a pure update over whole leaves, which XLA fuses.
Here ``update`` works **in place**, leaf by leaf and within a leaf in
chunks of ``CHUNK`` elements along its flattened (row-major) order, so the
f32 temporaries never span a whole leaf: on qwen3-4b a stacked MLP leaf,
(36, 2560, 9728), would take 3.59 GB per f32 temporary, and the update
makes about seven.  Parameters and moments are written where they lie;
``update`` returns the tensors it was given.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.train import tree

# elements per in-place chunk of a leaf: 16 Mi, 64 MiB per f32 temporary
CHUNK = 1 << 24


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # "bfloat16" halves optimizer memory


def schedule(c: OptConfig, step):
    """The learning rate at ``step`` (an integer or a tensor), f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps)
                    / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = c.min_lr_frac + (1 - c.min_lr_frac) * cos
    return c.lr * warm * frac


def init(c: OptConfig, params):
    dt = getattr(torch, c.state_dtype)
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chunks(x: torch.Tensor):
    flat = x.view(-1)
    for start in range(0, flat.numel(), CHUNK):
        yield flat[start:start + CHUNK]


def global_norm(grads):
    """√(Σ over leaves of Σ g²), squares summed in f32 chunk by chunk."""
    total = None
    for g in tree.leaves(grads):
        for part in _chunks(g.contiguous()):
            s = torch.sum(torch.square(part.to(torch.float32)))
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(c: OptConfig, grads, state, params):
    """Returns (params, state, stats): the parameters and moments are
    updated in place and returned; ``state["step"]`` is a new tensor."""
    step = state["step"] + 1
    lr = schedule(c, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = c.b1, c.b2
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)

    flat_p, structure = tree.flatten(params)
    for p, g, m, v in zip(flat_p, tree.leaves(grads), tree.leaves(state["m"]),
                          tree.leaves(state["v"])):
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g.contiguous()),
                                  _chunks(m), _chunks(v)):
            g32 = gc.to(torch.float32) * scale
            m32 = b1 * mc.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * vc.to(torch.float32) + (1 - b2) * g32 * g32
            mh, vh = m32 / c1, v32 / c2
            p32 = pc.to(torch.float32)
            step_ = mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * p32
            pc.copy_(p32 - lr * step_)
            mc.copy_(m32)
            vc.copy_(v32)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
