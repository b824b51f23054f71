"""Training step: CE loss, microbatched gradient accumulation, AdamW.

The reference package's ``repro.train.train_step``.
``make_train_step(cfg, opt_cfg, microbatches)`` returns a function
``(state, batch) -> (state, metrics)`` over the reference's state tree,
``{"params", "opt": {"m", "v", "step"}}``.  Gradients come from
``torch.autograd.grad`` through the model's training forward (on the card
every attention layer longer than ``flash_block`` runs K9 and, in the
backward, K9-bwd).  With microbatches the reference's ``lax.scan`` is a
loop over row slices of the batch: the gradient sum starts at zeros in the
reference's dtypes (f32 for f32 parameters, bf16 otherwise), is added to
in place and divided by the microbatch count; the loss is the mean ce.
The optimizer then updates the state in place (``train.optimizer``), and
the returned state holds the same tensors.

``abstract_state`` and ``state_axes`` (allocation-free lowering and the
logical-axis rules) wait for ``dryrun`` and the mesh rules (ROADMAP queue
1, item 13e).
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train import tree


def cross_entropy(logits, labels):
    """logits (B,S,V), labels (B,S) -> mean loss (f32)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def make_loss_fn(cfg: ModelConfig, model: Model, aux_weight: float = 0.01):
    def loss_fn(params, mb):
        logits, _, aux = model(params, mb["inputs"], mode="train",
                               image_embeds=mb.get("image_embeds"))
        ce = cross_entropy(logits, mb["labels"])
        return ce + aux_weight * aux, ce
    return loss_fn


def make_grad_fn(cfg: ModelConfig, microbatches: int = 1):
    """``(params, batch) -> (loss, ce, grads)``: the gradient half of the
    train step, grads a tree of the parameters' structure."""
    loss_fn = make_loss_fn(cfg, Model(cfg))

    def grad_fn(params, batch):
        flat, structure = tree.flatten(params)
        dev = flat[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if microbatches == 1:
            loss, ce = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, flat)
            return loss.detach(), ce.detach(), tree.unflatten(structure,
                                                              grads)
        gsum = [torch.zeros(p.shape, device=dev,
                            dtype=torch.float32 if p.dtype == torch.float32
                            else torch.bfloat16) for p in flat]
        ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
        rows = next(iter(batch.values())).shape[0] // microbatches
        for i in range(microbatches):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            loss, ce = loss_fn(params, mb)
            for acc, g in zip(gsum, torch.autograd.grad(loss, flat)):
                acc.add_(g)
            ce_sum = ce_sum + ce.detach()
        for acc in gsum:
            acc.div_(microbatches)
        loss = ce = ce_sum / microbatches
        return loss, ce, tree.unflatten(structure, gsum)

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg, microbatches: int = 1):
    grad_fn = make_grad_fn(cfg, microbatches)

    def train_step(state, batch):
        params = state["params"]
        loss, ce, grads = grad_fn(params, batch)
        new_params, new_opt, stats = opt.update(opt_cfg, grads, state["opt"],
                                                params)
        new_state = {"params": new_params, "opt": new_opt}
        metrics = {"loss": loss.to(torch.float32),
                   "ce": ce.to(torch.float32), **stats}
        return new_state, metrics

    return train_step


def init_state(cfg: ModelConfig, opt_cfg, seed: int = 0, device=None):
    """Parameters drawn from ``seed`` on ``device`` (``None`` means CUDA),
    marked ``requires_grad``, and zero moments."""
    params = Model(cfg).init(seed, device=_device.resolve(device))
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt.init(opt_cfg, params)}
