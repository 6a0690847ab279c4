"""Sharded AdamW: the pure per-shard update of the training engine.

Port of ``repro.optim.adamw`` (``adamw_update`` :20, ``cosine_lr`` :36).
Every rank updates only its optimizer shard of the fp32 master (paper §V-C),
so the optimizer itself needs no communication. Scalars are f32 tensors, as
they are f32 arrays in the reference.

``adamw_update_`` writes the step into the given master, m and v: what the
reference's step does to its donated state (``src/repro/core/engine.py:643``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWOut(NamedTuple):
    master: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


def adamw_update_(master, m, v, grad, *, step: int, lr, beta1: float = 0.9,
                  beta2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.0) -> AdamWOut:
    """One decoupled-weight-decay Adam step on a flat fp32 shard, in place:
    ``master``, ``m`` and ``v`` take the new values and are returned.
    ``step`` is the 1-based step index (bias correction); ``lr`` an f32
    scalar. Every element goes through the reference's f32 operations in
    its order, each product and sum rounded on its own (no fused ``alpha=``
    / ``addcmul_`` forms); at most two shard-sized temporaries live at
    once."""
    g = grad.float()
    m.mul_(beta1).add_(g * (1 - beta1))
    sq = g.square()
    v.mul_(beta2).add_(sq.mul_(1 - beta2))
    del sq
    t = torch.tensor(float(step), dtype=torch.float32, device=master.device)
    upd = m / (1 - torch.pow(beta1, t))
    vh = v / (1 - torch.pow(beta2, t))
    upd.div_(vh.sqrt_().add_(eps))
    del vh
    master.mul_(1 - lr * weight_decay).sub_(upd.mul_(lr))
    return AdamWOut(master, m, v)


def cosine_lr(step: int, *, base_lr: float, warmup_steps: int,
              total_steps: int, min_frac: float = 0.1,
              device=None) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_frac`` of ``base_lr`` (f32)."""
    s = torch.tensor(float(step), dtype=torch.float32, device=device)
    warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return base_lr * warm * cos
