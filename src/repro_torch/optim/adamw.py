"""Sharded AdamW: the pure per-shard update of the training engine.

Port of ``repro.optim.adamw`` (``adamw_update`` :20, ``cosine_lr`` :36).
Every rank updates only its optimizer shard of the fp32 master (paper §V-C),
so the optimizer itself needs no communication. Scalars are f32 tensors, as
they are f32 arrays in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWOut(NamedTuple):
    master: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


def adamw_update(master, m, v, grad, *, step: int, lr, beta1: float = 0.9,
                 beta2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> AdamWOut:
    """One decoupled-weight-decay Adam step on a flat fp32 shard. ``step`` is
    the 1-based step index (bias correction); ``lr`` an f32 scalar."""
    g = grad.float()
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g.square()
    t = torch.tensor(float(step), dtype=torch.float32, device=master.device)
    mh = m / (1 - torch.pow(beta1, t))
    vh = v / (1 - torch.pow(beta2, t))
    upd = mh / (vh.sqrt() + eps)
    new_master = master * (1 - lr * weight_decay) - lr * upd
    return AdamWOut(new_master, m, v)


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
