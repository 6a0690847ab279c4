"""Plain PyTorch versions of the ported kernels.

The port's counterpart of ``repro.kernels.ref``: each function computes what
its kernel computes, with ordinary tensor ops, on any device. The CPU runs
them in place of the kernels (kernels/ops.py dispatches by the tensor's
device), the tests hold them against the JAX package, and chip_smoke.py
holds each CUDA kernel against them on the card.

All quantization functions work on 2-D ``(num_blocks, block_size)`` views;
``ops.py`` owns the flatten/reshape plumbing.
"""
from __future__ import annotations

import math

import torch

INT8_QMAX = 127.0
NEG_INF = -1e30


def _scales(blocks: torch.Tensor, qmax: float) -> torch.Tensor:
    absmax = blocks.float().abs().amax(dim=-1, keepdim=True)
    # multiply by the f32 reciprocal: XLA folds `absmax / qmax` into this
    # under jit, and the reference always quantizes under jit
    return torch.where(absmax == 0.0, 1.0, absmax * (1.0 / qmax))


def quantize_int8_ref(blocks: torch.Tensor):
    """(nb, bs) float -> ((nb, bs) int8, (nb, 1) f32 scales)."""
    scales = _scales(blocks, INT8_QMAX)
    q = torch.clamp(torch.round(blocks.float() / scales), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scales


def dequantize_int8_ref(q: torch.Tensor, scales: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """(nb, bs) int8, (nb, 1) f32 -> (nb, bs) ``dtype``: q * scale in f32."""
    return (q.float() * scales).to(dtype)


def dequant_w_flat_ref(q: torch.Tensor, scales: torch.Tensor,
                       block: int) -> torch.Tensor:
    """(K, N) int8 with flat-layout scales (K, N // block) -> f32 (K, N):
    the scale of q[k, j] is scales[k, j // block]."""
    k, n = q.shape
    s = scales[:, :, None].expand(k, n // block, block).reshape(k, n)
    return q.float() * s


def dequant_matmul_flat_ref(x: torch.Tensor, q: torch.Tensor,
                            scales: torch.Tensor, block: int, *,
                            transpose: bool = False,
                            dtype=torch.float32) -> torch.Tensor:
    """x @ dequant(q) (transpose=False: x (M, K) -> (M, N)) or
    x @ dequant(q).T (transpose=True: x (M, N) -> (M, K)), f32 products and
    sums, cast to ``dtype``. One f32 matmul, so the summation order differs
    from the reference's blocked loop (tests state the tolerance)."""
    w = dequant_w_flat_ref(q, scales, block)
    if transpose:
        w = w.T
    return (x.float() @ w).to(dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q (BH, Sq, D); k, v (BH, Sk, D) -> (BH, Sq, D) in q's dtype.

    Masked softmax attention with the kernel's conventions: the scale is
    folded into q before the dot, masked scores are NEG_INF (not -inf), the
    output is acc / max(l, 1e-30), and a call whose mask is empty everywhere
    returns zeros."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    last_q = q_offset + sq - 1
    run = True
    if causal:
        run = run and (0 <= last_q)
    if window:
        run = run and (sk - 1 > q_offset - window)
    if not run:
        return torch.zeros_like(q)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window:
        mask = mask & (q_pos - k_pos < window)
    s = (q.float() * scale) @ k.float().transpose(1, 2)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p @ v.float()
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
