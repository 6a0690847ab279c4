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
INT4_QMAX = 7.0     # symmetric signed 4-bit: [-7, 7]
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


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., 2n) integer levels in [-7, 7] -> (..., n) uint8: +8, element 2i
    in the low nibble, 2i + 1 in the high nibble."""
    q = q.to(torch.int32) + 8
    return (q[..., 0::2] | (q[..., 1::2] << 4)).to(torch.uint8)


def quantize_int4_ref(blocks: torch.Tensor):
    """(nb, bs) float -> ((nb, bs // 2) uint8 packed, (nb, 1) f32 scales)."""
    scales = _scales(blocks, INT4_QMAX)
    q = torch.clamp(torch.round(blocks.float() / scales), -INT4_QMAX, INT4_QMAX)
    return _pack_int4(q), scales


def dequantize_int4_ref(packed: torch.Tensor, scales: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """(nb, bs // 2) uint8, (nb, 1) f32 -> (nb, bs) ``dtype``: the low nibble
    to the even element, the high to the odd, (nibble - 8) * scale in f32."""
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 8
    hi = ((p >> 4) & 0xF) - 8
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return (out.float() * scales).to(dtype)


def dequantize_int8_sum_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(d, nb, bs) int8, (d, nb, 1) f32 -> (nb, bs) f32: the sum over the d
    chunks of their dequantized values, in order j = 0..d-1."""
    acc = dequantize_int8_ref(q[0], scales[0])
    from .ops import meta_trips
    chunks, counted = meta_trips(q.shape[0] - 1, q.device, start=1)
    with counted:
        for j in chunks:
            acc = acc + dequantize_int8_ref(q[j], scales[j])
    return acc


def dequantize_int4_sum_ref(packed: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """(d, nb, bs // 2) uint8, (d, nb, 1) f32 -> (nb, bs) f32: the sum over
    the d chunks of their dequantized values, in order j = 0..d-1."""
    acc = dequantize_int4_ref(packed[0], scales[0])
    from .ops import meta_trips
    chunks, counted = meta_trips(packed.shape[0] - 1, packed.device, start=1)
    with counted:
        for j in chunks:
            acc = acc + dequantize_int4_ref(packed[j], scales[j])
    return acc


def matmul_quant_ref(x: torch.Tensor, g: torch.Tensor, block: int, *,
                     bits: int = 8):
    """C = x.T @ g in f32 (x (M, K), g (M, N)), then block-quantized along
    each row: (q (K, N) int8 | (K, N // 2) uint8 packed, scales
    (K, N // block) f32). One f32 matmul, so the sum runs in another order
    than the reference's blocked loop (tests state the tolerance)."""
    kk, n = x.shape[1], g.shape[1]
    qmax = INT4_QMAX if bits == 4 else INT8_QMAX
    c = (x.float().T @ g.float()).reshape(kk, n // block, block)
    scales = _scales(c, qmax)
    qv = torch.clamp(torch.round(c / scales), -qmax, qmax).reshape(kk, n)
    q = _pack_int4(qv) if bits == 4 else qv.to(torch.int8)
    return q, scales.reshape(kk, n // block)


def dequant_matmul_blocked_ref(x: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(q (K, N) int8) -> (M, N) f32 with 2-D blocked
    scales (K // bk, N): the scale of q[k, n] is scales[k // bk, n]. One f32
    matmul, so the sum runs in another order than the reference's K-blocked
    loop (tests state the tolerance)."""
    kb = q.shape[0] // scales.shape[0]
    w = q.float() * scales.repeat_interleave(kb, dim=0)
    return x.float() @ w


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


def selective_scan_ref(dt, x, b, c, a, h0):
    """dt, x (B, S, D); b, c (B, S, N); a (D, N); h0 (B, D, N) ->
    (y (B, S, D) f32, h_last (B, D, N) f32).

    The Mamba-1 recurrence in time order, in f32, with the reference's
    per-step ops (``repro.kernels.ref._scan_block``): da = exp(dt * a),
    dbx = (dt * x) * b, h = da * h + dbx, y_t = sum_N h * c. The reference
    blocks time into chunks, which never changes the arithmetic, so this is
    one loop over S (one step on meta, ``ops.meta_trips``)."""
    dt, x, b, c = (t.float() for t in (dt, x, b, c))
    af = a.float()
    h = h0.float()
    y = torch.empty(dt.shape, dtype=torch.float32, device=dt.device)
    from .ops import meta_trips
    steps, counted = meta_trips(dt.shape[1], dt.device)
    with counted:
        for t in steps:
            dtf = dt[:, t]                                    # (B, D)
            da = torch.exp(dtf[..., None] * af[None])         # (B, D, N)
            dbx = (dtf * x[:, t])[..., None] * b[:, t, None, :]
            h = da * h + dbx
            y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return y, h


SCAN_BWD_BLOCK = 256    # time steps a block, as the reference's oracle


def selective_scan_ref_vjp(dt, x, b, c, a, h0, gy, gh):
    """Autograd through ``selective_scan_ref`` for the cotangents gy of y
    and gh of h_last, one block of SCAN_BWD_BLOCK time steps at a time, as
    the reference's oracle rematerialises its 256-step blocks
    (``jax.checkpoint(_scan_block)``): a forward without a graph gives each
    block's start state, then each block is run again under autograd from
    its start state, last block first, carrying dh backwards. Only one
    block's graph is alive at a time; the per-step ops are those of the
    plain version, so the blocks' forward values are its values. The last
    block may be short.

    Returns (d dt, d x, d b, d c, d a, d h0), all f32."""
    from .ops import meta_trips
    dt, x, b, c, a, h0 = (t.detach().float() for t in (dt, x, b, c, a, h0))
    starts = range(0, dt.shape[1], SCAN_BWD_BLOCK)
    with torch.no_grad():
        h_starts, h = [], h0
        for t0 in starts:
            h_starts.append(h)
            _, h = selective_scan_ref(*(t[:, t0:t0 + SCAN_BWD_BLOCK]
                                        for t in (dt, x, b, c)), a, h)
    grads = [torch.zeros_like(t) for t in (dt, x, b, c)]
    da = torch.zeros_like(a)
    dh = gh.float()
    for t0, hs in zip(reversed(starts), reversed(h_starts)):
        sl = slice(t0, t0 + SCAN_BWD_BLOCK)
        leaves = [t[:, sl].clone().requires_grad_() for t in (dt, x, b, c)]
        leaves += [a.clone().requires_grad_(), hs.clone().requires_grad_()]
        with torch.enable_grad():
            yb, hb = selective_scan_ref(*leaves)
        # on meta the block's graph holds one step (``ops.meta_trips``), so
        # its backward is counted once a step of the block
        _, counted = meta_trips(leaves[0].shape[1], dt.device)
        with counted:
            *got, d_a, dh = torch.autograd.grad((yb, hb), leaves,
                                                (gy[:, sl].float(), dh))
        for g, d in zip(grads, got):
            g[:, sl] = d
        da += d_a
    return (*grads, da, dh)
