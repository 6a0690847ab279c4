"""Shared model layers: RMSNorm, LayerNorm, the tanh GELU, RoPE, attention,
decode attention, chunked cross-entropy.

Port of ``repro.models.layers``. Full-sequence attention (training and
prefill) goes through the kernel dispatch (``ops.flash_attention``,
differentiable) behind the reference's ``ops.attention_fusable`` gate; a
shape the gate rejects (a sequence under 8, or over 128 and not a
multiple of 128, as whisper's 1,500 frames; a value width other than the
key width, as MLA's) is recorded (``ops.record_fallback``, warned once)
and runs the reference's chunked attention in plain PyTorch: an f32
online softmax over KV chunks at the value's width, each query chunk
recomputed in the backward. Decode attention (``flash_decode``, and ``ring_decode`` over a
sliding window's ring) is plain PyTorch, as it is plain jnp in the
reference. On a mesh, a full-attention cache is sharded along the sequence
over the model-tier axes: ``flash_decode`` takes this rank's slice, its
softmax partials combined exactly over those axes (``core.collectives``
``seq_max`` / ``seq_sum``), and ``sharded_cache_write`` writes only the
positions this rank owns. The offsets are host integers from the bound
mesh (``seq_offset``), where the reference traces ``lax.axis_index``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import collectives as col
from ..kernels import ops

NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """f32 mean and population variance (two passes, as ``jnp.var``)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default form: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rope_freqs(positions, dim: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., dim//2), fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D//2) broadcast over heads."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def _attend_q_chunk(qb, kc, vc, qp, kp, causal: bool, window: int,
                    scale: float, out_dtype):
    """One query chunk against every KV chunk: the reference's ``q_body``.
    qb (B, H, C, D); kc, vc (nk, B, H, Ck, D); qp (C,), kp (nk, Ck) global
    positions. Returns (B, H, C, Dv) at ``out_dtype``."""
    b, h, c, _ = qb.shape
    dv = vc.shape[-1]
    acc = torch.zeros((b, h, c, dv), dtype=torch.float32, device=qb.device)
    m = torch.full((b, h, c), NEG_INF, dtype=torch.float32, device=qb.device)
    denom = torch.zeros((b, h, c), dtype=torch.float32, device=qb.device)
    q32 = qb.float()
    for j in range(kc.shape[0]):
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kc[j].float()) * scale
        mask = torch.ones((c, kp.shape[1]), dtype=torch.bool, device=qb.device)
        if causal:
            mask &= qp[:, None] >= kp[j][None, :]
        if window:
            mask &= qp[:, None] - kp[j][None, :] < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vc[j].float())
        m = m_new
    return (acc / torch.clamp(denom[..., None], min=1e-30)).to(out_dtype)


def _chunked_attention(q, k, v, *, causal: bool, window: int, q_chunk: int,
                       kv_chunk: int, q_offset: int, softmax_scale):
    """The reference's fallback (``layers.py:118-166``): GQA expanded, the
    sequences cut into ``_best_chunk`` chunks, an f32 online softmax over
    the KV chunks for each query chunk, which the backward recomputes
    (``jax.checkpoint`` of the scan body there, ``torch.utils.checkpoint``
    here)."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    q_chunk = _best_chunk(sq, q_chunk)
    kv_chunk = _best_chunk(sk, kv_chunk)
    nq, nk = sq // q_chunk, sk // kv_chunk
    qc = q.reshape(b, nq, q_chunk, h, d).permute(1, 0, 3, 2, 4)
    kc = k.reshape(b, nk, kv_chunk, h, d).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nk, kv_chunk, h, dv).permute(1, 0, 3, 2, 4)
    q_pos = q_offset + torch.arange(sq, device=q.device).reshape(nq, q_chunk)
    k_pos = torch.arange(sk, device=q.device).reshape(nk, kv_chunk)
    outs = [checkpoint(_attend_q_chunk, qc[i], kc, vc, q_pos[i], k_pos, causal,
                       window, scale, q.dtype, use_reentrant=False)
            for i in range(nq)]
    # nq x (B, H, C, Dv) -> (B, S, H, Dv)
    return torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sq, h, dv)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    q_offset: int = 0, softmax_scale: float | None = None,
                    impl: str | None = None):
    """q (B,Sq,H,D); k,v (B,Sk,Hkv,D). Returns (B,Sq,H,Dv).

    ``window`` > 0: sliding-window causal attention; ``q_offset``: global
    position of q[0] relative to k[0]. A fusable shape goes to the kernel
    dispatch with heads folded into the leading dim (query head h reads KV
    head h // (H / Hkv), the GQA fold); any other is recorded as a fallback
    and runs the chunked plain path (``q_chunk``, ``kv_chunk``)."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    fusable, reason = ops.attention_fusable(
        sq, sk, d, v.shape[-1], softmax_scale=softmax_scale, q_offset=q_offset)
    if not fusable:
        ops.record_fallback("attention", reason)
        return _chunked_attention(q, k, v, causal=causal, window=window,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk,
                                  q_offset=q_offset,
                                  softmax_scale=softmax_scale)
    qt = q.transpose(1, 2).reshape(b * h, sq, d)
    kt = k.transpose(1, 2).reshape(b * hkv, sk, d)
    vt = v.transpose(1, 2).reshape(b * hkv, sk, d)
    o = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                            q_offset=q_offset, impl=impl)
    return o.reshape(b, h, sq, d).transpose(1, 2)


def _row_positions(pos, b: int, device) -> torch.Tensor:
    """Broadcast a scalar or (B,) position to (B,) int64. A host int is
    filled on the device (no host-to-device copy, so a CUDA graph can hold
    it: the cross-attention's last frame)."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.long, device=device)
    p = torch.as_tensor(pos, device=device).long()
    return p.reshape(-1).expand(b) if p.ndim == 0 or p.numel() == 1 \
        else p.reshape(b)


def flash_decode(q, k_loc, v_loc, pos, *, seq_axes: tuple[str, ...] = (),
                 seq_offset: int = 0, softmax_scale: float | None = None):
    """Single-token decode over a (possibly sequence-sharded) KV cache.

    q: (B, H, D); k_loc/v_loc: (B, S_loc, Hkv, D), this rank's slice of the
    cache, whose entry 0 is global position ``seq_offset``; valid entries
    are positions <= pos (scalar or per-row (B,), for continuous batching).
    The partial softmax is combined exactly over ``seq_axes``: the max over
    the axes, then the numerator and denominator summed in f32 over them
    (in axis order, so every rank of the group gets the same bits)."""
    b, h, d = q.shape
    _, s_loc, hkv, _ = k_loc.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    n_rep = h // hkv
    kpos = torch.arange(seq_offset, seq_offset + s_loc, device=q.device)
    valid = kpos[None, :] <= _row_positions(pos, b, q.device)[:, None]
    qg = q.reshape(b, hkv, n_rep, d).float()
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k_loc.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = col.seq_max(s.amax(dim=-1), seq_axes)
    p = torch.exp(s - m[..., None])
    num = col.seq_sum(torch.einsum("bgrs,bsgd->bgrd", p, v_loc.float()),
                      seq_axes)
    den = col.seq_sum(p.sum(dim=-1), seq_axes)
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(b, h, d).to(q.dtype)


def ring_decode(q, k_ring, v_ring, pos, window: int,
                softmax_scale: float | None = None):
    """Decode over a sliding-window ring cache (B, W, Hkv, D) whose slot
    pos % W was just written. ``pos`` may be per-row (B,). Slot i holds the
    largest position p <= pos with p % W == i; it is attended when p >= 0
    and p > pos - window."""
    b, h, d = q.shape
    _, w, hkv, _ = k_ring.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    n_rep = h // hkv
    slot = torch.arange(w, device=q.device)
    pos_b = _row_positions(pos, b, q.device)[:, None]
    gpos = pos_b - (pos_b - slot[None, :]) % w
    valid = (gpos >= 0) & (gpos > pos_b - window)         # (B, W)
    qg = q.reshape(b, hkv, n_rep, d).float()
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k_ring.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_ring.float())
    return out.reshape(b, h, d).to(q.dtype)


def ring_cache_write(ring, new, pos):
    """Write ``new`` (B, 1, Hkv, D) at slot pos % W of ``ring`` (B, W, Hkv,
    D), IN PLACE, and return the ring. ``pos`` is a scalar or per-row (B,)
    tensor: row r writes its own slot, so no row touches another's ring, and
    the write reads no position on the host (a CUDA graph can hold it). The
    reference writes one scalar slot for every row
    (``lax.dynamic_update_slice_in_dim``), which is the same at a shared
    position."""
    b, w = ring.shape[:2]
    slot = _row_positions(pos, b, ring.device) % w
    ring[torch.arange(b, device=ring.device), slot] = new[:, 0].to(ring.dtype)
    return ring


def sharded_cache_write(cache_loc, new, pos, *, seq_axes: tuple[str, ...] = (),
                        axis_sizes: dict[str, int] | None = None):
    """Write ``new`` (B, 1, *tail) at global sequence position ``pos`` of
    ``cache_loc`` (B, S_loc, *tail), IN PLACE, and return the cache: K or V
    (tail Hkv, D), or an MLA latent (tail kv_lora + qk_rope: the
    reference's ``_lat_write``).

    ``cache_loc`` is this rank's contiguous slice of the global (B, S, ...)
    cache over ``seq_axes`` (major -> minor), and only the owner of a
    position writes it: a scalar ``pos`` outside this rank's range writes
    nothing (the reference's masked update), and so does each row of a
    per-row (B,) ``pos`` whose position lies outside it. Unsharded, a
    per-row write lands at each row's position: callers keep them inside
    the cache (the batcher retires a slot before it reaches max_len). The
    per-row write reads no position on the host (a CUDA graph can hold
    it)."""
    b, s_loc = cache_loc.shape[:2]
    sharded = col.mesh_size(seq_axes) > 1
    off = seq_offset(seq_axes, axis_sizes, s_loc) if sharded else 0
    p = torch.as_tensor(pos, device=cache_loc.device)
    val = new[:, 0].to(cache_loc.dtype)
    if p.ndim == 0:
        # read where it lies: a host position (the dry run's, beside a
        # cache on meta) needs no read from the device
        i = int(pos) - off
        if 0 <= i < s_loc:
            cache_loc[:, i] = val
        return cache_loc
    rows = torch.arange(b, device=cache_loc.device)
    if not sharded:
        cache_loc[rows, p.long()] = val
        return cache_loc
    local = p.long() - off
    inb = (local >= 0) & (local < s_loc)
    idx = local.clamp(0, s_loc - 1)
    inb = inb.reshape((b,) + (1,) * (val.ndim - 1))
    cache_loc[rows, idx] = torch.where(inb, val, cache_loc[rows, idx])
    return cache_loc


def _linear_index(axes: tuple[str, ...], axis_sizes: dict[str, int]) -> int:
    """This rank's row-major index over ``axes`` (major -> minor), from the
    bound mesh's coordinates."""
    idx = 0
    for a in axes:
        idx = idx * axis_sizes[a] + (col.mesh_coord(a) if axis_sizes[a] > 1
                                     else 0)
    return idx


def seq_offset(axes: tuple[str, ...], axis_sizes: dict[str, int],
               s_loc: int) -> int:
    """Global position of this rank's first entry of a cache (or sequence
    chunk) of ``s_loc`` positions sharded over ``axes``."""
    return _linear_index(axes, axis_sizes) * s_loc


def _best_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    for c in range(min(target, s), 0, -1):
        if s % c == 0:
            return c
    return 1


def _ce_chunk(xi, w_vocab, li, mi):
    logits = xi.float() @ w_vocab.float().T
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, li[..., None].long())[..., 0]
    return ((lse - gold) * mi).sum()


def chunked_cross_entropy(x, w_vocab, labels, mask, *, chunk: int = 512):
    """Next-token CE without materializing (B, S, V).

    x (B, S, d) final hidden states; w_vocab (V, d) dense LM head; labels
    (B, S) int; mask (B, S) {0, 1}. Each chunk of ``chunk`` positions is
    recomputed in the backward (the reference's checkpointed scan body).
    Returns (loss_sum f32, token_count)."""
    s = x.shape[1]
    chunk = _best_chunk(s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_ce_chunk, x[:, sl], w_vocab, labels[:, sl],
                                   mask[:, sl], use_reentrant=False)
    return total, mask.sum()
