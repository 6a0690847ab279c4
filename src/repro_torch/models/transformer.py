"""Decoder LM (+ an encoder): leaf specs, the training loss, prefill and
single-token decode.

Port of ``repro.models.transformer`` for these block kinds: ``attn``,
``attn_local`` and ``attn_global`` (attention + GLU MLP, SiLU or tanh GELU,
pre-norm RMSNorm, RoPE, optional QKV bias; a sliding window where the kind
has one, gemma3's 5:1 local/global pattern; RMSNorm or LayerNorm), ``moe``
(the same attention + the top-k MoE FFN of models/moe.py, whose
load-balance term the loss adds), ``neox`` (GPT-NeoX: attention and a GELU
MLP side by side on the block's input, ``x + attn(ln1(x)) + mlp(ln2(x))``,
LayerNorm with biases, full-width RoPE), ``mla`` (Multi-head Latent
Attention: queries through a low-rank ``w_dq`` / ``q_norm`` / ``w_uq``, keys
and values from a compressed latent of ``kv_lora`` plus a shared roped key
of ``qk_rope``), ``enc`` / ``dec`` (the encoder-decoder: a non-causal
encoder without RoPE over ``n_frames`` precomputed frame embeddings plus
sinusoidal positions, and a decoder whose blocks add cross-attention over
the encoder's output between self-attention and the FFN), ``mamba`` (the
Mamba-1 mixer of models/ssm.py with no FFN) and jamba's hybrid kinds
(``mamba_mlp`` / ``mamba_moe``: the mixer, then a GLU MLP or the MoE FFN;
``attn_mlp``: attention without RoPE), with a tied or separate LM
head, gemma's ``embed_scale``, and a VLM's patch prefix (``n_patches``
precomputed patch embeddings before the text, positions over both, the loss
over the text). Every weight access goes through a parameter view: the training engine's ``core.engine.ParamView`` (ZeRO
gathers with custom backwards) or serving's ``serve.resident.ResidentView``
(the INT8 residency). ``v.mm`` runs the fused dequant-matmul, ``v.get``
returns a dense leaf. The reference's ``lax.scan`` over stacked layers
becomes a Python loop over ``view.sub(i)``; in the loss each layer is
recomputed in the backward (``torch.utils.checkpoint``), as the reference
remats its scan body.

Caches: prefill returns K/V at compute dtype (prefill attends over the
un-rounded values); the serving pool stores them as bf16, and decode writes
the new K/V into the bf16 cache *before* attending over it, as the
reference does. A sliding-window layer keeps a ring of its last W
positions, position p at slot p % W (``_to_ring``); decode writes each
row's slot in place, then attends over the ring (``layers.ring_decode``).
An MLA layer caches its compressed latent ``lat`` (B, S, kv_lora + qk_rope)
alone: prefill decompresses it through ``w_ukv`` into K and V (the value
width differs from the key's, so attention takes the chunked plain path, as
in the reference), decode absorbs ``w_ukv`` into the query and attends the
latent itself (``_mla_decode``). A decoder block caches its cross K/V
``kx`` / ``vx`` over all frames once, at prefill. A mamba layer's caches
are its f32 scan state ``h`` and conv tail; decode writes both back into
the layer's cache in place.

On a mesh (``seq_axes``: the model-tier axes), a full-attention layer's
cache, and an MLA layer's latent, is sharded along the sequence: prefill
keeps this rank's chunk (``_seq_shard``), decode writes the positions this
rank owns and attends its slice with the exact distributed combine (max,
then sums, over the axes). Rings, cross caches and mamba states stay whole
on every rank. Sequence-parallel prefill (``seq_parallel``,
attention-only models) runs each rank's chunk of the prompt: K/V, roped at
their global positions, are gathered over the sequence axes (an MLA layer
gathers its latent instead, and decompresses it locally) and the local
queries attend them at a host-int ``q_offset``, so the kernel runs where
the reference, whose offset is traced, falls back to the chunked path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import collectives as col
from ..core.partition import GATHER_Q, MATMUL, PLAIN, LeafSpec
from . import layers as L
from .config import ArchConfig
from .moe import moe_ffn
from .ssm import mamba_decode, mamba_mixer


@dataclass(frozen=True)
class KindMeta:
    mixer: str                    # attn | mla | mamba
    ffn: str                      # mlp | moe | none
    window: int = 0               # sliding-window size (0 = full)
    theta: float = 10_000.0
    rope: bool = True
    causal: bool = True
    cross: bool = False           # + cross-attention (whisper decoder)
    parallel: bool = False        # parallel residual (GPT-NeoX)


def kind_meta(kind: str, cfg: ArchConfig) -> KindMeta:
    t, tg = cfg.rope_theta, cfg.rope_theta_global
    table = {
        "attn": KindMeta("attn", "mlp", window=cfg.sliding_window, theta=t),
        "attn_local": KindMeta("attn", "mlp", window=cfg.sliding_window, theta=t),
        "attn_global": KindMeta("attn", "mlp", window=0, theta=tg),
        "moe": KindMeta("attn", "moe", window=cfg.sliding_window, theta=t),
        "mla": KindMeta("mla", "mlp", theta=t),
        "neox": KindMeta("attn", "mlp", theta=t, parallel=True),
        "mamba": KindMeta("mamba", "none"),
        "mamba_mlp": KindMeta("mamba", "mlp"),
        "mamba_moe": KindMeta("mamba", "moe"),
        "attn_mlp": KindMeta("attn", "mlp", rope=False),
        "attn_moe": KindMeta("attn", "moe", rope=False),
        "enc": KindMeta("attn", "mlp", rope=False, causal=False),
        "dec": KindMeta("attn", "mlp", rope=False, cross=True),
    }
    return table[kind]


def _ported(kind: str, cfg: ArchConfig) -> KindMeta:
    """The block kinds the port runs: attention (full or sliding-window)
    with a sequential residual, RMSNorm or LayerNorm, and a GLU MLP (SiLU
    or GELU), the GELU MLP with biases under LayerNorm, or the MoE FFN with
    SiLU-GLU experts (RoPE); attention + GELU MLP with the parallel
    residual and LayerNorm (GPT-NeoX); MLA with a GLU MLP under RMSNorm;
    the encoder-decoder's ``enc`` and ``dec`` kinds (a model with an
    encoder); the mamba mixer under RMSNorm with no FFN, a GLU MLP or the
    MoE FFN with SiLU-GLU experts (jamba's ``mamba_mlp`` / ``mamba_moe``);
    any of them behind a patch prefix. Anything else raises instead of
    running wrong: among them a mamba mixer with the GELU MLP, whose
    ``w_in`` the reference's ``block_specs`` overwrites with the MLP's (a
    (d, d_ff) leaf where the mixer reads (d, 2 d_inner)), and the MoE FFN
    behind attention without RoPE, which no config has."""
    m = kind_meta(kind, cfg)
    attn_mlp = (m.mixer, m.ffn) == ("attn", "mlp")
    attn_moe = (m.mixer, m.ffn) == ("attn", "moe") and m.rope \
        and cfg.act == "silu_glu"
    glu = cfg.act in ("silu_glu", "gelu_glu")
    mamba = m.mixer == "mamba" and cfg.norm == "rms" and (
        m.ffn == "none" or (m.ffn == "mlp" and glu)
        or (m.ffn == "moe" and cfg.act == "silu_glu"))
    block = mamba \
        or ((attn_mlp or attn_moe) and not m.parallel
            and cfg.norm in ("rms", "ln") and glu) \
        or (attn_mlp and cfg.norm == "ln" and cfg.act == "gelu") \
        or ((m.mixer, m.ffn) == ("mla", "mlp") and cfg.norm == "rms" and glu)
    # cross-attention reads an encoder's output: every decoder block of a
    # model with an encoder has it, and no other block
    enc_dec = kind == "enc" or m.cross == bool(cfg.enc_layers)
    if not (block and enc_dec):
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} ({m}, norm={cfg.norm}, "
            f"act={cfg.act}) is not ported yet")
    return m


def _norm_specs(name: str, d: int, cfg: ArchConfig) -> dict[str, LeafSpec]:
    out = {name: LeafSpec(name, (d,), PLAIN, init="ones")}
    if cfg.norm == "ln":
        out[name + "_b"] = LeafSpec(name + "_b", (d,), PLAIN, init="zeros")
    return out


def block_specs(kind: str, cfg: ArchConfig) -> dict[str, LeafSpec]:
    """Per-layer leaf specs for one block kind (stack applied by the model)."""
    m = _ported(kind, cfg)
    d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hdim, cfg.d_ff
    s: dict[str, LeafSpec] = {}
    s.update(_norm_specs("ln1", d, cfg))
    if m.mixer == "mamba":
        c = cfg.ssm
        din, dtr = cfg.d_inner, cfg.dt_rank
        s["w_in"] = LeafSpec("w_in", (d, 2 * din), MATMUL)
        s["conv_w"] = LeafSpec("conv_w", (din, c.d_conv), PLAIN, init_scale=0.5)
        s["conv_b"] = LeafSpec("conv_b", (din,), PLAIN, init="zeros")
        s["w_xproj"] = LeafSpec("w_xproj", (din, dtr + 2 * c.d_state), MATMUL)
        s["w_dt"] = LeafSpec("w_dt", (dtr, din), MATMUL)
        s["dt_bias"] = LeafSpec("dt_bias", (din,), PLAIN, init="dt_bias")
        s["A_log"] = LeafSpec("A_log", (din, c.d_state), PLAIN, init="ssm_a")
        s["D"] = LeafSpec("D", (din,), PLAIN, init="ones")
        s["w_out"] = LeafSpec("w_out", (din, d), MATMUL)
        if m.ffn == "none":
            return s
    elif m.mixer == "mla":
        ml = cfg.mla
        s["w_dq"] = LeafSpec("w_dq", (d, ml.q_lora), MATMUL)
        s["q_norm"] = LeafSpec("q_norm", (ml.q_lora,), PLAIN, init="ones")
        s["w_uq"] = LeafSpec("w_uq", (ml.q_lora, h * (ml.qk_nope + ml.qk_rope)),
                             MATMUL)
        s["w_dkv"] = LeafSpec("w_dkv", (d, ml.kv_lora + ml.qk_rope), MATMUL)
        s["kv_norm"] = LeafSpec("kv_norm", (ml.kv_lora,), PLAIN, init="ones")
        s["w_ukv"] = LeafSpec("w_ukv", (ml.kv_lora, h * (ml.qk_nope + ml.v_head)),
                              MATMUL)
        s["wo"] = LeafSpec("wo", (h * ml.v_head, d), MATMUL)
    else:
        for name, shape in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                            ("wv", (d, kv * hd)), ("wo", (h * hd, d))):
            s[name] = LeafSpec(name, shape, MATMUL)
        if cfg.qkv_bias:
            for b, width in (("bq", h * hd), ("bk", kv * hd),
                             ("bv", kv * hd)):
                s[b] = LeafSpec(b, (width,), PLAIN, init="zeros")
    if m.cross:
        s.update(_norm_specs("ln_x", d, cfg))
        for name, shape in (("wq_x", (d, h * hd)), ("wk_x", (d, h * hd)),
                            ("wv_x", (d, h * hd)), ("wo_x", (h * hd, d))):
            s[name] = LeafSpec(name, shape, MATMUL)
    s.update(_norm_specs("ln2", d, cfg))
    if m.ffn == "moe":
        e, eff = cfg.moe.n_experts, cfg.moe.d_ff
        s["router"] = LeafSpec("router", (d, e), PLAIN, init_scale=0.02)
        s["w_gate"] = LeafSpec("w_gate", (e, d, eff), GATHER_Q)
        s["w_up"] = LeafSpec("w_up", (e, d, eff), GATHER_Q)
        s["w_down"] = LeafSpec("w_down", (e, eff, d), GATHER_Q)
        return s
    if cfg.act.endswith("_glu"):
        for name, shape in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                            ("w_down", (ff, d))):
            s[name] = LeafSpec(name, shape, MATMUL)
        return s
    # the GELU MLP; the reference gives it biases under LayerNorm, the only
    # norm _ported admits it with
    s["w_in"] = LeafSpec("w_in", (d, ff), MATMUL)
    s["w_out_ff"] = LeafSpec("w_out_ff", (ff, d), MATMUL)
    s["b_in"] = LeafSpec("b_in", (ff,), PLAIN, init="zeros")
    s["b_out"] = LeafSpec("b_out", (d,), PLAIN, init="zeros")
    return s


@dataclass(frozen=True)
class Ctx:
    positions: Any                      # (S_loc,) global positions
    want_cache: bool = False
    seq_axes: tuple[str, ...] = ()      # cache sequence-sharding axes
    axis_sizes: Any = None              # dict axis -> size (for offsets)
    seq_parallel: bool = False          # activations sharded over seq_axes;
    # attention gathers K/V over seq_axes (gather-KV sequence parallelism)
    q_offset: int = 0                   # global position of local chunk 0
    enc_out: Any = None                 # (B, F, d) the encoder's output


@dataclass(frozen=True)
class DecCtx:
    pos: Any                            # scalar or per-row (B,) write position
    seq_axes: tuple[str, ...] = ()
    axis_sizes: Any = None


def _norm(v, p, name, x, cfg: ArchConfig):
    if cfg.norm == "ln":
        return L.layer_norm(x, v.get(p + name), v.get(p + name + "_b"))
    return L.rms_norm(x, v.get(p + name))


def _qkv(v, p, cfg, x, positions, m: KindMeta):
    """Projections + bias + RoPE; positions broadcast against (B, S)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hdim
    q = v.mm(p + "wq", x).reshape(b, s, h, hd)
    k = v.mm(p + "wk", x).reshape(b, s, kv, hd)
    val = v.mm(p + "wv", x).reshape(b, s, kv, hd)
    if cfg.qkv_bias:
        q = q + v.get(p + "bq").reshape(h, hd)
        k = k + v.get(p + "bk").reshape(kv, hd)
        val = val + v.get(p + "bv").reshape(kv, hd)
    if m.rope:
        cos, sin = L.rope_freqs(positions, hd, m.theta)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    return q, k, val


def _seq_shard(x, ctx: Ctx):
    """This rank's sequence chunk of a locally whole (B, S, ...) tensor."""
    if not ctx.seq_axes:
        return x
    n = math.prod(ctx.axis_sizes[a] for a in ctx.seq_axes)
    s_loc = x.shape[1] // n
    off = L.seq_offset(ctx.seq_axes, ctx.axis_sizes, s_loc)
    return x[:, off:off + s_loc]


def _to_ring(k, window: int):
    """(B, S, kv, hd) -> ring (B, W, kv, hd) holding position p at slot
    p % W: the last W positions, or all S zero-padded to W when S < W."""
    b, s, kv, hd = k.shape
    if s < window:
        return torch.cat([k, k.new_zeros((b, window - s, kv, hd))], dim=1)
    ring = k.new_zeros((b, window, kv, hd))
    ring[:, torch.arange(s - window, s, device=k.device) % window] = \
        k[:, s - window:]
    return ring


def _attn_fwd(v, p, cfg, m: KindMeta, x, ctx: Ctx):
    b, s, _ = x.shape
    q, k, val = _qkv(v, p, cfg, x, ctx.positions, m)
    if ctx.seq_parallel:
        # gather-KV sequence parallelism: q stays local (S / n positions),
        # K/V (already roped at their global positions) gathered once
        k_att = col.gather_dim(k, ctx.seq_axes, 1)
        v_att = col.gather_dim(val, ctx.seq_axes, 1)
    else:
        k_att, v_att = k, val
    o = L.flash_attention(q, k_att, v_att, causal=m.causal, window=m.window,
                          q_offset=ctx.q_offset, impl=v.impl)
    out = v.mm(p + "wo", o.reshape(b, s, cfg.n_heads * cfg.hdim))
    cache = None
    if ctx.want_cache:
        if m.window:
            cache = {"k": _to_ring(k_att, m.window),
                     "v": _to_ring(v_att, m.window)}
        elif ctx.seq_parallel:
            cache = {"k": k, "v": val}        # already this rank's chunk
        else:
            cache = {"k": _seq_shard(k, ctx), "v": _seq_shard(val, ctx)}
    return out, cache


def _cross_fwd(v, p, cfg, x, ctx: Ctx):
    """Cross-attention of the decoder's (B, S, d) over the encoder's output
    ``ctx.enc_out`` (B, F, d): non-causal, no RoPE, no bias. Returns (out,
    {"kx", "vx": (B, F, H, D)} when the cache is wanted, else None)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hdim
    enc = ctx.enc_out
    f = enc.shape[1]
    q = v.mm(p + "wq_x", x).reshape(b, s, h, hd)
    k = v.mm(p + "wk_x", enc).reshape(b, f, h, hd)
    val = v.mm(p + "wv_x", enc).reshape(b, f, h, hd)
    o = L.flash_attention(q, k, val, causal=False, impl=v.impl)
    out = v.mm(p + "wo_x", o.reshape(b, s, h * hd))
    return out, ({"kx": k, "vx": val} if ctx.want_cache else None)


def _mla_fwd(v, p, cfg, m: KindMeta, x, ctx: Ctx):
    """MLA over the full sequence: the latent (kv_lora normed, then the
    shared key of qk_rope roped at its positions) decompressed through
    ``w_ukv`` into per-head K (nope, then the shared rope part) and V. The
    value width differs from the key's, so ``flash_attention`` records the
    ``mla_dv_mismatch`` fallback and runs the chunked plain path at scale
    1/sqrt(nope + rope), as the reference does. Sequence-parallel, the
    latent is gathered over the sequence axes (``lat_gather``: kv_lora +
    qk_rope values a position, where K and V would be H * (nope + rope +
    v_head)) and decompressed locally. The cache is the latent alone."""
    ml = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, vh, lora = ml.qk_nope, ml.qk_rope, ml.v_head, ml.kv_lora
    q_lat = L.rms_norm(v.mm(p + "w_dq", x), v.get(p + "q_norm"))
    q = v.mm(p + "w_uq", q_lat).reshape(b, s, h, nope + rope)
    kv_full = v.mm(p + "w_dkv", x)                   # (B, S, lora + rope)
    kv_lat = L.rms_norm(kv_full[..., :lora], v.get(p + "kv_norm"))
    cos, sin = L.rope_freqs(ctx.positions, rope, m.theta)
    q = torch.cat([q[..., :nope], L.apply_rope(q[..., nope:], cos, sin)],
                  dim=-1)
    k_rope = L.apply_rope(kv_full[:, :, None, lora:], cos, sin)[:, :, 0]
    lat = torch.cat([kv_lat, k_rope], dim=-1)        # (B, S, lora + rope)
    lat_att = col.gather_dim(lat, ctx.seq_axes, 1, op="lat_gather") \
        if ctx.seq_parallel else lat
    s_att = lat_att.shape[1]
    kv_up = v.mm(p + "w_ukv", lat_att[..., :lora]).reshape(b, s_att, h,
                                                           nope + vh)
    k = torch.cat([kv_up[..., :nope],
                   lat_att[:, :, None, lora:].expand(b, s_att, h, rope)],
                  dim=-1)
    o = L.flash_attention(q, k, kv_up[..., nope:], causal=True,
                          q_offset=ctx.q_offset, impl=v.impl)
    out = v.mm(p + "wo", o.reshape(b, s, h * vh))
    cache = None
    if ctx.want_cache:
        cache = {"lat": lat if ctx.seq_parallel else _seq_shard(lat, ctx)}
    return out, cache


def _attn_decode(v, p, cfg, m: KindMeta, x, cache, dc: DecCtx):
    b = x.shape[0]
    posv = L._row_positions(dc.pos, b, x.device)[:, None]      # (B, 1)
    q, k, val = _qkv(v, p, cfg, x, posv, m)
    if m.window:
        ck = L.ring_cache_write(cache["k"], k, dc.pos)
        cv = L.ring_cache_write(cache["v"], val, dc.pos)
        o = L.ring_decode(q[:, 0], ck, cv, dc.pos, m.window)
    else:
        ck = L.sharded_cache_write(cache["k"], k, dc.pos, seq_axes=dc.seq_axes,
                                   axis_sizes=dc.axis_sizes)
        cv = L.sharded_cache_write(cache["v"], val, dc.pos,
                                   seq_axes=dc.seq_axes,
                                   axis_sizes=dc.axis_sizes)
        off = L.seq_offset(dc.seq_axes, dc.axis_sizes, ck.shape[1]) \
            if dc.seq_axes else 0
        o = L.flash_decode(q[:, 0], ck, cv, dc.pos, seq_axes=dc.seq_axes,
                           seq_offset=off)
    out = v.mm(p + "wo", o.reshape(b, 1, cfg.n_heads * cfg.hdim))
    return out, {"k": ck, "v": cv}


def _cross_decode(v, p, cfg, x, cache):
    """One decode token's cross-attention over every frame of the layer's
    cross cache (``flash_decode`` at the last frame's position)."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.hdim
    q = v.mm(p + "wq_x", x).reshape(b, h, hd)
    o = L.flash_decode(q, cache["kx"], cache["vx"], cache["kx"].shape[1] - 1)
    return v.mm(p + "wo_x", o.reshape(b, 1, h * hd))


def _mla_decode(v, p, cfg, m: KindMeta, x, cache, dc: DecCtx):
    """The absorbed MLA decode over the latent cache (B, S_loc, lora +
    rope): the new latent is written in place at each row's position
    (``layers.sharded_cache_write``: index tensors only, a position off this
    rank's range dropped), ``w_ukv`` is read whole and its key half absorbed
    into the query, the scores (latent and rope parts) and the context are
    f32 einsums over the latent, scaled by 1/sqrt(nope + rope), the
    partial softmax combined exactly over the sequence axes (the max, then
    the context and the denominator summed in axis order, as
    ``layers.flash_decode``), the denominator floored at 1e-30, and the
    value half applied to the context; the result goes to ``wo`` at x's
    dtype."""
    ml = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    nope, rope, vh, lora = ml.qk_nope, ml.qk_rope, ml.v_head, ml.kv_lora
    q_lat = L.rms_norm(v.mm(p + "w_dq", x), v.get(p + "q_norm"))
    q = v.mm(p + "w_uq", q_lat).reshape(b, 1, h, nope + rope)
    pos_b = L._row_positions(dc.pos, b, x.device)
    cos, sin = L.rope_freqs(pos_b[:, None], rope, m.theta)
    q_rope = L.apply_rope(q[..., nope:], cos, sin)[:, 0]        # (B, h, rope)
    q_nope = q[:, 0, :, :nope]
    kv_full = v.mm(p + "w_dkv", x)                               # (B, 1, C)
    kv_lat = L.rms_norm(kv_full[..., :lora], v.get(p + "kv_norm"))
    k_rope = L.apply_rope(kv_full[:, :, None, lora:], cos, sin)[:, :, 0]
    clat = L.sharded_cache_write(cache["lat"], torch.cat([kv_lat, k_rope], -1),
                                 dc.pos, seq_axes=dc.seq_axes,
                                 axis_sizes=dc.axis_sizes)
    w_ukv = v.get(p + "w_ukv").reshape(lora, h, nope + vh).float()
    q_abs = torch.einsum("bhn,chn->bhc", q_nope.float(), w_ukv[..., :nope])
    lat_c, rope_c = clat[..., :lora].float(), clat[..., lora:].float()
    s_loc = clat.shape[1]
    off = L.seq_offset(dc.seq_axes, dc.axis_sizes, s_loc) \
        if dc.seq_axes else 0
    kpos = torch.arange(off, off + s_loc, device=x.device)
    valid = kpos[None, :] <= pos_b[:, None]                      # (B, S)
    scores = (torch.einsum("bhc,bsc->bhs", q_abs, lat_c)
              + torch.einsum("bhr,bsr->bhs", q_rope.float(), rope_c))
    scores = scores / math.sqrt(nope + rope)
    scores = torch.where(valid[:, None, :], scores, L.NEG_INF)
    mx = col.seq_max(scores.amax(dim=-1), dc.seq_axes)
    pr = torch.exp(scores - mx[..., None])
    ctx_lat = col.seq_sum(torch.einsum("bhs,bsc->bhc", pr, lat_c),
                          dc.seq_axes)
    den = col.seq_sum(pr.sum(dim=-1), dc.seq_axes)
    ctx_lat = ctx_lat / torch.clamp(den[..., None], min=1e-30)
    o = torch.einsum("bhc,chv->bhv", ctx_lat, w_ukv[..., nope:])
    out = v.mm(p + "wo", o.reshape(b, 1, h * vh).to(x.dtype))
    return out, {"lat": clat}


def _ffn(v, p, cfg: ArchConfig, m: KindMeta, x):
    """(y, aux): the block's FFN on x and the MoE load-balance term (None
    for an MLP)."""
    h = _norm(v, p, "ln2", x, cfg)
    if m.ffn == "moe":
        return moe_ffn(v, p, cfg, h)
    aux = None
    if cfg.act.endswith("_glu"):
        act = F.silu if cfg.act.startswith("silu") else L.gelu
        return v.mm(p + "w_down",
                    act(v.mm(p + "w_gate", h)) * v.mm(p + "w_up", h)), aux
    z = v.mm(p + "w_in", h) + v.get(p + "b_in")
    return v.mm(p + "w_out_ff", L.gelu(z)) + v.get(p + "b_out"), aux


def _residual(v, p, cfg: ArchConfig, m: KindMeta, x, o):
    """(the block's output, its FFN's aux or None) from its input x and its
    mixer's output o: the parallel residual (x + o) + ffn(x), both norms on
    the block's input, or the sequential x + o, then + ffn(x + o) where the
    block has one."""
    if m.parallel:
        y, aux = _ffn(v, p, cfg, m, x)
        return x + o + y, aux
    x = x + o
    if m.ffn == "none":
        return x, None
    y, aux = _ffn(v, p, cfg, m, x)
    return x + y, aux


def block_fwd(kind: str, v, cfg: ArchConfig, x, ctx: Ctx):
    """Returns (x, aux loss | None, cache_entry | None)."""
    m = _ported(kind, cfg)
    p = kind + "."
    h = _norm(v, p, "ln1", x, cfg)
    if m.mixer == "mamba":
        o, (h_last, conv_tail) = mamba_mixer(v, p, cfg, h)
        cache = {"h": h_last, "conv": conv_tail} if ctx.want_cache else None
    elif m.mixer == "mla":
        o, cache = _mla_fwd(v, p, cfg, m, h, ctx)
    else:
        o, cache = _attn_fwd(v, p, cfg, m, h, ctx)
    if m.cross:
        # the cross sublayer sits between the self-attention's residual
        # and the FFN: x + o + xo, then + ffn(x + o + xo)
        x = x + o
        o, cross = _cross_fwd(v, p, cfg, _norm(v, p, "ln_x", x, cfg), ctx)
        if cache is not None:
            cache.update(cross)
    x, aux = _residual(v, p, cfg, m, x, o)
    return x, aux, cache


def block_decode(kind: str, v, cfg: ArchConfig, x, cache, dc: DecCtx):
    """x (B,1,d); cache = this layer's entry, updated in place. Returns
    (x, new_cache)."""
    m = _ported(kind, cfg)
    p = kind + "."
    h = _norm(v, p, "ln1", x, cfg)
    if m.mixer == "mamba":
        o, (h_new, new_tail) = mamba_decode(v, p, cfg, h,
                                            (cache["h"], cache["conv"]))
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_tail)
        new_cache = cache
    elif m.mixer == "mla":
        o, new_cache = _mla_decode(v, p, cfg, m, h, cache, dc)
    else:
        o, new_cache = _attn_decode(v, p, cfg, m, h, cache, dc)
    if m.cross:
        x = x + o
        o = _cross_decode(v, p, cfg, _norm(v, p, "ln_x", x, cfg), cache)
        new_cache = dict(new_cache, kx=cache["kx"], vx=cache["vx"])
    return _residual(v, p, cfg, m, x, o)[0], new_cache


def _sinusoid(positions, d: int):
    """The encoder's positions: sin then cos of position x 10,000^(-i /
    (d / 2)), f32 (the reference's ``_sinusoid``)."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class LM:
    """Decoder-only LM, or encoder-decoder, over a parameter view."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.kinds = list(dict.fromkeys(cfg.pattern))

    def leaf_specs(self) -> dict[str, LeafSpec]:
        cfg = self.cfg
        out: dict[str, LeafSpec] = {
            "embed": LeafSpec("embed", (cfg.vocab, cfg.d_model), MATMUL,
                              init_scale=0.02),
        }
        out.update(_norm_specs("final_norm", cfg.d_model, cfg))
        if not cfg.tie_embeddings:
            out["lm_head"] = LeafSpec("lm_head", (cfg.vocab, cfg.d_model),
                                      MATMUL, init_scale=0.02)
        counts = cfg.kind_counts()
        for kind in self.kinds:
            for n, spec in block_specs(kind, cfg).items():
                name = f"{kind}.{n}"
                out[name] = replace(spec, name=name, stack=counts[kind])
        if cfg.enc_layers:
            for n, spec in block_specs("enc", cfg).items():
                out[f"enc.{n}"] = replace(spec, name=f"enc.{n}",
                                          stack=cfg.enc_layers)
            out.update(_norm_specs("enc_norm", cfg.d_model, cfg))
        return out

    def _layers(self):
        """(kind, index within the kind's stack) per layer, in order."""
        idx = dict.fromkeys(self.kinds, 0)
        for kind in self.cfg.pattern:
            yield kind, idx[kind]
            idx[kind] += 1

    def _embed(self, view, tokens):
        """The embedding rows, times sqrt(d_model) where the config says so
        (gemma). The reference multiplies by a weak-typed Python float,
        which JAX rounds to x's dtype first: 34.0 for d_model 1,152 in
        bf16, not 33.94 rounded after the product as torch would."""
        x = view.embed_lookup("embed", tokens)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=x.dtype).item()
        return x

    def _head_logits(self, view, x_last):
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        return view.mm(name, x_last, transpose=True)[:, 0].float()

    def _head_weight(self, view):
        return view.get("embed" if self.cfg.tie_embeddings else "lm_head")

    def _inputs(self, view, batch, tokens):
        """The embedded tokens, behind the patch prefix (``batch["patches"]``
        (B, P, d), in the compute dtype) where the config has one."""
        x = self._embed(view, tokens)
        if self.cfg.n_patches:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    def _encode(self, view, frames, train: bool = False):
        """The encoder over (B, F, d) frame embeddings (in the compute
        dtype) plus their sinusoidal positions (f32, cast to the frames'
        dtype before the add), then ``enc_norm``. In training the layers run
        through the view's loop (the gather prefetch rotation, the
        streaming sinks) over ("enc", i), each under its own checkpoint, as
        the decoder's do."""
        cfg = self.cfg
        pos = torch.arange(frames.shape[1], device=frames.device)
        x = frames + _sinusoid(pos, cfg.d_model).to(frames.dtype)
        ctx = Ctx(positions=pos)

        def layer(v, h):
            return block_fwd("enc", v, cfg, h, ctx)[0]

        steps = [("enc", i) for i in range(cfg.enc_layers)]
        if train:
            x = view.loop_layers(
                lambda v, h, _: checkpoint(layer, v, h, use_reentrant=False),
                x, steps)
        else:
            for _, i in steps:
                x = layer(view.sub(i), x)
        return _norm(view, "", "enc_norm", x, cfg)

    def loss(self, view, batch):
        """batch: {"tokens": (B, S + 1)} [+ {"patches": (B, P, d)} | {"frames":
        (B, F, d)}: the encoder's input]. Next-token CE over the S text
        inputs plus the MoE load-balance term times the token count:
        returns (loss sum f32, token_count). The
        layers run through the view's loop (the gather prefetch rotation
        when it overlaps), each under its own checkpoint: its forward is
        recomputed in the backward, re-issuing its gathers inline (a
        prefetched buffer is consumed by the first forward only, so the
        checkpoint never keeps one alive)."""
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        x = self._inputs(view, batch, inputs)
        ctx = Ctx(positions=torch.arange(x.shape[1], device=x.device))
        if self.cfg.enc_layers:
            ctx = replace(ctx, enc_out=self._encode(
                view, batch["frames"].to(x.dtype), train=True))

        def layer(v, kind, h, a):
            h, aux, _ = block_fwd(kind, v, self.cfg, h, ctx)
            return h, a if aux is None else a + aux

        def body(v, carry, kind):
            return checkpoint(layer, v, kind, *carry, use_reentrant=False)

        aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux = view.loop_layers(body, (x, aux0), list(self._layers()))
        x = _norm(view, "", "final_norm", x, self.cfg)
        if self.cfg.n_patches:
            x = x[:, self.cfg.n_patches:]
        loss_sum, ntok = L.chunked_cross_entropy(
            x, self._head_weight(view), labels,
            torch.ones(labels.shape, dtype=torch.float32, device=x.device))
        return loss_sum + aux * ntok, ntok

    def sp_eligible(self) -> bool:
        """Gather-KV sequence parallelism needs every mixer to be attention
        (an SSM scan has a serial cross-chunk dependency)."""
        return all(kind_meta(k, self.cfg).mixer in ("attn", "mla")
                   for k in self.cfg.pattern)

    def prefill(self, view, batch, *, seq_axes=(), axis_sizes=None,
                seq_parallel: bool = False):
        """batch: {"tokens": (B, S)} [+ {"patches": (B, P, d)}: positions
        run over the P patches, then the text | {"frames": (B, F, d)}: the
        encoder's input]. Returns (last-position logits (B, V) f32, caches
        {kind: {"k", "v": (L, B, S_loc, Hkv, D)} for attention (this rank's
        sequence chunk over ``seq_axes``, all S without them), (L, B, W,
        Hkv, D) rings for sliding-window attention, {"lat": (L, B, S_loc,
        kv_lora + qk_rope)} for MLA, + {"kx", "vx": (L, B, F, H, D)} for a
        decoder block, {"h": (L, B, din, N), "conv": (L, B, K-1, din)} for
        mamba, "pos": S}).

        ``seq_parallel`` (attention-only models, S a multiple of the
        sequence ranks) runs this rank's chunk of the prompt; the last
        position's hidden state, on the last sequence rank, is selected
        one-hot and summed in f32 over the axes (one rank contributes
        non-zeros: exact), as the reference does."""
        x = self._inputs(view, batch, batch["tokens"])
        s_total = x.shape[1]
        ctx = Ctx(positions=torch.arange(s_total, device=x.device),
                  want_cache=True, seq_axes=tuple(seq_axes),
                  axis_sizes=axis_sizes)
        if self.cfg.enc_layers:
            ctx = replace(ctx, enc_out=self._encode(
                view, batch["frames"].to(x.dtype)))
        n_sp = math.prod(axis_sizes[a] for a in seq_axes) if seq_axes else 1
        seq_parallel = (seq_parallel and self.sp_eligible() and n_sp > 1
                        and s_total % n_sp == 0)
        if seq_parallel:
            s_loc = s_total // n_sp
            off = L.seq_offset(ctx.seq_axes, axis_sizes, s_loc)
            x = x[:, off:off + s_loc]
            # q_offset is a host int: the kernel runs (the reference's is
            # traced and falls back to its chunked path)
            ctx = replace(ctx, positions=off + torch.arange(s_loc,
                                                            device=x.device),
                          seq_parallel=True, q_offset=off)
        per_kind: dict[str, list] = {k: [] for k in self.kinds}
        for kind, i in self._layers():
            x, _, cache = block_fwd(kind, view.sub(i), self.cfg, x, ctx)
            per_kind[kind].append(cache)
        x = _norm(view, "", "final_norm", x, self.cfg)
        if seq_parallel:
            last = L._linear_index(ctx.seq_axes, axis_sizes) == n_sp - 1
            x_last = x[:, -1:] if last else torch.zeros_like(x[:, -1:])
            x_last = col.seq_sum(x_last.float(), ctx.seq_axes).to(x.dtype)
        else:
            x_last = x[:, -1:]
        logits = self._head_logits(view, x_last)
        caches: dict[str, Any] = {
            k: {n: torch.stack([c[n] for c in lst]) for n in lst[0]}
            for k, lst in per_kind.items()}
        caches["pos"] = torch.tensor(s_total, dtype=torch.int32,
                                     device=x.device)
        return logits, caches

    def decode(self, view, caches, batch, *, seq_axes=(), axis_sizes=None):
        """One token. batch: {"token": (B,), ["row_pos": (B,)]}.

        ``row_pos`` (continuous batching) overrides the shared cache position
        with per-row write/attend positions. The caches (this rank's slices
        over ``seq_axes``) are updated in place and returned with the next
        position. Returns (logits, caches)."""
        pos = batch.get("row_pos", caches["pos"])
        x = self._embed(view, batch["token"][:, None])
        dc = DecCtx(pos=pos, seq_axes=tuple(seq_axes), axis_sizes=axis_sizes)
        for kind, i in self._layers():
            cl = {n: t[i] for n, t in caches[kind].items()}
            x, _ = block_decode(kind, view.sub(i), self.cfg, x, cl, dc)
        x = _norm(view, "", "final_norm", x, self.cfg)
        logits = self._head_logits(view, x)
        p = torch.as_tensor(pos, device=x.device)
        caches["pos"] = (p.max() if p.ndim else p).to(torch.int32) + 1
        return logits, caches
