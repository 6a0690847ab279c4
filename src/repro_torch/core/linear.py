"""The ZeRO-topo weight path as ``torch.autograd.Function``s (paper Fig. 4).

Port of ``repro.core.linear``: ``make_zero_matmul`` (:301, with
``_mm_bwd_core``, ``_mm_dw_stage1`` and ``_dw_fusable``),
``make_zero_gather_q`` (:333) and ``make_plain_gather`` (:590), the inline
path only (no prefetch, no streaming sinks).

``zero_matmul``:
  forward : INT8 block-quantized all-gather of the primary shard over the
            weight axes (W), then the fused dequant-matmul kernel on the
            gathered wire-format (q, scales) buffer. The gathered copy is cut
            to this rank's secondary partition, which is the only weight
            residual saved for the backward.
  backward: the weight comes back by an all-gather of the secondary over the
            secondary axes, in wire format, for the fused dX = g @ W^T. The
            weight gradient is reduce-scattered over W with INT4 through one
            all-to-all, so the cotangent has the primary-shard layout. On
            fusable leaves the quantize runs in the dW matmul's epilogue
            (``ops.matmul_quant``); the dense f32 dW is never written.

``zero_gather_q`` is the same machinery for weights read whole (the tied
embedding: its lookup and its LM head): quantized gather forward, quantized
reduce-scatter backward. ``plain_gather`` is the fp gather of small leaves,
whose backward is a reduce-scatter over W. The cross-replica and stage-2
reductions are left to the engine.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from . import collectives as col
from . import schedule as sched
from .partition import LeafSpec, ZeroConfig, padded_flat_size

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ZeroConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _pad_flat(x: torch.Tensor, padded: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, padded - flat.numel()))


def _fusable(spec: LeafSpec, cfg: ZeroConfig) -> bool:
    """Route this leaf's matmuls through the fused dequant-matmul kernel?
    Needs the INT8 weight path and whole blocks along each row of the
    (K, N) view (ops.matmul_fusable)."""
    return cfg.quantize_weights and \
        ops.matmul_fusable(spec.shape, cfg.quant_block)


def _w_kn(spec: LeafSpec) -> tuple[int, int]:
    n = spec.shape[-1]
    return spec.logical_size // n, n


def _mm_apply(x, w, transpose: bool, cfg: ZeroConfig):
    """Dense matmul against a materialized weight (non-quantized leaves)."""
    w2 = w.reshape(-1, w.shape[-1])
    if transpose:
        w2 = w2.T
    return torch.matmul(x.to(_dtype(cfg)), w2)


def _mm_apply_q(x, qf, sf, transpose: bool, spec: LeafSpec, cfg: ZeroConfig):
    """Fused dequant-matmul on a wire-format buffer: x (..., K) @ dequant(W)
    (or x (..., N) @ dequant(W).T with ``transpose``)."""
    k, n = _w_kn(spec)
    out_dim = k if transpose else n
    x2 = x.reshape(-1, x.shape[-1]).to(_dtype(cfg))
    y2 = ops.dequant_matmul(x2, qf, sf, (k, n), cfg.quant_block,
                            transpose=transpose, dtype=_dtype(cfg),
                            impl=cfg.impl)
    return y2.reshape(x.shape[:-1] + (out_dim,))


def _gather_full(primary, spec: LeafSpec, cfg: ZeroConfig):
    """Forward gather -> (w (logical shape), sec_q, sec_s)."""
    n = spec.logical_size
    if cfg.quantize_weights:
        full, qf, sf = col.quant_all_gather_int8(primary, cfg.axes.weight, cfg,
                                                 _dtype(cfg))
        sec_q, sec_s = _secondary(qf, sf, cfg)
    else:
        full = col.all_gather_flat(primary, cfg.axes.weight, cfg).to(_dtype(cfg))
        sec_q = sec_s = None
    return full[:n].reshape(spec.shape), sec_q, sec_s


def _secondary(qf, sf, cfg: ZeroConfig):
    if cfg.axes.secondary is None:
        return None, None
    return col.secondary_slice(qf, sf, cfg.axes.secondary, cfg)


def _regather_bwd(primary, sec_q, sec_s, spec: LeafSpec, cfg: ZeroConfig):
    """Backward weight re-materialization, dense (unfused leaves)."""
    n = spec.logical_size
    if sec_q is not None or cfg.quantize_weights:
        qf, sf = sched.regather_issue(primary, sec_q, sec_s, cfg)
        full = sched.regather_wait(qf, sf, cfg, _dtype(cfg))
    else:
        full = col.all_gather_flat(primary, cfg.axes.weight, cfg).to(_dtype(cfg))
    return full[:n].reshape(spec.shape)


def _grad_stage1(dw, spec: LeafSpec, cfg: ZeroConfig):
    """Stage 1: a full dense weight grad -> the primary-layout fp32 shard
    (INT4 a2a reduce-scatter over W)."""
    flat = _pad_flat(dw, padded_flat_size(spec.logical_size, cfg))
    tok = sched.grad_rs_issue(flat, cfg.axes.weight, cfg)
    return sched.grad_rs_wait(tok, cfg, out_dtype=torch.float32)


def _dw_fusable(spec: LeafSpec, cfg: ZeroConfig) -> bool:
    """Fuse the dW matmul with its wire-format quantize? Only when stage 1
    is the quantized a2a (INT4 grads, W group > 1) and the flat quant blocks
    tile the (K, N) dW view row by row, pad included."""
    if not cfg.quantize_grads or cfg.size(cfg.axes.weight) <= 1:
        return False
    if not ops.matmul_fusable(spec.shape, cfg.quant_block):
        return False
    padded = padded_flat_size(spec.logical_size, cfg)
    return (padded - spec.logical_size) % cfg.quant_block == 0


def _mm_dw_stage1(x2, g2, transpose: bool, spec: LeafSpec, cfg: ZeroConfig):
    """dW of a matmul backward -> primary-layout fp32 stage-1 shard: straight
    into wire format when fusable, else the dense matmul + quantize pair."""
    if _dw_fusable(spec, cfg):
        if transpose:
            # dW = (x2.T g2).T = g2.T x2: swap the operands, the wire layout
            # is row-major over N
            x2, g2 = g2, x2
        q, s = ops.matmul_quant(x2, g2, cfg.quant_block, bits=4,
                                pad_to=padded_flat_size(spec.logical_size, cfg),
                                impl=cfg.impl)
        tok = sched.grad_rs_issue_q(q, s, cfg.axes.weight, cfg)
        return sched.grad_rs_wait(tok, cfg, out_dtype=torch.float32)
    dw2 = torch.matmul(x2.T, g2)
    if transpose:
        dw2 = dw2.T
    return _grad_stage1(dw2.reshape(spec.shape), spec, cfg)


def _mm_bwd(x, primary, sec_q, sec_s, g, transpose: bool, spec: LeafSpec,
            cfg: ZeroConfig):
    """Matmul backward: (dX, the primary-shard weight cotangent)."""
    if _fusable(spec, cfg):
        qf, sf = sched.regather_issue(primary, sec_q, sec_s, cfg)
        gx = _mm_apply_q(g, qf, sf, not transpose, spec, cfg).to(x.dtype)
    else:
        w2 = _regather_bwd(primary, sec_q, sec_s, spec, cfg)
        w2 = w2.reshape(-1, w2.shape[-1])
        if transpose:
            w2 = w2.T
        gx = torch.matmul(g, w2.T).to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1]).float()
    g2 = g.reshape(-1, g.shape[-1]).float()
    g1 = _mm_dw_stage1(x2, g2, transpose, spec, cfg)
    return gx, g1.to(_dtype(cfg))


class ZeroMatmul(torch.autograd.Function):
    """y = x @ W (or x @ W.T) for a MATMUL leaf given by its primary shard."""

    @staticmethod
    def forward(ctx, x, primary, spec: LeafSpec, cfg: ZeroConfig,
                transpose: bool):
        if _fusable(spec, cfg):
            qf, sf = col.gather_issue_int8(primary, cfg.axes.weight, cfg)
            sec_q, sec_s = _secondary(qf, sf, cfg)
            y = _mm_apply_q(x, qf, sf, transpose, spec, cfg)
        else:
            w, sec_q, sec_s = _gather_full(primary, spec, cfg)
            y = _mm_apply(x, w, transpose, cfg)
        ctx.spec, ctx.cfg, ctx.transpose = spec, cfg, transpose
        ctx.has_sec = sec_q is not None
        if ctx.has_sec:
            ctx.save_for_backward(x, sec_q, sec_s)
        else:
            # no secondary: keep the primary for the re-gather
            ctx.save_for_backward(x, primary)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.has_sec:
            x, sec_q, sec_s = ctx.saved_tensors
            primary = None
        else:
            x, primary = ctx.saved_tensors
            sec_q = sec_s = None
        gx, gw = _mm_bwd(x, primary, sec_q, sec_s, g, ctx.transpose, ctx.spec,
                         ctx.cfg)
        return gx, gw, None, None, None


class ZeroGatherQ(torch.autograd.Function):
    """primary shard -> the dense logical tensor, quantized gather forward,
    quantized reduce-scatter backward."""

    @staticmethod
    def forward(ctx, primary, spec: LeafSpec, cfg: ZeroConfig):
        ctx.spec, ctx.cfg = spec, cfg
        return _gather_full(primary, spec, cfg)[0]

    @staticmethod
    def backward(ctx, g):
        g1 = _grad_stage1(g, ctx.spec, ctx.cfg)
        return g1.to(_dtype(ctx.cfg)), None, None


class PlainGather(torch.autograd.Function):
    """Small leaves: fp all-gather over W; backward reduce-scatters over W
    (what AD gives the reference)."""

    @staticmethod
    def forward(ctx, primary, spec: LeafSpec, cfg: ZeroConfig):
        ctx.spec, ctx.cfg = spec, cfg
        flat = col.all_gather_flat(primary, cfg.axes.weight, cfg)
        return flat[:spec.logical_size].reshape(spec.shape).to(_dtype(cfg))

    @staticmethod
    def backward(ctx, g):
        spec, cfg = ctx.spec, ctx.cfg
        flat = _pad_flat(g.to(_dtype(cfg)), padded_flat_size(spec.logical_size,
                                                             cfg))
        return col.psum_scatter(flat, cfg.axes.weight, cfg), None, None
