"""The ZeRO-topo weight path as ``torch.autograd.Function``s (paper Fig. 4).

Port of ``repro.core.linear``: ``make_zero_matmul`` (:301, with
``_mm_bwd_core``, ``_mm_dw_stage1`` and ``_dw_fusable``),
``make_zero_gather_q`` (:333) and ``make_plain_gather`` (:590), with their
prefetched-buffer forms (``make_gather_issue``, ``_consume_buf``,
``make_zero_matmul_pre``, ``make_zero_gather_q_pre``, :366-470) and streaming
forms (``make_zero_matmul_stream[_pre]``, ``make_zero_gather_q_stream``,
``_os_tail`` :203). Each reference variant is one of the two Functions here
with a ``buf`` and / or a ``sink`` argument.

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
whose backward is a reduce-scatter over W.

Prefetch (``ZeroConfig.overlap``): ``gather_issue`` starts a layer's
quantize + all-gathers ahead of the layer; the Functions take the waited
buffer in place of the inline gather, so the forward is bitwise the same.
Streaming (``ZeroConfig.stream_grads``): the backward also runs stage 2 and
the cross-replica sync (``_os_tail``) and returns the fully reduced fp32
optimizer-shard row as the gradient of a zero sink tensor; otherwise the
stage-2 and cross-replica reductions are left to the engine.
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
    """Forward gather -> (w (logical shape), sec_q, sec_s): the INT8 wire
    buffer gathered over W when weights are quantized, else the primary."""
    if cfg.quantize_weights:
        buf = col.gather_issue_int8(primary, cfg.axes.weight, cfg)
    else:
        buf = (col.all_gather_flat(primary, cfg.axes.weight, cfg),)
    return _consume_buf(buf, spec, cfg)


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


GRAD_RS_BITS = 4        # stage-1 wire width (the reduce-scatter's default)


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
    into wire format when fusable, else the dense matmul + quantize pair.
    x2, g2 come in the compute dtype: the fused kernel takes them as they
    are (its products and sums are f32, as the reference's kernel widens each
    tile), the dense matmul widens them to f32 first."""
    if _dw_fusable(spec, cfg):
        if transpose:
            # dW = (x2.T g2).T = g2.T x2: swap the operands, the wire layout
            # is row-major over N
            x2, g2 = g2, x2
        q, s = ops.matmul_quant(x2, g2, cfg.quant_block, bits=GRAD_RS_BITS,
                                pad_to=padded_flat_size(spec.logical_size, cfg),
                                impl=cfg.impl)
        tok = sched.grad_rs_issue_q(q, s, cfg.axes.weight, cfg,
                                    bits=GRAD_RS_BITS)
        return sched.grad_rs_wait(tok, cfg, out_dtype=torch.float32)
    dw2 = torch.matmul(x2.float().T, g2.float())
    if transpose:
        dw2 = dw2.T
    return _grad_stage1(dw2.reshape(spec.shape), spec, cfg)


def _mm_bwd(x, primary, sec_q, sec_s, g, transpose: bool, spec: LeafSpec,
            cfg: ZeroConfig):
    """Matmul backward: (dX, the primary-layout fp32 stage-1 weight grad)."""
    if _fusable(spec, cfg):
        qf, sf = sched.regather_issue(primary, sec_q, sec_s, cfg)
        gx = _mm_apply_q(g, qf, sf, not transpose, spec, cfg).to(x.dtype)
    else:
        w2 = _regather_bwd(primary, sec_q, sec_s, spec, cfg)
        w2 = w2.reshape(-1, w2.shape[-1])
        if transpose:
            w2 = w2.T
        gx = torch.matmul(g, w2.T).to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    g2 = g.reshape(-1, g.shape[-1])
    return gx, _mm_dw_stage1(x2, g2, transpose, spec, cfg)


def gather_issue(primary, cfg: ZeroConfig) -> col.GatherBuf:
    """Prefetch half of the forward gather (``make_gather_issue``): the
    quantize and the all-gathers over W in flight, nothing dequantized."""
    with torch.no_grad():
        if cfg.quantize_weights:
            return col.gather_issue_int8_async(primary, cfg.axes.weight, cfg)
        return col.GatherBuf((primary,), cfg.axes.weight, cfg)


def _consume_buf(buf, spec: LeafSpec, cfg: ZeroConfig):
    """A gathered buffer, (q, scales) or (flat,), -> (w (logical shape),
    sec_q, sec_s): the wait half of the prefetch and the tail of the inline
    gather, so both give the same forward."""
    n = spec.logical_size
    if cfg.quantize_weights:
        qf, sf = buf
        full = col.gather_wait_int8(qf, sf, cfg, _dtype(cfg))
        sec_q, sec_s = _secondary(qf, sf, cfg)
    else:
        full = buf[0].to(_dtype(cfg))
        sec_q = sec_s = None
    return full[:n].reshape(spec.shape), sec_q, sec_s


def _os_tail(g1, cfg: ZeroConfig):
    """Stage-1 shard -> the fully reduced fp32 optimizer-shard row: the cast
    through the compute dtype (the seed path's primary cotangent has it, so
    streaming stays bitwise at one microbatch), stage 2 over E, the
    cross-replica sync over R."""
    g1 = g1.to(_dtype(cfg)).float()
    tok = sched.grad_rs_issue(g1, cfg.axes.extra_grad, cfg)
    g2 = sched.grad_rs_wait(tok, cfg, out_dtype=torch.float32)
    return col.cross_replica_grad(g2, cfg, torch.float32)


def _cotangents(g1, stream: bool, cfg: ZeroConfig):
    """(primary cotangent, sink cotangent) of a stage-1 shard: the primary
    takes it in the seed regime, the sink takes its os-shard row when
    streaming (and the primary none)."""
    if stream:
        return None, _os_tail(g1, cfg)
    return g1.to(_dtype(cfg)), None


class ZeroMatmul(torch.autograd.Function):
    """y = x @ W (or x @ W.T) for a MATMUL leaf given by its primary shard.

    ``buf`` is this layer's prefetched gather, already waited (the
    ``*_pre`` forms), or None to gather inline. ``sink`` is None in the seed
    regime (the weight grad is the primary-layout stage-1 shard) or this
    layer's zero optimizer-shard sink (the ``*_stream`` forms: its grad is
    the fully reduced fp32 row, and the primary gets none)."""

    @staticmethod
    def forward(ctx, x, primary, sink, spec: LeafSpec, cfg: ZeroConfig,
                transpose: bool, buf):
        if _fusable(spec, cfg):
            qf, sf = buf if buf is not None else \
                col.gather_issue_int8(primary, cfg.axes.weight, cfg)
            sec_q, sec_s = _secondary(qf, sf, cfg)
            y = _mm_apply_q(x, qf, sf, transpose, spec, cfg)
        else:
            w, sec_q, sec_s = _consume_buf(buf, spec, cfg) if buf is not None \
                else _gather_full(primary, spec, cfg)
            y = _mm_apply(x, w, transpose, cfg)
        ctx.spec, ctx.cfg, ctx.transpose = spec, cfg, transpose
        ctx.stream = sink is not None
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
        gx, g1 = _mm_bwd(x, primary, sec_q, sec_s, g, ctx.transpose, ctx.spec,
                         ctx.cfg)
        gp, gs = _cotangents(g1, ctx.stream, ctx.cfg)
        return gx, gp, gs, None, None, None, None


class ZeroGatherQ(torch.autograd.Function):
    """primary shard -> the dense logical tensor, quantized gather forward
    (inline, or from a waited prefetch ``buf``), quantized reduce-scatter
    backward into the primary or, when streaming, into the ``sink``."""

    @staticmethod
    def forward(ctx, primary, sink, spec: LeafSpec, cfg: ZeroConfig, buf):
        ctx.spec, ctx.cfg, ctx.stream = spec, cfg, sink is not None
        if buf is not None:
            return _consume_buf(buf, spec, cfg)[0]
        return _gather_full(primary, spec, cfg)[0]

    @staticmethod
    def backward(ctx, g):
        g1 = _grad_stage1(g, ctx.spec, ctx.cfg)
        return (*_cotangents(g1, ctx.stream, ctx.cfg), None, None, None)


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
