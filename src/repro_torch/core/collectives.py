"""Wire-format collectives at degree 1.

Port of the serving half of ``repro.core.collectives``. On one device every
axis tuple has size 1, so each collective is the identity and what remains
is the local quantize / dequantize: ``gather_issue_int8`` is a quantize,
``gather_wait_int8`` a dequantize, and the residency slice / re-gather pass
their buffers through. The functions keep the reference's names and
signatures so the multi-device slice can fill the collectives in.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .partition import AxisTuple, ZeroConfig


def _degree_one(axes: AxisTuple, cfg: ZeroConfig) -> None:
    if cfg.size(tuple(axes)) != 1:
        raise NotImplementedError(
            f"collectives over axes {tuple(axes)} of size "
            f"{cfg.size(tuple(axes))}: only degree 1 is ported")


def gather_issue_int8(shard: torch.Tensor, axes: AxisTuple, cfg: ZeroConfig):
    """Quantize (+ all-gather, identity at degree 1) a flat shard; returns
    the wire-format (q, scales) pair."""
    _degree_one(axes, cfg)
    return ops.quantize_int8(shard, cfg.quant_block, impl=cfg.impl)


def gather_wait_int8(qf, sf, cfg: ZeroConfig, out_dtype=torch.bfloat16):
    """Local dequant of a gathered (q, scales) buffer (no communication)."""
    return ops.dequantize_int8(qf, sf, cfg.quant_block, out_dtype,
                               impl=cfg.impl)


def gather_issue_int8_rows(rows: torch.Tensor, axes: AxisTuple,
                           cfg: ZeroConfig):
    """Row-batched ``gather_issue_int8`` for stacked (layers, shard) leaves.

    Every row's shard is a whole number of quant blocks, so quantizing the
    flattened stack in one call gives exactly the per-row blocks: row r of
    the result is ``gather_issue_int8(rows[r], ...)``."""
    _degree_one(axes, cfg)
    stack, shard = rows.shape
    q, s = ops.quantize_int8(rows.reshape(-1), cfg.quant_block, impl=cfg.impl)
    return q.reshape(stack, shard), s.reshape(stack, shard // cfg.quant_block)


def residency_slice(qf, sf, axes: AxisTuple, cfg: ZeroConfig):
    """This device's residency partition of gathered (q, scales): the whole
    buffer at degree 1."""
    _degree_one(axes, cfg)
    return qf, sf


def gather_residency_q(res_q, res_s, axes: AxisTuple, cfg: ZeroConfig):
    """Decode-path wire re-gather: residency shards -> full (q, scales);
    the identity at degree 1."""
    _degree_one(axes, cfg)
    return res_q, res_s
