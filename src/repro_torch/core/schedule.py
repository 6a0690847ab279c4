"""The comm-schedule layer's inline path: backward re-gather and the
gradient reduce-scatter as issue / wait pairs.

Port of ``repro.core.schedule``'s machines 2 and 3 (:98-176) without the
overlap: ``regather_issue`` ends at the collective that rebuilds a weight in
wire format for the backward, ``regather_wait`` dequantizes it;
``grad_rs_issue`` quantizes and exchanges a gradient (or passes it through
when the group has size 1) and ``grad_rs_wait`` runs the local fused
dequant-sum. The token carries the group size, so issue and wait cannot
disagree. The forward gather prefetch (machine 1) and the
streaming-grad path are not ported yet; every collective here runs where it
is issued.
"""
from __future__ import annotations

import torch

from . import collectives as col
from .partition import AxisTuple, ZeroConfig


def regather_issue(primary, sec_q, sec_s, cfg: ZeroConfig):
    """Backward weight re-materialization in wire format (q, scales): the
    INT8 secondary partition gathered over the secondary axes when there is
    one, else the primary re-quantized and gathered over the weight axes."""
    if sec_q is not None:
        return col.gather_secondary_q(sec_q, sec_s, cfg.axes.secondary, cfg)
    return col.gather_issue_int8(primary, cfg.axes.weight, cfg)


def regather_wait(qf, sf, cfg: ZeroConfig, out_dtype=torch.bfloat16):
    """Local dequant of a re-gathered wire buffer (unfused path)."""
    return col.gather_wait_int8(qf, sf, cfg, out_dtype)


def grad_rs_issue(flat: torch.Tensor, axes: AxisTuple, cfg: ZeroConfig):
    """Issue half of a gradient reduce-scatter over ``axes``: INT4 quantize
    + all-to-all when the config quantizes gradients, the reduce-scatter
    itself otherwise, nothing for a group of size 1."""
    if cfg.size(tuple(axes)) == 1:
        return ("nop", flat)
    if not cfg.quantize_grads:
        return ("rs", col.psum_scatter(flat, axes, cfg))
    return ("a2a", col.a2a_rs_issue(flat, axes, cfg), cfg.size(tuple(axes)))


def grad_rs_issue_q(q, s, axes: AxisTuple, cfg: ZeroConfig):
    """Issue half for a gradient already in INT4 wire format (the
    matmul_quant epilogue): only the all-to-all remains."""
    if cfg.size(tuple(axes)) == 1:
        raise ValueError(f"grad_rs_issue_q over {tuple(axes)} of size 1")
    return ("a2a", col.a2a_rs_issue_q(q, s, axes, cfg), cfg.size(tuple(axes)))


def grad_rs_wait(token, cfg: ZeroConfig, *, out_dtype=torch.float32):
    """Wait half: the local fused dequant + sum of the received chunks."""
    if token[0] in ("nop", "rs"):
        return token[1].to(out_dtype)
    _, (q2, s2), d = token
    return col.a2a_rs_wait(q2, s2, d, cfg, out_dtype)
