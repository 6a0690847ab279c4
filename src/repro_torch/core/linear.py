"""Forward weight path of a ZeRO matmul leaf, as used by serving.

Port of the forward helpers of ``repro.core.linear``: the compute dtype, the
fusable gate, the (K, N) view of a leaf, the dense matmul and the fused
dequant-matmul on a wire-format (q, scales) buffer.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .partition import LeafSpec, ZeroConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ZeroConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


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
