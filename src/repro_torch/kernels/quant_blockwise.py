"""INT8 block quantize / dequantize and the fused dequant-sum on the card
(csrc/quant_int8.cu).

Port of ``repro.kernels.quant_blockwise``'s ``quantize_int8_pallas`` (:40),
``dequantize_int8_pallas`` (:63) and ``dequantize_int8_sum_pallas`` (:92).
The source note in csrc/quant_int8.cu gives the bound and the design;
``ref.quantize_int8_ref``, ``ref.dequantize_int8_ref`` and
``ref.dequantize_int8_sum_ref`` are the plain versions. Callers go through
``kernels/ops.py``, which counts the launches.
"""
from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from . import cuda

SIGNATURES = {
    "quantize_int8": (c_int, [c_void_p, c_int, c_void_p, c_void_p, c_longlong,
                              c_int, c_void_p]),
    "dequantize_int8": (c_int, [c_void_p, c_void_p, c_void_p, c_int,
                                c_longlong, c_int, c_void_p]),
    "dequantize_int8_sum": (c_int, [c_void_p, c_void_p, c_void_p, c_int,
                                    c_longlong, c_int, c_int, c_void_p]),
}


def _lib():
    return cuda.library("quant_int8", SIGNATURES)


def quantize_int8_cuda(blocks: torch.Tensor):
    """(nb, bs) f32 | bf16 -> ((nb, bs) int8, (nb, 1) f32 scales)."""
    cuda.require(blocks, "blocks", (torch.float32, torch.bfloat16))
    nb, bs = blocks.shape
    q = torch.empty((nb, bs), dtype=torch.int8, device=blocks.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=blocks.device)
    rc = _lib().quantize_int8(blocks.data_ptr(), cuda.DTYPE_CODE[blocks.dtype],
                              q.data_ptr(), s.data_ptr(), nb, bs,
                              cuda.stream(blocks))
    cuda.check(rc, "quantize_int8")
    return q, s


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """(nb, bs) int8, (nb, 1) f32 -> (nb, bs) ``dtype`` (f32 | bf16)."""
    cuda.require(q, "q", (torch.int8,))
    cuda.require(scales, "scales", (torch.float32,))
    nb, bs = q.shape
    if scales.numel() != nb or dtype not in cuda.DTYPE_CODE:
        raise ValueError(f"dequantize_int8: q {tuple(q.shape)}, scales "
                         f"{tuple(scales.shape)}, dtype {dtype}")
    out = torch.empty((nb, bs), dtype=dtype, device=q.device)
    rc = _lib().dequantize_int8(q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                                cuda.DTYPE_CODE[dtype], nb * bs, bs,
                                cuda.stream(q))
    cuda.check(rc, "dequantize_int8")
    return out


def dequantize_int8_sum_cuda(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(d, nb, bs) int8, (d, nb, 1) f32 -> (nb, bs) f32, the sum over the d
    chunks in order j = 0..d-1."""
    cuda.require(q, "q", (torch.int8,))
    cuda.require(scales, "scales", (torch.float32,))
    d, nb, bs = q.shape
    if scales.numel() != d * nb:
        raise ValueError(f"dequantize_int8_sum: q {tuple(q.shape)}, scales "
                         f"{tuple(scales.shape)}")
    out = torch.empty((nb, bs), dtype=torch.float32, device=q.device)
    vec4 = bs % 4 == 0 and q.data_ptr() % 4 == 0
    rc = _lib().dequantize_int8_sum(q.data_ptr(), scales.data_ptr(),
                                    out.data_ptr(), d, nb, bs, int(vec4),
                                    cuda.stream(q))
    cuda.check(rc, "dequantize_int8_sum")
    return out
