"""INT4 block quantize, dequantize and the fused unpack-dequant-sum on the
card (csrc/quant_int4.cu).

Port of ``repro.kernels.quant_int4``'s ``quantize_int4_pallas`` (:46),
``dequantize_int4_pallas`` (:68) and ``dequantize_int4_sum_pallas`` (:105);
the first and the last are the two halves of the INT4 all-to-all gradient
reduce-scatter. The quantize has two variants, chosen by block size, dtype
and alignment alone (``quantize_int4_path``): "wide" (16-byte loads, a
block in the registers of a lane group, 32-bit stores of 8 nibbles) for
blocks of 8 ... 2,048 elements that are 8 times a power of two, on x
aligned to 16 bytes; "warp" (a warp a block) for the rest. The source note
in csrc/quant_int4.cu gives the bound and the design; ``ref.quantize_int4_ref``, ``ref.dequantize_int4_ref`` and
``ref.dequantize_int4_sum_ref`` are the plain versions. Callers go through ``kernels/ops.py``, which counts
the launches.
"""
from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from . import cuda

SIGNATURES = {
    "quantize_int4_path": (c_int, [c_int] * 3),
    "quantize_int4": (c_int, [c_void_p, c_int, c_void_p, c_void_p, c_longlong,
                              c_int, c_void_p]),
    "dequantize_int4_sum": (c_int, [c_void_p, c_void_p, c_void_p, c_int,
                                    c_longlong, c_int, c_int, c_void_p]),
    "dequantize_int4": (c_int, [c_void_p, c_void_p, c_void_p, c_int,
                                c_longlong, c_int, c_int, c_void_p]),
}


# csrc/quant_int4.cu: Q4_WARP, Q4_WIDE
INT4_PATHS = ("warp", "wide")


def _lib():
    return cuda.library("quant_int4", SIGNATURES)


def quantize_int4_path(bs: int, dtype: torch.dtype, aligned: bool) -> int:
    """Index into ``INT4_PATHS`` of the variant blocks of ``bs`` elements of
    ``dtype`` take; ``aligned``: x starts on the 16-byte grid."""
    return _lib().quantize_int4_path(bs, cuda.DTYPE_CODE[dtype], int(aligned))


def quantize_int4_cuda(blocks: torch.Tensor):
    """(nb, bs) f32 | bf16, bs even -> ((nb, bs // 2) uint8, (nb, 1) f32),
    on the variant ``quantize_int4_path`` names."""
    cuda.require(blocks, "blocks", (torch.float32, torch.bfloat16))
    nb, bs = blocks.shape
    if bs % 2:
        raise ValueError(f"quantize_int4: block {bs} is odd")
    q = torch.empty((nb, bs // 2), dtype=torch.uint8, device=blocks.device)
    s = torch.empty((nb, 1), dtype=torch.float32, device=blocks.device)
    rc = _lib().quantize_int4(blocks.data_ptr(), cuda.DTYPE_CODE[blocks.dtype],
                              q.data_ptr(), s.data_ptr(), nb, bs,
                              cuda.stream(blocks))
    cuda.check(rc, "quantize_int4")
    return q, s


def dequantize_int4_cuda(packed: torch.Tensor, scales: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """(nb, bs // 2) uint8, (nb, 1) f32 -> (nb, bs) ``dtype`` (f32 | bf16)."""
    cuda.require(packed, "packed", (torch.uint8,))
    cuda.require(scales, "scales", (torch.float32,))
    nb, half = packed.shape
    if scales.numel() != nb or dtype not in cuda.DTYPE_CODE:
        raise ValueError(f"dequantize_int4: packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, dtype {dtype}")
    out = torch.empty((nb, 2 * half), dtype=dtype, device=packed.device)
    vec4 = half % 4 == 0 and packed.data_ptr() % 4 == 0
    rc = _lib().dequantize_int4(packed.data_ptr(), scales.data_ptr(),
                                out.data_ptr(), cuda.DTYPE_CODE[dtype], nb,
                                2 * half, int(vec4), cuda.stream(packed))
    cuda.check(rc, "dequantize_int4")
    return out


def dequantize_int4_sum_cuda(packed: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """(d, nb, bs // 2) uint8, (d, nb, 1) f32 -> (nb, bs) f32, the sum over
    the d chunks in order j = 0..d-1."""
    cuda.require(packed, "packed", (torch.uint8,))
    cuda.require(scales, "scales", (torch.float32,))
    d, nb, half = packed.shape
    if scales.numel() != d * nb:
        raise ValueError(f"dequantize_int4_sum: packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}")
    out = torch.empty((nb, 2 * half), dtype=torch.float32, device=packed.device)
    vec4 = half % 4 == 0 and packed.data_ptr() % 16 == 0
    rc = _lib().dequantize_int4_sum(packed.data_ptr(), scales.data_ptr(),
                                    out.data_ptr(), d, nb, 2 * half, int(vec4),
                                    cuda.stream(packed))
    cuda.check(rc, "dequantize_int4_sum")
    return out
