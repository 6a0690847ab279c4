"""Fused INT8-dequant x matmul and weight-grad matmul x quantize on the card
(csrc/dequant_matmul.cu, csrc/dequant_matmul_blocked.cu, csrc/matmul_quant.cu).

Port of ``repro.kernels.dequant_matmul``:

* ``dequant_matmul_pallas`` (:39): ``x @ dequant(q)`` with 2-D blocked
  scales (the scale of q[k, n] is scales[k // bk, n]);
* ``dequant_matmul_flat_pallas`` (:113), both orientations: ``x @ dequant(q)``
  and ``x @ dequant(q).T`` with the flat-shard scale layout (the scale of
  q[k, j] is scales[k, j // block]);
* ``matmul_quant_pallas`` (:209): ``C = x.T @ g`` block-quantized to the INT8
  or packed INT4 wire format in the matmul's epilogue.

The flat dequant-matmul has three paths, chosen by shape and dtype alone
(``dequant_matmul_path``), in this order: decode, for x @ W.T (the LM
head) at M <= 16 with a block that is a multiple of 16, in f32 or bf16 for
N <= 4,096, which streams the weight through a cp.async ring in 16-byte
copies on persistent CTAs and sums in f32 on the CUDA cores, and in bf16
past N = 4,096 (NeoX's untied heads), where each warp streams whole rows
of 16 q rows through its own cp.async ring and runs the exact int8 weight
against x on mma.sync, a quant block at a time; and in bf16 for x @ W (the
decode step's layer products) at M <= 8 with a block that is a multiple of
64 and K % 8 == 0, which folds the scale into x (two bf16 terms of x * s)
and runs the exact int8 weight against it on mma.sync, the K splits of a
column tile summed in one cluster; tensor cores (wgmma) for bf16 with a
block that is a multiple of 64, K % 8 == 0 (every bf16 row 16-byte
aligned) and M >= 9 (x @ W) or M >= 64 (x @ W.T); and SIMT f32 FMA for
the rest (f32 x @ W, f32 at larger M, f32 x @ W.T past N = 4,096, bf16
x @ W.T at M = 17 ... 63, other blocks). The tensor cores take x @ W.T with exact
products of bf16 x and the raw int8 q, scaled after each quant block, and
x @ W with each f32 weight split into two bf16 terms (hi + lo, 16 bits). A
q or x off the 16-byte grid (q off 4 bytes on the SIMT path) is copied to
a fresh allocation first, so every view the reference takes runs.

The blocked dequant-matmul has two paths too
(``dequant_matmul_blocked_path``): tensor cores (wgmma) for bk % 64 == 0,
K % 8 == 0 and N % 8 == 0, each f32 x split into three bf16 terms that
hold all of its 24 bits against the exact bf16 q, and SIMT f32 FMA for the
rest.

The weight-grad matmul has two paths too (``matmul_quant_path``): tensor
cores (TMA + wgmma) for bf16 operands with K % 8 == 0, N % 8 == 0 and a
block of 8 ... 128, their exact products summed in f32; SIMT f32 FMA for
f32 operands and every other shape (bf16 widened on the load).

The source notes in csrc/ give the bounds and the designs;
``ref.dequant_matmul_blocked_ref``, ``ref.dequant_matmul_flat_ref`` and
``ref.matmul_quant_ref`` are the plain versions. Callers go through ``kernels/ops.py``, which counts the launches.
"""
from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from . import cuda

SIGNATURES = {
    "dequant_matmul_path": (c_int, [c_int] * 6),
    "dequant_matmul_takes": (c_int, [c_int] * 7),
    "dequant_matmul_workspace": (c_longlong, [c_int] * 5),
    "dequant_matmul_on_path": (c_int, [c_void_p] * 5 + [c_int] * 7
                               + [c_void_p]),
}
# csrc/dequant_matmul.cu: PATH_SIMT, PATH_TC, PATH_DECODE (the first two
# also csrc/dequant_matmul_blocked.cu's and csrc/matmul_quant.cu's)
PATHS = ("simt", "tensor_core", "decode")


def dequant_matmul_path(m: int, k: int, n: int, block: int, transpose: bool,
                        dtype: torch.dtype) -> int:
    """Index into ``PATHS`` of the path a call of this shape takes."""
    lib = cuda.library("dequant_matmul", SIGNATURES)
    return lib.dequant_matmul_path(m, k, n, block, int(transpose),
                                   cuda.DTYPE_CODE[dtype])


def dequant_matmul_takes(m: int, k: int, n: int, block: int, transpose: bool,
                         dtype: torch.dtype, path: int) -> bool:
    """Whether path ``path`` (an index into ``PATHS``) takes a call of this
    shape and dtype, as its own path or forced."""
    lib = cuda.library("dequant_matmul", SIGNATURES)
    return bool(lib.dequant_matmul_takes(m, k, n, block, int(transpose),
                                         cuda.DTYPE_CODE[dtype], path))


def dequant_matmul_flat_cuda(x: torch.Tensor, q: torch.Tensor,
                             scales: torch.Tensor, block: int, *,
                             transpose: bool = False,
                             path: int | None = None) -> torch.Tensor:
    """x (M, K) -> (M, N), or x (M, N) -> (M, K) with ``transpose``; q (K, N)
    int8, scales (K, N // block) f32; the output has x's dtype (f32 | bf16).
    ``path`` (an index into ``PATHS``) overrides the shape's own path, to
    time both paths at one shape; the call raises if that path cannot take
    the shape."""
    cuda.require(x, "x", tuple(cuda.DTYPE_CODE))
    cuda.require(q, "q", (torch.int8,))
    cuda.require(scales, "scales", (torch.float32,))
    k, n = q.shape
    m = x.shape[0]
    c_len, out_dim = (n, k) if transpose else (k, n)
    if x.shape != (m, c_len) or n % block or block % 4 \
            or scales.shape != (k, n // block):
        raise ValueError(
            f"dequant_matmul: x {tuple(x.shape)}, q {tuple(q.shape)}, scales "
            f"{tuple(scales.shape)}, block {block}, transpose {transpose}: "
            "needs N % block == 0 and block % 4 == 0")
    lib = cuda.library("dequant_matmul", SIGNATURES)
    if path is None:
        path = dequant_matmul_path(m, k, n, block, transpose, x.dtype)
    # the tensor-core and decode paths load 16-byte chunks of x and q, the
    # SIMT path 4-byte words of q; a view off that grid is copied (a fresh
    # allocation is on it)
    if PATHS[path] == "simt":
        q = _aligned(q, 4)
    else:
        x = _aligned(x, 16)
        q = _aligned(q, 16)
    out = torch.empty((m, out_dim), dtype=x.dtype, device=x.device)
    n_work = lib.dequant_matmul_workspace(m, k, n, int(transpose), path)
    work = torch.empty((n_work,), dtype=torch.float32, device=x.device) \
        if n_work else None
    rc = lib.dequant_matmul_on_path(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None, cuda.DTYPE_CODE[x.dtype],
        m, k, n, block, int(transpose), path, cuda.stream(x))
    cuda.check(rc, f"dequant_matmul ({PATHS[path]} path)")
    return out


def _aligned(t: torch.Tensor, n_bytes: int) -> torch.Tensor:
    return t.clone() if t.data_ptr() % n_bytes else t


BLOCKED_SIGNATURES = {
    "dequant_matmul_blocked_path": (c_int, [c_int] * 4),
    "dequant_matmul_blocked_on_path": (c_int, [c_void_p] * 4 + [c_int] * 5
                                       + [c_void_p]),
}


def dequant_matmul_blocked_path(m: int, k: int, n: int, bk: int) -> int:
    """Index into ``PATHS`` of the path a blocked call of this shape takes
    ("simt" or "tensor_core")."""
    lib = cuda.library("dequant_matmul_blocked", BLOCKED_SIGNATURES)
    return lib.dequant_matmul_blocked_path(m, k, n, bk)


def dequant_matmul_blocked_cuda(x: torch.Tensor, q: torch.Tensor,
                                scales: torch.Tensor, *,
                                path: int | None = None) -> torch.Tensor:
    """x (M, K) f32, q (K, N) int8, scales (K // bk, N) f32 -> (M, N) f32.
    ``path`` overrides the shape's own path (to time both at one shape)."""
    cuda.require(x, "x", (torch.float32,))
    cuda.require(q, "q", (torch.int8,))
    cuda.require(scales, "scales", (torch.float32,))
    m, k = x.shape
    n = q.shape[1]
    kb = scales.shape[0]           # ops.dequant_matmul_blocked checks shapes
    lib = cuda.library("dequant_matmul_blocked", BLOCKED_SIGNATURES)
    if path is None:
        path = dequant_matmul_blocked_path(m, k, n, k // kb)
    if PATHS[path] == "tensor_core":     # 16-byte chunks of x and s, 8 of q
        x, scales, q = _aligned(x, 16), _aligned(scales, 16), _aligned(q, 8)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rc = lib.dequant_matmul_blocked_on_path(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(), m, k, n,
        k // kb, path, cuda.stream(x))
    cuda.check(rc, f"dequant_matmul_blocked ({PATHS[path]} path)")
    return out


MQ_SIGNATURES = {
    "matmul_quant_path": (c_int, [c_int] * 5),
    "matmul_quant_on_path": (c_int, [c_void_p] * 4 + [c_int] * 7 + [c_void_p]),
}


def matmul_quant_path(m: int, k: int, n: int, block: int,
                      dtype: torch.dtype) -> int:
    """Index into ``PATHS`` of the path a matmul_quant call of this shape
    and operand dtype takes."""
    lib = cuda.library("matmul_quant", MQ_SIGNATURES)
    return lib.matmul_quant_path(m, k, n, block, cuda.DTYPE_CODE[dtype])


def matmul_quant_cuda(x: torch.Tensor, g: torch.Tensor, block: int,
                      bits: int):
    """x (M, K), g (M, N), both f32 or both bf16 -> (q, scales): q (K, N)
    int8 (bits 8) or (K, N // 2) uint8 (bits 4), scales (K, N // block) f32.
    ``block`` is a power of two up to 512 that divides N. The path is the
    shape's own (``matmul_quant_path``)."""
    cuda.require(x, "x", tuple(cuda.DTYPE_CODE))
    cuda.require(g, "g", (x.dtype,))
    m, k = x.shape
    n = g.shape[1]
    if g.shape[0] != m or bits not in (4, 8) or n % block or block > 512 \
            or block & (block - 1):
        raise ValueError(f"matmul_quant: x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"block {block}, bits {bits}: needs N % block == 0 "
                         "and a power-of-two block <= 512")
    lib = cuda.library("matmul_quant", MQ_SIGNATURES)
    path = matmul_quant_path(m, k, n, block, x.dtype)
    if PATHS[path] == "tensor_core":     # TMA reads from 16-byte aligned rows
        x = _aligned(x, 16)
        g = _aligned(g, 16)
    if bits == 4:
        q = torch.empty((k, n // 2), dtype=torch.uint8, device=x.device)
    else:
        q = torch.empty((k, n), dtype=torch.int8, device=x.device)
    s = torch.empty((k, n // block), dtype=torch.float32, device=x.device)
    rc = lib.matmul_quant_on_path(x.data_ptr(), g.data_ptr(), q.data_ptr(),
                                  s.data_ptr(), cuda.DTYPE_CODE[x.dtype], m, k,
                                  n, block, bits, path, cuda.stream(x))
    cuda.check(rc, f"matmul_quant ({PATHS[path]} path)")
    return q, s
