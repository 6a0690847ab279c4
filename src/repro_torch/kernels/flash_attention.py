"""Online-softmax attention on the card (csrc/flash_attention.cu).

Port of ``repro.kernels.flash_attention.flash_attention_pallas`` (:92),
forward only, at the head widths of ``HEAD_DIMS`` (qwen2's 64,
GPT-NeoX-20B's 96, GPT-NeoX-10B's 128, gemma3-1b's 256; any other raises).
bf16 runs a tensor-core kernel (FlashAttention-2 tiles, the softmax scale
on the f32 scores, P rounded to bf16 for the P V product; at 256 Q read
from shared memory for each key tile and tiles of 32 keys), f32 a
CUDA-core kernel with one thread a query row. The source
note in csrc/flash_attention.cu gives the bounds and the designs;
``ref.flash_attention_ref`` is the plain version.
Callers go through ``kernels/ops.py``, which counts the launches.
"""
from __future__ import annotations

import math
from ctypes import c_float, c_int, c_void_p

import torch

from . import cuda

SIGNATURES = {
    "flash_attention": (c_int, [c_void_p, c_void_p, c_void_p, c_void_p, c_int,
                                c_int, c_int, c_int, c_int, c_int, c_int, c_int,
                                c_int, c_float, c_void_p]),
}
HEAD_DIMS = (64, 96, 128, 256)   # the head widths the kernel is compiled for


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, D); k, v (BH / n_rep, Sk, D) -> (BH, Sq, D), q's dtype.
    Query head ``i`` reads KV head ``i // n_rep`` (the GQA fold)."""
    cuda.require(q, "q", tuple(cuda.DTYPE_CODE))
    cuda.require(k, "k", (q.dtype,))
    cuda.require(v, "v", (q.dtype,))
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    if d not in HEAD_DIMS or k.shape != (bkv, sk, d) or v.shape != k.shape \
            or bh % bkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (head dim "
                         f"must be one of {HEAD_DIMS})")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel copies 16-byte rows: a view that starts
        # off that grid is copied to a fresh (aligned) allocation
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    lib = cuda.library("flash_attention", SIGNATURES)
    o = torch.empty_like(q)
    rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), cuda.DTYPE_CODE[q.dtype], bh, sq, sk,
                             d, bh // bkv, int(causal), int(window),
                             int(q_offset), 1.0 / math.sqrt(d), cuda.stream(q))
    cuda.check(rc, "flash_attention")
    return o
