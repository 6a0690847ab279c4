"""Public kernel entry points: flat-shard plumbing, device dispatch, launch
counts and the shape gates.

Port of ``repro.kernels.ops``. Where the reference picks an impl
(jnp | pallas | pallas_interpret), the port dispatches on the tensor's
device: a CPU tensor runs the plain PyTorch version (kernels/ref.py); a
CUDA tensor launches the hand-written kernel (csrc/, built on first use by
kernels/cuda.py) or raises. There is no fallback from a kernel to its plain
version. ``impl="plain"`` asks for the plain version on any device; it is
how chip_smoke.py computes the reference the kernels are held against.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (``reset_launches`` / ``launches``).

``record_fallback`` counts the model-level fallbacks: a call shape that a
gate (``attention_fusable``) keeps off a kernel and that the model runs
through its chunked plain path instead (models/layers.py), keyed
``<kernel>/fallback/<reason>`` with one warning per (kernel, reason), as
the reference's ``ops.py:58-86``. The reference counts at trace time, once
per traced call site; the port runs eagerly and counts every call
(``dispatch_counters`` / ``reset_dispatch_counters``).

On a ``meta`` tensor (the dry run, ``launch/census.py``) a wrapper takes
the route the card would take and runs the plain version on meta: where the
card would launch the kernel, ``WOULD_LAUNCH`` counts it under the kernel's
name and ``LAUNCHES`` is untouched; under ``impl="plain"`` nothing is
counted. While a census counts a step (``CENSUS``, the one slot that this
module and ``core/collectives.py`` read), each wrapper's call goes through
it (``_fused``), so a would-be launch is billed once at its
own inputs and outputs, as the reference's HLO census bills a fusion.

Attention and the selective scan are differentiable as in the reference
(``ops.py:390-423``, :453-463): each forward is the kernel (the plain version
on the CPU) and each backward is autograd through the plain version at the
saved inputs.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import warnings

import torch

from . import ref
from .dequant_matmul import (dequant_matmul_blocked_cuda,
                             dequant_matmul_flat_cuda, matmul_quant_cuda)
from .flash_attention import flash_attention_cuda
from .quant_blockwise import (dequantize_int8_cuda, dequantize_int8_sum_cuda,
                              quantize_int8_cuda)
from .quant_int4 import (dequantize_int4_cuda, dequantize_int4_sum_cuda,
                         quantize_int4_cuda)
from .selective_scan import selective_scan_cuda

KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
           "flash_attention", "quantize_int4", "dequantize_int4_sum",
           "matmul_quant", "selective_scan", "dequantize_int8_sum",
           "dequantize_int4", "dequant_matmul_blocked")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


# launches the card would make, counted on meta tensors (the dry run)
WOULD_LAUNCH: dict[str, int] = dict.fromkeys(KERNELS, 0)
# the census counting a step on meta (launch/census.py), or None; read here
# and by core/collectives.py
CENSUS = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


_DISPATCH_COUNTS: collections.Counter = collections.Counter()
_WARNED_FALLBACKS: set = set()


def record_fallback(kernel: str, reason: str) -> None:
    _DISPATCH_COUNTS[f"{kernel}/fallback/{reason}"] += 1
    key = (kernel, reason)
    if key not in _WARNED_FALLBACKS:
        _WARNED_FALLBACKS.add(key)
        warnings.warn(
            f"repro_torch.kernels.ops: {kernel} fell back to the chunked "
            f"plain path (reason: {reason}); the kernel will not be used for "
            "this call shape. Warned once per reason.", stacklevel=3)


def dispatch_counters() -> dict[str, int]:
    """Fallback counts, keyed ``kernel/fallback/reason``."""
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counters() -> None:
    _DISPATCH_COUNTS.clear()
    _WARNED_FALLBACKS.clear()


def _kernel(t: torch.Tensor, impl: str | None, name: str) -> bool:
    """True: launch the CUDA kernel ``name``; False: run the plain version
    (on meta, after counting the launch the card would make)."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or t.device.type == "cpu":
        return False
    if t.is_cuda:
        return True
    if t.is_meta:
        WOULD_LAUNCH[name] += 1
        return False
    raise ValueError(f"no kernel for device {t.device}")


def meta_trips(n: int, device: torch.device, start: int = 0):
    """(trips to run, context) of a loop of ``n`` trips from ``start`` whose
    every trip runs the same ops at the same shapes: all of them, except on
    ``meta`` (the dry run), where the first runs under the census's
    ``trips(n)`` (``launch/census.py``; with none counting, nothing is
    counted and one trip gives the shapes)."""
    if device.type != "meta" or n <= 1:
        return range(start, start + n), contextlib.nullcontext()
    return range(start, start + 1), (CENSUS.trips(n) if CENSUS is not None
                                     else contextlib.nullcontext())


def _fused(fn):
    """A kernel wrapper: while a census counts a step (``CENSUS``), its
    call goes through ``CENSUS.kernel_call``; otherwise straight to
    ``fn``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if CENSUS is None:
            return fn(*args, **kwargs)
        return CENSUS.kernel_call(fn, args, kwargs)
    return call


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    if x.ndim != 1 or x.numel() % block:
        raise ValueError(f"flat tensor of whole blocks expected: "
                         f"{tuple(x.shape)}, block {block}")
    return x.reshape(-1, block)


@_fused
def quantize_int8(x: torch.Tensor, block: int, impl: str | None = None):
    """1-D x (size % block == 0) -> (int8 same shape, f32 scales (size//block,))."""
    b = _blocks(x, block)
    if _kernel(x, impl, "quantize_int8"):
        LAUNCHES["quantize_int8"] += 1
        q, s = quantize_int8_cuda(b.contiguous())
    else:
        q, s = ref.quantize_int8_ref(b)
    return q.reshape(-1), s.reshape(-1)


@_fused
def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, block: int,
                    dtype=torch.float32, impl: str | None = None):
    """Flat int8 q + per-block scales -> flat ``dtype`` values."""
    qb = _blocks(q, block)
    sb = scales.reshape(-1, 1)
    if _kernel(q, impl, "dequantize_int8"):
        LAUNCHES["dequantize_int8"] += 1
        out = dequantize_int8_cuda(qb.contiguous(), sb.contiguous(), dtype)
    else:
        out = ref.dequantize_int8_ref(qb, sb, dtype)
    return out.reshape(-1)


@_fused
def quantize_int4(x: torch.Tensor, block: int, impl: str | None = None):
    """1-D x (size % block == 0, block even) -> (uint8 packed (size // 2,),
    f32 scales (size // block,))."""
    b = _blocks(x, block)
    if _kernel(x, impl, "quantize_int4"):
        LAUNCHES["quantize_int4"] += 1
        q, s = quantize_int4_cuda(b.contiguous())
    else:
        q, s = ref.quantize_int4_ref(b)
    return q.reshape(-1), s.reshape(-1)


@_fused
def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor, block: int,
                    dtype=torch.float32, impl: str | None = None):
    """Flat packed INT4 (size // 2,) uint8 + per-block scales -> flat
    ``dtype`` values (size,)."""
    qb = packed.reshape(-1, block // 2)
    sb = scales.reshape(-1, 1)
    if _kernel(packed, impl, "dequantize_int4"):
        LAUNCHES["dequantize_int4"] += 1
        out = dequantize_int4_cuda(qb.contiguous(), sb.contiguous(), dtype)
    else:
        out = ref.dequantize_int4_ref(qb, sb, dtype)
    return out.reshape(-1)


@_fused
def dequantize_int8_sum(q: torch.Tensor, scales: torch.Tensor, d: int,
                        block: int, dtype=torch.float32,
                        impl: str | None = None) -> torch.Tensor:
    """Fused dequant + sum of d received INT8 chunks.

    q: flat (d * n,) int8 (d chunks, row-major); scales: flat
    (d * n // block,). Returns (n,) ``dtype``: the sum over the chunks in f32,
    in chunk order, cast at the end."""
    qb = q.reshape(d, -1, block)
    sb = scales.reshape(d, -1, 1)
    if _kernel(q, impl, "dequantize_int8_sum"):
        LAUNCHES["dequantize_int8_sum"] += 1
        out = dequantize_int8_sum_cuda(qb.contiguous(), sb.contiguous())
    else:
        out = ref.dequantize_int8_sum_ref(qb, sb)
    return out.reshape(-1).to(dtype)


@_fused
def dequantize_int4_sum(packed: torch.Tensor, scales: torch.Tensor, d: int,
                        block: int, dtype=torch.float32,
                        impl: str | None = None) -> torch.Tensor:
    """Fused unpack + dequant + sum of d received INT4 chunks.

    packed: flat (d * n // 2,) uint8 (d chunks, row-major); scales: flat
    (d * n // block,). Returns (n,) ``dtype``: the sum over the chunks in f32,
    in chunk order."""
    qb = packed.reshape(d, -1, block // 2)
    sb = scales.reshape(d, -1, 1)
    if _kernel(packed, impl, "dequantize_int4_sum"):
        LAUNCHES["dequantize_int4_sum"] += 1
        out = dequantize_int4_sum_cuda(qb.contiguous(), sb.contiguous())
    else:
        out = ref.dequantize_int4_sum_ref(qb, sb)
    return out.reshape(-1).to(dtype)


@_fused
def matmul_quant(x2: torch.Tensor, g2: torch.Tensor, block: int, *,
                 bits: int = 8, pad_to: int | None = None,
                 impl: str | None = None):
    """Wire-format weight grad: C = x2.T @ g2, block-quantized in the matmul
    epilogue (the dense f32 C is never written out).

    x2 (M, K), g2 (M, N); N % block == 0. As in the reference's kernel, the
    operands keep their own dtype (bf16 operands go to the tensor cores as
    they are) and the products and sums are f32; operands of two dtypes, or
    of another float dtype, are widened to f32 first, which is exact.
    Returns flat (q, scales) in the
    layout ``quantize_int{8,4}(C.reshape(-1))`` gives: INT8 q is (K*N,) int8,
    INT4 q is (K*N // 2,) packed uint8, optionally padded to ``pad_to``
    logical elements with exact zero blocks (q 0 / 0x88, scale 1), which is
    what quantizing the zero padding gives on the unfused path."""
    kk, n = x2.shape[1], g2.shape[1]
    if n % block:
        raise ValueError(f"matmul_quant: N={n} is not a whole number of "
                         f"{block}-element blocks")
    if _kernel(x2, impl, "matmul_quant"):
        if x2.dtype != g2.dtype or x2.dtype not in (torch.float32,
                                                    torch.bfloat16):
            x2, g2 = x2.float(), g2.float()
        LAUNCHES["matmul_quant"] += 1
        q, s = matmul_quant_cuda(x2.contiguous(), g2.contiguous(), block, bits)
    else:
        q, s = ref.matmul_quant_ref(x2, g2, block, bits=bits)
    qf, sf = q.reshape(-1), s.reshape(-1)
    logical = kk * n
    if pad_to is not None and pad_to != logical:
        pad = pad_to - logical
        if pad < 0 or pad % block:
            raise ValueError(f"matmul_quant: pad_to {pad_to} for {logical} "
                             f"elements, block {block}")
        if bits == 4:
            tail = torch.full((pad // 2,), 0x88, dtype=torch.uint8,
                              device=qf.device)
        else:
            tail = torch.zeros((pad,), dtype=torch.int8, device=qf.device)
        qf = torch.cat([qf, tail])
        sf = torch.cat([sf, torch.ones((pad // block,), dtype=torch.float32,
                                       device=sf.device)])
    return qf, sf


def matmul_fusable(shape: tuple[int, ...], block: int) -> bool:
    """Can a weight of logical ``shape`` feed the fused dequant matmul?
    Needs >= 2 dims and whole quantization blocks along the last dim."""
    return len(shape) >= 2 and shape[-1] % block == 0


def dequant_matmul(x2: torch.Tensor, q_flat: torch.Tensor,
                   scales: torch.Tensor, w_shape: tuple[int, int], block: int,
                   *, transpose: bool = False, dtype=torch.bfloat16,
                   impl: str | None = None) -> torch.Tensor:
    """y = x2 @ dequant(W) (or x2 @ dequant(W).T) without materializing W.

    ``q_flat``/``scales`` are a flat wire-format buffer and its per-block
    scales (padded; only the first K*N / K*N//block entries are read).
    ``w_shape`` = (K, N) logical; x2 is (M, K), or (M, N) with ``transpose``,
    at ``dtype``, which is also the output dtype."""
    k, n = w_shape
    if n % block:
        raise ValueError(f"dequant_matmul: N={n} is not a whole number of "
                         f"{block}-element blocks (see matmul_fusable)")
    q2 = q_flat.reshape(-1)[: k * n].view(k, n)
    s2 = scales.reshape(-1)[: (k * n) // block].view(k, n // block)
    return _dequant_matmul(x2, q2, s2, block, transpose, dtype, impl)


@_fused
def _dequant_matmul(x2, q2, s2, block, transpose, dtype, impl):
    """``dequant_matmul`` on the (K, N) weight and its (K, N // block)
    scales, the part the kernel reads (so a census bills that part)."""
    if _kernel(x2, impl, "dequant_matmul"):
        if x2.dtype != dtype:
            raise ValueError(f"dequant_matmul: x is {x2.dtype}, output {dtype}")
        LAUNCHES["dequant_matmul"] += 1
        return dequant_matmul_flat_cuda(x2.contiguous(), q2, s2, block,
                                        transpose=transpose)
    return ref.dequant_matmul_flat_ref(x2, q2, s2, block, transpose=transpose,
                                       dtype=dtype)


@_fused
def dequant_matmul_blocked(x: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor, impl: str | None = None):
    """x (M, K) @ dequant(q (K, N) int8) -> (M, N) f32, with 2-D blocked
    scales (K // bk, N): one scale per column for each run of bk = K //
    scales.shape[0] rows. Not the flat layout of ``dequant_matmul``."""
    k, n = q.shape
    kb = scales.shape[0]
    if x.ndim != 2 or x.shape[1] != k or kb == 0 or k % kb \
            or scales.shape != (kb, n):
        raise ValueError(f"dequant_matmul_blocked: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scales {tuple(scales.shape)}")
    if _kernel(x, impl, "dequant_matmul_blocked"):
        LAUNCHES["dequant_matmul_blocked"] += 1
        return dequant_matmul_blocked_cuda(x.float().contiguous(),
                                           q.contiguous(), scales.contiguous())
    return ref.dequant_matmul_blocked_ref(x, q, scales)


def attention_fusable(sq: int, sk: int, d: int, dv: int, *,
                      softmax_scale=None,
                      q_offset=0) -> tuple[bool, str | None]:
    """Can this attention call use the kernel? Returns (ok, reason), with
    the reference's gate and reasons: "mla_dv_mismatch", "custom_scale",
    "traced_q_offset", "seq_unaligned"."""
    if dv != d:
        return False, "mla_dv_mismatch"
    if softmax_scale is not None:
        return False, "custom_scale"
    if not isinstance(q_offset, int):
        return False, "traced_q_offset"
    if sq < 8 or sk < 8 or sq % min(128, sq) or sk % min(128, sk):
        return False, "seq_unaligned"
    return True, None


def _attention_plain(q, k, v, causal: bool, window: int, q_offset: int):
    n_rep = q.shape[0] // k.shape[0]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=0)
        v = v.repeat_interleave(n_rep, dim=0)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)


class _Attention(torch.autograd.Function):
    """Forward: the kernel (or the plain version); backward: autograd
    through the plain version at the saved inputs, as the reference's
    custom_vjp takes ``jax.vjp`` of its oracle."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, impl):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        if _kernel(q, impl, "flash_attention"):
            LAUNCHES["flash_attention"] += 1
            return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=causal,
                                        window=window, q_offset=q_offset)
        return _attention_plain(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = _attention_plain(q, k, v, *ctx.mask)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


@_fused
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, impl: str | None = None):
    """q (BH, Sq, D); k, v (BH / n_rep, Sk, D) -> (BH, Sq, D).

    The caller (models/layers.py) folds heads and checks
    ``attention_fusable`` first. Query head i attends KV head i // n_rep."""
    return _Attention.apply(q, k, v, causal, window, q_offset, impl)


class _SelectiveScan(torch.autograd.Function):
    """Forward: the kernel (or the plain version); backward: autograd
    through the plain version at the saved f32 inputs for both outputs, as
    the reference's custom_vjp takes ``jax.vjp`` of its oracle. The kernel's
    outputs carry no graph of their own: this gives the scan its gradient
    on the card."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a, h0, impl):
        args = tuple(t.float() for t in (dt, x, b, c, a, h0))
        ctx.save_for_backward(*args)
        ctx.dtypes = tuple(t.dtype for t in (dt, x, b, c, a, h0))
        if _kernel(dt, impl, "selective_scan"):
            LAUNCHES["selective_scan"] += 1
            return selective_scan_cuda(*(t.contiguous() for t in args))
        return ref.selective_scan_ref(*args)

    @staticmethod
    def backward(ctx, gy, gh):
        # 256-step blocks rematerialised, as the reference's oracle: one
        # block's graph alive at a time, not the whole sequence's
        grads = ref.selective_scan_ref_vjp(*ctx.saved_tensors, gy, gh)
        return tuple(g.to(dtype) for g, dtype in zip(grads, ctx.dtypes)) \
            + (None,)


@_fused
def selective_scan(dt, x, b, c, a, h0, *, impl: str | None = None):
    """The Mamba-1 recurrence: dt, x (B, S, D); b, c (B, S, N); a (D, N);
    h0 (B, D, N) -> (y (B, S, D) f32, h_last (B, D, N) f32). Inputs are taken
    in f32, as the reference's kernel casts them; gradients come back in the
    inputs' dtypes."""
    bsz, s, d = dt.shape
    n = a.shape[-1]
    if x.shape != dt.shape or b.shape != (bsz, s, n) or c.shape != b.shape \
            or a.shape != (d, n) or h0.shape != (bsz, d, n):
        raise ValueError(
            f"selective_scan: dt {tuple(dt.shape)}, x {tuple(x.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, a {tuple(a.shape)}, h0 "
            f"{tuple(h0.shape)}")
    return _SelectiveScan.apply(dt, x, b, c, a, h0, impl)
