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
"""
from __future__ import annotations

import torch

from . import ref
from .dequant_matmul import dequant_matmul_flat_cuda
from .flash_attention import flash_attention_cuda
from .quant_blockwise import dequantize_int8_cuda, quantize_int8_cuda

KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
           "flash_attention")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


def _kernel(t: torch.Tensor, impl: str | None) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or t.device.type == "cpu":
        return False
    if t.is_cuda:
        return True
    raise ValueError(f"no kernel for device {t.device}")


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    if x.ndim != 1 or x.numel() % block:
        raise ValueError(f"flat tensor of whole blocks expected: "
                         f"{tuple(x.shape)}, block {block}")
    return x.reshape(-1, block)


def quantize_int8(x: torch.Tensor, block: int, impl: str | None = None):
    """1-D x (size % block == 0) -> (int8 same shape, f32 scales (size//block,))."""
    b = _blocks(x, block)
    if _kernel(x, impl):
        LAUNCHES["quantize_int8"] += 1
        q, s = quantize_int8_cuda(b.contiguous())
    else:
        q, s = ref.quantize_int8_ref(b)
    return q.reshape(-1), s.reshape(-1)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, block: int,
                    dtype=torch.float32, impl: str | None = None):
    """Flat int8 q + per-block scales -> flat ``dtype`` values."""
    qb = _blocks(q, block)
    sb = scales.reshape(-1, 1)
    if _kernel(q, impl):
        LAUNCHES["dequantize_int8"] += 1
        out = dequantize_int8_cuda(qb.contiguous(), sb.contiguous(), dtype)
    else:
        out = ref.dequantize_int8_ref(qb, sb, dtype)
    return out.reshape(-1)


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
    if _kernel(x2, impl):
        if x2.dtype != dtype:
            raise ValueError(f"dequant_matmul: x is {x2.dtype}, output {dtype}")
        LAUNCHES["dequant_matmul"] += 1
        return dequant_matmul_flat_cuda(x2.contiguous(), q2, s2, block,
                                        transpose=transpose)
    return ref.dequant_matmul_flat_ref(x2, q2, s2, block, transpose=transpose,
                                       dtype=dtype)


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, impl: str | None = None):
    """q (BH, Sq, D); k, v (BH / n_rep, Sk, D) -> (BH, Sq, D).

    The caller (models/layers.py) folds heads and checks
    ``attention_fusable`` first. Query head i attends KV head i // n_rep."""
    if _kernel(q, impl):
        LAUNCHES["flash_attention"] += 1
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, q_offset=q_offset)
    n_rep = q.shape[0] // k.shape[0]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=0)
        v = v.repeat_interleave(n_rep, dim=0)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
