"""PyTorch + CUDA port of the ``repro`` JAX package, slice by slice.

This package imports ``torch`` and never ``jax`` or anything of ``repro``.
Its entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such request they raise (``repro_torch.device``).
"""
