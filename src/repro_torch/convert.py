"""Weights across the two packages.

``from_jax_primaries`` takes the reference's ``state["primaries"]`` on a
one-device mesh, handed over as numpy arrays (flat padded ``(pad,)`` or
``(stack, pad)`` at compute dtype, bf16 as ml_dtypes' bfloat16), and returns
the port's primaries: the same values in the same layout as torch tensors.
Both packages then build the same residency and compute the same thing.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .models.config import ArchConfig
from .models.transformer import LM


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype != np.float32:
        raise ValueError(f"unsupported primary dtype {a.dtype}")
    return torch.from_numpy(a.copy())


def from_jax_primaries(primaries: dict[str, np.ndarray], arch: ArchConfig,
                       device="cuda") -> dict[str, torch.Tensor]:
    """Reference primaries (numpy) -> the port's primaries on ``device``.

    Checks that the leaf names are the model's and that each array has the
    ``[stack,] pad`` layout of its leaf (pad >= the logical size)."""
    dev = resolve(device)
    specs = LM(arch).leaf_specs()
    if set(primaries) != set(specs):
        raise ValueError(f"leaf names differ: missing "
                         f"{sorted(set(specs) - set(primaries))}, unexpected "
                         f"{sorted(set(primaries) - set(specs))}")
    out = {}
    for name, spec in specs.items():
        a = np.asarray(primaries[name])
        ndim = 2 if spec.stack else 1
        if a.ndim != ndim or (spec.stack and a.shape[0] != spec.stack) \
                or a.shape[-1] < spec.logical_size:
            raise ValueError(f"{name}: shape {a.shape} is not the "
                             f"[stack,] pad layout of {spec}")
        out[name] = _to_torch(a).to(dev)
    return out
