"""Weights and training state across the two packages.

``from_jax_primaries`` takes the reference's ``state["primaries"]`` on a
one-device mesh, handed over as numpy arrays (flat padded ``(pad,)`` or
``(stack, pad)`` at compute dtype, bf16 as ml_dtypes' bfloat16), and returns
the port's primaries: the same values in the same layout as torch tensors.
Both packages then build the same residency and compute the same thing.

``from_jax_state`` takes the reference's whole ``init_state`` output as
global numpy arrays (primaries, fp32 master, ``opt_m``, ``opt_v``, ``step``)
and returns this rank's shards of it for a ``core.engine.ZeroEngine``;
``save_global_state`` / ``load_global_state`` carry such a state in one
``.npz`` file (bf16 as its raw 16 bits).
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


STATE_KEYS = ("primaries", "master", "opt_m", "opt_v")


def from_jax_state(state: dict, engine) -> dict:
    """The reference's global state -> this rank's port state. The arrays
    may be numpy (bf16 as ml_dtypes' bfloat16) or torch tensors (as
    ``load_global_state`` returns them). Every returned tensor is a copy the
    engine owns (``engine.shard_primary`` / ``shard_os`` clone), since its
    step updates the state in place: the caller's arrays stay as they
    were."""
    specs = engine.specs
    out = {"step": int(state["step"])}
    for key in STATE_KEYS:
        if set(state[key]) != set(specs):
            raise ValueError(f"{key}: leaf names differ from the engine's")
        shard = engine.shard_primary if key == "primaries" else engine.shard_os
        out[key] = {}
        for name in sorted(specs):
            a = state[key][name]
            t = a if isinstance(a, torch.Tensor) else _to_torch(np.asarray(a))
            if t.shape[-1] != engine._pad[name]:
                raise ValueError(f"{key}/{name}: shape {tuple(t.shape)}, "
                                 f"padded length {engine._pad[name]}")
            out[key][name] = shard(name, t)
    return out


def save_global_state(path, state: dict) -> None:
    """A global numpy state (``STATE_KEYS`` dicts + ``step``) -> ``.npz``."""
    arrays = {"step": np.asarray(state["step"])}
    for key in STATE_KEYS:
        for name, a in state[key].items():
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                arrays[f"{key}/bf16/{name}"] = a.view(np.int16)
            else:
                arrays[f"{key}/{name}"] = a
    np.savez(path, **arrays)


def load_global_state(path) -> dict:
    """``save_global_state``'s file -> {key: {name: torch tensor}, step}."""
    out = {key: {} for key in STATE_KEYS}
    with np.load(path) as z:
        for k in z.files:
            if k == "step":
                out["step"] = int(z[k])
                continue
            key, rest = k.split("/", 1)
            if rest.startswith("bf16/"):
                out[key][rest[5:]] = torch.from_numpy(z[k].copy()).view(
                    torch.bfloat16)
            else:
                out[key][rest] = torch.from_numpy(z[k].copy())
    return out
