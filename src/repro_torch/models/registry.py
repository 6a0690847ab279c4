"""Architecture registry: ArchConfig -> ModelDef (leaf specs + cache shapes).

The torch-side half of ``repro.models.registry``: ``register``/``get_arch``
and the per-kind cache shapes serving allocates. KV caches are bf16 whatever
the compute dtype, as in the reference; a sliding-window layer's ring holds
its window's W positions, and a mamba layer's scan state and conv tail are
f32: both are O(1) per row (not sequence-indexed, so never paged).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..core.partition import LeafSpec
from .config import ArchConfig, ShapeConfig
from .ssm import mamba_state_spec
from .transformer import LM, kind_meta

ARCHS: dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]):
    cfg = fn()
    ARCHS[cfg.name] = fn
    return fn


def get_arch(name: str) -> ArchConfig:
    if not ARCHS:
        load_all_configs()
    return ARCHS[name]()


def load_all_configs():
    """Import every repro_torch.configs.<arch> module (they self-register)."""
    import importlib
    import pkgutil

    from .. import configs as pkg
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"repro_torch.configs.{m.name}")


@dataclass
class ModelDef:
    arch: ArchConfig
    lm: LM

    def leaf_specs(self) -> dict[str, LeafSpec]:
        return self.lm.leaf_specs()

    def cache_shapes(self, shape: ShapeConfig) -> dict[str, Any]:
        """Global cache (shape, dtype, seq-indexed) per kind and entry."""
        cfg = self.arch
        b, s = shape.global_batch, shape.seq_len
        kv, hd = cfg.kv_heads, cfg.hdim
        out: dict[str, Any] = {}
        for kind, count in cfg.kind_counts().items():
            m = kind_meta(kind, cfg)
            if m.mixer == "mamba":
                (h_shape, h_dt), (c_shape, c_dt) = mamba_state_spec(cfg, b)
                out[kind] = {"h": ((count,) + h_shape, h_dt, False),
                             "conv": ((count,) + c_shape, c_dt, False)}
                continue
            if m.mixer != "attn":
                raise NotImplementedError(
                    f"{kind}: only attention and mamba caches are ported")
            # a ring is always the window long (slot = pos % W)
            length, seq_indexed = (m.window, False) if m.window else (s, True)
            shape = (count, b, length, kv, hd)
            out[kind] = {"k": (shape, torch.bfloat16, seq_indexed),
                         "v": (shape, torch.bfloat16, seq_indexed)}
        return out


def build_model(arch: ArchConfig) -> ModelDef:
    return ModelDef(arch, LM(arch))
