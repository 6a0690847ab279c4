"""Architecture registry: ArchConfig -> ModelDef (leaf specs + cache shapes).

The torch-side half of ``repro.models.registry``: ``register``/``get_arch``/
``list_archs``, ``ModelDef.param_count``,
the serving axes of a mesh (``data_axes``, ``model_axes``, ``batch_axes``),
the train and prefill batch shapes (a VLM's patch prefix counted in the
sequence, an encoder-decoder's frames beside the tokens) and the per-kind
cache shapes serving allocates. KV caches are bf16 whatever the compute
dtype, as in the reference; an MLA layer caches its compressed latent
(kv_lora + qk_rope a position), sequence-indexed as K/V are; a decoder
block's cross K/V hold all F frames, written once at prefill; a
sliding-window layer's ring holds its window's W positions, and a mamba
layer's scan state and conv tail are f32: rings, cross caches and mamba
states are not sequence-indexed, so never paged. On a mesh the
full-attention caches and MLA latents are sharded over the model-tier axes
along the sequence (``seq_shard``), every cache over the batch axes along
the rows; the rest are whole on every rank of a row's group.
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


def list_archs() -> list[str]:
    if not ARCHS:
        load_all_configs()
    return sorted(ARCHS)


def load_all_configs():
    """Import every repro_torch.configs.<arch> module (they self-register)."""
    import importlib
    import pkgutil

    from .. import configs as pkg
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"repro_torch.configs.{m.name}")


# ---------------------------------------------------------------------------
# Batch partitioning helpers (a ``launch.mesh.Mesh``: axis_names, shape)
# ---------------------------------------------------------------------------

MODEL_AXES = ("model", "node", "gcd")


def batch_axes(mesh, global_batch: int,
               candidates: tuple[str, ...] | None = None) -> tuple[str, ...]:
    """Largest major->minor prefix of mesh axes whose product divides batch."""
    axes = candidates if candidates is not None else tuple(mesh.axis_names)
    out: list[str] = []
    prod = 1
    for a in axes:
        n = mesh.shape[a]
        if global_batch % (prod * n) == 0:
            out.append(a)
            prod *= n
        else:
            break
    return tuple(out)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes used for batch sharding of serve shapes (everything but model
    tiers)."""
    return tuple(a for a in mesh.axis_names if a not in MODEL_AXES)


def model_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in MODEL_AXES)


@dataclass
class ModelDef:
    arch: ArchConfig
    lm: LM

    def leaf_specs(self) -> dict[str, LeafSpec]:
        return self.lm.leaf_specs()

    def param_count(self) -> int:
        """Logical (unpadded) parameter count, ``ZeroEngine.param_count``'s."""
        return sum(s.logical_size * (s.stack or 1)
                   for s in self.leaf_specs().values())

    def _extra_inputs(self, b: int) -> dict[str, tuple]:
        cfg = self.arch
        out = {}
        if cfg.n_patches:
            out["patches"] = ((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
        if cfg.enc_layers:
            out["frames"] = ((b, cfg.n_frames, cfg.d_model), torch.bfloat16)
        return out

    def train_batch_shapes(self, shape: ShapeConfig) -> dict[str, tuple]:
        """Global train batch (shape, dtype) per input: ``shape.seq_len``
        positions a row, a VLM's patch prefix among them (``S_text =
        seq_len - n_patches`` tokens, one more for the shift)."""
        b, s = shape.global_batch, shape.seq_len
        s_text = s - self.arch.n_patches
        out = {"tokens": ((b, s_text + 1), torch.int32)}
        out.update(self._extra_inputs(b))
        return out

    def prefill_batch_shapes(self, shape: ShapeConfig) -> dict[str, tuple]:
        """Global prefill batch (shape, dtype) per input, as
        ``train_batch_shapes`` without the shift."""
        b, s = shape.global_batch, shape.seq_len
        out = {"tokens": ((b, s - self.arch.n_patches), torch.int32)}
        out.update(self._extra_inputs(b))
        return out

    def cache_shapes(self, shape: ShapeConfig) -> dict[str, Any]:
        """Global cache (shape, dtype, seq-indexed) per kind and entry; a
        cache holds ``shape.seq_len`` positions, a patch prefix's too."""
        cfg = self.arch
        b, s = shape.global_batch, shape.seq_len
        h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.hdim
        out: dict[str, Any] = {}
        for kind, count in cfg.kind_counts().items():
            m = kind_meta(kind, cfg)
            if m.mixer == "mamba":
                (h_shape, h_dt), (c_shape, c_dt) = mamba_state_spec(cfg, b)
                out[kind] = {"h": ((count,) + h_shape, h_dt, False),
                             "conv": ((count,) + c_shape, c_dt, False)}
                continue
            if m.mixer == "mla":
                ml = cfg.mla
                out[kind] = {"lat": ((count, b, s, ml.kv_lora + ml.qk_rope),
                                     torch.bfloat16, True)}
                continue
            # a ring is always the window long (slot = pos % W)
            length, seq_indexed = (m.window, False) if m.window else (s, True)
            shape = (count, b, length, kv, hd)
            out[kind] = {"k": (shape, torch.bfloat16, seq_indexed),
                         "v": (shape, torch.bfloat16, seq_indexed)}
            if m.cross:
                xs = (count, b, cfg.n_frames, h, hd)
                out[kind].update(kx=(xs, torch.bfloat16, False),
                                 vx=(xs, torch.bfloat16, False))
        return out

    def local_cache_shapes(self, shape: ShapeConfig, n_batch: int = 1,
                           n_seq: int = 1) -> dict[str, Any]:
        """One rank's cache shapes when the rows are split ``n_batch`` ways
        and the sequence-indexed entries ``n_seq`` ways: ``(L, B / n_batch,
        S / n_seq, ...)`` for those, ``(L, B / n_batch, ...)`` for the
        rest."""
        out: dict[str, Any] = {}
        for kind, entry in self.cache_shapes(shape).items():
            out[kind] = {}
            for name, (sh, dt, seq_shard) in entry.items():
                sh = list(sh)
                if sh[1] % n_batch or (seq_shard and sh[2] % n_seq):
                    raise ValueError(f"{kind}.{name} {tuple(sh)}: rows over "
                                     f"{n_batch}, sequence over {n_seq}")
                sh[1] //= n_batch
                if seq_shard:
                    sh[2] //= n_seq
                out[kind][name] = (tuple(sh), dt, seq_shard)
        return out


def build_model(arch: ArchConfig) -> ModelDef:
    return ModelDef(arch, LM(arch))
