"""Deterministic synthetic token batches.

Port of ``repro.data.pipeline``'s ``BatchSpec`` (:29), ``spec_for`` (:38) and
``SyntheticTokens`` (:70): the same numpy-seeded stream, so both packages
train on bit-identical batches (a VLM's patch embeddings drawn from the same
generator after the tokens). Every rank draws the global batch and keeps its own rows
(``local_rows``), as the reference's ``batch_specs`` shard dim 0 over the
batch axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BatchSpec:
    global_batch: int
    seq_len: int              # text tokens per row (excl. next-token shift)
    vocab: int
    n_patches: int = 0
    n_frames: int = 0
    d_model: int = 0


def spec_for(arch, global_batch: int, seq_len: int) -> BatchSpec:
    """The batch of ``arch`` at ``seq_len`` positions a row: a VLM's
    ``n_patches`` of them are its patch prefix, the rest text."""
    s_text = seq_len - arch.n_patches if arch.n_patches else seq_len
    return BatchSpec(global_batch, s_text, arch.vocab,
                     n_patches=arch.n_patches, n_frames=arch.n_frames,
                     d_model=arch.d_model)


class SyntheticTokens:
    """Deterministic learnable token stream.

    Each row: Zipf(1.2)-sampled tokens where every position with
    ``i % 4 != 0`` deterministically repeats a function of the previous token
    — a next-token structure a model learns within a few hundred steps.
    """

    def __init__(self, spec: BatchSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed

    def batch(self, step: int) -> dict[str, np.ndarray]:
        sp = self.spec
        rng = np.random.default_rng((self.seed, step))
        b, s = sp.global_batch, sp.seq_len
        base = rng.zipf(1.2, size=(b, s + 1)).astype(np.int64)
        toks = (base - 1) % sp.vocab
        for k in range(1, 4):
            idx = np.arange(k, s + 1, 4)
            toks[:, idx] = (toks[:, idx - 1] * 31 + 7) % sp.vocab
        out = {"tokens": toks.astype(np.int32)}
        if sp.n_patches:
            out["patches"] = self._embed(rng, (b, sp.n_patches, sp.d_model))
        if sp.n_frames:
            out["frames"] = self._embed(rng, (b, sp.n_frames, sp.d_model))
        return out

    @staticmethod
    def _embed(rng, shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def batch_axes(mesh, global_batch: int) -> tuple[str, ...]:
    """Largest major -> minor prefix of the mesh axes whose product divides
    the global batch (the reference's ``registry.batch_axes``)."""
    out, prod = [], 1
    for a in mesh.axis_names:
        n = mesh.shape[a]
        if global_batch % (prod * n):
            break
        out.append(a)
        prod *= n
    return tuple(out)


def local_rows(batch: dict[str, np.ndarray], mesh) -> dict[str, np.ndarray]:
    """This rank's rows of a global batch: dim 0 split over the batch axes,
    block i to the rank whose linear index over them is i."""
    out = {}
    for k, v in batch.items():
        axes = batch_axes(mesh, v.shape[0])
        n = mesh.axis_size(axes)
        rows = v.shape[0] // n
        i = mesh.index(axes)
        out[k] = v[i * rows:(i + 1) * rows]
    return out
