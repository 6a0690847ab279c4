"""Serving over a mesh of ranks: batched prefill and single-token decode
steps, from the training engine's primaries (the ``gathered`` backend).

Port of ``repro.serve.engine``. Every rank runs this code on its own rows
and its own cache slices, and the collectives meet over the mesh's process
groups (``launch.mesh.serve_axis_tuples``), where the reference runs one
``shard_map`` program:

* the batch is split over the data axes (``batch_axes``: the largest
  prefix of them that divides it); a rank's prefill and decode take the
  global batch and run its rows. A B = 1 prefill runs whole on every rank
  of the data axes, as the reference's does;
* full-attention caches are sharded along the sequence over the model-tier
  axes (``ServeConfig.seq_axes``) and attended with the exact distributed
  flash-decode (``models.layers.flash_decode``); rings and mamba states are
  whole on every rank;
* logits are this rank's rows; ``gather_rows`` all-gathers a row-indexed
  tensor (the greedy tokens) over the batch axes, so every rank's host
  holds every token.

``ServeEngine`` serves straight from ``state["primaries"]`` through the
training forward's per-layer INT8 gather (``core.engine.ParamView`` under
``torch.no_grad``: quantize, all-gather over W, fused dequant-matmul; no
sinks, no prefetch buffers, no autograd graph), "FSDP-style inference"; the
reference's serving keeps the inline gather whatever ``overlap`` says.
``serve.resident.ResidentServeEngine`` runs the same code over the INT8
residency.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import collectives as col
from ..core.engine import ParamView
from ..models.config import ShapeConfig
from ..models.registry import batch_axes, data_axes, model_axes


@dataclass
class ServeConfig:
    seq_axes: tuple[str, ...]          # cache sequence-sharding axes
    batch_axes_: tuple[str, ...]       # cache/batch batch-sharding axes


def make_serve_config(mesh, global_batch: int) -> ServeConfig:
    baxes = batch_axes(mesh, global_batch, candidates=data_axes(mesh))
    return ServeConfig(seq_axes=model_axes(mesh), batch_axes_=baxes)


class MeshServe:
    """Prefill / decode / greedy generation of ``model`` at ``shape`` on
    this rank of ``mesh`` (None: one device, no axes), over the parameter
    view ``_view(params)`` that a backend defines."""

    def __init__(self, model, mesh, shape: ShapeConfig,
                 sc: ServeConfig | None = None):
        self.model = model
        self.mesh = mesh
        self.shape = shape
        if mesh is None:
            self.sc = sc or ServeConfig((), ())
            self.axis_sizes = {}
            self.n_batch = self.n_seq = 1
            self.row0 = 0
        else:
            from ..launch.mesh import serve_axis_tuples
            mesh.bind(serve_axis_tuples(mesh))
            col.bind(mesh)
            self.sc = sc or make_serve_config(mesh, shape.global_batch)
            self.axis_sizes = dict(mesh.shape)
            self.n_batch = mesh.axis_size(self.sc.batch_axes_)
            self.n_seq = mesh.axis_size(self.sc.seq_axes)
            self.row0 = mesh.index(self.sc.batch_axes_) \
                * (shape.global_batch // self.n_batch)
        self.b_loc = shape.global_batch // self.n_batch

    def _view(self, params):
        raise NotImplementedError

    def cache_shapes(self):
        """This rank's cache (shape, dtype, seq-indexed) per kind and
        entry."""
        return self.model.local_cache_shapes(self.shape, self.n_batch,
                                             self.n_seq)

    def prefill_inputs(self, device) -> dict[str, torch.Tensor]:
        """The global prefill batch's tensors, uninitialised, on ``device``:
        the dry run's stand-ins (the reference's ``prefill_inputs_sds``,
        ``src/repro/serve/engine.py:71``) on ``meta``."""
        return {k: torch.empty(sh, dtype=dt, device=device)
                for k, (sh, dt) in
                self.model.prefill_batch_shapes(self.shape).items()}

    def decode_inputs(self, device):
        """(this rank's caches, the global decode batch) of one decode step,
        uninitialised, on ``device`` (the reference's ``decode_inputs_sds``,
        :97). The shared position is the cache's last (a full cache), a
        host integer, so no step reads it from ``device``."""
        caches: dict = {kind: {n: torch.empty(sh, dtype=dt, device=device)
                               for n, (sh, dt, _) in entry.items()}
                        for kind, entry in self.cache_shapes().items()}
        caches["pos"] = torch.tensor(self.shape.seq_len - 1, dtype=torch.int32)
        batch = {"token": torch.empty((self.shape.global_batch,),
                                      dtype=torch.int32, device=device)}
        return caches, batch

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global row-indexed tensor."""
        if self.n_batch == 1:
            return t
        return t[self.row0:self.row0 + self.b_loc]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's rows (all-gather over the
        batch axes, in axis order)."""
        return col.gather_dim(t, self.sc.batch_axes_, 0, op="batch_gather")

    def make_prefill(self, seq_parallel: bool = False):
        lm, sc = self.model.lm, self.sc

        def prefill(params, batch):
            local = {k: self.local_rows(v) for k, v in batch.items()}
            with torch.no_grad():
                return lm.prefill(self._view(params), local,
                                  seq_axes=sc.seq_axes,
                                  axis_sizes=self.axis_sizes,
                                  seq_parallel=seq_parallel)
        return prefill

    def make_decode(self, per_row_pos: bool = False):
        """``decode(params, caches, batch)``: batch {"token": (B,)} and, for
        continuous batching (``per_row_pos``), {"row_pos": (B,)}, global;
        ``caches`` this rank's. Returns (this rank's logits, caches)."""
        lm, sc = self.model.lm, self.sc

        def decode(params, caches, batch):
            local = {k: self.local_rows(v) for k, v in batch.items()}
            with torch.no_grad():
                return lm.decode(self._view(params), caches, local,
                                 seq_axes=sc.seq_axes,
                                 axis_sizes=self.axis_sizes)
        return decode

    def generate(self, params, prompt_batch, n_tokens: int):
        """Greedy generation: prefill, then decode at the shared position
        (a position past the prefill cache writes nothing, as in the
        reference). Returns the global (B, n_tokens) int32 tokens on every
        rank."""
        prefill = self.make_prefill()
        decode = self.make_decode()
        logits, caches = prefill(params, prompt_batch)
        toks = [self.gather_rows(logits.argmax(dim=-1).to(torch.int32))]
        for _ in range(n_tokens - 1):
            logits, caches = decode(params, caches, {"token": toks[-1]})
            toks.append(self.gather_rows(
                logits.argmax(dim=-1).to(torch.int32)))
        return torch.stack(toks, dim=1)


class ServeEngine(MeshServe):
    """The gathered backend: every weight re-gathered per use from the
    ZeRO primaries (``params`` = ``state["primaries"]``) through the
    engine's ``ParamView``."""

    def __init__(self, model, engine, mesh, shape: ShapeConfig,
                 sc: ServeConfig | None = None):
        super().__init__(model, mesh, shape, sc)
        self.engine = engine

    def _view(self, primaries):
        return ParamView(self.engine.fns, primaries, self.engine.cfg.impl)
