"""Quantized-resident serving: the INT8 wire format as the weight residency.

Port of ``repro.serve.resident``. Each MATMUL leaf is quantized once at
server start into its wire format (INT8 payload + f32 per-block scales),
exactly as the training forward gathers it (``col.gather_issue_int8`` over
the weight axes W), and this rank keeps its residency slice
(``col.residency_slice`` over the residency axes: by default the scheme's
secondary partition, else the mesh's model tier, ``default_res_axes``).
Every matmul of prefill and decode re-gathers the slices over the
residency axes (``col.gather_residency_q``; nothing at degree 1) and feeds
the buffer straight to the fused dequant-matmul kernel
(``linear._mm_apply_q``), so the logits are bit for bit the gathered
backend's (``serve.engine.ServeEngine``) at the same quant config. PLAIN
leaves (norms, biases) are gathered over W once and stay dense in the
compute dtype. The embedding lookup dequantizes only the looked-up rows:
each row of ``embed`` is whole quant blocks, so the numbers equal the
reference's dequantize-the-whole-table-then-take.

The weights come, on one device, from ``iter_primaries`` /
``init_primaries`` (a seeded init with the reference's distributions, drawn
from a ``torch.Generator``, one leaf at a time and a stacked leaf one layer
row at a time) or from the reference's
own primaries (``repro_torch.convert.from_jax_primaries``); on a mesh,
from a training engine's ``state["primaries"]`` (never its fp32 master).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..core import collectives as col
from ..core import linear
from ..core.partition import (GATHER_Q, MATMUL, LeafSpec, ZeroConfig,
                              padded_flat_size, resident_memory_bytes)
from ..models.config import ShapeConfig
from ..models.moe import expert_glu
from ..models.registry import model_axes
from .engine import MeshServe, ServeConfig

WIRE = "wire"     # INT8 payload + per-block scales
DENSE = "dense"   # compute-dtype dense tensor


def default_res_axes(cfg: ZeroConfig, mesh=None) -> tuple[str, ...]:
    """Residency axes: the training secondary partition when the scheme has
    one, else the mesh's model tier (intra-node bandwidth for the per-token
    re-gather); none without a mesh."""
    if cfg.axes.secondary:
        return tuple(cfg.axes.secondary)
    return model_axes(mesh) if mesh is not None else ()


class ResidentLayout:
    """Per-leaf quant config, padded sizes and residency mode of one model
    under one scheme config (the slice of the reference's ZeroEngine that
    serving reads). On ``mesh`` (this rank's, or None for one device) the
    residency axes' process groups are bound."""

    def __init__(self, specs: dict[str, LeafSpec], cfg: ZeroConfig,
                 res_axes: tuple[str, ...] | None = None, mesh=None):
        self.specs = dict(specs)
        self.cfg = cfg
        if res_axes is None:
            res_axes = default_res_axes(cfg, mesh)
        self.res_axes = tuple(res_axes)
        self.res_degree = cfg.size(self.res_axes)
        if mesh is not None:
            mesh.bind([self.res_axes])
        self.leaf_cfg = {n: cfg.for_leaf(s.logical_size)
                         for n, s in self.specs.items()}
        self.pad = {n: padded_flat_size(s.logical_size, cfg)
                    for n, s in self.specs.items()}

    @property
    def dtype(self) -> torch.dtype:
        return linear._dtype(self.cfg)

    def mode(self, name: str) -> str:
        spec = self.specs[name]
        if spec.kind in (MATMUL, GATHER_Q) and self.leaf_cfg[name].quantize_weights:
            return WIRE
        return DENSE

    def wire_lens(self, name: str) -> tuple[int, int]:
        """Per-device (q, scales) residency lengths for a WIRE leaf."""
        pad = self.pad[name]
        return (pad // self.res_degree,
                pad // self.leaf_cfg[name].quant_block // self.res_degree)

    def memory_report(self) -> dict[str, Any]:
        """Per-device resident bytes, wire vs dense, plus the formula view."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        wire = dense = psi = 0
        for name, spec in self.specs.items():
            reps = spec.stack or 1
            if self.mode(name) == WIRE:
                qlen, slen = self.wire_lens(name)
                wire += reps * (qlen + 4 * slen)
                psi += reps * spec.logical_size
            else:
                dense += reps * spec.logical_size * itemsize
        return dict(
            res_axes=list(self.res_axes), res_degree=self.res_degree,
            wire_bytes=int(wire), dense_bytes=int(dense),
            total_bytes=int(wire + dense),
            formula_bytes=int(resident_memory_bytes(
                self.cfg, psi, res_degree=self.res_degree)))


def _draw_rows(draw, gen, rows: int, n: int, device):
    """Yields ``rows`` draws of ``draw((n,))`` (``torch.randn`` or
    ``torch.rand``) from ``gen``, one at a time, so that one row's f32 is
    alive at a time: a stacked leaf is drawn a layer row at a time."""
    for _ in range(rows):
        yield draw((n,), generator=gen, device=device)


def _init_rows(spec: LeafSpec, rows: int, n: int, gen, device):
    """Yields the f32 (n,) initial values of each of a leaf's ``rows``
    rows in turn (None for zeros): the reference's distributions. No
    generator here keeps a row it yielded once it is resumed, so a row's
    draw is freed before the next one is drawn."""
    if spec.init == "zeros":
        yield from (None for _ in range(rows))
    elif spec.init == "ones":
        for _ in range(rows):
            yield torch.ones((n,), dtype=torch.float32, device=device)
    elif spec.init == "ssm_a":
        # mamba: A_log = log(1..d_state) broadcast over d_inner
        d_inner, d_state = spec.shape
        a = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device))
        for _ in range(rows):
            yield a.expand(d_inner, d_state).reshape(n)
    elif spec.init == "dt_bias":
        # mamba: softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]
        lo, hi = 1e-3, 1e-1
        draws = _draw_rows(torch.rand, gen, rows, n, device)
        for _ in range(rows):
            dt = torch.exp(next(draws) * (math.log(hi) - math.log(lo))
                           + math.log(lo))
            dt = torch.log(torch.exp(dt) - 1.0 + 1e-9)
            yield dt
            del dt
    else:
        scale = spec.init_scale
        if scale is None:
            fan_in = spec.shape[0] if len(spec.shape) >= 2 else n
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        draws = _draw_rows(torch.randn, gen, rows, n, device)
        for _ in range(rows):
            z = next(draws).mul_(scale)
            yield z
            del z


class StackRows:
    """A stacked leaf's padded primary ``[stack, pad]``, drawn one layer
    row at a time: ``shape`` is the stack's; iterating yields each row's
    ``(pad,)`` primary in order, each drawn when it is asked for (once: the
    rows come from the shared generator in leaf order)."""

    def __init__(self, shape: tuple[int, int], rows):
        self.shape = shape
        self._rows = rows

    def __iter__(self):
        return self._rows


def iter_primaries(layout: ResidentLayout, seed: int, device):
    """Yields (name, seeded padded primary at compute dtype), one leaf at a
    time in sorted leaf order: a ``(pad,)`` tensor, or for a stacked leaf a
    ``StackRows`` that draws its layer rows one at a time.

    The distributions of the reference's ``ZeroEngine._init_full``: zeros,
    ones, ``ssm_a`` (log(1..N) per row), ``dt_bias`` (softplus^-1 of a
    log-uniform draw in [1e-3, 1e-1]), or normal * (init_scale or
    1/sqrt(fan_in)), zero-padded. Drawn from one ``torch.Generator``; the
    numbers differ from ``jax.random`` and need not match them. A stack is
    drawn a row at a time (``_draw_rows``), so a consumer that drops each
    row once it is used (``build_resident``) keeps the peak near the
    residency plus one row's f32 draw and its compute-dtype copy (an MoE
    expert stack is 16 experts a row: whole, phi3.5's ``w_gate`` stack
    would be 53.7 GB in f32)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def padded(rows, n, pad):
        for values in rows:
            full = torch.zeros((pad,), dtype=layout.dtype, device=device)
            if values is not None:
                full[:n] = values
            del values
            yield full
            del full

    for name in sorted(layout.specs):
        spec = layout.specs[name]
        n, pad = spec.logical_size, layout.pad[name]
        rows = padded(_init_rows(spec, spec.stack or 1, n, gen, device), n,
                      pad)
        if spec.stack:
            yield name, StackRows((spec.stack, pad), rows)
        else:
            yield name, next(rows)


def init_primaries(layout: ResidentLayout, seed: int, device) -> dict:
    """All of ``iter_primaries`` as one dict {name: ``[stack,] pad``
    primary}."""
    return {name: torch.stack(list(p)) if isinstance(p, StackRows) else p
            for name, p in iter_primaries(layout, seed, device)}


def _wire_rows(layout: ResidentLayout, name: str, rows: StackRows) -> dict:
    """A stacked WIRE leaf's residency from its rows, quantized one at a
    time into the stack's (q, scales) buffers."""
    lcfg = layout.leaf_cfg[name]
    q = s = None
    for i, row in enumerate(rows):
        qf, sf = col.gather_issue_int8(row, layout.cfg.axes.weight, lcfg)
        del row
        qr, sr = col.residency_slice(qf, sf, layout.res_axes, lcfg)
        if q is None:
            q = qr.new_empty((rows.shape[0],) + tuple(qr.shape))
            s = sr.new_empty((rows.shape[0],) + tuple(sr.shape))
        q[i], s[i] = qr, sr
        del qf, sf, qr, sr
    return {"q": q, "s": s}


def build_resident(layout: ResidentLayout, primaries) -> dict:
    """Primaries -> this rank's residency: ``{"q", "s"}`` wire buffers for
    WIRE leaves (``[stack,] pad / res_degree`` int8 and ``[stack,] pad //
    block / res_degree`` f32), dense ``[stack,] *shape`` compute-dtype
    tensors for DENSE leaves.

    ``primaries`` is an iterable of (name, primary) pairs (``iter_primaries``
    or a dict's ``items()``), each this rank's shard over W (the whole
    padded leaf at degree 1); a pair's primary is dropped once it is
    built, a ``StackRows``' rows one at a time."""
    w = layout.cfg.size(layout.cfg.axes.weight)
    out = {}
    for name, prim in primaries:
        spec = layout.specs[name]
        lcfg = layout.leaf_cfg[name]
        want = ((spec.stack,) if spec.stack else ()) \
            + (layout.pad[name] // w,)
        if tuple(prim.shape) != want:
            raise ValueError(f"{name}: primary shape {tuple(prim.shape)}, "
                             f"expected {want}")
        if layout.mode(name) == WIRE:
            if isinstance(prim, StackRows):
                out[name] = _wire_rows(layout, name, prim)
                continue
            if spec.stack:
                qf, sf = col.gather_issue_int8_rows(prim, layout.cfg.axes.weight,
                                                    lcfg)
            else:
                qf, sf = col.gather_issue_int8(prim, layout.cfg.axes.weight, lcfg)
            q, s = col.residency_slice(qf, sf, layout.res_axes, lcfg)
            out[name] = {"q": q, "s": s}
        else:
            if isinstance(prim, StackRows):
                prim = torch.stack(list(prim))
            n = spec.logical_size
            full = col.all_gather_flat(prim, layout.cfg.axes.weight, lcfg)
            dense = full[..., :n].reshape(want[:-1] + spec.shape)
            out[name] = dense.to(linear._dtype(lcfg))
        del prim
    if set(out) != set(layout.specs):
        raise ValueError(f"primaries missing for "
                         f"{sorted(set(layout.specs) - set(out))}")
    return out


class ResidentView:
    """Parameter view over the residency, as the model code sees it.

    ``mm`` on a fusable WIRE leaf runs the fused dequant-matmul kernel on the
    (q, scales) buffer; a non-fusable WIRE leaf is dequantized and multiplied
    dense, and DENSE leaves multiply dense, as in the reference. ``sub(i)``
    binds layer ``i`` of the stacked leaves."""

    def __init__(self, layout: ResidentLayout, params: dict[str, Any],
                 layer: int | None = None):
        self._layout = layout
        self._p = params
        self._layer = layer

    @property
    def impl(self):
        return self._layout.cfg.impl

    def sub(self, layer: int) -> "ResidentView":
        return ResidentView(self._layout, self._p, layer)

    def _leaf(self, name: str):
        entry = self._p[name]
        if self._layout.specs[name].stack:
            if self._layer is None:
                raise ValueError(f"{name} is stacked: bind a layer with sub()")
            if isinstance(entry, dict):
                return {k: t[self._layer] for k, t in entry.items()}
            return entry[self._layer]
        return entry

    def _wire(self, name: str):
        entry = self._leaf(name)
        return col.gather_residency_q(entry["q"], entry["s"],
                                      self._layout.res_axes,
                                      self._layout.leaf_cfg[name])

    def mm(self, name: str, x, transpose: bool = False):
        spec = self._layout.specs[name]
        lcfg = self._layout.leaf_cfg[name]
        if self._layout.mode(name) == WIRE:
            qf, sf = self._wire(name)
            if linear._fusable(spec, lcfg):
                return linear._mm_apply_q(x, qf, sf, transpose, spec, lcfg)
            full = col.gather_wait_int8(qf, sf, lcfg, linear._dtype(lcfg))
            w = full[: spec.logical_size].reshape(spec.shape)
            return linear._mm_apply(x, w, transpose, lcfg)
        return linear._mm_apply(x, self._leaf(name), transpose, lcfg)

    def get(self, name: str):
        spec = self._layout.specs[name]
        lcfg = self._layout.leaf_cfg[name]
        if self._layout.mode(name) == WIRE:
            qf, sf = self._wire(name)
            full = col.gather_wait_int8(qf, sf, lcfg, linear._dtype(lcfg))
            return full[: spec.logical_size].reshape(spec.shape)
        return self._leaf(name)

    def expert_ffn(self, prefix: str, e_in):
        """The MoE expert GLU over the residency: each expert stack
        dequantized whole through ``get``, as the gathered backend reads it,
        so the two backends give the same bits."""
        return expert_glu(self.get, prefix, e_in)

    def embed_lookup(self, name: str, ids):
        """Token-embedding rows for ``ids``: dequantizes only those rows when
        each row is whole quant blocks (the reference dequantizes the whole
        table, then takes rows; the numbers are the same)."""
        spec = self._layout.specs[name]
        lcfg = self._layout.leaf_cfg[name]
        vocab, d = spec.shape
        block = lcfg.quant_block
        if self._layout.mode(name) != WIRE or d % block:
            return self.get(name)[ids]
        qf, sf = self._wire(name)
        flat_ids = ids.reshape(-1)
        rows = qf[: vocab * d].view(vocab, d)[flat_ids]
        srows = sf[: vocab * d // block].view(vocab, d // block)[flat_ids]
        out = col.gather_wait_int8(rows.reshape(-1), srows.reshape(-1), lcfg,
                                   linear._dtype(lcfg))
        return out.reshape(tuple(ids.shape) + (d,))


class ResidentServeEngine(MeshServe):
    """Prefill / decode / greedy generation over the INT8 residency, on one
    device (``mesh`` None) or on this rank of ``mesh``
    (``serve.engine.MeshServe``)."""

    def __init__(self, model, layout: ResidentLayout, shape: ShapeConfig,
                 mesh=None, sc: ServeConfig | None = None):
        super().__init__(model, mesh, shape, sc)
        self.layout = layout

    def _view(self, residency):
        return ResidentView(self.layout, residency)

    def abstract_params(self, device) -> dict:
        """``build_resident``'s shapes and dtypes, uninitialised, on
        ``device`` (the reference's ``abstract_params``,
        ``src/repro/serve/resident.py:256``; the dry run's on ``meta``)."""
        lay = self.layout
        out = {}
        for name in sorted(lay.specs):
            spec = lay.specs[name]
            rows = (spec.stack,) if spec.stack else ()
            if lay.mode(name) == WIRE:
                qlen, slen = lay.wire_lens(name)
                out[name] = {
                    "q": torch.empty(rows + (qlen,), dtype=torch.int8,
                                     device=device),
                    "s": torch.empty(rows + (slen,), dtype=torch.float32,
                                     device=device)}
            else:
                out[name] = torch.empty(
                    rows + spec.shape, dtype=linear._dtype(lay.leaf_cfg[name]),
                    device=device)
        return out
