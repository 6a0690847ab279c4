"""ZeroEngine: the training step on one rank of a ``torch.distributed`` mesh.

Port of the train step of ``repro.core.engine`` (``init_state`` :501,
``make_train_step`` :602, ``_make_local_grads`` :645, ``_stage2_rs`` :541,
``_replica_sync`` :553, ``_clip_grads`` :719, ``_apply_updates`` :574,
``memory_report`` :440, ``stream_leaf_names`` :415,
``scheme_fingerprint`` :398, ``_zero_sinks`` :533,
``_grads_to_os`` :567), in both gradient regimes and with or without the
gather prefetch (``ZeroConfig.overlap``). The reference runs one program over the mesh
inside ``shard_map``; here every rank runs this code on its own shards and
the collectives meet over the mesh's process groups.

Storage: every leaf is flattened, padded to a multiple of
``os_degree * block`` and kept as this rank's 1-D primary shard (compute
dtype, sharded over the weight axes W); stacked leaves carry a leading layer
dimension. The fp32 master and Adam m / v live in optimizer-shard layout:
the same flat tensor sharded over all axes (W, then E, then R, major to
minor).

One step:

1. The loss and its backward (``ParamView``; core/linear.py): MATMUL leaves
   gather INT8 over W and reduce-scatter their weight grads INT4 over W
   inside the backward (stage 1), so each leaf's cotangent has primary-shard
   layout. Microbatch grads accumulate in f32.
2. Stage 2: the INT4 all-to-all reduce-scatter over E.
3. The cross-replica sync over R.
4. Grad-norm clipping (``det_psum``: the same sum on every process layout),
   AdamW on the master shard, in place: the step consumes its state, as the
   reference's step donates it.
5. The update all-gather over E + R rebuilds the primary shards.

With ``stream_grads`` the stacked MATMUL / GATHER_Q leaves run steps 2 and 3
inside each layer's backward and hand the fully reduced fp32 os-shard row
to a zero sink (core/linear.py), so their microbatch grads accumulate in
os layout (4 * psi / os_degree instead of 4 * psi / w_degree); the tied
embedding and the PLAIN leaves keep the path above. At one microbatch the
two regimes give the same bits. With ``overlap`` the layer loop prefetches
each layer's gathers during the previous layer (core/schedule.py).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..device import resolve
from ..models.moe import expert_glu
from ..obs.spans import tracing
from ..optim.adamw import adamw_update_, cosine_lr
from . import collectives as col
from . import schedule as sched
from .linear import PlainGather, ZeroGatherQ, ZeroMatmul, _dtype, gather_issue
from .partition import (GATHER_Q, MATMUL, PLAIN, LeafSpec, ZeroConfig,
                        grad_buffer_bytes, padded_flat_size,
                        prefetch_buffer_bytes)


@dataclass
class TrainHparams:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 10
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    n_microbatch: int = 1
    overlap: bool | None = None   # None: ZeroConfig.overlap; a bool overrides
    # the scheme config (the train CLI's --overlap)
    stream_grads: bool | None = None  # None: ZeroConfig.stream_grads; a bool
    # overrides the scheme config (the train CLI's --stream-grads)


@dataclass(frozen=True)
class _LeafFns:
    spec: LeafSpec
    mm: Callable | None        # (x, primary, sink, transpose, buf) -> y
    full: Callable             # (primary, sink, buf) -> dense tensor
    issue: Callable | None = None   # prefetch: primary -> GatherBuf


class ParamView:
    """What model code sees: named weights, materialized on demand.

    ``mm(name, x)`` runs the ZeRO matmul (gather forward, secondary
    re-gather backward, quantized grad reduce-scatter) without keeping the
    dense weight; ``get(name)`` materializes the dense tensor (norms, biases,
    the tied embedding). ``sub(i)`` binds layer ``i`` of the stacked leaves,
    whose primaries are held one row per layer.

    ``bufs`` (overlap; core/schedule.py ``loop_layers``): the bound layer's
    prefetched gathers, {name: GatherBuf}. Each is consumed once: the first
    ``mm`` / ``get`` of the leaf waits on it and takes it in place of the
    inline gather. The layer's recompute in the backward (one checkpoint
    per layer) finds it gone and gathers inline, so the step makes the same
    gathers with overlap on and off and no buffer lives past its layer.

    ``sinks`` (streaming): {name: [zero fp32 optimizer-shard row per layer]}
    for the stacked MATMUL / GATHER_Q leaves; the bound layer's row takes
    that leaf's fully reduced gradient.

    Serving (``serve.engine.ServeEngine``) builds one straight over the
    primaries under ``torch.no_grad``, with no buffers and no sinks: every
    ``mm`` and ``get`` then runs the training forward's inline gather and
    nothing keeps a graph."""

    def __init__(self, fns: dict[str, _LeafFns], leaves: dict, impl,
                 layer: int | None = None, *, bufs: dict | None = None,
                 sinks: dict | None = None, overlap: bool = False):
        self._fns = fns
        self._p = leaves
        self._impl = impl
        self._layer = layer
        self._bufs = bufs
        self._sinks = sinks
        self.overlap = overlap

    @property
    def impl(self):
        return self._impl

    @property
    def fns(self) -> dict[str, _LeafFns]:
        return self._fns

    def sub(self, layer: int, bufs: dict | None = None) -> "ParamView":
        return ParamView(self._fns, self._p, self._impl, layer, bufs=bufs,
                         sinks=self._sinks, overlap=self.overlap)

    def stacked_names(self, kind: str) -> list[str]:
        """The stacked leaves of one block kind, in name order."""
        return [n for n in sorted(self._fns)
                if n.startswith(kind + ".") and self._fns[n].spec.stack]

    def layer_primaries(self, names, layer: int) -> dict:
        return {n: self._p[n][layer] for n in names}

    def loop_layers(self, body, carry, steps):
        """The layer loop through the prefetch rotation (core/schedule.py):
        ``body(sub_view, carry, tag) -> carry`` over ``steps`` = [(tag,
        layer)]."""
        return sched.loop_layers(self, body, carry, steps)

    def _leaf(self, name: str):
        if self._fns[name].spec.stack:
            if self._layer is None:
                raise ValueError(f"{name} is stacked: bind a layer with sub()")
            return self._p[name][self._layer]
        return self._p[name]

    def _buf(self, name: str):
        """The bound layer's prefetched gather of ``name``, waited; None when
        there is none or it was consumed."""
        if not self._bufs or name not in self._bufs:
            return None
        return self._bufs.pop(name).wait()

    def _sink(self, name: str):
        if self._sinks is None or name not in self._sinks:
            return None
        return self._sinks[name][self._layer]

    def mm(self, name: str, x, transpose: bool = False):
        fn = self._fns[name]
        if fn.mm is None:
            raise ValueError(f"{name} is not a matmul leaf")
        return fn.mm(x, self._leaf(name), self._sink(name), transpose,
                     self._buf(name))

    def get(self, name: str):
        return self._fns[name].full(self._leaf(name), self._sink(name),
                                    self._buf(name))

    def embed_lookup(self, name: str, ids):
        return self.get(name)[ids]

    def expert_ffn(self, prefix: str, e_in):
        """The MoE expert GLU on dispatched slots (E, C, d): the expert
        stacks come whole through ``get`` (the GATHER_Q path: INT8 gather
        forward, INT4 reduce-scatter of their gradient backward); the
        products are library batched matmuls, as the reference's einsums
        run outside any kernel (``src/repro/core/engine.py:192``)."""
        return expert_glu(self.get, prefix, e_in)


class ZeroEngine:
    """Sharded state and the train step of one model under one scheme, on
    this rank of ``mesh``, on the card unless ``device="cpu"`` is asked for
    (``device.resolve``: no card raises)."""

    def __init__(self, specs: dict[str, LeafSpec], cfg: ZeroConfig, mesh,
                 hp: TrainHparams | None = None, device=None):
        self._setup(specs, cfg, mesh, hp,
                    resolve("cuda" if device is None else device))

    @classmethod
    def abstract(cls, specs: dict[str, LeafSpec], cfg: ZeroConfig, mesh,
                 hp: TrainHparams | None = None) -> "ZeroEngine":
        """The dry run's engine (``launch.dryrun``): its state and step on
        ``meta`` tensors, which carry shapes and dtypes and no storage
        (``abstract_state``); nothing is allocated and no kernel launches.
        No other entry point builds one."""
        eng = cls.__new__(cls)
        eng._setup(specs, cfg, mesh, hp, torch.device("meta"))
        return eng

    def _setup(self, specs, cfg, mesh, hp, device: torch.device) -> None:
        if hp is not None:
            over = {k: v for k, v in (("overlap", hp.overlap),
                                      ("stream_grads", hp.stream_grads))
                    if v is not None and v != getattr(cfg, k)}
            if over:
                cfg = dataclasses.replace(cfg, **over)
        cfg.validate_dependency_rule()
        for a, size in cfg.axis_sizes:
            if mesh.shape.get(a) != size:
                raise ValueError(f"axis {a}: config {size}, mesh {mesh.shape}")
        self.specs = dict(specs)
        self.cfg = cfg
        self.mesh = mesh
        self.hp = hp or TrainHparams()
        self.device = device
        self.leaf_cfg = {n: cfg.for_leaf(s.logical_size)
                         for n, s in self.specs.items()}
        self._pad = {n: padded_flat_size(s.logical_size, cfg)
                     for n, s in self.specs.items()}
        self.fns = {n: self._build_fns(s) for n, s in self.specs.items()}
        # host seconds per phase of the step, each ending in a device sync
        self.phase_s: collections.Counter = collections.Counter()
        if mesh.size > 1:
            from ..launch.mesh import config_axis_tuples
            mesh.bind(config_axis_tuples(cfg))
        col.bind(mesh)

    def _build_fns(self, spec: LeafSpec) -> _LeafFns:
        ls = dataclasses.replace(spec, stack=None)
        lcfg = self.leaf_cfg[spec.name]
        if spec.kind in (MATMUL, GATHER_Q):
            mm = None
            if spec.kind == MATMUL:
                def mm(x, p, sink, transpose, buf):
                    return ZeroMatmul.apply(x, p, sink, ls, lcfg, transpose,
                                            buf)
            return _LeafFns(spec, mm,
                            lambda p, sink, buf: ZeroGatherQ.apply(
                                p, sink, ls, lcfg, buf),
                            lambda p: gather_issue(p, lcfg))
        if spec.kind == PLAIN:
            return _LeafFns(spec, None,
                            lambda p, sink, buf: PlainGather.apply(p, ls, lcfg))
        raise ValueError(spec.kind)

    # -- shapes ---------------------------------------------------------------

    def primary_shard_len(self, name: str) -> int:
        return self._pad[name] // self.cfg.w_degree

    def os_shard_len(self, name: str) -> int:
        return self._pad[name] // self.cfg.os_degree

    def param_count(self) -> int:
        return sum(s.logical_size * (s.stack or 1) for s in self.specs.values())

    def padded_param_count(self) -> int:
        return sum(self._pad[n] * (s.stack or 1) for n, s in self.specs.items())

    def stream_leaf_names(self) -> tuple[str, ...]:
        """Leaves on the streaming grad path (stacked MATMUL / GATHER_Q):
        their grads are reduced inside each layer's backward and accumulate
        in fp32 optimizer-shard layout."""
        return tuple(n for n in sorted(self.specs)
                     if self.specs[n].stack
                     and self.specs[n].kind in (MATMUL, GATHER_Q))

    def _prefetch_slot_bytes(self) -> int:
        """One slot of the 2-slot prefetch buffer: the largest layer's
        gathered wire-format weights (INT8 payload + f32 scales when
        quantized, compute dtype otherwise) over its prefetchable leaves."""
        per_kind: dict[str, int] = {}
        bytes_per = torch.empty((), dtype=_dtype(self.cfg)).element_size()
        for n, s in self.specs.items():
            if not s.stack or self.fns[n].issue is None:
                continue
            kind = n.split(".", 1)[0]
            pad, lcfg = self._pad[n], self.leaf_cfg[n]
            b = pad + 4 * pad // lcfg.quant_block \
                if lcfg.quantize_weights else bytes_per * pad
            per_kind[kind] = per_kind.get(kind, 0) + b
        return max(per_kind.values(), default=0)

    def memory_report(self) -> dict[str, int]:
        """Per-rank training-state bytes by the reference's formulas:
        ``grad_buffer`` counts streamed leaves at fp32 os-shard layout and
        the rest at fp32 primary layout; ``prefetch_buffer`` is the 2-slot
        gathered-weight buffer of the overlap (0 when it is off)."""
        cfg = self.cfg
        psi = self.padded_param_count()
        bytes_per = torch.empty((), dtype=_dtype(cfg)).element_size()
        primary = bytes_per * psi // cfg.w_degree
        sec = 0 if cfg.sec_degree is None else \
            psi // cfg.sec_degree + 4 * psi // (cfg.quant_block * cfg.sec_degree)
        stream = set(self.stream_leaf_names()) if cfg.stream_grads else set()
        grads = sum(grad_buffer_bytes(cfg, self._pad[n] * (s.stack or 1),
                                      streaming=n in stream)
                    for n, s in self.specs.items())
        optimizer = 12 * psi // cfg.os_degree
        prefetch = prefetch_buffer_bytes(cfg, self._prefetch_slot_bytes())
        return dict(primary=primary, secondary=sec, grad_buffer=grads,
                    optimizer=optimizer, prefetch_buffer=prefetch,
                    total=primary + sec + grads + optimizer + prefetch)

    # -- state ------------------------------------------------------------------

    def shard_cols(self, name: str, key: str) -> tuple[int, int]:
        """The columns [lo, hi) of the global ``[stack,] pad`` leaf ``name``
        that this rank holds in the state dict ``key``: its W shard for
        "primaries", its optimizer shard (over all axes) for "master",
        "opt_m" and "opt_v"."""
        if key == "primaries":
            i = self.mesh.index(self.cfg.axes.weight)
            n = self.primary_shard_len(name)
        else:
            i, n = self.mesh.index(self.cfg.axes.all), self.os_shard_len(name)
        return i * n, (i + 1) * n

    def shard_primary(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's W shard of a global ``[stack,] pad`` tensor."""
        lo, hi = self.shard_cols(name, "primaries")
        return full[..., lo:hi].to(self.device).clone()

    def shard_os(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's optimizer shard (over all axes) of a global tensor."""
        lo, hi = self.shard_cols(name, "master")
        return full[..., lo:hi].to(self.device).clone()

    def scheme_fingerprint(self) -> dict:
        """Layout identity of this engine's checkpoints (JSON-serializable):
        the config's ``fingerprint`` and every leaf's padded length. A
        checkpoint written under one fingerprint restores under another only
        by resharding (train/checkpoint.py)."""
        fp = self.cfg.fingerprint()
        fp["padded_sizes"] = {n: self._pad[n] for n in sorted(self._pad)}
        return fp

    def shard_state(self, full: dict[str, torch.Tensor]):
        """This rank's fresh state from global padded fp32 masters
        ``[stack,] pad``: the primaries are the master at compute dtype, m
        and v are zero (the reference's ``init_state``)."""
        cdt = _dtype(self.cfg)
        state = dict(primaries={}, master={}, opt_m={}, opt_v={}, step=0)
        for n in sorted(full):
            f = full[n].float()
            state["primaries"][n] = self.shard_primary(n, f.to(cdt))
            m = self.shard_os(n, f)
            state["master"][n] = m
            state["opt_m"][n] = torch.zeros_like(m)
            state["opt_v"][n] = torch.zeros_like(m)
        return state

    def _init_leaves(self, seed: int, dtype):
        """Yields (name, global padded ``[stack,] pad`` leaf at ``dtype``) of
        the seeded init, one leaf at a time in sorted leaf order: the
        reference's distributions (zeros, ones, or normal * (init_scale or
        1/sqrt(fan_in)), zero-padded), drawn from one ``torch.Generator`` on
        the engine's device, so every rank draws the same global tensors.
        The draw is rounded to ``dtype`` once, whatever ``dtype`` is."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for n in sorted(self.specs):
            spec = self.specs[n]
            rows, size = spec.stack or 1, spec.logical_size
            f = torch.zeros((rows, self._pad[n]), dtype=dtype,
                            device=self.device)
            if spec.init == "ones":
                f[:, :size] = 1.0
            elif spec.init != "zeros":
                scale = spec.init_scale
                if scale is None:
                    fan_in = spec.shape[0] if len(spec.shape) >= 2 else size
                    scale = 1.0 / math.sqrt(max(fan_in, 1))
                draw = torch.randn((rows, size), generator=gen,
                                   device=self.device)
                f[:, :size] = draw.mul_(scale)
                del draw
            yield n, (f if spec.stack else f[0])
            del f

    def _abstract_leaf(self, name: str, key: str, dtype) -> torch.Tensor:
        spec = self.specs[name]
        n = self.primary_shard_len(name) if key == "primaries" \
            else self.os_shard_len(name)
        return torch.empty(((spec.stack,) if spec.stack else ()) + (n,),
                           dtype=dtype, device=self.device)

    def abstract_state(self):
        """``init_state``'s shapes and dtypes on the engine's device with
        nothing drawn (the reference's ``abstract_state``,
        ``src/repro/core/engine.py:379``, this rank's shards): on ``meta``
        (``ZeroEngine.abstract``) no storage either."""
        state = dict(step=0, primaries=self.abstract_primaries())
        for k in ("master", "opt_m", "opt_v"):
            state[k] = {n: self._abstract_leaf(n, k, torch.float32)
                        for n in sorted(self.specs)}
        return state

    def abstract_primaries(self) -> dict:
        """``init_primaries``' shapes and dtypes, nothing drawn (the
        reference's ``abstract_primaries``, :790)."""
        return {n: self._abstract_leaf(n, "primaries", _dtype(self.cfg))
                for n in sorted(self.specs)}

    def init_state(self, seed: int = 0):
        """Seeded init (``_init_leaves``): this rank's shards of the global
        tensors. The numbers differ from ``jax.random``'s."""
        state = dict(primaries={}, master={}, opt_m={}, opt_v={}, step=0)
        for n, f in self._init_leaves(seed, torch.float32):
            one = self.shard_state({n: f})
            for k in ("primaries", "master", "opt_m", "opt_v"):
                state[k].update(one[k])
        return state

    def init_primaries(self, seed: int = 0) -> dict:
        """``init_state(seed)["primaries"]`` bit for bit, with no master and
        no optimizer state (serving): each leaf drawn at compute dtype, so
        the peak is the primaries, one leaf's f32 draw and its copy."""
        return {n: self.shard_primary(n, f)
                for n, f in self._init_leaves(seed, _dtype(self.cfg))}

    # -- the train step -------------------------------------------------------

    def _leaves(self, primaries, frozen=()):
        """Autograd leaves over the primaries: one per layer row of a stacked
        leaf, so each row's cotangent lands in its own ``.grad``. The
        ``frozen`` leaves (streamed: their grads leave through sinks) are
        rows that take no grad."""
        out = {}
        for n, p in primaries.items():
            want = n not in frozen
            if self.specs[n].stack:
                out[n] = [p[i].detach().requires_grad_(want)
                          for i in range(p.shape[0])]
            else:
                out[n] = p.detach().requires_grad_(want)
        return out

    def _zero_sinks(self, names) -> dict[str, list[torch.Tensor]]:
        """fp32 optimizer-shard gradient sinks, one zero row per layer of each
        streamed leaf: their grads are the os-layout accumulation. Each row
        is one zero expanded to the row's length, so the sinks take no
        memory of their own (their grads do)."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return {n: [zero.expand(self.os_shard_len(n)).requires_grad_()
                    for _ in range(self.specs[n].stack)]
                for n in names}

    @staticmethod
    def _grad(leaf) -> torch.Tensor:
        """A leaf's f32 grad (a stacked leaf's rows into one tensor); each
        row's own ``.grad`` is dropped as it is taken, so the compute-dtype
        grads and their f32 form are not all alive at once."""
        def one(t):
            g = torch.zeros_like(t, dtype=torch.float32) if t.grad is None \
                else t.grad.float()
            t.grad = None
            return g
        if isinstance(leaf, list):
            out = torch.empty((len(leaf),) + tuple(leaf[0].shape),
                              dtype=torch.float32, device=leaf[0].device)
            for i, t in enumerate(leaf):
                out[i] = one(t)
            return out
        return one(leaf)

    def local_grads(self, loss_fn: Callable, primaries, batch):
        """The microbatch loop: ``loss_fn(view, batch) -> (loss_sum, tokens)``.
        Returns (f32 grads, global mean loss, global tokens). Each microbatch
        loss is normalized by its global token count. The grads are in
        primary layout, except that with ``stream_grads`` the streamed leaves'
        (``stream_leaf_names``) arrive fully reduced, in os-shard layout,
        from their sinks."""
        n_mb = self.hp.n_microbatch
        cfg = self.cfg
        axes = cfg.axes.all
        stream = self.stream_leaf_names() if cfg.stream_grads else ()
        gacc = None
        loss = gtok = 0.0
        for j in range(n_mb):
            mb = {k: v.chunk(n_mb)[j] for k, v in batch.items()}
            leaves = self._leaves(primaries, frozen=stream)
            sinks = self._zero_sinks(stream)
            view = ParamView(self.fns, leaves, cfg.impl, sinks=sinks,
                             overlap=cfg.overlap)
            loss_sum, tok = loss_fn(view, mb)
            # token counts are integers in f32: exact in any order
            t = col.det_psum(tok.float(), axes, cfg)
            l_mb = loss_sum.float() / torch.clamp(t, min=1.0)
            l_mb.backward()
            g = {n: self._grad(sinks[n] if n in sinks else leaves[n])
                 for n in sorted(self.specs)}
            gacc = g if gacc is None else {n: gacc[n] + g[n] for n in g}
            loss = loss + l_mb.detach()
            gtok = gtok + t
        if n_mb > 1:
            gacc = {n: g / n_mb for n, g in gacc.items()}
            loss = loss / n_mb
        return gacc, col.det_psum(loss, axes, cfg), gtok

    def _stage2_rs(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """Reduce-scatter a primary-layout grad over E (INT4 a2a). Each row
        of a stacked leaf is scattered on its own; chunk j of every row goes
        to member j in one exchange."""
        lcfg = self.leaf_cfg[name]
        axes = lcfg.axes.extra_grad
        d = lcfg.size(axes)
        g = g.float()
        if d == 1:
            return g
        rows = g.reshape(-1, g.shape[-1])
        x = rows.reshape(rows.shape[0], d, -1).transpose(0, 1).reshape(-1)
        out = col.reduce_scatter_flat(x, axes, lcfg)
        return out.reshape(g.shape[:-1] + (-1,))

    def _replica_sync(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """Stage 3: the cross-replica sync of a stage-2 shard (each row of a
        stacked leaf keeps its own 1/R slice)."""
        return col.cross_replica_grad(g, self.leaf_cfg[name])

    def _clip_grads(self, os_grads: dict):
        """Scales the optimizer-shard grads in place; returns the global
        grad norm."""
        sq = sum(g.square().sum() for g in os_grads.values())
        gnorm = torch.sqrt(col.det_psum(sq, self.cfg.axes.all, self.cfg))
        scale = torch.clamp(self.hp.grad_clip / (gnorm + 1e-6), max=1.0)
        for g in os_grads.values():
            g.mul_(scale)
        return gnorm

    def _lr(self, step: int):
        hp = self.hp
        return cosine_lr(step, base_lr=hp.lr, warmup_steps=hp.warmup_steps,
                         total_steps=hp.total_steps, min_frac=hp.min_lr_frac,
                         device=self.device)

    def _apply_updates(self, state, os_grads: dict):
        """AdamW on each leaf's master, m and v in place, then its primary
        replaced by the update all-gather's result before the next leaf, so
        no second copy of the state or of the primaries is ever alive. Each
        leaf's grad is dropped from ``os_grads`` once it is used."""
        hp = self.hp
        step = state["step"] + 1
        lr = self._lr(state["step"])
        b1, b2 = hp.betas
        cdt = _dtype(self.cfg)
        for n in sorted(self.specs):
            wd = hp.weight_decay \
                if self.specs[n].kind in (MATMUL, GATHER_Q) else 0.0
            master, _, _ = adamw_update_(
                state["master"][n], state["opt_m"][n], state["opt_v"][n],
                os_grads.pop(n), step=step, lr=lr, beta1=b1, beta2=b2,
                eps=hp.eps, weight_decay=wd)
            state["primaries"][n] = None      # freed before the gather
            state["primaries"][n] = col.update_all_gather(
                master, self.leaf_cfg[n], cdt)
        state["step"] = step
        return state, lr

    def _phase(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.phase_s[name] += t1 - t0
        return t1

    def train_step(self, loss_fn: Callable, state, batch, rec=None):
        """One step; returns (state, metrics) with the metrics global over
        the mesh: loss, grad_norm, lr, tokens (f32 scalars).

        The step consumes ``state``, as the reference's step donates its
        state (``jax.jit(..., donate_argnums=(0,))``,
        ``src/repro/core/engine.py:643``): the returned state is the same
        dict, its ``master`` / ``opt_m`` / ``opt_v`` tensors updated in
        place and its primaries replaced, so a caller that still needs the
        state before the step keeps a copy of its own. Adds the host time of
        its phases to ``phase_s``: "grads" (forward, backward and stage 1),
        "stage2" (+ the replica sync), "update" (clip, AdamW, update
        all-gather).

        ``rec`` (an ``obs.spans.SpanRecorder``: trace mode) runs each piece
        under ``rec.fenced`` in the reference's segments
        (``obs.spans.SEGMENTS``), one span each: fwd_bwd, grad_rs_e,
        cross_replica, gnorm_clip, update. A fence waits for the card and
        changes nothing the step computes, so a traced step is bit for bit
        the untraced one (the reference jits its segments apart and is only
        float-close)."""
        fence = _unfenced if rec is None else rec.fenced
        with contextlib.nullcontext() if rec is None else tracing():
            t = time.perf_counter()
            grads, loss, gtok = fence("fwd_bwd", self.local_grads, loss_fn,
                                      state["primaries"], batch)
            t = self._phase("grads", t)
            streamed = self.stream_leaf_names() if self.cfg.stream_grads \
                else ()
            # primary-layout grads; streamed leaves arrive from the backward
            # already reduced to the optimizer shard. Stage 2 of each, then
            # the replica sync of each, each grad freed as it is taken
            seeded = [n for n in sorted(self.specs) if n not in streamed]
            g2 = fence("grad_rs_e", lambda: {
                n: self._stage2_rs(n, grads.pop(n)) for n in seeded})
            g3 = fence("cross_replica", lambda: {
                n: self._replica_sync(n, g2.pop(n)) for n in seeded})
            t = self._phase("stage2", t)
            # sorted leaf order: the grad norm's sum depends on it
            os_grads = {n: g3.pop(n) if n in g3 else grads.pop(n)
                        for n in sorted(self.specs)}
            gnorm = fence("gnorm_clip", self._clip_grads, os_grads)
            state, lr = fence("update", self._apply_updates, state, os_grads)
            self._phase("update", t)
        return state, dict(loss=loss, grad_norm=gnorm, lr=lr, tokens=gtok)


def _unfenced(name: str, fn: Callable, *args):
    """``SpanRecorder.fenced``'s call without the span (an untraced step)."""
    return fn(*args)
