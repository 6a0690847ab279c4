"""Trace mode's attribution of the phased step: the out-of-band probes and
the per-phase seconds of the metrics stream.

Port of ``repro.obs.phased``. The reference jits each segment of its step
apart, which changes XLA's fusions, so its traced step is only float-close
to the fused one. The port's step is eager: trace mode runs the engine's
own step, ``ZeroEngine.train_step(..., rec=)``, with each segment
(``obs.spans.SEGMENTS``) fenced, so a traced step is bit for bit the
untraced one: losses, grad norms, masters.

The in-loop collectives (the per-layer weight gathers, the stage-1 grad
reduce-scatter) run inside the forward and backward and are not fenced
apart. ``run_probes`` measures them out of band: serial re-executions of
each collective over the real stacked primaries (one a layer), reduced to
a scalar, each fenced on its own. Probe spans are attribution only, not
part of the wall-time sum. Their kernel launches and payload bytes are
kept in ``probe_counts`` beside the step's own counts.
"""
from __future__ import annotations

import collections
import contextlib
import math

import torch

from ..core import collectives as col
from ..core.engine import ParamView
from ..core.linear import _dtype
from ..core.partition import GATHER_Q, MATMUL
from ..kernels import ops
from .spans import PROBES, SpanRecorder, tracing


def _resize(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` flattened and repeated to length ``n`` (``jnp.resize``)."""
    flat = t.reshape(-1)
    return flat.repeat(math.ceil(n / flat.numel()))[:n]


def _checksum(tensors) -> torch.Tensor:
    return sum(t.float().sum() for t in tensors)


class PhasedStep:
    """The probes and phase attribution of trace mode for one engine and
    loss function (the step itself: ``ZeroEngine.train_step(..., rec=)``)."""

    def __init__(self, engine, loss_fn):
        self.eng = eng = engine
        self.loss_fn = loss_fn
        self.names = sorted(eng.specs)
        # stacked leaves with an issue half: the layer loop's gathers
        self.pf = [n for n in self.names
                   if eng.specs[n].stack and eng.fns[n].issue is not None]
        self.rs_leaves = [n for n in self.names
                          if eng.specs[n].stack
                          and eng.specs[n].kind in (MATMUL, GATHER_Q)]
        # kernel launches ("launches"), payload bytes ("payload") and update
        # gather launches ("update_gather") the probes made
        self.probe_counts = {k: collections.Counter()
                             for k in ("launches", "payload", "update_gather")}

    # -- probes ----------------------------------------------------------------

    @contextlib.contextmanager
    def _counted_apart(self):
        """Add what the probes launch and move to ``probe_counts``."""
        l0, p0 = ops.launches(), collections.Counter(col.PAYLOAD)
        u0 = collections.Counter(col.UPDATE_GATHER_LAUNCHES)
        yield
        c = self.probe_counts
        c["launches"].update({k: v - l0[k] for k, v in ops.launches().items()
                              if v > l0[k]})
        c["payload"].update(collections.Counter(col.PAYLOAD) - p0)
        c["update_gather"].update(
            collections.Counter(col.UPDATE_GATHER_LAUNCHES) - u0)

    def _eval(self, state, batch):
        """The global mean loss of a forward with no graph
        (``make_eval_step``)."""
        eng, cfg = self.eng, self.eng.cfg
        with torch.no_grad():
            view = ParamView(eng.fns, state["primaries"], cfg.impl,
                             overlap=cfg.overlap)
            loss_sum, tok = self.loss_fn(view, batch)
            t = col.det_psum(tok.float(), cfg.axes.all, cfg)
            loss = col.det_psum(loss_sum.float(), cfg.axes.all, cfg)
            return loss / torch.clamp(t, min=1.0)

    def _fwd_allgather(self, prim):
        """Each stacked leaf's per-layer gather issue, waited."""
        return sum((_checksum(self.eng.fns[n].issue(row).wait())
                    for n in self.pf for row in prim[n]), 0.0)

    def _bwd_allgather(self, prim):
        """The backward's re-gather: from the INT8 secondary partition
        (synthesised a layer from the primary row: values do not matter to
        the time), or the primary gather where there is no secondary."""
        eng = self.eng
        total = 0.0
        for n in self.rs_leaves:
            lcfg = eng.leaf_cfg[n]
            for row in prim[n]:
                if lcfg.axes.secondary is None:
                    total = total + _checksum(eng.fns[n].issue(row).wait())
                    continue
                pad, sdeg = eng._pad[n], lcfg.sec_degree
                base = row.float()
                sq = _resize(base, pad // sdeg).to(torch.int8)
                ss = _resize(base, pad // lcfg.quant_block // sdeg).abs() + 1
                total = total + _checksum(col.gather_secondary_q(
                    sq, ss, lcfg.axes.secondary, lcfg))
        return total

    def _grad_rs_w(self, prim):
        """Stage 1: the grad reduce-scatter over W, a layer, on a dense row
        synthesised from the primary row."""
        eng = self.eng
        total = 0.0
        for n in self.rs_leaves:
            lcfg = eng.leaf_cfg[n]
            for row in prim[n]:
                g = _resize(row.float(), eng._pad[n])
                total = total + col.reduce_scatter_flat(
                    g, lcfg.axes.weight, lcfg).sum()
        return total

    def _update_gather(self, master):
        """The real update all-gather of every leaf (results dropped)."""
        eng, cdt = self.eng, _dtype(self.eng.cfg)
        return sum((_checksum([col.update_all_gather(
            master[n], eng.leaf_cfg[n], cdt)]) for n in self.names), 0.0)

    def run_probes(self, state, batch, rec: SpanRecorder):
        """Out-of-band attribution: each collective family re-run serially
        and fenced on its own; one span a probe, NOT in the wall sum. The
        state is read, never changed."""
        prim = state["primaries"]
        with tracing(), torch.no_grad(), self._counted_apart():
            rec.fenced("fwd", self._eval, state, batch)
            if self.pf:
                rec.fenced("fwd_allgather", self._fwd_allgather, prim)
            if self.rs_leaves:
                rec.fenced("bwd_allgather", self._bwd_allgather, prim)
                rec.fenced("grad_rs_w", self._grad_rs_w, prim)
            rec.fenced("update_gather", self._update_gather, state["master"])

    def probe_inventory(self) -> dict:
        """What the probes run (structure, never time)."""
        eng = self.eng
        layers = {n: int(eng.specs[n].stack or 0) for n in self.rs_leaves}
        return dict(
            fwd_allgather=dict(leaves=list(self.pf),
                               layers=sum(layers.get(n, 0)
                                          for n in self.pf)),
            bwd_allgather=dict(
                leaves=list(self.rs_leaves),
                secondary=[n for n in self.rs_leaves
                           if eng.leaf_cfg[n].axes.secondary is not None]),
            grad_rs_w=dict(leaves=list(self.rs_leaves),
                           layers=sum(layers.values())),
            update_gather=dict(leaves=list(self.names)),
        )

    # -- measured phase attribution ----------------------------------------------

    def phase_seconds(self, rec: SpanRecorder, step: int,
                      probe: dict[str, float] | None = None) -> dict:
        """One step's fenced segments and the latest probes on the
        reference's phase names, plus ``compute``: the in-loop probes
        measure one microbatch's collectives and scale by the microbatches;
        ``compute`` is fwd_bwd less that in-loop estimate (floored at 0: on
        an overlapped schedule part of it is hidden inside the segment)."""
        seg = rec.step_seconds(step)
        probe = probe if probe is not None else self.last_probe(rec)
        n_mb = self.eng.hp.n_microbatch
        out = {}
        for ph in ("fwd_allgather", "bwd_allgather", "grad_rs_w"):
            out[ph] = n_mb * probe.get(ph, 0.0)
        out["grad_rs_e"] = seg.get("grad_rs_e", 0.0)
        out["cross_replica"] = seg.get("cross_replica", 0.0)
        # the update segment is AdamW + gather; the probe isolates the
        # gather's share when there is one, capped by the segment
        upd_seg = seg.get("update", 0.0)
        out["update_gather"] = min(probe["update_gather"], upd_seg) \
            if "update_gather" in probe else upd_seg
        in_loop = sum(out[ph] for ph in
                      ("fwd_allgather", "bwd_allgather", "grad_rs_w"))
        out["compute"] = max(seg.get("fwd_bwd", 0.0) - in_loop, 0.0)
        return out

    def last_probe(self, rec: SpanRecorder) -> dict[str, float]:
        """The latest measurement of each probe span, any step."""
        out: dict[str, float] = {}
        for s in rec.spans:
            if s.name in PROBES:
                out[s.name] = s.dur
        return out

    def overlap_efficiency(self, rec: SpanRecorder, step: int) -> float:
        """The share of measured communication time that lies in the
        overlappable in-loop region rather than the serial tail after the
        backward (measurement only)."""
        ph = self.phase_seconds(rec, step)
        hideable = (ph["fwd_allgather"] + ph["bwd_allgather"]
                    + ph["grad_rs_w"])
        exposed = ph["grad_rs_e"] + ph["cross_replica"] + ph["update_gather"]
        total = hideable + exposed
        return hideable / total if total > 0 else 0.0
