"""Analytic cost model: seconds and bytes for any ``ZeroConfig`` on any
``Topology``.

Port of ``repro.topo.cost``. Every formula keeps the reference's
operations in the reference's order, so both packages give equal floats
(not merely close ones) and the planner ranks ties alike. The phase names
are those ``obs.phased.PhasedStep.phase_seconds`` measures under, which is
what ``obs.calibrate`` compares and inverts.

The model prices exactly the collective inventory ``core/collectives.py``
emits per train step (DESIGN.md §4):

  per microbatch (inside the layer loop / backward):
    fwd_allgather  — weight all-gather of the primary shard over the W axes,
                     INT8 when ``quantize_weights`` (collectives.quant_all_
                     gather_int8 / gather_issue_int8);
    bwd_allgather  — backward re-materialization: all-gather of the INT8
                     secondary partition over the secondary axes when one
                     exists (collectives.gather_secondary), else the primary
                     gather again;
    grad_rs_w      — stage-1 weight-grad reduce-scatter over the W axes,
                     inside every backward pass (linear._grad_to_primary_
                     shard), INT4 all-to-all based when ``quantize_grads``
                     (collectives.a2a_quant_reduce_scatter);
  per step (after microbatch accumulation; seed regime):
    grad_rs_e      — stage-2 reduce-scatter of the accumulated primary-layout
                     grads over the E axes (engine ``_to_os``; once per step,
                     strictly less communication than per-microbatch);
    cross_replica  — replica-tier gradient sync (allreduce+select, or the
                     beyond-paper reduce_scatter at half volume);
    update_gather  — the update all-gather over E+R rebuilding bf16 primaries
                     (collectives.update_all_gather), INT8-halved when
                     ``quantize_update_gather``.

With ``Workload.stream_grads`` (the streaming grad path, DESIGN.md §8),
``grad_rs_e`` and ``cross_replica`` move into the backward layer loop:
per-microbatch cadence (volume x n_microbatch, latency per layer) but
*overlappable* with the backward matmuls, so only the update gather stays
in the exposed post-backward section (``StepCost.exposed_s``), and grad
memory is charged at os-shard layout (``partition.grad_buffer_bytes``).

In the seed regime the two grad-RS stages telescope: ``grad_rs_w +
grad_rs_e = g_bytes * (dg-1)/dg``, exactly the single-stage Table VIII
figure, so byte counts stay comparable with the repo's ``benchmarks/comm_volume.py``
while the *timing* charges each stage at its own tier and cadence (the
streaming regime trades n_microbatch x the stage-2 bytes for the overlap
and the memory drop).

Each phase costs ``volume / bottleneck_bandwidth + hops * per_hop_latency``
where the bottleneck link is the slowest axis the collective spans and
``hops = group_size - 1`` (ring schedule).  Per-microbatch phases pay the
latency term once per layer — the paper's central argument: ZeRO-topo pins
those group sizes (2 / 8) so the latency term is constant in cluster size,
while ZeRO-3/ZeRO++ groups grow with scale.

Volumes are the paper's Tables VII/VIII accounting, generalized to any
``ZeroAxes`` assignment; ``benchmarks/comm_volume.py`` cross-checks the
three preset columns against its own independently-written formulas
(tests/test_topo.py; tests/test_torch_topo.py holds this module to the
reference's).  Memory reuses the Table V/VI formulas from
``core/partition.py`` — one source of truth for both planner and benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.partition import (ZeroConfig, grad_buffer_bytes,
                              grad_memory_bytes, optimizer_memory_bytes,
                              weight_memory_bytes)
from .model import Topology

PER_MICROBATCH = ("fwd_allgather", "bwd_allgather", "grad_rs_w")
PER_STEP = ("grad_rs_e", "cross_replica", "update_gather")
PHASES = PER_MICROBATCH + PER_STEP
# phases the streaming grad path (DESIGN.md §8) moves into the backward
# layer loop: per-microbatch cadence, overlappable with the backward matmuls
STREAMED = ("grad_rs_e", "cross_replica")


@dataclass(frozen=True)
class Workload:
    """What one train step does, per device."""
    psi: float                        # total model parameters
    n_layers: int = 44                # layer-loop trip count (latency term)
    tokens_per_device_mb: int = 2048  # tokens per device per microbatch
    n_microbatch: int = 4             # gradient-accumulation factor
    hidden_fraction: float = 0.6      # fraction of comm hidden under compute
    # (DeepSpeed-style prefetch; matches the repo's overlap schedule §3)
    fused_kernels: bool = True        # dequant fused into the consumer
    # (kernels/dequant_matmul.py + the a2a dequant-reduce). False prices the
    # unfused pipeline: every gathered weight is dequantized to bf16 in HBM
    # and re-read by the matmul, and the a2a-received grad chunks round-trip
    # once more before the reduction (step_cost's kernel_s term).
    stream_grads: bool = False        # streaming grad regime (DESIGN.md §8):
    # stage-2 RS + cross-replica run per layer per microbatch inside the
    # backward (volume x n_microbatch, but overlappable) instead of once per
    # step fully exposed, and grad memory is charged at os-shard layout —
    # which is what lets the planner's memory-budget search admit schemes it
    # previously rejected.


def phase_volumes(cfg: ZeroConfig, psi: float) -> dict[str, float]:
    """Bytes per device per step for each collective phase (Tables VII/VIII).

    All-gather over degree d moves ``shard_bytes * (d-1)`` per device;
    reduce-scatter moves ``full_bytes * (d-1)/d``; ring allreduce twice that.
    """
    dw = cfg.w_degree
    ds = cfg.sec_degree or dw
    dg = cfg.g_degree
    dos = cfg.os_degree
    dr = cfg.size(cfg.axes.replica)
    # forward all-gather of the primary: INT8 (1 B/param) when quantized
    w_bytes = psi / dw * (1 if cfg.quantize_weights else 2)
    fwd = w_bytes * (dw - 1)
    # backward re-gather: INT8 secondary over its own group, else primary again
    if cfg.axes.secondary is not None:
        bwd = psi / ds * (ds - 1)
    else:
        bwd = fwd
    # gradient reduce-scatter, two stages: INT4 (0.5 B/param) when quantized,
    # bf16 otherwise. Stage 1 (per backward pass): full dense grad -> primary
    # shard over W. Stage 2 (per step): primary-layout shard -> grad shard
    # over E. Their sum equals the single-stage figure over dg.
    gb = 0.5 if cfg.quantize_grads else 2
    de = cfg.size(cfg.axes.extra_grad)
    grs_w = psi * gb * (dw - 1) / dw
    grs_e = (psi / dw) * gb * (de - 1) / de if de > 1 else 0.0
    # cross-replica sync of the grad shards (bf16-accounted, paper §V-C):
    # ring allreduce = 2x the reduce-scatter volume
    if dr > 1:
        ar = 2 if cfg.cross_replica == "allreduce" else 1
        crs = ar * (2 * psi / dg) * (dr - 1) / dr
    else:
        crs = 0.0
    # update all-gather over E+R (bf16 primaries; INT8 halves it)
    upd = (2 * psi / dw) * (1 - dw / dos) \
        * (0.5 if cfg.quantize_update_gather else 1)
    return dict(fwd_allgather=fwd, bwd_allgather=bwd,
                grad_rs_w=grs_w, grad_rs_e=grs_e,
                cross_replica=crs, update_gather=upd,
                total=fwd + bwd + grs_w + grs_e + crs + upd)


def phase_axes(cfg: ZeroConfig) -> dict[str, tuple[str, ...]]:
    """Which mesh axes each phase's collective spans (collectives.py)."""
    return dict(
        fwd_allgather=cfg.axes.weight,
        bwd_allgather=cfg.axes.secondary if cfg.axes.secondary is not None
        else cfg.axes.weight,
        grad_rs_w=cfg.axes.weight,
        grad_rs_e=cfg.axes.extra_grad,
        cross_replica=cfg.axes.replica,
        update_gather=cfg.axes.extra_grad + cfg.axes.replica,
    )


@dataclass(frozen=True)
class StepCost:
    """Predicted cost of one train step for (cfg, topo, workload)."""
    comm_s: dict[str, float]          # seconds per phase, per step
    volumes: dict[str, float]         # bytes per device per step, per phase
    compute_s: float
    memory: dict[str, float]          # per-device state bytes (Tables V/VI)
    fits: bool                        # memory_total <= budget
    kernel_s: float = 0.0             # unfused quant/dequant HBM round-trips
    # (zero when Workload.fused_kernels: the dequant rides the matmul's
    # on-chip pipeline and never touches HBM)
    exposed_s: float = 0.0            # comm seconds that CANNOT hide under
    # compute: the serial post-backward section (stage-2 RS, cross-replica,
    # update gather run after the last backward matmul). The streaming grad
    # regime moves the grad phases into the backward layer loop, leaving
    # only the update gather exposed — exposed-comm pricing (DESIGN.md §8).

    @property
    def comm_total_s(self) -> float:
        return sum(self.comm_s.values())

    @property
    def memory_total(self) -> float:
        return self.memory["total"]

    def step_s(self, hidden_fraction: float = 0.6) -> float:
        """Wall-clock: overlappable comm partially hides under compute;
        exposed comm (the serial post-backward phases) adds on top."""
        c = self.compute_s + self.kernel_s
        m = self.comm_total_s - self.exposed_s
        return max(c, m) + (1 - hidden_fraction) * min(c, m) + self.exposed_s


def memory_bytes(cfg: ZeroConfig, psi: float, *,
                 streaming: bool | None = None) -> dict[str, float]:
    """Per-device training-state bytes.

    Weights/optimizer follow the paper Table V/VI formulas; grads are
    charged at the buffer the engine *actually allocates*
    (``partition.grad_buffer_bytes``): fp32 primary layout on the seed
    path, fp32 os-shard layout when streaming — the memory-budget lever of
    the streaming grad regime. ``grads_table`` keeps the paper's Table VI
    grad-shard figure for reference."""
    weights = weight_memory_bytes(cfg, int(psi))
    grads = grad_buffer_bytes(cfg, int(psi), streaming=streaming)
    opt = optimizer_memory_bytes(cfg, int(psi))
    return dict(weights=weights, grads=grads,
                grads_table=grad_memory_bytes(cfg, int(psi)),
                optimizer=opt, total=weights + grads + opt)


def phase_breakdown(cfg: ZeroConfig, topo: Topology,
                    wl: Workload) -> dict[str, dict]:
    """Per-phase prediction record: the seconds ``step_cost`` charges plus
    everything needed to *invert* the model from a measurement
    (obs.calibrate): total wire bytes at the phase's cadence, the spanned
    axes and bottleneck axis, and the latency share. For each phase::

        seconds = wire_bytes / bandwidth(axes) + latency_s

    with per-microbatch phases paying the ring latency once per layer per
    microbatch (the paper's central group-size argument) and wire bytes
    multiplied by the cadence.
    """
    vols = phase_volumes(cfg, wl.psi)
    axes = phase_axes(cfg)
    # streaming regime: the stage-2 RS and cross-replica sync run per layer
    # per microbatch inside the backward (overlappable); otherwise they are
    # once-per-step and fully exposed, like the update gather
    in_loop = set(PER_MICROBATCH) | (set(STREAMED) if wl.stream_grads
                                     else set())
    out = {}
    for phase in PHASES:
        ax = axes[phase]
        group = cfg.size(ax)
        rec = dict(axes=list(ax or ()), group=group,
                   in_loop=phase in in_loop, seconds=0.0, wire_bytes=0.0,
                   latency_s=0.0, bottleneck=None)
        if ax and group > 1:
            wire = vols[phase] / topo.bandwidth(ax)
            hops = (group - 1) * topo.latency(ax)
            if phase in in_loop:
                # inside the layer loop: one collective per layer per mb
                rec["seconds"] = wl.n_microbatch * (wire + wl.n_layers * hops)
                rec["wire_bytes"] = wl.n_microbatch * vols[phase]
                rec["latency_s"] = wl.n_microbatch * wl.n_layers * hops
            else:
                rec["seconds"] = wire + hops
                rec["wire_bytes"] = vols[phase]
                rec["latency_s"] = hops
            rec["bottleneck"] = min(ax, key=lambda a: topo.link(a).bandwidth)
        out[phase] = rec
    return out


def step_cost(cfg: ZeroConfig, topo: Topology, wl: Workload,
              memory_budget: float | None = None) -> StepCost:
    """Price one train step of ``wl`` under ``cfg`` on ``topo``."""
    vols = phase_volumes(cfg, wl.psi)
    phases = phase_breakdown(cfg, topo, wl)
    comm = {phase: phases[phase]["seconds"] for phase in PHASES}
    exposed_s = sum(comm[ph] for ph in PER_STEP if not phases[ph]["in_loop"])
    tokens_per_device = wl.n_microbatch * wl.tokens_per_device_mb
    compute_s = 6.0 * wl.psi * tokens_per_device / topo.flops_per_device
    kernel_s = 0.0
    if not wl.fused_kernels:
        # unfused quant path: every INT8 weight gather is dequantized to a
        # bf16 copy in HBM (write 2B/param) that the matmul re-reads
        # (another 2B/param), forward and backward, per microbatch; the a2a
        # grad RS likewise materializes the received chunks in f32 before
        # reducing. Fusion (kernels/dequant_matmul.py, *_sum kernels)
        # deletes all of it — HBM only ever sees the 1B/param wire format.
        kb = 0.0
        if cfg.quantize_weights:
            kb += wl.n_microbatch * 2 * 4.0 * wl.psi        # fwd + bwd dequant
        if cfg.quantize_grads:
            kb += wl.n_microbatch * 2 * 4.0 * wl.psi / cfg.w_degree
            # producing side: without the matmul_quant epilogue the dense
            # f32 dW is written to HBM (4B/param) and re-read by the
            # quantize kernel (4B/param) before the wire format exists;
            # the fused epilogue (kernels/ops.matmul_quant) emits the
            # INT-wire directly from the accumulator, per microbatch
            kb += wl.n_microbatch * 2 * 4.0 * wl.psi
        kernel_s = kb / topo.hbm_bw
    mem = memory_bytes(cfg, wl.psi, streaming=wl.stream_grads
                       or cfg.stream_grads)
    budget = topo.hbm_bytes if memory_budget is None else memory_budget
    return StepCost(comm_s=comm, volumes=vols, compute_s=compute_s,
                    memory=mem, fits=mem["total"] <= budget,
                    kernel_s=kernel_s, exposed_s=exposed_s)


def tflops_per_device(cfg: ZeroConfig, topo: Topology, wl: Workload) -> float:
    """Modeled sustained TFLOP/s per device (the paper's Figs 7/8 metric)."""
    c = step_cost(cfg, topo, wl)
    tokens_per_device = wl.n_microbatch * wl.tokens_per_device_mb
    return 6.0 * wl.psi * tokens_per_device / c.step_s(wl.hidden_fraction) / 1e12


# ---------------------------------------------------------------------------
# serving cost model (DESIGN.md §12)
#
# One continuous-batching decode step prices three traffic classes:
#
#   res_gather — per-token re-materialization of the weights from the
#                residency partition: the INT8 wire shards (1 + 4/Q B/param)
#                all-gathered over the residency axes per layer
#                (collectives.gather_residency_q -> the fused dequant matmul),
#                or the fp-materialized gather (compute-dtype B/param) for the
#                seed "gathered" backend;
#   act_psum   — per-layer activation allreduce of each slot's single-token
#                row over the residency/model axes (collectives.
#                activation_psum in the decode shard_map);
#   kv_pages   — HBM traffic of the paged pool: the page-table gather reads
#                every live context position once per step and the writeback
#                scatters one new position per active slot (serve/paged.py).
#
# Weights are read from HBM once per step regardless of batch, so arithmetic
# intensity (2*psi*slots flops over weight+KV bytes) grows with the live
# batch — the knob the SLO admission controls. Residency memory reuses the
# partition.resident_memory_bytes accounting: wire bytes shrink with the
# residency degree while res_gather traffic grows with it — the serving
# analog of the training weight-axes trade the planner already ranks.

SERVE_PHASES = ("res_gather", "act_psum")


@dataclass(frozen=True)
class ServeWorkload:
    """What one continuous-batching decode step does, per device."""
    psi: float                         # total model parameters
    n_layers: int = 44                 # decode layer-loop trip count
    d_model: int = 6144                # activation width (act_psum volume)
    n_slots: int = 8                   # live decode rows (the batch)
    context: int = 1024                # mean live context per slot, tokens
    max_len: int = 2048                # pool provisioning length per slot
    kv_bytes_per_token: float = 0.0    # all-layer KV bytes per token;
    # 0 estimates a GQA-quarter-width cache (serve_workload_for_model fills
    # the exact figure from model.cache_shapes)
    page_size: int = 16
    quant_block: int = 64

    def kv_token_bytes(self) -> float:
        if self.kv_bytes_per_token:
            return self.kv_bytes_per_token
        return 2 * (self.d_model / 4) * 2 * self.n_layers


def serve_wire_bytes(psi: float, quant_block: int, res_degree: int, *,
                     resident: bool = True) -> float:
    """Per-device weight bytes held by the serving path.

    Resident: the INT8 wire shard, 1 B/param + 4/Q B/param of f32 scales,
    over the residency degree (matches partition.resident_memory_bytes).
    Gathered: the seed fp-materialized path keeps bf16 primaries."""
    per_param = (1 + 4 / max(quant_block, 1)) if resident else 2
    return psi * per_param / max(res_degree, 1)


def serve_phase_volumes(wl: ServeWorkload, res_degree: int, *,
                        resident: bool = True) -> dict[str, float]:
    """Network bytes per device per decode step, plus the KV HBM traffic."""
    deg = max(res_degree, 1)
    shard = serve_wire_bytes(wl.psi, wl.quant_block, deg, resident=resident)
    gather = shard * (deg - 1)
    # per-layer single-token-row allreduce (2x the RS volume), bf16 rows
    psum = 2 * (2 * wl.d_model * wl.n_slots) * wl.n_layers \
        * (deg - 1) / deg if deg > 1 else 0.0
    kv_read = wl.kv_token_bytes() * wl.context * wl.n_slots
    kv_write = wl.kv_token_bytes() * wl.n_slots
    return dict(res_gather=gather, act_psum=psum,
                kv_pages=kv_read + kv_write,
                total=gather + psum + kv_read + kv_write)


def serve_memory_bytes(wl: ServeWorkload, res_degree: int, *,
                       resident: bool = True) -> dict[str, float]:
    """Per-device serving-state bytes: wire residency + the paged pool."""
    weights = serve_wire_bytes(wl.psi, wl.quant_block, res_degree,
                               resident=resident)
    kv = wl.kv_token_bytes() * wl.max_len * wl.n_slots
    return dict(weights=weights, kv_pool=kv, total=weights + kv)


@dataclass(frozen=True)
class ServeStepCost:
    """Predicted cost of one continuous-batching decode step."""
    comm_s: dict[str, float]
    volumes: dict[str, float]
    hbm_s: float                       # weight + KV-page HBM traffic
    compute_s: float
    memory: dict[str, float]
    fits: bool
    n_slots: int

    @property
    def comm_total_s(self) -> float:
        return sum(self.comm_s.values())

    @property
    def memory_total(self) -> float:
        return self.memory["total"]

    def step_s(self) -> float:
        # decode is bandwidth-bound: HBM streaming and compute overlap,
        # the per-layer collectives are latency-dominated and exposed
        return max(self.compute_s, self.hbm_s) + self.comm_total_s

    def tokens_per_s(self) -> float:
        return self.n_slots / self.step_s()

    def arithmetic_intensity(self) -> float:
        """flops per HBM byte — grows with the live batch (weights are read
        once per step regardless of how many slots decode)."""
        bytes_touched = self.memory["weights"] + self.volumes["kv_pages"]
        return 2.0 * self._psi * self.n_slots / max(bytes_touched, 1.0)

    _psi: float = 0.0


def serve_step_cost(topo: Topology, wl: ServeWorkload,
                    res_axes: tuple[str, ...], *, resident: bool = True,
                    memory_budget: float | None = None) -> ServeStepCost:
    """Price one decode step with the wire residency sharded over
    ``res_axes`` (empty = fully replicated wire, no per-token gather)."""
    deg = 1
    sizes = dict(topo.axis_sizes)
    for a in res_axes:
        deg *= sizes[a]
    vols = serve_phase_volumes(wl, deg, resident=resident)
    comm = {}
    for phase in SERVE_PHASES:
        if not res_axes or deg <= 1:
            comm[phase] = 0.0
            continue
        wire = vols[phase] / topo.bandwidth(res_axes)
        hops = (deg - 1) * topo.latency(res_axes)
        # both phases run once per layer inside the decode loop
        comm[phase] = wire + wl.n_layers * hops
    mem = serve_memory_bytes(wl, deg, resident=resident)
    hbm = (mem["weights"] + vols["kv_pages"]) / topo.hbm_bw
    compute = 2.0 * wl.psi * wl.n_slots / topo.flops_per_device
    budget = topo.hbm_bytes if memory_budget is None else memory_budget
    return ServeStepCost(comm_s=comm, volumes=vols, hbm_s=hbm,
                         compute_s=compute, memory=mem,
                         fits=mem["total"] <= budget, n_slots=wl.n_slots,
                         _psi=wl.psi)
