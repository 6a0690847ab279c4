"""Three-term roofline of one rank's step on an H100, from the dry run's
census.

Port of ``repro.launch.roofline`` (``Roofline``, ``model_flops``,
``collective_seconds``, ``build``, ``active_params``). The census
(``launch/census.py``) counts one rank's step, so it yields per-GPU FLOPs,
HBM bytes and collective wire bytes directly:

    compute term    = census FLOPs / peak FLOP/s (each dtype at its peak)
    memory term     = census HBM bytes / HBM bandwidth
    collective term = wire bytes / link bandwidth + hops x hop latency

The card's constants live in one ``Target``; ``H100_SXM`` is the default
and the only one the port prices on. ``MODEL_FLOPS`` = 6 N D (dense) or
6 N_active D (MoE) a training step, 2 N D for inference; the ratio
MODEL_FLOPS / census FLOPs shows the remat recompute and the rest.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Target:
    """A card and its network, as the roofline prices them. A collective
    group whose span in ranks (max - min member) reaches ``node`` crosses
    nodes and runs at ``cross_bw``; the others at ``link_bw``. Each ring
    hop costs ``hop_lat``."""
    name: str
    peak_flops: float           # dense bf16 FLOP/s a GPU
    peak_flops_f32: float       # dense f32 FLOP/s a GPU (no TF32)
    hbm_bw: float               # B/s a GPU
    link_bw: float              # B/s a GPU a direction inside a node
    cross_bw: float             # B/s a GPU across nodes
    hop_lat: float              # s a ring hop
    node: int                   # GPUs a node

    def peak(self, dtype: str) -> float:
        """FLOP/s of a matmul whose operands are ``dtype`` (the census's
        names): f32 at the f32 peak, the rest at the bf16 tensor-core
        peak."""
        return self.peak_flops_f32 if dtype == "f32" else self.peak_flops


# NVIDIA H100 SXM5 80 GB (the card of every measurement in PERF.md: NVIDIA
# H100 80GB HBM3, 700.00 W), its network as in an 8-GPU HGX / DGX H100 node.
H100_SXM = Target(
    name="NVIDIA H100 80GB HBM3 (SXM5, 700 W)",
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense (without
    # sparsity): BF16 989 TFLOPS, FP32 67 TFLOPS, GPU memory bandwidth
    # 3.35 TB/s
    peak_flops=989e12,
    peak_flops_f32=67e12,
    hbm_bw=3.35e12,
    # same data sheet: NVLink 900 GB/s a GPU, both directions together
    # (18 fourth-generation links), so 450 GB/s a direction
    link_bw=450e9,
    # DGX H100 user guide: eight ConnectX-7 InfiniBand NDR ports of 400
    # Gb/s, one a GPU: 50 GB/s a GPU across nodes
    cross_bw=50e9,
    # a model constant, not measured: the order of one ring step's latency
    # over NVLink in NCCL's tuning model (src/graph/tuning.cc)
    hop_lat=1e-6,
    # DGX H100: 8 GPUs a node
    node=8,
)


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_chip: float
    hlo_flops_per_chip: float   # the census's FLOPs (the reference's name)
    peak_flops: float = H100_SXM.peak_flops

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops_per_chip / max(self.hlo_flops_per_chip, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        return self.model_flops_per_chip / (self.step_time_s * self.peak_flops) \
            if self.step_time_s else 0.0

    def summary(self) -> dict:
        return dict(compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s, bottleneck=self.bottleneck,
                    step_time_s=self.step_time_s,
                    model_flops_per_chip=self.model_flops_per_chip,
                    hlo_flops_per_chip=self.hlo_flops_per_chip,
                    useful_flop_ratio=self.useful_flop_ratio,
                    mfu_bound=self.mfu_bound)


def model_flops(n_params: int, n_active_params: int, tokens: int,
                kind: str) -> float:
    """6·N·D training FLOPs (fwd 2ND + bwd 4ND); 2·N·D for inference."""
    n = n_active_params or n_params
    per_tok = 6.0 * n if kind == "train" else 2.0 * n
    return per_tok * tokens


def compute_seconds(census: dict, target: Target = H100_SXM) -> float:
    """FLOPs over the peak: each dtype of ``flops_by_dtype`` at its own
    peak; a census without the split (the reference's) at the bf16 one."""
    by_dtype = census.get("flops_by_dtype")
    if not by_dtype:
        return census["flops"] / target.peak_flops
    return sum(f / target.peak(d) for d, f in by_dtype.items())


def collective_seconds(census: dict, target: Target = H100_SXM) -> float:
    """Tier-aware: groups that cross nodes at ``cross_bw``, the others at
    ``link_bw``, plus the ring hop-latency term (count x (d - 1) hops)."""
    groups = census.get("groups")
    if not groups:
        return census["total_wire_bytes"] / target.link_bw
    total = 0.0
    for key, (wire, count) in groups.items():
        _, d, span = key.split("|")
        bw = target.cross_bw if int(span) >= target.node else target.link_bw
        total += wire / bw + count * (int(d) - 1) * target.hop_lat
    return total


def build(census: dict, *, n_chips: int, n_params: int,
          n_active_params: int, tokens: int, kind: str,
          target: Target = H100_SXM) -> Roofline:
    mf = model_flops(n_params, n_active_params, tokens, kind) / n_chips
    return Roofline(
        compute_s=compute_seconds(census, target),
        memory_s=census["hbm_bytes"] / target.hbm_bw,
        collective_s=collective_seconds(census, target),
        model_flops_per_chip=mf,
        hlo_flops_per_chip=census["flops"],
        peak_flops=target.peak_flops,
    )


def active_params(arch, total_params: int) -> int:
    """MoE: count only top-k of the expert FFN params as active."""
    if not arch.moe.n_experts:
        return total_params
    e, k = arch.moe.n_experts, arch.moe.top_k
    expert_per_layer = 3 * arch.d_model * arch.moe.d_ff * e
    n_moe_layers = sum(1 for p in arch.pattern if "moe" in p)
    expert_total = expert_per_layer * n_moe_layers
    return total_params - expert_total + expert_total * k // e
