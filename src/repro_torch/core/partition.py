"""Hierarchical partitioning: sharding degrees, block padding, leaf specs.

The port's own copy of the pure-Python half of ``repro.core.partition``:
the per-category axes and degrees, the scheme presets, the per-leaf
quantization block (``ZeroConfig.block_for`` / ``for_leaf``), the flat
padding rule (``padded_flat_size``), the leaf kinds and ``LeafSpec``, and the
memory formulas the engine reports (``grad_buffer_bytes``,
``prefetch_buffer_bytes``). Each category of training state is
sharded over a prefix of the bandwidth hierarchy: weights over W, gradients
over W + E, optimizer state over W + E + R, with the flat slices nested in
that major -> minor order. ``ZeroConfig.fingerprint`` is the layout
identity a checkpoint records (``repro.core.partition`` :107).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

AxisTuple = tuple[str, ...]


@dataclass(frozen=True)
class ZeroAxes:
    """Per-category mesh axes, ordered major -> minor within each tuple."""
    weight: AxisTuple          # L0: primary shard + fwd all-gather
    extra_grad: AxisTuple      # E: additional gradient sharding (L1 minus L0)
    replica: AxisTuple         # R: pure data-parallel replication (slowest)
    secondary: AxisTuple | None = None  # secondary partition axes (ZeRO++)

    def __post_init__(self):
        cats = (self.weight, self.extra_grad, self.replica)
        flat = [a for c in cats for a in c]
        assert len(set(flat)) == len(flat), f"axes must be disjoint: {cats}"
        if self.secondary is not None:
            for a in self.secondary:
                assert a in flat, (a, self)

    @property
    def grad(self) -> AxisTuple:
        return self.weight + self.extra_grad

    @property
    def all(self) -> AxisTuple:  # optimizer axes == all participating axes
        return self.weight + self.extra_grad + self.replica


@dataclass(frozen=True)
class ZeroConfig:
    axes: ZeroAxes
    axis_sizes: tuple[tuple[str, int], ...]   # full mesh axis -> size
    quantize_weights: bool = False      # INT8 block quant on weight all-gather
    quantize_grads: bool = False        # INT4 a2a-based gradient reduce-scatter
    quant_block: int = 512
    cross_replica: str = "allreduce"    # the paper's flow: all-reduce over R,
    # then keep this rank's slice; "reduce_scatter": a reduce-scatter over R
    # lands the slice directly, at about half the wire bytes
    quantize_update_gather: bool = False  # INT8 update all-gather over E + R
    overlap: bool = False               # prefetch layer i+1's weight gathers
    # while layer i computes; schedule only: the same collectives and numbers
    stream_grads: bool = False          # reduce each stacked layer's weight
    # grad to the optimizer shard inside its backward (stage 1 over W, stage 2
    # over E, the replica sync over R); grads accumulate in os layout
    impl: str | None = None             # None: the kernel for a CUDA tensor and
    # the plain version for a CPU tensor; "plain": the plain version on any
    # device (the reference chip_smoke.py holds the kernels against)
    compute_dtype: str = "bfloat16"
    name: str = "custom"

    def size(self, axes: AxisTuple) -> int:
        d = dict(self.axis_sizes)
        return math.prod(d[a] for a in axes) if axes else 1

    @property
    def w_degree(self) -> int:
        return self.size(self.axes.weight)

    @property
    def g_degree(self) -> int:
        return self.size(self.axes.grad)

    @property
    def os_degree(self) -> int:
        return self.size(self.axes.all)

    @property
    def sec_degree(self) -> int | None:
        return None if self.axes.secondary is None else \
            self.size(self.axes.secondary)

    def validate_dependency_rule(self) -> None:
        """AMSP / paper §V: deg(os) >= deg(grad) >= deg(weight)."""
        assert self.os_degree >= self.g_degree >= self.w_degree, self

    def fingerprint(self) -> dict:
        """Shard-layout identity (JSON-serializable): everything about this
        config that determines how a flat parameter is split across ranks.
        ``ZeroEngine.scheme_fingerprint`` extends it with per-leaf padded
        sizes; train/checkpoint.py refuses to restore across different
        fingerprints. ``cross_replica``, ``quantize_update_gather``,
        ``overlap``, ``stream_grads``, ``impl`` and ``compute_dtype`` leave
        the layout as it is and stay out."""
        return dict(
            scheme=self.name,
            axes=dict(weight=list(self.axes.weight),
                      extra_grad=list(self.axes.extra_grad),
                      replica=list(self.axes.replica),
                      secondary=None if self.axes.secondary is None
                      else list(self.axes.secondary)),
            axis_sizes={a: s for a, s in self.axis_sizes},
            degrees=dict(w=self.w_degree, g=self.g_degree, os=self.os_degree,
                         sec=self.sec_degree),
            quant_block=self.quant_block,
        )

    def block_for(self, logical_size: int) -> int:
        """Effective quantization block for a leaf: large leaves use the full
        configured block; small leaves (norm scales, biases) shrink it so the
        alignment padding (os_degree * block) never dwarfs the leaf."""
        per_dev = -(-logical_size // self.os_degree)
        b = 4
        while b < per_dev and b < self.quant_block:
            b *= 2
        return b

    def for_leaf(self, logical_size: int) -> "ZeroConfig":
        b = self.block_for(logical_size)
        return self if b == self.quant_block else \
            dataclasses.replace(self, quant_block=b)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_flat_size(logical_size: int, cfg: ZeroConfig) -> int:
    """Pad so every stage's shard is block-aligned:
    padded % (D_total * block) == 0."""
    return round_up(max(logical_size, 1),
                    cfg.os_degree * cfg.block_for(logical_size))


MATMUL = "matmul"    # quantized gather + secondary + quantized grad RS
GATHER_Q = "gather_q"  # quantized gather of a full tensor (MoE experts)
PLAIN = "plain"      # small params: fp gather, kept dense


@dataclass(frozen=True)
class LeafSpec:
    name: str
    shape: tuple[int, ...]          # logical (per-layer) shape
    kind: str = PLAIN
    stack: int | None = None        # leading stacked-layers dimension
    init: str = "normal"            # "normal" | "zeros" | "ones"
    init_scale: float | None = None  # stddev override (default fan-in)

    @property
    def logical_size(self) -> int:
        return math.prod(self.shape)


SCHEMES = ("zero_topo", "zeropp", "zero3", "zero1", "zero2")


def preset(scheme: str, *, intra_axes: AxisTuple, inter_axes: AxisTuple,
           axis_sizes: dict[str, int], l0_axes: AxisTuple | None = None,
           **over) -> ZeroConfig:
    """Scheme config for a mesh split into bandwidth tiers (paper Table IV)."""
    sizes = tuple(sorted(axis_sizes.items()))
    l0 = l0_axes or ()
    every = l0 + tuple(a for a in intra_axes if a not in l0) + inter_axes
    if scheme == "zero3":
        axes = ZeroAxes(weight=every, extra_grad=(), replica=())
        return ZeroConfig(axes, sizes, name="zero3", **over)
    if scheme == "zeropp":
        intra_full = l0 + tuple(a for a in intra_axes if a not in l0)
        axes = ZeroAxes(weight=every, extra_grad=(), replica=(),
                        secondary=intra_full)
        return ZeroConfig(axes, sizes, quantize_weights=True,
                          quantize_grads=True, name="zeropp", **over)
    if scheme == "zero_topo":
        w = l0_axes if l0_axes else intra_axes
        e = tuple(a for a in intra_axes if a not in w)
        axes = ZeroAxes(weight=w, extra_grad=e, replica=inter_axes,
                        secondary=w + e)
        return ZeroConfig(axes, sizes, quantize_weights=True,
                          quantize_grads=True, name="zero_topo", **over)
    if scheme == "zero1":
        axes = ZeroAxes(weight=(), extra_grad=(), replica=every)
        return ZeroConfig(axes, sizes, name="zero1",
                          cross_replica="allreduce", **over)
    if scheme == "zero2":
        axes = ZeroAxes(weight=(), extra_grad=every, replica=())
        return ZeroConfig(axes, sizes, name="zero2", **over)
    raise ValueError(scheme)


def single_device_config(scheme: str = "zero_topo", **over) -> ZeroConfig:
    """``scheme`` on a one-device mesh ("data", "node", "gcd") = (1, 1, 1):
    the reference's ``scheme_config(scheme, make_test_mesh((1, 1, 1)))``."""
    return preset(scheme, intra_axes=("node", "gcd"), inter_axes=("data",),
                  l0_axes=("gcd",), axis_sizes={"data": 1, "node": 1, "gcd": 1},
                  **over)


def grad_buffer_bytes(cfg: ZeroConfig, psi: int, *,
                      streaming: bool | None = None) -> int:
    """Bytes of the gradient buffer the engine allocates: microbatch grads
    accumulate in fp32 primary layout (``4 * psi / w_degree``), or, on the
    streaming path, in fp32 optimizer-shard layout (``4 * psi / os_degree``)."""
    if streaming is None:
        streaming = cfg.stream_grads
    deg = cfg.os_degree if streaming else cfg.w_degree
    return 4 * psi // deg


def prefetch_buffer_bytes(cfg: ZeroConfig, layer_bytes: int) -> int:
    """Bytes of the 2-slot gather-prefetch buffer: two layers' gathered
    weights in wire format (``layer_bytes`` each); 0 when overlap is off."""
    return 2 * layer_bytes if cfg.overlap else 0


def resident_memory_bytes(cfg: ZeroConfig, psi: int, *,
                          res_degree: int) -> int:
    """Per-device bytes of the serving wire residency: INT8 payload + fp32
    per-block scales of the quantized leaves, over the residency degree."""
    deg = max(res_degree, 1)
    scales = 4 * psi // max(cfg.quant_block, 1)
    return (psi + scales) // deg
