"""Topology description: mesh axes annotated with link characteristics.

Port of ``repro.topo.model``. A ``Topology`` is the planner's view of a
cluster: an ordered list of mesh axes, fastest link first, each carrying
the effective per-device bandwidth, the per-hop latency of the collective
algorithm on that link, and a tier label (``l0`` / ``intra`` / ``inter``)
matching the paper's three Frontier levels (GCD pair / node / Slingshot).
New clusters are config files, not code: declare the axes in JSON
(`Topology.save` / `load_topology`; either package reads the other's
files) and the planner searches the full scheme space on them.

The axis *order* is load-bearing: the partition presets in
``core/partition.py`` build their axis tuples fastest-first
(l0 + intra + inter), and the planner enumerates prefix assignments of the
same ordering, so every hand-written preset is a point inside the searched
space.

The presets' numbers (``frontier``, ``gpu_pod``, ``tpu_pod``) and the tier
defaults of ``Topology.from_mesh`` are the reference's modelling constants,
kept bit for bit so both packages rank alike: Frontier's MI250X links, a
generic NVLink / InfiniBand pod, a TPU pod slice. None of them is a
measurement of an H100 host; ``obs.calibrate`` solves a mesh's effective
bandwidths from its measured phases and writes them into a ``Topology``
(``calibrated``).
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, replace
from pathlib import Path

TIERS = ("l0", "intra", "inter")


@dataclass(frozen=True)
class Link:
    """One mesh axis and the interconnect its neighbours talk over."""
    name: str
    size: int                 # mesh axis size (devices along this axis)
    bandwidth: float          # effective per-device bandwidth, bytes/s
    latency: float            # per-hop latency of ring collectives, s
    tier: str = "intra"       # l0 | intra | inter (paper's three levels)

    def __post_init__(self):
        assert self.size >= 1 and self.bandwidth > 0 and self.latency >= 0, self
        assert self.tier in TIERS, f"tier must be one of {TIERS}: {self}"


@dataclass(frozen=True)
class Topology:
    """A cluster as a bandwidth hierarchy: axes ordered fastest -> slowest."""
    name: str
    links: tuple[Link, ...]
    flops_per_device: float = 135e12   # achievable matmul FLOP/s
    hbm_bytes: float = 64e9            # per-device memory budget default
    hbm_bw: float = 1.6e12             # per-device HBM bandwidth, B/s
    # (prices the dequant round-trip the fused kernels remove, cost.py)

    def __post_init__(self):
        names = [l.name for l in self.links]
        assert len(set(names)) == len(names), f"duplicate axes: {names}"
        # fastest -> slowest is the canonical order (stable for ties, so
        # same-tier axes keep their declared relative order)
        ordered = tuple(sorted(self.links, key=lambda l: -l.bandwidth))
        object.__setattr__(self, "links", ordered)

    # -- views ---------------------------------------------------------------

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(l.name for l in self.links)

    @property
    def axis_sizes(self) -> tuple[tuple[str, int], ...]:
        return tuple((l.name, l.size) for l in self.links)

    @property
    def n_devices(self) -> int:
        return math.prod(l.size for l in self.links)

    def link(self, axis: str) -> Link:
        for l in self.links:
            if l.name == axis:
                return l
        raise KeyError(axis)

    def tiers(self) -> dict[str, tuple[str, ...]]:
        """(l0, intra, inter) axis split, mirroring ``mesh.zero_tiers``.

        ``l0`` falls back to the fastest axis when no axis is labelled l0;
        ``intra`` always contains l0 (the paper's node contains the GCD pair).
        """
        l0 = tuple(l.name for l in self.links if l.tier == "l0")
        if not l0 and self.links:
            l0 = (self.links[0].name,)
        intra = l0 + tuple(l.name for l in self.links
                           if l.tier == "intra" and l.name not in l0)
        inter = tuple(l.name for l in self.links if l.name not in intra)
        return dict(l0=l0, intra=intra, inter=inter)

    # -- link aggregation over a collective's axis tuple ---------------------

    def bandwidth(self, axes: tuple[str, ...]) -> float:
        """Bottleneck bandwidth of a collective spanning ``axes``."""
        assert axes, "no link to price for an empty axis tuple"
        return min(self.link(a).bandwidth for a in axes)

    def latency(self, axes: tuple[str, ...]) -> float:
        """Per-hop latency of a collective spanning ``axes`` (slowest hop)."""
        assert axes
        return max(self.link(a).latency for a in axes)

    def group_size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.link(a).size for a in axes)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        links = tuple(Link(**l) for l in d["links"])
        return cls(name=d["name"], links=links,
                   flops_per_device=float(d.get("flops_per_device", 135e12)),
                   hbm_bytes=float(d.get("hbm_bytes", 64e9)),
                   hbm_bw=float(d.get("hbm_bw", 1.6e12)))

    def save(self, path) -> str:
        Path(path).write_text(json.dumps(self.to_dict(), indent=1))
        return str(path)

    @classmethod
    def load(cls, path) -> "Topology":
        return cls.from_dict(json.loads(Path(path).read_text()))

    # -- from a live mesh ----------------------------------------------------

    @classmethod
    def from_mesh(cls, mesh, *,
                  bandwidths: dict[str, float] | None = None,
                  latencies: dict[str, float] | None = None,
                  flops_per_device: float = 135e12,
                  hbm_bytes: float = 64e9) -> "Topology":
        """Annotate a live mesh (``launch.mesh.Mesh``) with per-tier link
        defaults.

        The tier split comes from ``launch.mesh.zero_tiers`` (the same rule
        the hand-written presets use), so ``--scheme auto`` searches exactly
        the space the presets live in.  ``bandwidths``/``latencies`` override
        per *tier* (keys l0/intra/inter).

        Axes that cross a *host* boundary (``launch.mesh.process_axes`` of
        the mesh's rank -> host map ``Mesh.hosts``) are pinned
        to the inter tier and priced at the inter link: the host boundary
        IS the slow network, whatever the axis is named. ``zero_tiers``
        raises if a host boundary would cut an intra axis, so by the time
        we get here spanning axes are inter axes; the pin is asserted
        rather than silently re-derived.
        """
        from ..launch.mesh import process_axes, zero_tiers
        bw = dict(DEFAULT_TIER_BANDWIDTH)
        bw.update(bandwidths or {})
        lat = dict(DEFAULT_TIER_LATENCY)
        lat.update(latencies or {})
        tiers = zero_tiers(mesh)
        spanning = process_axes(mesh)
        assert all(a in tiers["inter"] for a in spanning), (spanning, tiers)
        links = []
        for tier in ("l0", "intra", "inter"):
            for a in tiers[tier]:
                if any(l.name == a for l in links):
                    continue     # l0 axes also appear in intra
                links.append(Link(a, mesh.shape[a], bw[tier], lat[tier], tier))
        name = f"mesh:{dict(mesh.shape)}"
        if spanning:
            name += f" procs@{','.join(spanning)}"
        return cls(name=name, links=tuple(links),
                   flops_per_device=flops_per_device, hbm_bytes=hbm_bytes)


# per-tier defaults for meshes declared without explicit link data
# (Frontier numbers: MI250X GCD pair / intra-node IF / 4x Slingshot per node)
DEFAULT_TIER_BANDWIDTH = dict(l0=200e9, intra=40e9, inter=100e9 / 8)
DEFAULT_TIER_LATENCY = dict(l0=2e-6, intra=4e-6, inter=15e-6)


# ---------------------------------------------------------------------------
# Built-in presets
# ---------------------------------------------------------------------------

def frontier(n_nodes: int = 48) -> Topology:
    """Frontier (paper §IV): MI250X GCD pair / 8-GCD node / Slingshot.

    Per-GCD effective numbers used throughout the paper-figure benchmarks:
    200 GB/s inside the GCD pair, ~40 GB/s across the node, 4x100 GB/s
    Slingshot NICs shared by 8 GCDs inter-node.
    """
    return Topology("frontier", (
        Link("gcd", 2, 200e9, 2e-6, "l0"),
        Link("node", 4, 40e9, 4e-6, "intra"),
        Link("data", n_nodes, 100e9 / 8, 15e-6, "inter"),
    ), flops_per_device=135e12, hbm_bytes=64e9)


def gpu_pod(n_nodes: int = 32, gpus_per_node: int = 8) -> Topology:
    """Generic NVLink-node GPU cluster: NVLink intra-node, IB inter-node."""
    return Topology("gpu_pod", (
        Link("model", gpus_per_node, 300e9, 3e-6, "intra"),
        Link("data", n_nodes, 25e9, 10e-6, "inter"),
    ), flops_per_device=300e12, hbm_bytes=80e9)


def tpu_pod(ici: int = 16, dci: int = 16) -> Topology:
    """TPU pod slice: short ICI paths intra, long ICI + DCI inter."""
    return Topology("tpu", (
        Link("model", ici, 50e9, 1e-6, "intra"),
        Link("data", dci, 50e9 / 4, 10e-6, "inter"),
    ), flops_per_device=197e12, hbm_bytes=16e9)


PRESETS = dict(frontier=frontier, gpu_pod=gpu_pod, tpu=tpu_pod,
               tpu_pod=tpu_pod)


def load_topology(spec: str, **kw) -> Topology:
    """Resolve a topology: preset name or a JSON file path."""
    if spec in PRESETS:
        return PRESETS[spec](**kw)
    p = Path(spec)
    if p.exists():
        return Topology.load(p)
    raise ValueError(f"unknown topology {spec!r}: not a preset "
                     f"({sorted(PRESETS)}) and no such file")


def scaled(topo: Topology, axis: str, size: int) -> Topology:
    """Same topology with one axis resized (scaling sweeps)."""
    links = tuple(replace(l, size=size) if l.name == axis else l
                  for l in topo.links)
    return replace(topo, links=links)


def calibrated(topo: Topology, eff_bandwidths: dict[str, float],
               name: str | None = None) -> Topology:
    """Same topology with *measured* effective bandwidths swapped in on the
    named axes (the ``obs.calibrate`` back-solve); axes without a
    measurement keep their preset numbers. The result round-trips through
    ``save``/``load_topology``, so ``planner --topology <file>`` plans off
    measured links."""
    links = tuple(
        replace(l, bandwidth=float(eff_bandwidths[l.name]))
        if eff_bandwidths.get(l.name, 0) and eff_bandwidths[l.name] > 0
        else l for l in topo.links)
    return replace(topo, name=name or f"{topo.name}:calibrated",
                   links=links)
