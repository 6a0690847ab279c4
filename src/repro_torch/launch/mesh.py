"""Named device meshes over ``torch.distributed`` ranks, and the scheme
config for a mesh.

Port of ``repro.launch.mesh``'s ``process_axes`` (:42), ``zero_tiers`` (:64)
and ``scheme_config`` (:94), ``"auto"`` (the topology planner) included. A
``Mesh`` is a row-major grid of ranks with named
axes, e.g. ``("data", "node", "gcd")`` = (1, 2, 2): rank r sits at the
coordinates of r unravelled over the shape. For every axis tuple the
collectives use, ``Mesh.bind`` creates one process group per set of ranks
that share the other coordinates; the group's members are listed in the
tuple's major -> minor order, which is the order the reference's tiled
all-gathers concatenate in and its all-to-alls address chunks by.
``torch.distributed`` numbers a group's ranks in its own order, so the
collectives reorder between the two (``Group.to_group``).

Axis-to-tier mapping, as in the reference (DESIGN.md §2): "gcd" is the
fastest tier (primary weight shards), "node" x "gcd" the intra tier
(gradient shards + secondary partition), the other axes the inter tier.

The reference finds the slow network where a mesh axis crosses a JAX
process. Here every rank is a process of its own, so a rank's *host* takes
that place: ``Mesh.hosts`` maps each rank to a host id (None: every rank on
one host; the train launcher fills it from the host names its ranks gather,
``launch.distributed.host_map``), and ``process_axes`` lists the axes
along which it changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist

from ..core.partition import AxisTuple, ZeroConfig, preset

TEST_AXES = ("data", "node", "gcd")


@dataclass(frozen=True)
class Group:
    """One process group over ``axes``: ``members`` are global ranks in axis
    order, ``index`` is this rank's position among them, ``to_group[j]`` the
    torch group rank of member j."""
    axes: AxisTuple
    members: tuple[int, ...]
    index: int
    pg: object
    to_group: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.members)


class Mesh:
    """A row-major grid of ``torch.distributed`` ranks with named axes."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 rank: int = 0, hosts=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        if hosts is not None and len(hosts) != self.size:
            raise ValueError(f"{len(hosts)} hosts for {self.size} ranks")
        self.hosts = None if hosts is None else tuple(hosts)
        self.coords = self._coords(rank)
        self._groups: dict[AxisTuple, Group] = {}
        self._pgs: dict[tuple[int, ...], object] = {}   # by sorted members

    def _coords(self, rank: int) -> dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return out

    def _rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axis_size(self, axes: AxisTuple) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: AxisTuple) -> int:
        """This rank's linear index over ``axes`` (major -> minor)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def members(self, axes: AxisTuple, rank: int | None = None) -> tuple[int, ...]:
        """Global ranks that share ``rank``'s other coordinates, in the order
        of their linear index over ``axes``."""
        base = self._coords(self.rank if rank is None else rank)
        out = []
        for j in range(self.axis_size(axes)):
            c = dict(base)
            for a in reversed(axes):
                j, c[a] = divmod(j, self.shape[a])
            out.append(self._rank_of(c))
        return tuple(out)

    def bind(self, axis_tuples) -> None:
        """Create the process groups of every axis tuple of size > 1. Every
        rank calls this with the same tuples in the same order (each
        ``new_group`` is collective over the whole world). Tuples over the
        same set of ranks (on (1, 2, 2): ("gcd", "node") and all three
        axes) share one gloo group, the world's own when they are every rank:
        each new group costs its connections."""
        for axes in axis_tuples:
            axes = tuple(axes)
            if self.axis_size(axes) == 1 or axes in self._groups:
                continue
            if dist.get_world_size() != self.size:
                raise RuntimeError(f"mesh of {self.size} ranks, world of "
                                   f"{dist.get_world_size()}")
            seen = set()
            for r in range(self.size):
                members = self.members(axes, r)
                key = frozenset(members)
                if key in seen:
                    continue
                seen.add(key)
                ranks = tuple(sorted(members))
                pg = self._pgs.get(ranks)
                if pg is None:
                    pg = dist.group.WORLD if len(ranks) == self.size \
                        else dist.new_group(ranks=list(ranks))
                    self._pgs[ranks] = pg
                if self.rank in members:
                    self._groups[axes] = Group(
                        axes, members, members.index(self.rank), pg,
                        tuple(dist.get_group_rank(pg, m) for m in members))

    def group(self, axes: AxisTuple) -> Group:
        try:
            return self._groups[tuple(axes)]
        except KeyError:
            raise RuntimeError(f"no process group for axes {tuple(axes)}: "
                               "call Mesh.bind first") from None


def config_axis_tuples(cfg: ZeroConfig) -> list[AxisTuple]:
    """Every axis tuple a train step of ``cfg`` runs a collective over."""
    a = cfg.axes
    out = [a.weight, a.extra_grad, a.replica, a.all, a.extra_grad + a.replica]
    if a.secondary is not None:
        out.append(a.secondary)
    return out


def serve_axis_tuples(mesh: Mesh) -> list[AxisTuple]:
    """Every axis tuple serving runs a collective over, besides the
    scheme's: the model-tier axes (the caches' sequence axes: the
    flash-decode combine, the sequence-parallel K/V gather) and the data
    axes (the decode batch's rows; the tokens are gathered over them)."""
    from ..models.registry import data_axes, model_axes
    return [model_axes(mesh), data_axes(mesh)]


def process_axes(mesh: Mesh) -> AxisTuple:
    """Mesh axes that cross a host boundary: those along which the rank ->
    host map ``mesh.hosts`` (None: one host) changes."""
    hosts = mesh.hosts
    if hosts is None or len(set(hosts)) == 1:
        return ()
    spanning = []
    for a in mesh.axis_names:
        for r in range(mesh.size):
            c = mesh._coords(r)
            c[a] = 0
            if hosts[r] != hosts[mesh._rank_of(c)]:
                spanning.append(a)
                break
    return tuple(spanning)


def zero_tiers(mesh: Mesh) -> dict[str, AxisTuple]:
    """Map a mesh's axes onto the (l0, intra, inter) bandwidth tiers.

    On a mesh over several hosts (``process_axes``) the host boundary MUST
    fall inside the inter tier: the primary weight gather and the secondary
    partition live on the intra axes precisely because those are the fast
    in-node links, and a host boundary there would silently run them over
    the network."""
    names = set(mesh.axis_names)
    if {"node", "gcd"} <= names:
        intra, l0 = ("node", "gcd"), ("gcd",)
    elif "model" in names:
        intra = l0 = ("model",)
    else:  # single-axis test meshes
        intra = l0 = (mesh.axis_names[-1],)
    inter = tuple(a for a in mesh.axis_names if a not in intra)
    crossing = tuple(a for a in process_axes(mesh) if a not in inter)
    if crossing:
        raise ValueError(
            f"process boundary crosses intra-tier axes {crossing} of mesh "
            f"{dict(mesh.shape)}: a multi-process launch must keep whole "
            f"intra groups (axes {intra}) inside one process — lower the "
            f"per-process device count or reorder the mesh so only the "
            f"leading axes {inter} span processes")
    return dict(l0=l0, intra=intra, inter=inter)


def scheme_config(scheme: str, mesh: Mesh, *, psi=None, n_layers=None,
                  memory_budget=None, **over) -> ZeroConfig:
    """The ZeroConfig of ``scheme`` on ``mesh``; keyword overrides
    (quant_block, overlap, stream_grads, impl, ...) apply to it.

    ``scheme="auto"`` runs the topology planner (``topo``) against the mesh
    and returns its top-ranked config, named "auto"; ``psi`` / ``n_layers``
    describe the workload (default: the paper's 20B / 44-layer model) and
    ``memory_budget`` bounds per-device state bytes (None: unbounded).
    ``stream_grads`` goes to the planner, which prices and tags the
    streaming regime; the other overrides apply to the chosen config."""
    if scheme == "auto":
        import dataclasses

        from ..topo import plan_for_mesh
        stream = bool(over.pop("stream_grads", False))
        cfg = plan_for_mesh(mesh, psi=psi, n_layers=n_layers,
                            memory_budget=memory_budget,
                            stream_grads=stream, top_k=1)[0].cfg
        return dataclasses.replace(cfg, **over) if over else cfg
    tiers = zero_tiers(mesh)
    cfg = preset(scheme, intra_axes=tiers["intra"], inter_axes=tiers["inter"],
                 l0_axes=tiers["l0"], axis_sizes=dict(mesh.shape), **over)
    cfg.validate_dependency_rule()
    return cfg
