"""Named device meshes over ``torch.distributed`` ranks, and the scheme
config for a mesh.

Port of ``repro.launch.mesh``'s ``zero_tiers`` (:64) and the preset half of
``scheme_config`` (:94). A ``Mesh`` is a row-major grid of ranks with named
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
                 rank: int = 0):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
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


def zero_tiers(mesh: Mesh) -> dict[str, AxisTuple]:
    """Map a mesh's axes onto the (l0, intra, inter) bandwidth tiers."""
    names = set(mesh.axis_names)
    if {"node", "gcd"} <= names:
        intra, l0 = ("node", "gcd"), ("gcd",)
    elif "model" in names:
        intra = l0 = ("model",)
    else:  # single-axis test meshes
        intra = l0 = (mesh.axis_names[-1],)
    inter = tuple(a for a in mesh.axis_names if a not in intra)
    return dict(l0=l0, intra=intra, inter=inter)


def scheme_config(scheme: str, mesh: Mesh, **over) -> ZeroConfig:
    """The preset ZeroConfig of ``scheme`` on ``mesh`` (no planner); keyword
    overrides (quant_block, overlap, stream_grads, impl, ...) apply to it."""
    tiers = zero_tiers(mesh)
    cfg = preset(scheme, intra_axes=tiers["intra"], inter_axes=tiers["inter"],
                 l0_axes=tiers["l0"], axis_sizes=dict(mesh.shape), **over)
    cfg.validate_dependency_rule()
    return cfg
