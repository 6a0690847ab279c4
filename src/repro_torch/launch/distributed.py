"""Cross-process launch: which rank this process is, and the gloo group.

Port of ``repro.launch.distributed``:

* ``DistConfig``: the coordinator address and this process's rank among
  ``num_processes``, resolved (``detect``) from, in this order, explicit
  CLI flags, SLURM, OpenMPI, the ``REPRO_*`` variables and, after the
  reference's sources, torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT``. Without any of them the run is one
  process, and the launcher spawns its own ranks (``--devices``).
* ``host_map()``: which host each rank of the live group runs on, from
  the host names the ranks gather (the mesh's host boundaries,
  ``launch.mesh``).
* ``initialize(dcfg)``: ``torch.distributed.init_process_group`` with gloo
  at ``tcp://<coordinator>`` (rank 0 binds it). Nothing on one process.
* ``add_cli_args`` / ``from_args``: the ``--coordinator`` /
  ``--num-processes`` / ``--process-id`` flags of ``launch/train.py``.
* ``Heartbeat`` / ``heartbeat``: the per-rank stall detector of trace mode
  (obs.heartbeat) bound to this process's rank.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta


@dataclass(frozen=True)
class DistConfig:
    """One process's view of the job. ``num_processes == 1``: the ordinary
    single-process mode (no group is started here)."""
    coordinator: str | None = None
    num_processes: int = 1
    process_id: int = 0
    source: str = "single"     # single | flags | slurm | ompi | env | torchrun

    def __post_init__(self):
        assert self.num_processes >= 1, self
        assert 0 <= self.process_id < self.num_processes, self
        if self.num_processes > 1:
            assert self.coordinator, \
                f"multi-process launch needs a coordinator address: {self}"

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


_DEFAULT_PORT = 12621


def _from_slurm() -> DistConfig | None:
    """srun sets the rank layout; the coordinator is the first host of the
    step's node list on port 12621 (a ``host[1-4]`` range taken by its
    prefix), or ``REPRO_COORDINATOR``."""
    if "SLURM_PROCID" not in os.environ or "SLURM_NTASKS" not in os.environ:
        return None
    n = int(os.environ["SLURM_NTASKS"])
    if n == 1:
        return None
    host = os.environ.get("REPRO_COORDINATOR")
    if not host:
        nodelist = os.environ.get("SLURM_STEP_NODELIST",
                                  os.environ.get("SLURM_NODELIST", ""))
        first = nodelist.split(",")[0]
        if "[" in first:      # "frontier[00123-00170]" -> "frontier00123"
            prefix, rng = first.split("[", 1)
            first = prefix + rng.split("-")[0].split(",")[0].rstrip("]")
        host = f"{first}:{_DEFAULT_PORT}" if first else None
    if not host:
        return None
    return DistConfig(host, n, int(os.environ["SLURM_PROCID"]), "slurm")


def _from_ompi() -> DistConfig | None:
    """mpirun / mpiexec (OpenMPI): the world size and rank from its
    variables; only with ``REPRO_COORDINATOR`` (OpenMPI does not name rank
    0's host portably)."""
    if "OMPI_COMM_WORLD_RANK" not in os.environ:
        return None
    n = int(os.environ.get("OMPI_COMM_WORLD_SIZE", "1"))
    if n == 1:
        return None
    host = os.environ.get("REPRO_COORDINATOR")
    if not host:
        return None
    return DistConfig(host, n, int(os.environ["OMPI_COMM_WORLD_RANK"]), "ompi")


def _from_env() -> DistConfig | None:
    """A launch by hand: REPRO_COORDINATOR / REPRO_NUM_PROCESSES /
    REPRO_PROCESS_ID."""
    n = int(os.environ.get("REPRO_NUM_PROCESSES", "1"))
    if n == 1:
        return None
    return DistConfig(os.environ.get("REPRO_COORDINATOR"), n,
                      int(os.environ.get("REPRO_PROCESS_ID", "0")), "env")


def _from_torchrun() -> DistConfig | None:
    """torchrun's RANK / WORLD_SIZE, at MASTER_ADDR:MASTER_PORT."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    n = int(os.environ["WORLD_SIZE"])
    if n == 1:
        return None
    host = f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:" \
        f"{os.environ.get('MASTER_PORT', '29500')}"
    return DistConfig(host, n, int(os.environ["RANK"]), "torchrun")


def detect(coordinator: str | None = None, num_processes: int | None = None,
           process_id: int | None = None) -> DistConfig:
    """The job's layout: explicit arguments > SLURM > OpenMPI > REPRO_* >
    torchrun. Explicit arguments come as a complete set (coordinator, count
    and id); a partial set raises rather than falling through."""
    explicit = [coordinator, num_processes, process_id]
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError(
                "--coordinator, --num-processes and --process-id must be "
                f"given together (got {explicit})")
        return DistConfig(coordinator, num_processes, process_id, "flags")
    for probe in (_from_slurm, _from_ompi, _from_env, _from_torchrun):
        dcfg = probe()
        if dcfg is not None:
            return dcfg
    return DistConfig()


def initialize(dcfg: DistConfig, timeout_s: float = 900.0) -> DistConfig:
    """Join the job's gloo group at ``tcp://<coordinator>`` as rank
    ``process_id`` (rank 0 binds the address); nothing on one process."""
    if dcfg.is_distributed:
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"tcp://{dcfg.coordinator}",
            rank=dcfg.process_id, world_size=dcfg.num_processes,
            timeout=timedelta(seconds=timeout_s))
    return dcfg


def host_map() -> tuple[int, ...] | None:
    """Rank -> host of the live group (``launch.mesh.Mesh.hosts``): every
    rank's host name, gathered, numbered by ``number_hosts``. Exact under
    any launcher and any placement of ranks on hosts. None without a group
    of more than one rank. A collective: every rank of the group calls it."""
    import socket

    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return number_hosts(names)


def number_hosts(names) -> tuple[int, ...]:
    """Each rank's host name -> a host id, numbered in order of first
    appearance."""
    ids: dict[str, int] = {}
    return tuple(ids.setdefault(n, len(ids)) for n in names)


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


# -- rank heartbeat / stall detection (trace mode) ---------------------------

@dataclass(frozen=True)
class Heartbeat:
    """The per-rank stall detector bound to a process layout: ``stamp(step)``
    before every step (an atomic file a rank), ``report()`` classifies every
    expected rank as dead, stalled, behind or ok (obs.heartbeat)."""
    directory: str
    rank: int
    n_ranks: int

    def stamp(self, step: int):
        from ..obs import heartbeat as hb
        return hb.stamp(self.directory, self.rank, step)

    def report(self, *, stall_s: float = 30.0) -> dict:
        from ..obs import heartbeat as hb
        return hb.straggler_report(self.directory, self.n_ranks,
                                   stall_s=stall_s)


def heartbeat(directory) -> Heartbeat:
    """The heartbeat of this process: its rank and the world size of the
    live group (rank 0 of 1 without one)."""
    return Heartbeat(str(directory), process_index(), process_count())


# -- CLI wiring (launch/train.py) --------------------------------------------

def add_cli_args(ap) -> None:
    g = ap.add_argument_group(
        "distributed", "multi-process launch (omit all three to autodetect "
        "SLURM / OpenMPI / REPRO_* env, or run single-process)")
    g.add_argument("--coordinator", default=None,
                   help="rank 0 address, host:port")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)


def from_args(args) -> DistConfig:
    return detect(args.coordinator, args.num_processes, args.process_id)
