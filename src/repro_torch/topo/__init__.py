"""Topology-aware partition planning (DESIGN.md §4).

Port of ``repro.topo``; pure Python: nothing here imports torch at import
time (``planner``'s workload helpers import the model registry when
called).

Three layers:

  model.py   — ``Topology``: each mesh axis mapped to link bandwidth /
               latency / tier, with built-in presets (Frontier, GPU pod,
               TPU pod) and JSON load/save for user-declared clusters.
  cost.py    — analytic per-step communication seconds and per-device
               memory bytes for *any* valid ``ZeroConfig``, priced from the
               real collective inventory of ``core/collectives.py``.
  planner.py — enumerate every axis-prefix assignment satisfying the AMSP
               dependency rule (plus secondary placement and quantization),
               score under a memory budget, emit ranked ``ZeroConfig``s.
"""
from .cost import StepCost, Workload, phase_volumes, step_cost  # noqa: F401
from .model import (Link, Topology, frontier, gpu_pod,  # noqa: F401
                    load_topology, tpu_pod)

_PLANNER_EXPORTS = ("Plan", "enumerate_candidates", "plan", "plan_for_mesh",
                    "preset_on_topology", "model_workload")


def __getattr__(name):
    # planner re-exports are lazy so `python -m repro_torch.topo.planner` does not
    # import the submodule twice (runpy's sys.modules warning)
    if name in _PLANNER_EXPORTS:
        from . import planner
        return getattr(planner, name)
    raise AttributeError(name)
