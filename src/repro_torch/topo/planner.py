"""Search the partition-scheme space on a topology and rank by predicted
step time (the ZeRO++-style "targeted strategy", generalized to any cluster).

Port of ``repro.topo.planner``: the same candidates in the same order, the
same costs and the same stable sort, so both packages rank alike (ties
included) and ``main`` prints what the reference prints.

Search space (DESIGN.md §4): with topology axes ordered fastest -> slowest
``(a_1 .. a_k)``, every scheme is an **axis-prefix assignment**

    weight    = a_1 .. a_i          (fastest links)
    extra_grad= a_{i+1} .. a_j
    replica   = a_{j+1} .. a_k      (slowest links)

for ``0 <= i <= j <= k`` — which satisfies the AMSP dependency rule
``deg(os) >= deg(grad) >= deg(weight)`` by construction (still asserted per
candidate) — crossed with the secondary-partition placement (None or any
axis prefix; requires the INT8 weight path) and the quantization switches.
Every hand-written preset in ``core/partition.py`` is a point in this space,
so the planner's top choice can never predict worse than the presets.

CLI:

    PYTHONPATH=src python -m repro_torch.topo.planner \
        --topology frontier --model gpt_neox_20b [--top 8] [--budget-gb 64]

``--topology`` takes a preset name (frontier / gpu_pod / tpu) or a JSON file
written by ``Topology.save`` (``obs.calibrate`` writes one from measured
phases) — new clusters are config files, not code.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from ..core.partition import ZeroAxes, ZeroConfig, preset
from .cost import (ServeStepCost, ServeWorkload, StepCost, Workload,
                   serve_step_cost, step_cost)
from .model import Topology, load_topology


@dataclass(frozen=True)
class Plan:
    cfg: ZeroConfig
    cost: StepCost
    step_s: float

    @property
    def label(self) -> str:
        a = self.cfg.axes

        def j(t):
            return "+".join(t) if t else "-"

        quant = ("int8w" if self.cfg.quantize_weights else "fp16w") + \
            ("/int4g" if self.cfg.quantize_grads else "/fp16g")
        return (f"w={j(a.weight)} e={j(a.extra_grad)} r={j(a.replica)} "
                f"sec={j(a.secondary) if a.secondary is not None else 'none'} "
                f"{quant}")


def enumerate_candidates(topo: Topology, *,
                         quantize: bool | None = None) -> list[ZeroConfig]:
    """All prefix assignments x secondary placements x quantization switches.

    ``quantize=True/False`` pins both switches; None searches both.
    """
    axes = topo.axis_names
    sizes = topo.axis_sizes
    k = len(axes)
    q_opts = [(False, False), (True, False), (False, True), (True, True)] \
        if quantize is None else [(quantize, quantize)]
    out: list[ZeroConfig] = []
    seen: set = set()
    for i in range(k + 1):
        for j in range(i, k + 1):
            za = ZeroAxes(weight=axes[:i], extra_grad=axes[i:j],
                          replica=axes[j:])
            for qw, qg in q_opts:
                # secondary is an INT8 copy sliced from the quantized forward
                # gather (linear._gather_full): needs qw and a real gather
                secs: list[tuple[str, ...] | None] = [None]
                if qw and i > 0:
                    secs += [axes[:m] for m in range(1, k + 1)]
                if qw and i == 0:
                    continue   # w_degree==1: nothing to gather or compress
                for sec in secs:
                    cfg = ZeroConfig(
                        dataclasses.replace(za, secondary=sec), sizes,
                        quantize_weights=qw, quantize_grads=qg, name="auto")
                    cfg.validate_dependency_rule()
                    key = (za.weight, za.extra_grad, za.replica, sec, qw, qg)
                    if key not in seen:
                        seen.add(key)
                        out.append(cfg)
    return out


def plan(topo: Topology, wl: Workload, *,
         memory_budget: float | None = None,
         quantize: bool | None = None,
         top_k: int | None = None) -> list[Plan]:
    """Rank the whole scheme space by predicted step time under the budget.

    Plans that exceed the memory budget sort after every plan that fits
    (they are still reported — on a toy mesh nothing may fit the default
    HBM budget and the ranking is still the deliverable).
    """
    plans = []
    for cfg in enumerate_candidates(topo, quantize=quantize):
        if wl.stream_grads:
            # carry the regime on the config so an engine built from the
            # chosen plan actually streams (scheme_config("auto"))
            cfg = dataclasses.replace(cfg, stream_grads=True)
        c = step_cost(cfg, topo, wl, memory_budget=memory_budget)
        plans.append(Plan(cfg, c, c.step_s(wl.hidden_fraction)))
    plans.sort(key=lambda p: (not p.cost.fits, p.step_s,
                              p.cost.memory_total))
    return plans[:top_k] if top_k else plans


def preset_on_topology(scheme: str, topo: Topology, **over) -> ZeroConfig:
    """Build a hand-written preset on this topology's tier split."""
    t = topo.tiers()
    return preset(scheme, intra_axes=t["intra"], inter_axes=t["inter"],
                  l0_axes=t["l0"] or None, axis_sizes=dict(topo.axis_sizes),
                  **over)


def plan_for_mesh(mesh, *, psi: float | None = None,
                  n_layers: int | None = None,
                  memory_budget: float | None = None,
                  stream_grads: bool = False,
                  top_k: int | None = None, **topo_kw) -> list[Plan]:
    """Run the planner against a live mesh (``--scheme auto``).

    Axis link data comes from ``Topology.from_mesh`` tier defaults unless
    overridden.  ``psi``/``n_layers`` default to the paper's 20B / 44-layer
    evaluation model when the caller has no model at hand.
    ``stream_grads`` prices (and tags) the streaming grad regime.
    """
    topo = Topology.from_mesh(mesh, **topo_kw)
    wl = Workload(psi=float(psi) if psi else 20e9,
                  n_layers=int(n_layers) if n_layers else 44,
                  stream_grads=stream_grads)
    budget = memory_budget if memory_budget is not None else float("inf")
    # default budget inf: the live mesh is often fake CPU devices — ranking,
    # not feasibility, is the deliverable there; real launches pass a budget
    return plan(topo, wl, memory_budget=budget, top_k=top_k)


def model_workload(model_name: str, *, n_microbatch: int = 4,
                   tokens_per_device_mb: int = 2048,
                   stream_grads: bool = False) -> Workload:
    """Workload from a registered architecture (CLI helper).

    Accepts registry names with ``_`` or ``-`` separators
    (``gpt_neox_20b`` == ``gpt-neox-20b``).
    """
    from ..models.registry import build_model, get_arch, list_archs
    names = {n.replace("-", "_").replace(".", "_"): n for n in list_archs()}
    canon = model_name.replace("-", "_").replace(".", "_")
    if canon not in names and model_name not in list_archs():
        raise SystemExit(f"unknown model {model_name!r}; "
                         f"known: {', '.join(list_archs())}")
    arch = get_arch(names.get(canon, model_name))
    psi = build_model(arch).param_count()
    return Workload(psi=float(psi), n_layers=arch.n_layers,
                    n_microbatch=n_microbatch,
                    tokens_per_device_mb=tokens_per_device_mb,
                    stream_grads=stream_grads)


def replan_from_checkpoint(ckpt: str, topo: Topology, *,
                           step: int | None = None,
                           memory_budget: float | None = None,
                           stream_grads: bool = False,
                           top_k: int | None = None):
    """Elastic re-plan (DESIGN.md §11): price the SURVIVING topology for the
    workload recorded in a checkpoint's meta.json and rank new schemes.

    ``ckpt`` is either a ``step_NNNNNNNN`` directory or a checkpoint root
    (latest step picked). The workload is recovered from the checkpoint
    itself — psi from the primaries' global shapes, layer count from the
    stacked leading dim — so no model registry lookup is needed; the chosen
    scheme is what ``launch.train --scheme auto --resume`` would build on
    the new mesh, and the elastic restore path reshards the checkpoint onto
    it. Returns ``(meta, workload, plans)``. Reads only meta.json of a v1
    checkpoint (either package's: ``train/checkpoint.py``).
    """
    import json
    from pathlib import Path
    p = Path(ckpt)
    if not p.name.startswith("step_"):
        steps = sorted(int(q.name.split("_")[1]) for q in p.glob("step_*"))
        if step is None:
            if not steps:
                raise SystemExit(f"no checkpoints under {ckpt}")
            step = steps[-1]
        p = p / f"step_{step:08d}"
    meta = json.loads((p / "meta.json").read_text())
    shapes = {k: v for k, v in meta.get("global_shapes", {}).items()
              if k.startswith("primaries/")}
    if not shapes:
        raise SystemExit(f"{p}/meta.json records no primaries leaves")
    psi = sum(math.prod(v) for v in shapes.values())
    n_layers = max([v[0] for v in shapes.values() if len(v) == 2],
                   default=1)
    wl = Workload(psi=float(psi), n_layers=int(n_layers),
                  stream_grads=stream_grads)
    return meta, wl, plan(topo, wl, memory_budget=memory_budget,
                          top_k=top_k)


@dataclass(frozen=True)
class ServePlan:
    """One serving layout: residency axes x backend (DESIGN.md §12)."""
    res_axes: tuple[str, ...]
    resident: bool
    cost: ServeStepCost
    tok_s: float

    @property
    def label(self) -> str:
        ax = "+".join(self.res_axes) if self.res_axes else "-"
        return f"res={ax} {'int8-wire' if self.resident else 'fp-gathered'}"


def serve_workload_for_model(model_name: str, *, n_slots: int = 8,
                             context: int = 1024, max_len: int = 2048,
                             page_size: int = 16,
                             quant_block: int = 64) -> ServeWorkload:
    """Serving workload from a registered architecture, with the exact
    all-layer KV bytes/token taken from ``model.cache_shapes`` (the same
    source of truth the paged pool provisions from)."""
    import torch

    from ..models.config import ShapeConfig
    from ..models.registry import build_model, get_arch, list_archs
    names = {n.replace("-", "_").replace(".", "_"): n for n in list_archs()}
    canon = model_name.replace("-", "_").replace(".", "_")
    if canon not in names and model_name not in list_archs():
        raise SystemExit(f"unknown model {model_name!r}; "
                         f"known: {', '.join(list_archs())}")
    arch = get_arch(names.get(canon, model_name))
    model = build_model(arch)
    shape = ShapeConfig("plan", max_len, n_slots, "decode")
    kv_per_tok = 0.0
    for entry in model.cache_shapes(shape).values():
        for (shp, dtype, seq_shard) in entry.values():
            if seq_shard:   # (count, b, s, *tail): bytes/token = count * tail
                kv_per_tok += shp[0] * math.prod(shp[3:]) \
                    * torch.empty((), dtype=dtype).element_size()
    return ServeWorkload(psi=float(model.param_count()),
                         n_layers=arch.n_layers, d_model=arch.d_model,
                         n_slots=n_slots, context=context, max_len=max_len,
                         kv_bytes_per_token=kv_per_tok, page_size=page_size,
                         quant_block=quant_block)


def plan_serve(topo: Topology, wl: ServeWorkload, *,
               memory_budget: float | None = None,
               top_k: int | None = None) -> list[ServePlan]:
    """Rank serving layouts: every residency axis-prefix x backend.

    The trade is the serving analog of the training weight axes: a larger
    residency degree shrinks per-device wire bytes but pays the per-layer
    re-gather on every decoded token. Fitting layouts rank first, then by
    predicted tokens/s (descending), then by memory."""
    axes = topo.axis_names
    out = []
    for i in range(len(axes) + 1):
        for resident in (True, False):
            c = serve_step_cost(topo, wl, axes[:i], resident=resident,
                                memory_budget=memory_budget)
            out.append(ServePlan(axes[:i], resident, c, c.tokens_per_s()))
    out.sort(key=lambda p: (not p.cost.fits, -p.tok_s, p.cost.memory_total))
    return out[:top_k] if top_k else out


def format_serve_plans(plans: list[ServePlan], top_k: int = 8) -> str:
    rows = [f"{'#':>3s} {'tok/s':>10s} {'step(ms)':>9s} {'comm(ms)':>9s} "
            f"{'mem/dev':>9s} {'AI':>7s} {'fits':>4s}  layout"]
    for r, p in enumerate(plans[:top_k], 1):
        rows.append(
            f"{r:3d} {p.tok_s:10.1f} {p.cost.step_s() * 1e3:9.3f} "
            f"{p.cost.comm_total_s * 1e3:9.3f} "
            f"{p.cost.memory_total / 1e9:8.2f}G "
            f"{p.cost.arithmetic_intensity():7.1f} "
            f"{'y' if p.cost.fits else 'N':>4s}  {p.label}")
    return "\n".join(rows)


def format_plans(plans: list[Plan], presets: dict[str, Plan] | None = None,
                 top_k: int = 8) -> str:
    rows = [f"{'#':>3s} {'step(s)':>9s} {'comm(s)':>9s} {'mem/dev':>9s} "
            f"{'fits':>4s}  scheme"]
    for r, p in enumerate(plans[:top_k], 1):
        rows.append(f"{r:3d} {p.step_s:9.4f} {p.cost.comm_total_s:9.4f} "
                    f"{p.cost.memory_total / 1e9:8.2f}G "
                    f"{'y' if p.cost.fits else 'N':>4s}  {p.label}")
    if presets:
        rows.append("  -- hand-written presets, same cost model --")
        for name, p in presets.items():
            rows.append(f"    {p.step_s:9.4f} {p.cost.comm_total_s:9.4f} "
                        f"{p.cost.memory_total / 1e9:8.2f}G "
                        f"{'y' if p.cost.fits else 'N':>4s}  "
                        f"{name}: {p.label}")
    return "\n".join(rows)


def build_parser():
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.topo.planner",
        description="rank ZeRO partition schemes on a topology")
    ap.add_argument("--topology", default="frontier",
                    help="preset name (frontier/gpu_pod/tpu) or JSON path")
    ap.add_argument("--model", default="gpt_neox_20b",
                    help="registered architecture for the workload")
    ap.add_argument("--replan-from", default="",
                    help="checkpoint dir (root or step_NNNNNNNN): take the "
                         "workload from its meta.json and re-plan for the "
                         "surviving --topology; adopt the choice by "
                         "relaunching with --scheme auto --resume "
                         "(elastic restore reshards the checkpoint)")
    ap.add_argument("--n-microbatch", type=int, default=4)
    ap.add_argument("--tokens-per-device", type=int, default=2048)
    ap.add_argument("--budget-gb", type=float, default=0.0,
                    help="per-device memory budget; 0 = topology HBM")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--no-quant", action="store_true",
                    help="restrict the search to unquantized collectives")
    ap.add_argument("--stream-grads", action="store_true",
                    help="price the streaming grad regime (DESIGN.md §8): "
                         "per-layer grad RS overlapped with the backward, "
                         "grad memory at os-shard layout")
    ap.add_argument("--save-topology", default="",
                    help="write the resolved topology JSON here and exit")
    ap.add_argument("--serve", action="store_true",
                    help="rank SERVING layouts instead of training schemes: "
                         "residency axis-prefixes x {int8-wire, fp-gathered} "
                         "priced by per-token gather/dequant volume, KV-page "
                         "traffic, and batch-dependent arithmetic intensity "
                         "(DESIGN.md §12)")
    ap.add_argument("--slots", type=int, default=8,
                    help="live decode slots (serve workload batch)")
    ap.add_argument("--context", type=int, default=1024,
                    help="mean live context per slot, tokens (serve)")
    ap.add_argument("--max-len", type=int, default=2048,
                    help="paged-pool provisioning length per slot (serve)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens (serve)")
    return ap


def main(argv=None):
    """The planner CLI; its output is the reference's, byte for byte, the
    commands it names included (the two packages take the same flags)."""
    ap = build_parser()
    args = ap.parse_args(argv)

    topo = load_topology(args.topology)
    if args.save_topology:
        print(topo.save(args.save_topology))
        return 0
    budget = args.budget_gb * 1e9 if args.budget_gb else None
    if args.serve:
        swl = serve_workload_for_model(
            args.model, n_slots=args.slots, context=args.context,
            max_len=args.max_len, page_size=args.page_size)
        plans_s = plan_serve(topo, swl, memory_budget=budget)
        print(f"topology {topo.name}: " + ", ".join(
            f"{l.name}({l.size}) {l.bandwidth / 1e9:.0f}GB/s {l.tier}"
            for l in topo.links) + f"  [{topo.n_devices} devices]")
        print(f"serve workload: psi={swl.psi / 1e9:.1f}B params, "
              f"{swl.n_layers} layers, {swl.n_slots} slots x "
              f"{swl.context} ctx (max {swl.max_len}), "
              f"{swl.kv_token_bytes() / 1e3:.1f}KB KV/token, "
              f"page={swl.page_size}")
        print(format_serve_plans(plans_s, top_k=args.top))
        best = plans_s[0]
        print(f"serve: residency over {best.label} — adopt with "
              f"`repro.launch.serve --backend "
              f"{'resident' if best.resident else 'gathered'}"
              + (f" --res-axes {','.join(best.res_axes)}`"
                 if best.res_axes else "`"))
        return 0
    if args.replan_from:
        meta, wl, plans = replan_from_checkpoint(
            args.replan_from, topo, memory_budget=budget,
            stream_grads=args.stream_grads)
        saved_mesh = meta.get("mesh", {})
        saved_scheme = meta.get("scheme", {})
        print(f"re-planning from checkpoint step {meta.get('step')}: "
              f"psi={wl.psi / 1e9:.2f}B (padded), {wl.n_layers} layers")
        print(f"  written on: {dict(zip(saved_mesh.get('axes', []), saved_mesh.get('shape', [])))} "
              f"{saved_mesh.get('process_count')} process(es), "
              f"scheme={saved_scheme.get('scheme')} "
              f"degrees={saved_scheme.get('degrees')}")
        print(f"  surviving topology {topo.name}: " + ", ".join(
            f"{l.name}({l.size}) {l.bandwidth / 1e9:.0f}GB/s {l.tier}"
            for l in topo.links) + f"  [{topo.n_devices} devices]")
        print(format_plans(plans, top_k=args.top))
        print("adopt: relaunch `repro.launch.train --scheme auto --resume "
              "--ckpt-dir ...` on the surviving mesh — elastic restore "
              "reshards every leaf onto the new layout (DESIGN.md §11)")
        return 0
    wl = model_workload(args.model, n_microbatch=args.n_microbatch,
                        tokens_per_device_mb=args.tokens_per_device,
                        stream_grads=args.stream_grads)
    plans = plan(topo, wl, memory_budget=budget,
                 quantize=False if args.no_quant else None)
    presets = {}
    for scheme in ("zero3", "zeropp", "zero_topo"):
        # presets priced in the same regime so the dominance check compares
        # like with like
        cfg = preset_on_topology(scheme, topo,
                                 stream_grads=args.stream_grads)
        c = step_cost(cfg, topo, wl, memory_budget=budget)
        presets[scheme] = Plan(cfg, c, c.step_s(wl.hidden_fraction))

    print(f"topology {topo.name}: " + ", ".join(
        f"{l.name}({l.size}) {l.bandwidth / 1e9:.0f}GB/s {l.tier}"
        for l in topo.links) + f"  [{topo.n_devices} devices]")
    print(f"workload: psi={wl.psi / 1e9:.1f}B params, {wl.n_layers} layers, "
          f"{wl.n_microbatch}x{wl.tokens_per_device_mb} tokens/device/step, "
          f"{len(plans)} candidate schemes")
    print(format_plans(plans, presets, top_k=args.top))

    # dominance is within the same feasibility class: a preset that blows
    # the memory budget may have a lower raw step time, but the planner
    # correctly ranks every fitting plan ahead of it
    def rank_key(p):
        return (not p.cost.fits, p.step_s)

    best = plans[0]
    fastest_preset = min(presets.values(), key=rank_key)
    worst_preset = max(presets.values(), key=rank_key)
    print(f"planner choice is {fastest_preset.step_s / best.step_s:.2f}x the "
          f"best preset, {worst_preset.step_s / best.step_s:.2f}x the worst"
          + ("" if fastest_preset.cost.fits else
             "  (no preset fits the memory budget)"))
    if args.no_quant:
        # the quantized presets are outside the restricted search space, so
        # dominance is not guaranteed (the comparison is informational)
        print("note: search restricted to unquantized schemes; quantized "
              "presets may rank faster")
    else:
        assert rank_key(best) <= rank_key(fastest_preset), \
            "planner must never rank below a preset (presets are in the space)"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
