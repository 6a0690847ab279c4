"""The dry run: one rank's training step, prefill or decode step of any
(architecture x input shape x mesh x scheme) traced on ``meta`` tensors
over a fake process group of the mesh's world size, with no allocation, and
its census, memory and H100 roofline recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gemma3-1b --shape train_4k --mesh prod --scheme zero_topo

    --arch all --shape all --mesh prod,prod_mp   # the reference's sweep

Port of ``repro.launch.dryrun``. The reference lowers and compiles the SPMD
program of a step on 512 forced host devices with ``ShapeDtypeStruct``
stand-ins and parses its HLO (``launch/hlo.py``). Here this process is rank
0 of a ``fake`` process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: collectives accept meta
tensors and move nothing), the state is the engine's ``abstract_state``
(``ZeroEngine.abstract``), and ``launch.census.Census`` counts the step as
it runs. Where the card would launch a kernel, the plain version runs on
meta and the census counts a would-be launch. Records go to
``experiments/dryrun_torch/`` with the reference's keys (``compile_s`` is
the trace's seconds; ``cost_analysis`` repeats the census's totals, which
count every loop trip).

Exit code != 0 if any combination fails to trace: a shape mismatch, a
collective without a group or a read of the device from the host are
bugs. ``--save-hlo`` and ``--kernel-impl pallas*`` mean something to XLA
only and are refused. The reference's multi-process flags are not here: a
process traces rank 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from .mesh import make_production_mesh, make_topo_mesh

MESHES = {
    "prod": make_production_mesh,
    "prod_mp": lambda: make_production_mesh(multi_pod=True),
    "topo": make_topo_mesh,
    "topo_mp": lambda: make_topo_mesh(multi_pod=True),
}
SERVE_MODES = ("zero", "resident", "zero_sp", "resident_sp")
OUT = "experiments/dryrun_torch"


def train_batch_candidates(mesh):
    """Batch-shard axes for training: every non-pod axis (ZeRO = pure DP),
    pod last (replicated unless batch demands it)."""
    return tuple(a for a in mesh.axis_names if a != "pod")


def mesh_for(name: str):
    """A mesh of ``MESHES`` by name, or ``"d,n,g"``: the (data, node, gcd)
    mesh of those sizes that the train and serve CLIs run (their
    ``--mesh-shape``), as rank 0 sees it."""
    if name in MESHES:
        return MESHES[name]()
    from .mesh import TEST_AXES, Mesh
    try:
        shape = tuple(int(x) for x in name.split(","))
    except ValueError:
        shape = ()
    if len(shape) != len(TEST_AXES):
        raise ValueError(f"mesh {name!r}: one of {', '.join(MESHES)} or "
                         "data,node,gcd sizes")
    return Mesh(shape, TEST_AXES, 0)


def arch_for(name: str, layers: int = 0):
    """``get_arch(name)``, at its published width and its first ``layers``
    layers when ``layers`` is given (its block pattern and encoder cut
    alike), named ``<name>@L<layers>``."""
    from ..models.registry import get_arch
    a = get_arch(name)
    if not layers:
        return a
    return dataclasses.replace(a, name=f"{a.name}@L{layers}", n_layers=layers,
                               block_pattern=a.pattern[:layers],
                               enc_layers=min(a.enc_layers, layers))


def shape_for(name: str, batch: int = 0, seq: int = 0):
    """``SHAPES[name]``, its global batch and sequence length replaced by
    ``batch`` / ``seq`` where given (named ``<name>@b<B>s<S>``)."""
    from ..models.config import SHAPES
    sh = SHAPES[name]
    if not (batch or seq):
        return sh
    b, s = batch or sh.global_batch, seq or sh.seq_len
    return dataclasses.replace(sh, name=f"{name}@b{b}s{s}", global_batch=b,
                               seq_len=s)


def fake_group(world: int, rank: int = 0) -> None:
    """This process as rank ``rank`` of a ``fake`` process group of
    ``world`` ranks (re-initialised when the world differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _train_batch(model, shape, mesh, device) -> dict:
    """This rank's rows of a training batch as the trainer hands them to
    the step (tokens int64, the rest f32), uninitialised on ``device``."""
    import torch

    from ..models.registry import batch_axes
    baxes = batch_axes(mesh, shape.global_batch,
                       candidates=train_batch_candidates(mesh))
    rows = shape.global_batch // mesh.axis_size(baxes)
    return {k: torch.empty((rows,) + tuple(sh[1:]),
                           dtype=torch.long if k == "tokens" else torch.float32,
                           device=device)
            for k, (sh, _) in model.train_batch_shapes(shape).items()}


def trace_combo(arch_name: str, shape_name: str, mesh_name: str,
                scheme: str, quant_block: int = 2048,
                serve_mode: str = "zero", engine_opts: dict | None = None,
                layers: int = 0, batch: int = 0, seq: int = 0):
    """Set up rank 0 of the combination on its mesh (this process rank 0
    of a fake group of the mesh's size; ``mesh_for``), the arch
    cut to ``layers`` and the shape's batch / sequence replaced where given
    (``arch_for``, ``shape_for``), and trace its step (``trace_step``).
    Returns (engine, arch, shape, trace)."""
    from ..core.engine import TrainHparams, ZeroEngine
    from ..models.registry import build_model
    from .mesh import scheme_config

    t0 = time.perf_counter()
    mesh = mesh_for(mesh_name)
    fake_group(mesh.size)
    arch = arch_for(arch_name, layers)
    shape = shape_for(shape_name, batch, seq)
    model = build_model(arch)
    planner_kw = {}
    if scheme == "auto":
        planner_kw = dict(psi=model.param_count(), n_layers=arch.n_layers)
    cfg = scheme_config(scheme, mesh, quant_block=quant_block, **planner_kw)
    if engine_opts:
        cfg = dataclasses.replace(cfg, **engine_opts)
    eng = ZeroEngine.abstract(model.leaf_specs(), cfg, mesh, TrainHparams())
    trace = trace_step(model, eng, shape, serve_mode)
    # the set-up is everything but the trace: mesh, group, engine, inputs
    trace["setup_s"] = time.perf_counter() - t0 - trace["trace_s"]
    return eng, arch, shape, trace


def trace_step(model, eng, shape, serve_mode: str = "zero") -> dict:
    """One step of ``shape`` on this rank of ``eng.mesh`` (a training step
    through ``ZeroEngine.train_step``; a prefill or decode step through
    ``ServeEngine``, or ``ResidentServeEngine`` for the ``resident`` serve
    modes, ``*_sp`` the sequence-parallel prefill), from the abstract state
    on meta, under a ``Census``. ``eng`` is ``ZeroEngine.abstract``'s, its
    mesh bound over this process's (fake) group. Returns the census, the
    step's argument, output and aliased output bytes, and the set-up and
    trace seconds."""
    import torch
    from torch.utils._pytree import tree_leaves

    from .census import Census, _nbytes, _storage

    t0 = time.perf_counter()
    mesh, cfg, meta = eng.mesh, eng.cfg, eng.device
    if shape.kind == "train":
        state = eng.abstract_state()
        batch = _train_batch(model, shape, mesh, meta)
        args = (state, batch)

        def step():
            return eng.train_step(model.lm.loss, state, batch)
    else:
        if "resident" in serve_mode:
            from ..serve.resident import ResidentLayout, ResidentServeEngine
            layout = ResidentLayout(model.leaf_specs(), cfg, mesh=mesh)
            se = ResidentServeEngine(model, layout, shape, mesh)
            params = se.abstract_params(meta)
        else:
            from ..serve.engine import ServeEngine
            se = ServeEngine(model, eng, mesh, shape)
            params = eng.abstract_primaries()
        if shape.kind == "prefill":
            fn = se.make_prefill(seq_parallel="sp" in serve_mode)
            batch = se.prefill_inputs(meta)
            args = (params, batch)
        else:
            fn = se.make_decode()
            caches, batch = se.decode_inputs(meta)
            args = (params, caches, batch)

        def step():
            return fn(*args)
    arg_storages = {_storage(t) for t in tree_leaves(args)
                    if isinstance(t, torch.Tensor)}
    out = dict(argument_bytes=_nbytes(args),
               setup_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with Census() as census:
        res = step()
    out["trace_s"] = time.perf_counter() - t0
    outs = [t for t in tree_leaves(res) if isinstance(t, torch.Tensor)]
    out.update(census=census,
               output_bytes=_nbytes(outs),
               alias_bytes=_nbytes([t for t in outs
                                    if _storage(t) in arg_storages]))
    return out


def _topology(mesh, topology: str):
    """The mesh's synthetic topology, overlaid with ``topology``'s link
    bandwidths where its links share an axis name."""
    from ..topo.model import Topology, calibrated, load_topology
    topo = Topology.from_mesh(mesh)
    if topology:
        src = load_topology(topology)
        known = {l.name: l.bandwidth for l in src.links}
        topo = calibrated(
            topo, {l.name: known[l.name] for l in topo.links
                   if l.name in known},
            name=f"{topo.name}<-{src.name}")
    return topo


def compare_phases(eng, arch, shape, mesh, metrics_path, topology: str = ""):
    """Predicted-vs-measured per-phase table (the reference's DESIGN.md
    §10). Predicted: ``topo.cost.phase_breakdown`` for this combo's config
    on ``--topology`` (default: the mesh's synthetic topology; a file's
    link bandwidths replace the same-named axes'). Measured: the last
    ``phase_ms`` record of a ``--metrics-jsonl`` stream from a traced run
    (every rank lane merged). The two need not share a mesh."""
    from ..obs import metrics as obs_metrics
    from ..topo import cost as tcost
    topo = _topology(mesh, topology)
    n_mb = max(eng.hp.n_microbatch, 1)
    wl = tcost.Workload(
        psi=float(eng.param_count()), n_layers=arch.n_layers,
        tokens_per_device_mb=shape.global_batch * shape.seq_len
        // mesh.size // n_mb,
        n_microbatch=n_mb, stream_grads=eng.cfg.stream_grads)
    pred = tcost.phase_breakdown(eng.cfg, topo, wl)
    measured = obs_metrics.last_phase_ms(obs_metrics.read_lanes(metrics_path))
    rows = {}
    lines = [f"{'phase':<16}{'predicted_ms':>14}{'measured_ms':>14}"]
    for ph in tcost.PHASES:
        p = pred[ph]["seconds"] * 1e3
        m = measured.get(ph)
        rows[ph] = dict(predicted_ms=p, measured_ms=m)
        lines.append(f"{ph:<16}{p:>14.3f}" +
                     (f"{m:>14.2f}" if m is not None else f"{'--':>14}"))
    return rows, "\n".join(lines)


def compare_serve_phases(eng, arch, shape, mesh, metrics_path,
                         topology: str = "", resident: bool = True):
    """Predicted-vs-measured for one serving decode step (the reference's
    DESIGN.md §12). Predicted: ``topo.cost.serve_step_cost`` for this
    combo's residency layout on ``--topology`` (as ``compare_phases``).
    Measured: the last serve ``phase_ms`` record of a continuous-batching
    run's ``--metrics-jsonl`` stream (``launch.serve``): ``serve_decode``
    is the decode step, ``serve_admit`` the admission work; the per-layer
    comm phases are predicted only."""
    from ..obs import metrics as obs_metrics
    from ..topo import cost as tcost
    from ..topo.planner import serve_workload_for_model
    topo = _topology(mesh, topology)
    wl = serve_workload_for_model(
        arch.name, n_slots=shape.global_batch, context=shape.seq_len,
        max_len=shape.seq_len, quant_block=eng.cfg.quant_block)
    res_axes = tuple(eng.cfg.axes.secondary or ())
    pred = tcost.serve_step_cost(topo, wl, res_axes, resident=resident)
    measured = obs_metrics.last_phase_ms(obs_metrics.read_lanes(metrics_path))
    rows = {}
    lines = [f"{'phase':<16}{'predicted_ms':>14}{'measured_ms':>14}"]
    preds = dict(pred.comm_s)
    preds["serve_decode"] = pred.step_s()
    preds["serve_admit"] = None
    for ph in tcost.SERVE_PHASES + ("serve_decode", "serve_admit"):
        p = preds[ph]
        m = measured.get(ph)
        rows[ph] = dict(
            predicted_ms=None if p is None else p * 1e3, measured_ms=m)
        lines.append(
            f"{ph:<16}" +
            (f"{p * 1e3:>14.3f}" if p is not None else f"{'--':>14}") +
            (f"{m:>14.2f}" if m is not None else f"{'--':>14}"))
    return rows, "\n".join(lines)


def record_name(arch_name, shape_name, mesh_name, scheme,
                serve_mode: str = "zero", tag: str = "") -> str:
    name = f"{arch_name}__{shape_name}__{mesh_name}__{scheme}"
    if serve_mode != "zero":
        name += f"__{serve_mode}"
    if tag:
        name += f"__{tag}"
    return name


def run_combo(arch_name, shape_name, mesh_name, scheme, outdir: Path,
              quant_block: int = 2048, serve_mode: str = "zero",
              engine_opts: dict | None = None, tag: str = "",
              compare: str = "", topology: str = "", layers: int = 0,
              batch: int = 0, seq: int = 0):
    from . import roofline

    eng, arch, shape, tr = trace_combo(arch_name, shape_name, mesh_name,
                                       scheme, quant_block, serve_mode,
                                       engine_opts, layers, batch, seq)
    census, mesh = tr["census"], eng.mesh
    summary = census.summary()
    n_params = eng.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    rl = roofline.build(
        summary, n_chips=mesh.size, n_params=n_params,
        n_active_params=roofline.active_params(arch, n_params),
        tokens=tokens, kind=shape.kind)
    rec = dict(
        arch=arch.name, shape=shape.name, mesh=mesh_name, scheme=scheme,
        serve_mode=serve_mode, n_chips=mesh.size, n_params=n_params,
        target=roofline.H100_SXM.name,
        lower_s=round(tr["setup_s"], 1), compile_s=round(tr["trace_s"], 1),
        memory=dict(argument_bytes=tr["argument_bytes"],
                    output_bytes=tr["output_bytes"],
                    temp_bytes=census.temp_bytes,
                    alias_bytes=tr["alias_bytes"]),
        cost_analysis=dict(flops=summary["flops"],
                           bytes_accessed=summary["hbm_bytes"]),
        census=summary,
        roofline=rl.summary(),
    )
    if compare and shape.kind == "train":
        rows, table = compare_phases(eng, arch, shape, mesh, compare,
                                     topology)
        rec["phase_compare"] = rows
        print(table, flush=True)
    elif compare and shape.kind == "decode":
        rows, table = compare_serve_phases(
            eng, arch, shape, mesh, compare, topology,
            resident="resident" in serve_mode)
        rec["phase_compare"] = rows
        print(table, flush=True)
    outdir.mkdir(parents=True, exist_ok=True)
    name = record_name(arch.name, shape.name, mesh_name, scheme, serve_mode,
                       tag)
    (outdir / f"{name}.json").write_text(json.dumps(rec, indent=1))
    print(f"OK  {name}  setup={tr['setup_s']:.1f}s "
          f"trace={tr['trace_s']:.1f}s "
          f"bottleneck={rl.bottleneck} "
          f"terms(c/m/x)={rl.compute_s:.3f}/{rl.memory_s:.3f}/"
          f"{rl.collective_s:.3f}s", flush=True)
    return rec


def build_parser() -> argparse.ArgumentParser:
    """The dry-run CLI surface (rendered into docs/CLI_torch.md by
    ``repro_torch.launch.cli_reference``)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="trace one rank's step of (arch x shape x mesh x "
                    "scheme) combos on meta tensors over a fake process "
                    "group of the mesh's size, no allocation; census, "
                    "memory and the H100 roofline")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="prod",
                    help="comma-separated: " + ", ".join(MESHES) + "; or "
                         "one data,node,gcd mesh shape (e.g. 1,2,2: the "
                         "train CLI's --mesh-shape)")
    ap.add_argument("--layers", type=int, default=0,
                    help="trace the arch at published width and its first "
                         "N layers (0: all)")
    ap.add_argument("--batch", type=int, default=0,
                    help="replace the shape's global batch (0: keep)")
    ap.add_argument("--seq", type=int, default=0,
                    help="replace the shape's sequence length (0: keep)")
    ap.add_argument("--scheme", default="zero_topo",
                    help="comma-separated presets, or 'auto' for the "
                         "topology planner's choice on each mesh")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--quant-block", type=int, default=2048)
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: there is no HLO (the reference's flag)")
    ap.add_argument("--serve-mode", default="zero", choices=SERVE_MODES)
    ap.add_argument("--cross-replica", default="",
                    choices=["", "allreduce", "reduce_scatter"])
    ap.add_argument("--quant-update", action="store_true")
    ap.add_argument("--stream-grads", action="store_true",
                    help="trace the streaming gradient path (DESIGN.md §8)")
    ap.add_argument("--kernel-impl", default="",
                    choices=["", "plain", "pallas", "pallas_interpret"],
                    help="'plain': trace every kernel's plain version (no "
                         "would-be launches); empty: the kernels where the "
                         "card launches them; the pallas choices are "
                         "refused (XLA's)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--compare", default="",
                    help="metrics JSONL from a traced run (--metrics-jsonl): "
                         "print a predicted-vs-measured per-phase column for "
                         "each train combo (DESIGN.md §10); serve JSONL from "
                         "repro_torch.launch.serve does the same for decode "
                         "combos (DESIGN.md §12)")
    ap.add_argument("--topology", default="",
                    help="topology preset or JSON (e.g. obs.calibrate "
                         "output) pricing --compare's predicted column; "
                         "default: the live mesh's synthetic topology")
    return ap


def main(argv=None):
    from ..models.config import SHAPES, shape_supported
    from ..models.registry import get_arch, list_archs

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port traces on meta tensors and compiles "
                 "no HLO; the record carries the census")
    if args.kernel_impl.startswith("pallas"):
        ap.error(f"--kernel-impl {args.kernel_impl}: Pallas is XLA's; the "
                 "port traces its CUDA kernels' routes (default) or the "
                 "plain versions ('plain')")
    if args.compare and args.layers:
        ap.error("--compare prices each registered model at its full depth; "
                 "drop --layers")
    engine_opts = {}
    if args.cross_replica:
        engine_opts["cross_replica"] = args.cross_replica
    if args.quant_update:
        engine_opts["quantize_update_gather"] = True
    if args.stream_grads:
        engine_opts["stream_grads"] = True
    if args.kernel_impl:
        engine_opts["impl"] = args.kernel_impl

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    # default "all" = the 10 assigned archs (the paper's neox models by name)
    if args.arch == "all":
        archs = [a for a in archs if not a.startswith("gpt-neox")]
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [args.mesh] if args.mesh[:1].isdigit() \
        else args.mesh.split(",")
    for m in meshes:
        try:
            mesh_for(m)
        except ValueError as e:
            ap.error(f"--mesh: {e}")
    schemes = args.scheme.split(",")
    outdir = Path(args.out)

    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            if not shape_supported(get_arch(arch), SHAPES[shape]):
                print(f"SKIP {arch} {shape} (sub-quadratic attention "
                      f"required; see DESIGN.md)", flush=True)
                continue
            for mesh in meshes:
                for scheme in schemes:
                    try:
                        run_combo(arch, shape, mesh, scheme, outdir,
                                  args.quant_block, args.serve_mode,
                                  engine_opts or None, args.tag,
                                  args.compare, args.topology, args.layers,
                                  args.batch, args.seq)
                    except Exception as e:
                        failures.append((arch, shape, mesh, scheme, str(e)))
                        print(f"FAIL {arch} {shape} {mesh} {scheme}: "
                              f"{type(e).__name__}: {e}", flush=True)
                        traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print(f"\nall combinations traced in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
