"""Measured-vs-predicted calibration loop (DESIGN.md §10).

    PYTHONPATH=src python -m repro_torch.obs.calibrate [--device cpu] \
        [--scheme zero_topo] [--steps 4] [--out-topology topo_calibrated.json]

Port of ``repro.obs.calibrate``. Runs a reduced-model traced loop on the
ranks of ``--mesh`` (``launch.train.spawn``: local processes over gloo, on
the card unless ``--device cpu``): the engine's own fenced step
(``ZeroEngine.train_step(..., rec=)``) plus the out-of-band
comm-attribution probes of ``obs.phased``. Rank 0 returns its spans; this
process takes the per-phase medians, compares them with
``topo.cost.phase_breakdown``'s prediction for the same ZeroConfig,
reports per-phase error, and back-solves effective link bandwidths into a
calibrated ``Topology`` JSON the planner consumes
(``python -m repro_torch.topo.planner --topology <file>``), so
``--scheme auto`` can plan off *measured*, not preset, bandwidths.

Back-solve: the model prices each phase as ``wire_bytes/bandwidth(axes) +
latency_s`` with the bottleneck axis setting the bandwidth
(``topo.cost.phase_breakdown``). Holding the latency model fixed, a
measurement ``m`` inverts to ``eff_bw = wire_bytes / max(m - latency_s,
eps)``, attributed to that phase's bottleneck axis; the per-axis median
over phases becomes the calibrated link bandwidth. Ranks that share one
host and talk through gloo measure that host's memory, not a cluster's
links: the numbers then describe this machine, and the point is the
loop's plumbing; on a real cluster the same command calibrates real links.

The overlap A/B (skipped under ``--quick``) measures how much in-loop comm
the §3 schedule actually hides: the same model's fwd_bwd segment with
overlap off vs on — ``hidden = clamp(t_serial - t_overlap, 0, comm)`` —
the measured counterpart of ``Workload.hidden_fraction``.

``--quick``: two measured steps and no A/B. The reference also writes
``BENCH_obs.json`` there (``--emit-bench``), a census of its compiled XLA
step; the port has no such census yet and refuses ``--emit-bench``.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

RANK_TIMEOUT_S = 900.0


def _rank(rank: int, world: int, args, overlap: bool, stream: bool,
          steps: int, warmup: int):
    """One rank of the traced run: warmup + measured steps of the engine's
    fenced step, then one probe pass. Rank 0 returns its spans (the
    measured steps' phase seconds and segments, every step's wall time)
    with the config and workload it ran; the other ranks return None."""
    import numpy as np
    import torch

    from ..core.engine import TrainHparams, ZeroEngine
    from ..device import resolve
    from ..launch.mesh import Mesh, scheme_config
    from ..models.registry import build_model, get_arch
    from .phased import PhasedStep
    from .spans import SEGMENTS, SpanRecorder

    device = resolve(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    elif world > 1:
        torch.set_num_threads(1)
    mesh = Mesh(tuple(args.mesh), tuple(args.axes), rank)
    cfg = scheme_config(args.scheme, mesh, quant_block=args.quant_block,
                        overlap=overlap, stream_grads=stream)
    arch = get_arch(args.model).reduced(
        n_layers=args.n_layers, d_model=args.d_model, vocab=args.vocab)
    model = build_model(arch)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh,
                     TrainHparams(lr=1e-3, total_steps=64, warmup_steps=0,
                                  n_microbatch=args.n_microbatch), device)
    # one row per rank per microbatch, sharded over every mesh axis: this
    # rank's rows are block ``rank`` of the global batch
    n_mb = max(args.n_microbatch, 1)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, args.vocab, (n_mb * mesh.size, args.seq),
                          dtype=np.int32)
    batch = {"tokens": torch.from_numpy(
        tokens[rank * n_mb:(rank + 1) * n_mb]).long().to(device)}
    loss_fn = model.lm.loss
    state = eng.init_state(0)
    rec = SpanRecorder(device=device)
    walls = []
    for i in range(warmup + steps):
        rec.step = i
        t0 = time.perf_counter()
        state, _ = eng.train_step(loss_fn, state, batch, rec=rec)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    phased = PhasedStep(eng, loss_fn)
    phased.run_probes(state, batch, rec)
    if rank:
        return None
    probe = phased.last_probe(rec)
    measured = range(warmup, warmup + steps)
    return dict(
        cfg=cfg, arch=arch.name, n_layers=arch.n_layers,
        psi=eng.param_count(), walls=walls,
        phases=[phased.phase_seconds(rec, i, probe) for i in measured],
        segments=[{k: v for k, v in rec.step_seconds(i).items()
                   if k in SEGMENTS} for i in measured])


def _measure(args, overlap: bool, stream: bool, *, steps: int, warmup: int):
    """Traced run on the mesh's ranks (this process alone for one rank):
    rank 0's per-phase and per-segment medians over the measured steps,
    and the median share of a step's wall time its fenced segments cover."""
    from ..launch import train

    n = 1
    for d in args.mesh:
        n *= d
    fn_args = (args, overlap, stream, steps, warmup)
    if n == 1:
        run = _rank(0, 1, *fn_args)
    else:
        run = train.spawn(_rank, n, RANK_TIMEOUT_S, args.device != "cpu",
                          fn_args, what="calibration")[0]
    per_step = run["phases"]
    run["phase"] = {k: statistics.median([p[k] for p in per_step])
                    for k in per_step[0]}
    run["seg"] = {name: statistics.median([s[name] for s in run["segments"]])
                  for name in run["segments"][0]}
    # spans-sum vs wall coverage over the measured steps (the fenced
    # segments account for the step, within 10%)
    walls = run["walls"][warmup:]
    run["coverage"] = statistics.median(
        sum(s.values()) / w if w > 0 else 0.0
        for s, w in zip(run["segments"], walls))
    return run


def solve_bandwidths(predicted: dict, measured_phase: dict,
                     *, eps: float = 1e-9) -> dict[str, float]:
    """Invert the cost model per phase and reduce to per-axis medians.

    ``predicted`` is ``topo.cost.phase_breakdown`` output; ``measured_phase``
    maps phase name -> measured seconds at the same cadence.
    """
    per_axis: dict[str, list[float]] = {}
    for ph, rec in predicted.items():
        m = measured_phase.get(ph, 0.0)
        if not rec["wire_bytes"] or rec["bottleneck"] is None or m <= 0:
            continue
        eff = rec["wire_bytes"] / max(m - rec["latency_s"], eps)
        per_axis.setdefault(rec["bottleneck"], []).append(eff)
    return {ax: statistics.median(vals) for ax, vals in per_axis.items()}


def build_parser() -> argparse.ArgumentParser:
    """The calibration CLI: the reference's flags and defaults, plus
    ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.calibrate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="qwen2-0.5b")
    ap.add_argument("--scheme", default="zero_topo")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--stream-grads", action="store_true")
    ap.add_argument("--n-microbatch", type=int, default=2)
    ap.add_argument("--quant-block", type=int, default=64)
    ap.add_argument("--mesh", type=lambda s: [int(x) for x in s.split(",")],
                    default=[2, 2, 2])
    ap.add_argument("--axes", type=lambda s: s.split(","),
                    default=["data", "node", "gcd"])
    ap.add_argument("--seq", type=int, default=33)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4,
                    help="measured steps (after one compile/warmup step)")
    ap.add_argument("--topology", default="",
                    help="preset name or Topology JSON to calibrate "
                         "(default: Topology.from_mesh of the live mesh)")
    ap.add_argument("--out-topology", default="topo_calibrated.json",
                    help="where to write the calibrated Topology JSON")
    ap.add_argument("--quick", action="store_true",
                    help="2 measured steps, no overlap A/B")
    ap.add_argument("--emit-bench", action="store_true",
                    help="BENCH_obs.json: not written by the port yet (it "
                         "needs a census of the compiled step); refused")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.emit_bench:
        ap.error("--emit-bench: BENCH_obs.json needs a census of the "
                 "compiled step, which the port does not have yet")
    from ..device import resolve
    resolve(args.device)      # no card for --device cuda: raise here, once

    from ..launch.mesh import Mesh
    from ..topo import cost as tcost
    from ..topo.model import Topology, calibrated, load_topology

    steps = 2 if args.quick else args.steps
    run = _measure(args, args.overlap, args.stream_grads,
                   steps=steps, warmup=1)
    cfg = run["cfg"]
    mesh = Mesh(tuple(args.mesh), tuple(args.axes))

    topo = load_topology(args.topology) if args.topology \
        else Topology.from_mesh(mesh)
    wl = tcost.Workload(   # one row of --seq tokens a device a microbatch
        psi=float(run["psi"]), n_layers=run["n_layers"],
        tokens_per_device_mb=args.seq,
        n_microbatch=args.n_microbatch, stream_grads=cfg.stream_grads)
    pred = tcost.phase_breakdown(cfg, topo, wl)

    print(f"calibrate: {run['arch']}/{cfg.name} on {topo.name} "
          f"({steps} measured steps, n_mb={args.n_microbatch})")
    print(f"span/wall coverage (median): {run['coverage']:.3f}")
    print(f"{'phase':<16}{'measured_ms':>12}{'predicted_ms':>14}{'error':>9}")
    for ph in tcost.PHASES:
        m = run["phase"].get(ph, 0.0)
        p = pred[ph]["seconds"]
        err = f"{(m - p) / p:+8.1%}" if p > 0 else "      --"
        print(f"{ph:<16}{m * 1e3:>12.2f}{p * 1e3:>14.3f}{err:>9}")
    mcomp = run["phase"].get("compute", 0.0)
    pcomp = 6.0 * wl.psi * wl.n_microbatch * wl.tokens_per_device_mb \
        / topo.flops_per_device
    print(f"{'compute':<16}{mcomp * 1e3:>12.2f}{pcomp * 1e3:>14.3f}")

    # measured overlap A/B: same model, §3 prefetch off vs on
    if not args.quick:
        serial = _measure(args, False, args.stream_grads, steps=steps,
                          warmup=1)
        over = _measure(args, True, args.stream_grads, steps=steps, warmup=1)
        comm = sum(run["phase"].get(ph, 0.0)
                   for ph in ("fwd_allgather", "bwd_allgather", "grad_rs_w"))
        hidden = min(max(serial["seg"].get("fwd_bwd", 0.0)
                         - over["seg"].get("fwd_bwd", 0.0), 0.0), comm)
        frac = hidden / comm if comm > 0 else 0.0
        print(f"overlap A/B: fwd_bwd serial "
              f"{serial['seg'].get('fwd_bwd', 0.0) * 1e3:.2f}ms vs "
              f"overlapped {over['seg'].get('fwd_bwd', 0.0) * 1e3:.2f}ms -> "
              f"hidden {hidden * 1e3:.2f}ms "
              f"({frac:.2f} of in-loop comm; "
              f"model hidden_fraction={wl.hidden_fraction})")

    eff = solve_bandwidths(pred, run["phase"])
    for ax, bw in sorted(eff.items()):
        print(f"effective bandwidth[{ax}]: {bw / 1e9:.3f} GB/s "
              f"(preset {topo.link(ax).bandwidth / 1e9:.3f})")
    cal = calibrated(topo, eff)
    if args.out_topology:
        cal.save(args.out_topology)
        print(f"wrote calibrated topology -> {args.out_topology} "
              f"(feed to: python -m repro_torch.topo.planner --topology "
              f"{args.out_topology})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
