"""Serving launcher: continuous batching over the paged KV pool, from the
training engine's primaries (``--backend gathered``, the reference's
default) or the INT8 wire residency (``--backend resident``), on one card or
on a mesh of ranks.

Port of ``repro.launch.serve`` with the same flags plus ``--device``
(default ``cuda``), ``--reduced``, ``--mesh-shape``, ``--timeout`` and the
distributed group of the train launcher (``--coordinator --num-processes --process-id``;
launch/distributed.py). The reference always serves the reduced model on
fake CPU devices; this launcher serves the published width unless
``--reduced`` is given (meant for the CPU).

``--devices N`` serves on the mesh ("data", "node", "gcd") of N ranks,
mapped as the train launcher maps it (``--mesh-shape``, else (N/4, 2, 2),
or (1, 1, N) for N = 1, 2): N local processes forked from the train
launcher's fork server, meeting over gloo at its rendezvous
(``launch.train.spawn``), or this process's rank of a job whose processes
were started by someone else. The decode batch is split over "data", the
full-attention caches along the sequence over ("node", "gcd"), and the
resident backend's INT8 residency over the scheme's secondary partition.
The gathered backend serves the engine's seeded primaries alone
(``ZeroEngine.init_primaries``: no master, no optimizer state). With
``--devices 1 --backend resident`` the residency is built from the seeded
init one leaf at a time (``setup``: the models whose primaries and
residency would not fit beside each other on one card). On a card the
kernels are built (or loaded) before the timed run, once by the launcher
before its ranks start.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --backend resident --requests 8 --slots 4 --prompt-len 128 \
        --max-len 256 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --backend gathered \
        --devices 4 --mesh-shape 2,1,2 --prompt-len 128 --max-len 256
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
        --devices 4 --mesh-shape 2,1,2 --backend resident
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..core.partition import SCHEMES
from ..obs.metrics import (SERVE_REQUIRED_FIELDS, MetricsWriter, read_jsonl,
                           serve_aggregates)
from .distributed import add_cli_args

BACKENDS = ("gathered", "resident")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Continuous-batching server: paged KV pool + SLO "
                    "admission over the INT8-resident weights")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="registered architecture")
    ap.add_argument("--reduced", action="store_true",
                    help="serve ArchConfig.reduced() (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--scheme", default="zero_topo", choices=SCHEMES)
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the mesh (default 1, or the process count "
                         "of a multi-process launch); more than one are "
                         "spawned as local processes unless the launch is "
                         "multi-process")
    ap.add_argument("--mesh-shape", default="",
                    help="data,node,gcd sizes of the mesh, their product "
                         "--devices (default: from --devices)")
    ap.add_argument("--quant-block", type=int, default=128)
    ap.add_argument("--backend", default="gathered", choices=BACKENDS,
                    help="weight path: fp re-gather per token, or the INT8 "
                         "wire residency")
    ap.add_argument("--res-axes", default="",
                    help="comma-separated residency axes (default: the "
                         "scheme's secondary partition)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of random requests to queue")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64,
                    help="per-slot KV provisioning length")
    ap.add_argument("--gen", type=int, default=16,
                    help="max new tokens per request")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size in tokens (0 = auto)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="KV pool pages (0 = fully provisioned; fewer "
                         "oversubscribes and triggers preemption)")
    ap.add_argument("--max-queue-steps", type=int, default=0,
                    help="SLO: reject requests queued longer than N "
                         "scheduler steps (0 = never)")
    ap.add_argument("--reserve-pages", type=int, default=0,
                    help="SLO: keep N pages free when admitting")
    ap.add_argument("--metrics-jsonl", default="",
                    help="write one JSON record per scheduler step")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the requests")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a rank waits at the rendezvous or in a "
                         "collective before it fails")
    add_cli_args(ap)
    return ap


def setup(args, arch=None, device=None):
    """One device, ``--backend resident``: the device, model, residency
    layout and the INT8 residency built from the seeded init one leaf at a
    time (``iter_primaries``). Returns (device, arch, model, layout,
    residency)."""
    from ..core.partition import single_device_config
    from ..device import resolve
    from ..models.registry import build_model, get_arch
    from ..serve.resident import ResidentLayout, build_resident, iter_primaries

    if args.devices not in (None, 1):
        raise SystemExit("--devices: setup builds the one-device residency "
                         "(run() serves on a mesh)")
    device = device or resolve(args.device)
    arch = arch or get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    model = build_model(arch)
    cfg = single_device_config(args.scheme, quant_block=args.quant_block)
    want = tuple(a for a in args.res_axes.split(",") if a) or None
    layout = ResidentLayout(model.leaf_specs(), cfg, want)
    residency = build_resident(layout,
                               iter_primaries(layout, args.seed, device))
    return device, arch, model, layout, residency


def make_requests(args, arch):
    from ..serve.scheduler import Request
    rng = np.random.default_rng(args.seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, arch.vocab, args.prompt_len)
                    .astype(np.int32),
                    max_new=args.gen) for i in range(args.requests)]


def make_batcher(args, model, engine, device, metrics=None, mesh=None):
    """The batcher of ``args`` over ``engine``: a ``ZeroEngine`` (with its
    ``mesh``; ``--backend``) or a one-device ``ResidentLayout``."""
    from ..serve.scheduler import ContinuousBatcher, ServeSLO
    slo = ServeSLO(max_queue_steps=args.max_queue_steps,
                   reserve_pages=args.reserve_pages)
    want = tuple(a for a in args.res_axes.split(",") if a) or None
    return ContinuousBatcher(
        model, engine, mesh, n_slots=args.slots, max_len=args.max_len,
        prompt_len=args.prompt_len, device=device,
        page_size=args.page_size or None, n_pages=args.n_pages, slo=slo,
        backend=None if mesh is None else args.backend, res_axes=want,
        metrics=metrics)


def serve_rank(rank: int, world: int, args, arch=None, *,
               engine_opts=None, hook=None) -> dict:
    """One rank's server: builds its weights (the engine's seeded primaries,
    ``ZeroEngine.init_primaries``: the same global tensors on any mesh; or
    the one-device residency of ``setup``), serves ``make_requests`` and
    returns its tokens, counters, timings, collective payload bytes, kernel
    launches and attention fallbacks. Rank 0 prints the summary and writes
    the metrics lane. ``arch`` (an ArchConfig) stands in for
    ``get_arch(args.arch)``; ``engine_opts`` go to ``scheme_config`` (as
    ``launch.train.run`` takes them); ``hook(cb, params)``, when given, is
    called with the batcher and its weights before they serve (a probe that
    records the prefills and steps)."""
    import torch

    from ..core import collectives as col
    from ..core.engine import ZeroEngine
    from ..device import resolve
    from ..kernels import cuda as kcuda
    from ..kernels import ops
    from ..models.registry import build_model, get_arch
    from ..serve.resident import ResidentLayout, build_resident
    from .mesh import TEST_AXES, Mesh, scheme_config
    from .train import mesh_shape

    device = resolve(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    elif world > 1:
        torch.set_num_threads(1)
    log0 = print if rank == 0 else (lambda *a, **k: None)
    t0 = time.perf_counter()
    if device.type == "cuda":
        kcuda.build_all()
    build_s = time.perf_counter() - t0
    mesh = None
    if world == 1 and args.backend == "resident":
        device, arch, model, engine, params = setup(args, arch, device)
        layout = engine
    else:
        arch = arch or get_arch(args.arch)
        if args.reduced:
            arch = arch.reduced()
        model = build_model(arch)
        mesh = Mesh(mesh_shape(args), TEST_AXES, rank)
        cfg = scheme_config(args.scheme, mesh, quant_block=args.quant_block,
                            **(engine_opts or {}))
        engine = ZeroEngine(model.leaf_specs(), cfg, mesh, device=device)
        params = engine.init_primaries(args.seed)
        layout = None
        if args.backend == "resident":
            want = tuple(a for a in args.res_axes.split(",") if a) or None
            layout = ResidentLayout(engine.specs, cfg, want, mesh)
            params = build_resident(layout, params.items())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    if layout is not None:
        rep = layout.memory_report()
        log0(f"residency: axes={rep['res_axes']} degree={rep['res_degree']} "
             f"wire={rep['wire_bytes']}B dense={rep['dense_bytes']}B "
             f"per device ({device})")
    else:
        log0(f"gathered: mesh={mesh.shape} scheme={engine.cfg.name} "
             f"primaries {engine.memory_report()['primary']}B per device "
             f"({device})")
    metrics = MetricsWriter(args.metrics_jsonl,
                            fields=SERVE_REQUIRED_FIELDS) \
        if args.metrics_jsonl and rank == 0 else None
    cb = make_batcher(args, model, engine, device, metrics, mesh)
    log0(f"paged pool: {cb.paged.n_pages} pages x {cb.paged.page_size} "
         f"tokens ({cb.paged.blocks_per_slot}/slot)")
    reqs = make_requests(args, arch)
    if hook is not None:
        hook(cb, params)
    ops.reset_launches()
    ops.reset_dispatch_counters()
    col.reset_counters()
    setup_peak = None
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cb.run(params, reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if metrics is not None:
        metrics.close()
        # the lane read back, its schema checked again, and summarised
        agg = serve_aggregates(read_jsonl(args.metrics_jsonl,
                                          SERVE_REQUIRED_FIELDS))
        log0(f"metrics: {args.metrics_jsonl} {json.dumps(agg)}")

    c = cb.counters
    tok = sum(len(r.out) for r in reqs)
    lat = cb.latency_percentiles()
    log0(f"arch={arch.name} backend={cb.backend} {args.requests} reqs "
         f"-> {tok} tokens in {dt:.2f}s ({tok / max(dt, 1e-9):.1f} tok/s, "
         f"{cb.step_count} steps; setup {setup_s:.1f}s, of it kernels "
         f"{build_s:.1f}s)")
    log0(f"admitted {c['admitted']} rejected {c['rejected']} "
         f"preempted {c['preempted']} retired {c['retired']}; "
         f"p50 {lat['p50_ms']:.1f}ms p99 {lat['p99_ms']:.1f}ms")
    done = next((r for r in reqs if r.out), None)
    if done is not None:
        log0("sample:", done.out[:16])
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    if peak is not None:
        log0(f"peak bytes allocated on {device}: setup {setup_peak}, "
             f"serving {peak}")
    return dict(rank=rank, device=str(device), backend=cb.backend,
                mesh=None if mesh is None else list(mesh.shape.values()),
                tokens=[list(r.out) for r in reqs],
                rejected=[r.rejected for r in reqs], counters=dict(c),
                steps=cb.step_count, run_s=dt, setup_s=setup_s,
                build_s=build_s, launches=ops.launches(),
                fallbacks=ops.dispatch_counters(),
                payload_bytes=dict(col.PAYLOAD),
                collective_s=dict(col.SECONDS), latency=lat,
                memory=None if layout is None else layout.memory_report(),
                peak_bytes=peak, setup_peak_bytes=setup_peak)


def launch_config(args):
    """``launch.train.launch_config`` with one rank when ``--devices`` is
    unset and the launch is not multi-process."""
    from .distributed import from_args
    from .train import launch_config as train_launch_config
    if args.devices is None and not from_args(args).is_distributed:
        args.devices = 1
    return train_launch_config(args)


def refuse_non_text_arch(arch) -> None:
    """The CLI serves through the continuous batcher, which takes text
    prompts only (as the reference's does): a model with a patch prefix or
    an encoder (``arch``: an ArchConfig or a registered name) raises before
    anything is built."""
    from ..models.registry import get_arch
    from ..serve.scheduler import refuse_non_text
    if isinstance(arch, str):
        arch = get_arch(arch)
    try:
        refuse_non_text(arch)
    except ValueError as e:
        raise SystemExit(f"--arch {arch.name}: the serving CLI runs the "
                         f"continuous batcher. {e} (ResidentServeEngine, "
                         "ServeEngine)") from None


def run(args, arch=None) -> list[dict]:
    """Serve; returns every local rank's ``serve_rank`` result by rank. A
    multi-process launch (``distributed.detect``) runs this process's one
    rank; ``--devices``, when given, must be its process count."""
    from ..device import resolve
    from .distributed import initialize
    from .train import mesh_shape, spawn

    refuse_non_text_arch(arch or args.arch)
    dcfg = launch_config(args)
    n = args.devices
    mesh_shape(args)
    resolve(args.device)      # no card for --device cuda: raise here, once
    if dcfg.is_distributed:
        initialize(dcfg, args.timeout)
        try:
            return [serve_rank(dcfg.process_id, n, args, arch)]
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    if n == 1:
        return [serve_rank(0, 1, args, arch)]
    if args.device != "cpu":
        from ..kernels import cuda as kcuda
        kcuda.build_all()     # once here, not by every rank at once
        print(f"kernels: {kcuda.BUILD_LOG['built']} built in "
              f"{kcuda.BUILD_LOG['seconds']:.1f}s")
    return spawn(serve_rank, n, args.timeout, args.device != "cpu",
                 (args, arch), what="serving")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        launch_config(args)
    except ValueError as e:
        ap.error(str(e))
    return run(args)


if __name__ == "__main__":
    main()
