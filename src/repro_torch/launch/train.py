"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --scheme zero_topo --devices 4 --batch 8 --seq 1024 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --devices 4 --steps 3

Port of ``repro.launch.train`` with the flags ``--arch --scheme --steps
--batch --seq --reduced --quant-block --overlap --stream-grads --lr
--compute-dtype --ckpt-dir --ckpt-every --resume --strict-restore
--log-json``, the observability group ``--trace --metrics-jsonl
--chrome-trace --heartbeat-dir --probe-every`` and the distributed group
``--coordinator --num-processes --process-id`` (launch/distributed.py), plus
``--device`` (default ``cuda``; there is no CPU fallback), ``--devices N``,
``--seed``, ``--microbatches``, ``--kernel-impl plain`` (the plain PyTorch version of every
kernel, the reference the kernels are held against) and ``--init-npz`` (start
from a global state saved by ``convert.save_global_state``, e.g. the JAX
package's ``init_state``). The reference trains the reduced model on fake
CPU devices; this launcher trains the published width unless ``--reduced``.
``--resume`` restores the latest checkpoint of ``--ckpt-dir`` (in the JAX
package's format: either package's) in place of the seed, resharded onto
this run's mesh unless ``--strict-restore``; ``--steps`` stays the steps of
this run and the schedule's ``total_steps``, as in the reference.

``--devices N`` runs the step on the mesh ("data", "node", "gcd") =
(N/4, 2, 2) (N = 1, 2 give (1, 1, N); ``--mesh-shape`` picks another shape
of N ranks, e.g. 2,1,2 for a replica tier): N local processes, one rank each,
meeting over gloo at one TCP rendezvous on 127.0.0.1. Ranks on a card share
the cards round-robin (four ranks on one H100 all use cuda:0). A job whose
processes were started by someone else (the three flags, SLURM, OpenMPI,
the ``REPRO_*`` variables or torchrun: ``distributed.detect``) runs one rank
in each process, and ``--devices`` is then its process count.

Trace mode (any of ``--trace``, ``--metrics-jsonl``, ``--chrome-trace``,
``--heartbeat-dir``) fences the step's segments (``ZeroEngine.train_step``
with a ``SpanRecorder``: bit for bit the untraced step) and runs the
out-of-band probes (obs/phased.py); after the run rank 0 prints the
heartbeat report and the throughput without the first step.
"""
from __future__ import annotations

import argparse
import os
import queue as queue_mod
import time
import traceback
from datetime import timedelta

from ..core.partition import SCHEMES
from .distributed import add_cli_args, from_args, initialize

# the modules the launcher's fork server imports once, before it forks any
# rank: each rank then starts with torch imported, and with torch._dynamo,
# which the first torch.utils.checkpoint call of a step imports otherwise.
# Four ranks spawned at once on an H100 host paid 8 s for `import torch` and
# 27 s more in their first step than in a steady one
# (probes/train_phases.py --phase first_step). Nothing here touches a card.
PRELOAD = ("torch", "torch.distributed", "torch._dynamo",
           "repro_torch.launch.train", "repro_torch.train.trainer")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="ZeRO-topo training on torch.distributed ranks")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--scheme", default="zero_topo", choices=SCHEMES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the mesh (default 4, or the process "
                         "count of a multi-process launch); spawned as local "
                         "processes unless the launch is multi-process")
    ap.add_argument("--mesh-shape", default="",
                    help="data,node,gcd sizes of the mesh, their product "
                         "--devices (default: from --devices)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8, help="global batch rows")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="train ArchConfig.reduced() (CPU-sized)")
    ap.add_argument("--quant-block", type=int, default=128)
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered prefetch of the per-layer weight "
                         "all-gather (DESIGN.md §3)")
    ap.add_argument("--stream-grads", action="store_true",
                    help="streaming gradient path (DESIGN.md §8): per-layer "
                         "grad reduce-scatter fused into the backward, "
                         "microbatch grads accumulated in fp32 "
                         "optimizer-shard layout (grad buffer 4*psi/os "
                         "instead of 4*psi/w)")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--kernel-impl", default=None, choices=["plain"],
                    help="'plain': run every kernel's plain PyTorch version "
                         "(default: the kernels on a card, the plain "
                         "versions on the CPU)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="split each rank's rows into this many microbatches, "
                         "gradients accumulated in f32 (TrainHparams."
                         "n_microbatch)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights and of the batches")
    ap.add_argument("--init-npz", default="",
                    help="start from this global state "
                         "(convert.save_global_state) instead of the seed")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir; a "
                         "checkpoint written under a different mesh/process "
                         "layout or scheme is resharded onto the live one "
                         "(elastic restore, DESIGN.md §11)")
    ap.add_argument("--strict-restore", action="store_true",
                    help="with --resume: refuse any layout difference "
                         "(MeshMismatch/SchemeMismatch) instead of "
                         "resharding — the pre-elastic behavior")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a rank waits at the rendezvous or in a "
                         "collective before it fails")
    ap.add_argument("--profile-step", type=int, default=-1,
                    help="trace this step (0-based) with torch.profiler and "
                         "report its kernels' device time (-1: none)")
    ap.add_argument("--log-json", default="",
                    help="write rank 0's TrainLog as JSON")
    g = ap.add_argument_group(
        "observability", "opt-in runtime tracing (DESIGN.md §10); without "
        "--trace the monolithic step runs untouched and every bitwise "
        "contract holds")
    g.add_argument("--trace", action="store_true",
                   help="run the phased fenced step: per-phase spans, "
                        "comm-attribution probes, JSONL metrics stream")
    g.add_argument("--metrics-jsonl", default="",
                   help="per-step JSONL metrics path (multi-process runs "
                        "write per-rank .rank<k> lanes next to it)")
    g.add_argument("--chrome-trace", default="",
                   help="write collected spans as a Chrome/Perfetto "
                        "trace.json at end of run")
    g.add_argument("--heartbeat-dir", default="",
                   help="per-rank heartbeat files + straggler report "
                        "(launch.distributed.Heartbeat)")
    g.add_argument("--probe-every", type=int, default=4,
                   help="steps between out-of-band comm-attribution probe "
                        "runs (0 disables probes)")
    add_cli_args(ap)
    return ap


def trace_config(args):
    """The run's TraceConfig: trace mode when any of ``--trace``,
    ``--metrics-jsonl``, ``--chrome-trace``, ``--heartbeat-dir`` is given
    (the reference's rule), else None."""
    if not (args.trace or args.metrics_jsonl or args.chrome_trace
            or args.heartbeat_dir):
        return None
    from ..obs.spans import TraceConfig
    return TraceConfig(metrics_path=args.metrics_jsonl or None,
                       chrome_trace=args.chrome_trace or None,
                       heartbeat_dir=args.heartbeat_dir or None,
                       probe_every=args.probe_every)


def mesh_shape(args) -> tuple[int, ...]:
    """The (data, node, gcd) sizes for ``args``: ``--mesh-shape``, else
    (N/4, 2, 2) for N = --devices (N = 1, 2: (1, 1, N); unset: 4)."""
    n = args.devices or 4
    if args.mesh_shape:
        shape = tuple(int(v) for v in args.mesh_shape.split(","))
        if len(shape) != 3 or shape[0] * shape[1] * shape[2] != n:
            raise ValueError(f"--mesh-shape {args.mesh_shape}: three sizes "
                             f"whose product is --devices {n}")
        return shape
    if n in (1, 2):
        return (1, 1, n)
    if n % 4:
        raise ValueError(f"--devices {n}: use 1, 2 or a multiple of 4")
    return (n // 4, 2, 2)


def train_rank(rank: int, world: int, args, arch=None, steps=None,
               engine_opts=None) -> dict:
    """One rank's run. Returns its per-step metrics, its kernel launches
    and collective payload bytes over the steps (and the launches inside
    the update all-gather), its peak device memory, the step it resumed
    from, the sha256 of each shard it restored
    (``checkpoint.shard_digests``), its checkpoints' seconds and, in trace
    mode, its spans (``trace``; rank 0 also the heartbeat report, read after
    every rank has stamped its last step). ``arch`` (an ArchConfig) stands
    in for ``get_arch(args.arch)`` when given (e.g. a published width at a
    cut depth). ``steps``: stop after this many steps (default ``--steps``,
    which still sets the schedule). ``engine_opts``: ZeroConfig overrides
    (``cross_replica``, ``quantize_update_gather``), as the reference's
    ``scheme_config(**engine_opts)``."""
    import torch
    import torch.distributed as dist

    from ..convert import from_jax_state, load_global_state
    from ..core import collectives as col
    from ..core.engine import TrainHparams, ZeroEngine
    from ..data.pipeline import spec_for
    from ..device import resolve
    from ..kernels import ops
    from ..models.registry import build_model, get_arch
    from ..obs.spans import PROBES, SEGMENTS
    from ..train import checkpoint
    from ..train.trainer import Trainer
    from .distributed import heartbeat
    from .mesh import TEST_AXES, Mesh, scheme_config

    device = resolve(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    elif world > 1:
        torch.set_num_threads(1)
    log0 = print if rank == 0 else (lambda *a, **k: None)

    if arch is None:
        arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    model = build_model(arch)
    mesh = Mesh(mesh_shape(args), TEST_AXES, rank)
    cfg = scheme_config(args.scheme, mesh, quant_block=args.quant_block,
                        overlap=args.overlap, stream_grads=args.stream_grads,
                        compute_dtype=args.compute_dtype, impl=args.kernel_impl,
                        **(engine_opts or {}))
    hp = TrainHparams(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 2),
                      n_microbatch=args.microbatches, overlap=args.overlap,
                      stream_grads=args.stream_grads)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device)
    trace = trace_config(args)
    tr = Trainer(model, eng, spec_for(arch, args.batch, args.seq),
                 seed=args.seed, trace=trace)
    log0(f"arch={arch.name} scheme={cfg.name} mesh={mesh.shape} "
         f"params={eng.param_count():,} overlap={eng.cfg.overlap} "
         f"stream_grads={eng.cfg.stream_grads} "
         f"cross_replica={eng.cfg.cross_replica} "
         f"quantize_update_gather={eng.cfg.quantize_update_gather} "
         f"device={device} kernel_impl={eng.cfg.impl or 'kernel'} "
         f"ranks={world}")
    if trace is not None:
        log0(f"trace mode: phased fenced step (bit for bit the untraced "
             f"step) probes_every={args.probe_every}")
    log0(f"per-rank state bytes: {eng.memory_report()}")
    resumed_from, restore_s, restored = None, None, None
    if args.resume:
        t0 = time.perf_counter()
        state = tr.restore(args.ckpt_dir, reshard=not args.strict_restore)
        restore_s = time.perf_counter() - t0
        resumed_from = state["step"]
        restored = checkpoint.shard_digests(state)
        log0(f"resumed from step {resumed_from}"
             + ("" if args.strict_restore else " (elastic restore enabled)")
             + f" in {restore_s:.3f}s")
    elif args.init_npz:
        state = from_jax_state(load_global_state(args.init_npz), eng)
    else:
        state = eng.init_state(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    ops.reset_dispatch_counters()
    col.reset_counters()
    eng.phase_s.clear()
    tr.run(state, args.steps if steps is None else steps, print_fn=log0,
           profile_step=args.profile_step if args.profile_step >= 0 else None,
           ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every)
    launches, payload = ops.launches(), dict(col.PAYLOAD)
    update_gather = dict(col.UPDATE_GATHER_LAUNCHES)
    fallbacks = ops.dispatch_counters()
    log = tr.log
    traced = None
    if tr.phased is not None:
        rec, ph = tr.recorder, tr.phased
        spans = [rec.step_seconds(i) for i in range(len(log.steps))]
        probes = [{k: v for k, v in sp.items() if k in PROBES}
                  for sp in spans]
        traced = dict(
            segments=[{k: v for k, v in sp.items() if k in SEGMENTS}
                      for sp in spans],
            probes=probes,
            phase_s=[ph.phase_seconds(rec, i, p or None)
                     for i, p in enumerate(probes)],
            overlap_efficiency=[ph.overlap_efficiency(rec, i)
                                for i in range(len(spans))],
            probe_inventory=ph.probe_inventory(),
            probe_counts={k: dict(v) for k, v in ph.probe_counts.items()},
            chrome_events=len(rec.chrome_events(rank)))
    hb_report = None
    if args.heartbeat_dir:
        if world > 1:
            dist.barrier()      # every rank has stamped its last step
        if rank == 0:
            hb_report = heartbeat(args.heartbeat_dir).report()
    log0(f"final loss: {log.losses[-1]}")
    if rank == 0 and args.log_json:
        log.save(args.log_json)
    return dict(rank=rank, device=str(device), losses=log.losses,
                grad_norms=log.grad_norms, lrs=log.lrs,
                step_times=log.step_times, tokens=log.tokens,
                tokens_per_s=log.tokens_per_s, launches=launches,
                tflops_per_gpu=log.tflops_per_gpu,
                aggregates=log.aggregates(), update_gather_launches=update_gather,
                trace=traced, heartbeat=hb_report, fallbacks=fallbacks,
                payload_bytes=payload, collective_s=dict(col.SECONDS),
                phase_s=dict(eng.phase_s), profile=log.meta.get("profile"),
                memory=eng.memory_report(), resumed_from=resumed_from,
                ckpt_save_s=log.ckpt_save_s, ckpt_restore_s=restore_s,
                restored_shards=restored,
                peak_bytes=torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None,
                peak_reserved_bytes=torch.cuda.max_memory_reserved(device)
                if device.type == "cuda" else None)


def fork_context():
    """The multiprocessing context the launcher starts its ranks in: a fork
    server that imports PRELOAD once (started at its first use, or by
    ``start_fork_server``)."""
    import multiprocessing as mp
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    return ctx


def start_fork_server() -> None:
    """Start the fork server now: its imports run in the background while
    the caller goes on, and the first ranks find it ready."""
    from multiprocessing import forkserver
    fork_context()
    forkserver.ensure_running()


def stop_fork_server() -> None:
    """Stop this process's fork server, if it started one, and wait until it
    has exited (it would otherwise exit on its own only once this process
    has)."""
    from multiprocessing import forkserver
    stop = getattr(forkserver._forkserver, "_stop", None)
    if stop is not None:
        stop()


def rendezvous(world: int, timeout_s: float):
    """The rendezvous store of ``world`` local ranks: a TCPStore server on
    a port the OS picks as it binds, held by the launching process until
    its ranks are done, so no other process can take the port between its
    choice and the ranks' meeting (``.port`` is what ``init_group``
    takes)."""
    import torch.distributed as dist
    return dist.TCPStore("127.0.0.1", 0, world_size=world, is_master=True,
                         wait_for_workers=False,
                         timeout=timedelta(seconds=timeout_s))


def init_group(rank: int, world: int, timeout_s: float, port: int) -> None:
    """Join the gloo group through the ``rendezvous`` store on ``port``."""
    import torch.distributed as dist
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", port, world_size=world,
                          is_master=False, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=timeout)


class ParentFd:
    """The launching process's file descriptor ``fd`` as a forked rank
    receives it: pickled while the rank starts, it reaches the rank through
    the fork server (which holds the descriptors of the process that
    started it, not the launcher's current ones)."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        from multiprocessing import reduction
        return _detach_fd, (reduction.DupFd(self.fd),)


def _detach_fd(dup) -> int:
    return dup.detach()


def rank_main(rank: int, world: int, port: int, timeout: float, cuda: bool,
              fn, fn_args: tuple, queue, std=None) -> None:
    """A local rank: its stdout and stderr are ``std``, the launcher's own
    (``ParentFd``), then the group and ``fn(rank, world, *fn_args)``; the
    result, or the traceback, goes on ``queue``."""
    for fd, target in enumerate(std or (), start=1):
        os.dup2(target, fd)
        os.close(target)
    import torch.distributed as dist
    if cuda:
        # local ranks share the cards round-robin (four on one H100): with
        # growable segments a rank's freed blocks do not stay reserved in
        # fixed segments the other ranks cannot use (set before this
        # process's first allocation; a caller's own setting stands)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    try:
        init_group(rank, world, timeout, port)
        queue.put((rank, fn(rank, world, *fn_args), None))
    except Exception:
        # the parent raises with this traceback and stops the other ranks
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _worker(rank: int, world: int, port: int, args, arch, steps, engine_opts,
            queue, std=None) -> None:
    """A local training rank (``rank_main`` of ``train_rank``)."""
    rank_main(rank, world, port, args.timeout, args.device != "cpu",
              train_rank, (args, arch, steps, engine_opts), queue, std)


def spawn(fn, n: int, timeout: float, cuda: bool, fn_args: tuple,
          what: str = "training") -> list:
    """``fn(rank, n, *fn_args)`` on ``n`` local ranks forked from the fork
    server (``fork_context``), meeting at one ``rendezvous`` store; returns
    their results by rank. A rank's failure stops the others and raises
    with its traceback."""
    ctx = fork_context()
    queue = ctx.Queue()
    store = rendezvous(n, timeout)
    procs = [ctx.Process(target=rank_main,
                         args=(r, n, store.port, timeout, cuda, fn, fn_args,
                               queue, (ParentFd(1), ParentFd(2))))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout + 120
    try:
        while len(results) < n and not errors:
            try:
                rank, res, err = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} died without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"no result within {timeout + 120} s")
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                results[rank] = res
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError(f"{what} rank failed\n" + "\n".join(errors))
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"{what} ranks exited with {bad}")
    return [results[r] for r in range(n)]


def launch_config(args):
    """This process's ``distributed.DistConfig``; sets ``args.devices`` to
    its process count when it is multi-process (a ``--devices`` that
    differs raises ValueError), else to 4 when unset."""
    dcfg = from_args(args)
    if dcfg.is_distributed:
        if args.devices not in (None, dcfg.num_processes):
            raise ValueError(f"--devices {args.devices}: this launch has "
                             f"{dcfg.num_processes} processes ({dcfg.source})")
        args.devices = dcfg.num_processes
    elif args.devices is None:
        args.devices = 4
    return dcfg


def run(args, arch=None, *, steps=None, engine_opts=None) -> list[dict]:
    """Train; returns every local rank's ``train_rank`` result by rank.
    ``arch``: an ArchConfig to train in place of ``get_arch(args.arch)``;
    ``steps``, ``engine_opts``: as ``train_rank`` takes them. A
    multi-process launch (``distributed.detect``) runs this process's one
    rank; ``--devices``, when given, must be its process count. ``--resume
    --strict-restore`` onto another mesh layout raises
    ``checkpoint.MeshMismatch`` here, before any rank starts."""
    dcfg = launch_config(args)
    n = args.devices
    mesh_shape(args)
    from ..device import resolve
    resolve(args.device)      # no card for --device cuda: raise here, once
    if args.resume and args.strict_restore and args.ckpt_dir:
        # a strict restore onto another layout is refused before any rank
        # starts (each rank's restore checks the scheme and the rest)
        from ..train import checkpoint
        from .mesh import TEST_AXES, Mesh
        step = checkpoint.latest_step(args.ckpt_dir)
        if step is not None:
            checkpoint.check_layout(args.ckpt_dir, step,
                                    Mesh(mesh_shape(args), TEST_AXES))
    if dcfg.is_distributed:
        initialize(dcfg, args.timeout)
        try:
            return [train_rank(dcfg.process_id, n, args, arch, steps,
                               engine_opts)]
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    if n == 1:
        return [train_rank(0, 1, args, arch, steps, engine_opts)]
    return spawn(train_rank, n, args.timeout, args.device != "cpu",
                 (args, arch, steps, engine_opts))


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    try:
        launch_config(args)
    except ValueError as e:
        ap.error(str(e))
    results = run(args)
    if len(results) > 1:
        for r in results:
            print(f"rank {r['rank']}: launches {r['launches']} payload "
                  f"bytes {r['payload_bytes']}")
    r0 = results[0]
    if r0["rank"] == 0:
        from ..obs import heartbeat as hb
        if r0["heartbeat"] is not None:
            print(hb.format_report(r0["heartbeat"]))
        agg = r0["aggregates"]
        if agg.get("n_timed_steps"):
            share = f" (per rank of {args.devices})" \
                if args.devices > 1 else ""
            print(f"throughput (excl. compile step): "
                  f"{agg['tokens_per_s_mean']:.0f} tok/s, "
                  f"{agg['tflops_per_gpu_mean']:.3f} model-TFLOPS/GPU{share}")
    return results


if __name__ == "__main__":
    main()
