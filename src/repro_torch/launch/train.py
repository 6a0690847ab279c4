"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --scheme zero_topo --devices 4 --batch 8 --seq 1024 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --devices 4 --steps 3

Port of ``repro.launch.train`` with the flags ``--arch --scheme --steps
--batch --seq --reduced --quant-block --overlap --stream-grads --lr
--compute-dtype --ckpt-dir --ckpt-every --resume --strict-restore
--log-json`` plus
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
the cards round-robin (four ranks on one H100 all use cuda:0). Under
``torchrun`` the launcher reads RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT
from the environment instead and runs its one rank.
"""
from __future__ import annotations

import argparse
import os
import queue as queue_mod
import time
import traceback
from datetime import timedelta

from ..core.partition import SCHEMES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="ZeRO-topo training on torch.distributed ranks")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--scheme", default="zero_topo", choices=SCHEMES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks (local processes) of the mesh")
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
    return ap


def mesh_shape(args) -> tuple[int, ...]:
    """The (data, node, gcd) sizes for ``args``: ``--mesh-shape``, else
    (N/4, 2, 2) for N = --devices (N = 1, 2: (1, 1, N))."""
    n = args.devices
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


def train_rank(rank: int, world: int, args, arch=None, steps=None) -> dict:
    """One rank's run. Returns its per-step metrics, its kernel launches
    and collective payload bytes over the steps, its peak device memory,
    the step it resumed from, the sha256 of each shard it restored
    (``checkpoint.shard_digests``) and its checkpoints' seconds. ``arch``
    (an ArchConfig) stands in for ``get_arch(args.arch)`` when given (e.g.
    a published width at a cut depth). ``steps``: stop after this many
    steps (default ``--steps``, which still sets the schedule)."""
    import torch

    from ..convert import from_jax_state, load_global_state
    from ..core import collectives as col
    from ..core.engine import TrainHparams, ZeroEngine
    from ..data.pipeline import BatchSpec
    from ..device import resolve
    from ..kernels import ops
    from ..models.registry import build_model, get_arch
    from ..train import checkpoint
    from ..train.trainer import Trainer
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
                        compute_dtype=args.compute_dtype, impl=args.kernel_impl)
    hp = TrainHparams(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 2),
                      n_microbatch=args.microbatches, overlap=args.overlap,
                      stream_grads=args.stream_grads)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device)
    tr = Trainer(model, eng, BatchSpec(args.batch, args.seq, arch.vocab),
                 seed=args.seed)
    log0(f"arch={arch.name} scheme={cfg.name} mesh={mesh.shape} "
         f"params={eng.param_count():,} overlap={eng.cfg.overlap} "
         f"stream_grads={eng.cfg.stream_grads} device={device} "
         f"kernel_impl={eng.cfg.impl or 'kernel'} ranks={world}")
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
    fallbacks = ops.dispatch_counters()
    log = tr.log
    log0(f"final loss: {log.losses[-1]}")
    if rank == 0 and args.log_json:
        log.save(args.log_json)
    return dict(rank=rank, device=str(device), losses=log.losses,
                grad_norms=log.grad_norms, lrs=log.lrs,
                step_times=log.step_times, tokens=log.tokens,
                tokens_per_s=log.tokens_per_s, launches=launches,
                fallbacks=fallbacks,
                payload_bytes=payload, collective_s=dict(col.SECONDS),
                phase_s=dict(eng.phase_s), profile=log.meta.get("profile"),
                memory=eng.memory_report(), resumed_from=resumed_from,
                ckpt_save_s=log.ckpt_save_s, ckpt_restore_s=restore_s,
                restored_shards=restored,
                peak_bytes=torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None,
                peak_reserved_bytes=torch.cuda.max_memory_reserved(device)
                if device.type == "cuda" else None)


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


def init_group(rank: int, world: int, timeout_s: float,
               port: int | None = None) -> None:
    """Join the gloo group: through the ``rendezvous`` store on ``port``,
    or, with no port, through torchrun's environment."""
    import torch.distributed as dist
    timeout = timedelta(seconds=timeout_s)
    if port is None:
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
        return
    store = dist.TCPStore("127.0.0.1", port, world_size=world,
                          is_master=False, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=timeout)


def _worker(rank: int, world: int, port: int, args, arch, steps,
            queue) -> None:
    import torch.distributed as dist
    if args.device != "cpu":
        # local ranks share the cards round-robin (four on one H100): with
        # growable segments a rank's freed blocks do not stay reserved in
        # fixed segments the other ranks cannot use (set before this
        # process's first allocation; a caller's own setting stands)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    try:
        init_group(rank, world, args.timeout, port)
        queue.put((rank, train_rank(rank, world, args, arch, steps), None))
    except Exception:
        # the parent raises with this traceback and stops the other ranks
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(args, arch=None, *, steps=None) -> list[dict]:
    """Train; returns every local rank's ``train_rank`` result by rank.
    ``arch``: an ArchConfig to train in place of ``get_arch(args.arch)``;
    ``steps``: as ``train_rank`` takes it. ``--resume --strict-restore``
    onto another mesh layout raises ``checkpoint.MeshMismatch`` here,
    before any rank starts."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_group(rank, world, args.timeout)
        try:
            return [train_rank(rank, world, args, arch, steps)]
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
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
    if n == 1:
        return [train_rank(0, 1, args, arch, steps)]
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = rendezvous(n, args.timeout)
    procs = [ctx.Process(target=_worker,
                         args=(r, n, store.port, args, arch, steps, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + args.timeout + 120
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
                    errors.append(f"no result within {args.timeout + 120} s")
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
        raise RuntimeError("training rank failed\n" + "\n".join(errors))
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"training ranks exited with {bad}")
    return [results[r] for r in range(n)]


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    results = run(args)
    if len(results) > 1:
        for r in results:
            print(f"rank {r['rank']}: launches {r['launches']} payload "
                  f"bytes {r['payload_bytes']}")
    return results


if __name__ == "__main__":
    main()
