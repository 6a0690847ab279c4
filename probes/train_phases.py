#!/usr/bin/env python3
"""Card probe of the cut-depth training phases of chip_smoke.py that run
falcon-mamba-7b and gemma3-1b, and of what their readings rest on, without
the rest of the smoke run.

    python3 probes/train_phases.py [--phase PHASE ...] [--out FILE]

Needs one CUDA card and nvcc. Phases (all by default):

- ``ssm``, ``gemma``: ``chip_smoke.ssm_train_phase`` (falcon-mamba-7b at
  published width and SSM_TRAIN_L layers on four ranks sharing the card) and
  ``chip_smoke.gemma_train_phase`` (gemma3-1b at GEMMA_TRAIN_L layers), each held
  against the plain versions as chip_smoke.py holds them, after
  ``chip_smoke.check_kernels``; prints each phase's JSON line
  (``train_ssm``, ``train_gemma``).
- ``timing``: flash at gemma's training shape, the scan at falcon-mamba's.
- ``scan_backward``: one mamba layer's plain scan backward at a training
  rank's shape, blocked in 256 steps (what the step runs) and unblocked
  (the graph of every step alive at once): host seconds, peak memory.
- ``ssm_ablation``: the ``ssm`` phase's run (untraced) through the kernels,
  through the plain versions, and through the kernels with one of the
  scan, the dequant-matmul and matmul_quant turned plain; each run's loss
  and grad norm a step beside the plain run's.
- ``trace_events``: qwen2-0.5b (24 layers) and gpt-neox-20b (1 layer) on
  the train phases' mesh and batch for 2 steps, the last traced, once
  recording the card's events alone (what ``train.trainer`` records) and
  once the host's too; the traced device ms of each run, kernel by kernel.
- ``depth``: gpt-neox-20b and deepseek-7b at published width on the train
  phases' mesh and batch, 2 steps through the kernels, at each depth of
  ``--neox-layers`` / ``--deepseek-layers`` in turn until one leaves less
  than chip_smoke's TRAIN_HEADROOM of the card free or fails: the ranks'
  summed max_memory_allocated, bytes a parameter, step times; then the
  deepest depth that fit again through the plain versions (the phase runs
  both). How NEOX_TRAIN_L and DEEPSEEK_TRAIN_L are chosen.
- ``serve_deepseek``: chip_smoke's deepseek serving phase alone.
- ``serve_moe``: chip_smoke's moe, mixtral and vlm phases alone
  (phi3.5-moe-42b-a6.6b at published width and depth from its INT8
  residency, mixtral-8x7b at 2 layers, internvl2-1b with its patch
  prefix).
- ``jamba``: chip_smoke's jamba phase (jamba-v0.1-52b at published width
  and depth from its INT8 residency through the batcher) and its
  train_jamba phase (layer 0 on four ranks) alone.
- ``train_moe``: the ``depth`` search for phi3.5-moe-42b-a6.6b at
  ``--moe-layers`` (how MOE_TRAIN_L is chosen), then chip_smoke's
  train_vlm phase (internvl2-1b at VLM_TRAIN_L layers).
- ``ckpt``: chip_smoke's train phase's kernel run alone (qwen2-0.5b at
  full size on four ranks, saving step 3 into ``chip_smoke.CKPT_DIR``),
  then ``chip_smoke.ckpt_phase`` (legs (a), (b), (c)); prints the
  ``ckpt`` line and removes the checkpoint. About 5 minutes with the
  builds.
- ``first_step``: where a training run's start and first step spend the
  seconds a steady step does not: chip_smoke's train phase run (qwen2-0.5b
  at full size on four ranks, 3 steps, trace mode without probes, so each
  step's fenced segments are kept) three times: its ranks spawned (a fresh
  interpreter each, as before the launcher's fork server), forked from the
  fork server that has imported torch (as chip_smoke runs them), and
  forked and warm, each rank first importing torch._dynamo (the first
  checkpoint call's import), loading the kernel libraries (ctypes), creating
  cuBLAS's handles (bf16 and f32 products, a product with a bias),
  growing its allocator by WARM_ALLOC bytes and sending WARM_GATHER bytes
  through gloo twice, each timed. Prints every rank's host timeline
  (spawn, entry, torch imported, group joined, CUDA context, engine and
  groups bound, state, run end, joined) and each step's segments.
- ``replica``: chip_smoke's replica phase (4i) alone.
- ``serve_mesh``: chip_smoke's serving phase on the mesh (2, 1, 2) (4j)
  alone, about 2-3 minutes with the build.
- ``trace_window``: gpt-neox-20b served at published depth, then its
  prefill traced ``--traces`` times, in turns bare (launched the moment
  the trace starts), padded (``train.trainer.pad_trace``'s idle card
  inside the profiler before and after the prefill, as
  ``chip_smoke.trace_prefill`` and the trainer trace), and bare recording
  the host's events too. For each trace: its device events, the flash
  launches counted and traced, and the margins between the host's clock
  (profiler entered, prefill synchronised) and the first and last device
  event; a trace that lost events is listed with the names it lost
  against a whole trace and its first events.

With ``--out``, writes every phase's result to that JSON file.
"""
import argparse
import gc
import json
import queue as queue_mod
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("ssm", "gemma", "timing", "scan_backward", "ssm_ablation",
          "trace_events", "depth", "serve_deepseek", "trace_window", "ckpt",
          "serve_moe", "train_moe", "jamba",
          "first_step", "replica", "serve_mesh")
# the bytes the first_step phase's warm run has its allocator map before
# the steps, and sends through one gloo all-gather twice
WARM_ALLOC = 6 << 30
WARM_GATHER = 256 << 20
# the ops functions turned plain, one at a time, in ``ssm_ablation``
ABLATED = ("selective_scan", "dequant_matmul", "matmul_quant")


def scan_backward_probe(c, gen, dev) -> dict:
    """One mamba layer's scan backward at a training rank's shape (B = 2
    rows of 1,024, D = 8,192, N = 16) through the plain version: host
    seconds and the peak memory above what was allocated before, blocked in
    256 steps (``ref.selective_scan_ref_vjp``) and unblocked; the two
    gradients held within chip_smoke's F32_TOL of max|grad|."""
    import torch

    from repro_torch.kernels import ref

    inputs = c.scan_inputs(gen, dev, c.SCAN_TRAIN_B, 1024, c.SCAN_D, False,
                           3.0)
    gy = torch.randn((c.SCAN_TRAIN_B, 1024, c.SCAN_D), generator=gen,
                     device=dev)
    gh = torch.randn((c.SCAN_TRAIN_B, c.SCAN_D, c.SCAN_N), generator=gen,
                     device=dev)

    def unblocked():
        leaves = [t.clone().requires_grad_() for t in inputs]
        y, h = ref.selective_scan_ref(*leaves)
        return torch.autograd.grad((y, h), leaves, (gy, gh))

    out, grads = {}, {}
    for key, fn in (("blocked", lambda: ref.selective_scan_ref_vjp(
            *inputs, gy, gh)), ("unblocked", unblocked)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads[key] = fn()
        torch.cuda.synchronize()
        out[key] = dict(host_s=time.perf_counter() - t0,
                        peak_bytes=torch.cuda.max_memory_allocated() - base)
    for name, a, b in zip(("dt", "x", "b", "c", "a", "h0"),
                          grads["blocked"], grads["unblocked"]):
        err, scale = c.rel_err(a, b)
        out[f"d {name} blocked vs unblocked"] = err / scale
        if err > c.F32_TOL * scale:
            raise c.Failed(f"scan backward d {name}: blocked vs unblocked "
                           f"err {err} > {c.F32_TOL * scale}")
    del inputs, gy, gh, grads
    torch.cuda.empty_cache()
    return out


def _forced_plain(fn):
    def plain(*args, **kwargs):
        kwargs["impl"] = "plain"
        return fn(*args, **kwargs)
    return plain


def _worker(rank, world, port, args, arch, queue, plain, host_events,
            std=None):
    """``launch.train``'s rank, with the ops of ``plain`` turned plain and,
    with ``host_events``, the traced step recording the host's events too."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.train import trainer

    for name in plain:
        setattr(ops, name, _forced_plain(getattr(ops, name)))
    if host_events:
        act = torch.profiler.ProfilerActivity
        trainer._profiler = lambda device: torch.profiler.profile(
            activities=[act.CPU, act.CUDA])
    train._worker(rank, world, port, args, arch, None, None, queue, std)


def warm_up(device, world: int) -> dict:
    """The first uses a step pays for, each timed on the host clock (s):
    the kernel libraries' load, cuBLAS's handles, the allocator's growth and
    the first and second gloo all-gathers of a CUDA tensor."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import cuda as kcuda

    out = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        out[key] = time.perf_counter() - t0

    a = torch.randn(256, 256, device=device, dtype=torch.bfloat16)
    timed("import_dynamo", lambda: __import__("torch._dynamo"))
    timed("ctypes_load", kcuda.build_all)
    timed("cublas_bf16", lambda: a @ a)
    timed("cublas_f32", lambda: a.float() @ a.float())
    timed("cublaslt_bias", lambda: torch.nn.functional.linear(a, a, a[0]))
    timed("allocator_grow", lambda: torch.empty(WARM_ALLOC, dtype=torch.uint8,
                                                device=device))
    x = torch.ones(WARM_GATHER // 4, device=device)
    outs = [torch.empty_like(x) for _ in range(world)]
    timed("gloo_first", lambda: dist.all_gather(outs, x))
    timed("gloo_second", lambda: dist.all_gather(outs, x))
    return out


class _Tagged:
    """A queue whose results carry ``extra`` (a spawned rank's own data)."""

    def __init__(self, queue, extra):
        self.queue, self.extra = queue, extra

    def put(self, item):
        rank, res, err = item
        self.queue.put((rank, res if res is None else dict(res, **self.extra),
                        err))


def _first_step_worker(rank, world, port, args, queue, warm, std=None):
    """``launch.train``'s rank, its host timeline stamped (``time.time()``,
    comparable across the processes of one host) at its entry, torch
    imported, the group joined, ``train_rank`` started, the CUDA context,
    the engine and its groups bound, the state built, the run's end and
    ``train_rank``'s end (results under ``timeline``); with ``warm`` it runs
    ``warm_up`` after the state is built, before the steps (under
    ``warm``)."""
    timeline = dict(entry=time.time())
    import torch
    import torch.distributed  # noqa: F401

    from repro_torch.core import engine
    from repro_torch.launch import train
    from repro_torch.train import trainer

    timeline["torch"] = time.time()

    def stamped(obj, attr, before=None, after=None):
        real = getattr(obj, attr)

        def call(*a, **kw):
            if before and before not in timeline:
                timeline[before] = time.time()
            out = real(*a, **kw)
            if after and after not in timeline:
                timeline[after] = time.time()
            return out
        setattr(obj, attr, call)

    stamped(train, "init_group", after="group")
    stamped(train, "train_rank", before="start", after="end")
    stamped(torch.cuda, "set_device", after="context")
    stamped(engine.ZeroEngine, "__init__", after="engine")
    timed = {}
    real_run = trainer.Trainer.run

    def run(self, state, n_steps, **kw):
        timeline["state"] = time.time()
        if warm:
            timed.update(warm_up(self.engine.device, world))
        out = real_run(self, state, n_steps, **kw)
        timeline["run"] = time.time()
        return out

    trainer.Trainer.run = run
    train._worker(rank, world, port, args, None, None, None,
                  _Tagged(queue, dict(warm=timed, timeline=timeline)), std)


def first_step(c) -> dict:
    """chip_smoke's train phase run for 3 steps, traced without probes:
    its ranks spawned (a fresh interpreter each, as before the launcher's
    fork server), forked from the fork server that preloads torch, and
    forked and warmed up (``_first_step_worker``): every rank's timeline
    relative to the entry, its steps' seconds and fenced segments, and the
    warm run's first uses."""
    argv = list(c.TRAIN_ARGS)
    argv[argv.index("--steps") + 1] = "3"
    argv += ["--trace", "--probe-every", "0"]
    out = {}
    for label, start, warm in (("spawn", "spawn", False),
                               ("forkserver", "forkserver", False),
                               ("warm", "forkserver", True)):
        t0 = time.perf_counter()
        runs = run_ranks(argv, None, worker=_first_step_worker,
                         extra=(warm,), start=start)
        wall = time.perf_counter() - t0
        rows = []
        for r in runs:
            tl = r["timeline"]
            rows.append(dict(
                rank=r["rank"], step_s=r["step_times"],
                segments=r["trace"]["segments"],
                collective_s=r["collective_s"], warm=r["warm"],
                timeline={k: v - tl["entry"] for k, v in sorted(
                    tl.items(), key=lambda kv: kv[1])}))
            print(f"first_step {label} rank {r['rank']}: "
                  f"{json.dumps(rows[-1])}", flush=True)
        out[label] = dict(wall_s=wall, ranks=rows)
        print(f"first_step {label}: {wall:.1f} s", flush=True)
    return out


def run_ranks(argv, arch, plain=(), host_events=False, worker=None,
              extra=(), start="forkserver") -> list[dict]:
    """``launch.train.run`` of ``argv`` on its local ranks through
    ``_worker`` (or ``worker(rank, world, port, args, queue, *extra)``),
    started as the launcher starts them (``start``: its fork server) or by
    another start method: each rank's result, by rank."""
    import multiprocessing as mp

    from repro_torch.launch import train

    args = train.build_parser().parse_args(argv)
    n = args.devices
    ctx = train.fork_context() if start == "forkserver" else \
        mp.get_context(start)
    queue = ctx.Queue()
    store = train.rendezvous(n, args.timeout)
    t_spawn = time.time()
    std = (train.ParentFd(1), train.ParentFd(2))
    procs = [ctx.Process(target=_worker, args=(r, n, store.port, args, arch,
                                               queue, tuple(plain),
                                               host_events, std))
             if worker is None else
             ctx.Process(target=worker, args=(r, n, store.port, args, queue)
                         + tuple(extra) + (std,))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + args.timeout
    try:
        while len(results) < n and not errors:
            try:
                rank, res, err = queue.get(timeout=5)
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    errors.append("a rank died or timed out")
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
        raise RuntimeError("\n".join(errors))
    t_joined = time.time()
    for r in results.values():
        if "timeline" in r:        # a _first_step_worker's
            r["timeline"].update(spawn=t_spawn, joined=t_joined)
    return [results[r] for r in range(n)]


def ssm_ablation(c) -> dict:
    """falcon-mamba-7b as ``ssm_train_phase`` runs it, untraced, through
    every kernel, through none, and with each of ABLATED plain: every
    run's per-step loss and grad norm and their relative gaps to the
    plain run's, with the runs' ranks agreeing."""
    arch = c.cut_train_arch("falcon-mamba-7b", c.SSM_TRAIN_L)
    runs = {"kernels": (c.SSM_TRAIN_ARGS, ())}
    runs.update({f"{name} plain": (c.SSM_TRAIN_ARGS, (name,))
                 for name in ABLATED})
    runs["plain"] = (c.SSM_TRAIN_ARGS + ["--kernel-impl", "plain"], ())
    out = {}
    for key, (argv, plain) in runs.items():
        t0 = time.perf_counter()
        ranks = run_ranks(argv, arch, plain)
        r0 = ranks[0]
        if any((r["losses"], r["grad_norms"]) != (r0["losses"],
                                                   r0["grad_norms"])
               for r in ranks):
            raise c.Failed(f"ssm_ablation {key}: ranks disagree")
        out[key] = dict(losses=r0["losses"], grad_norms=r0["grad_norms"],
                        lrs=r0["lrs"], launches_per_rank=r0["launches"],
                        run_s=time.perf_counter() - t0)
        print(f"  ssm_ablation {key}: {out[key]}", flush=True)
    base = out["plain"]
    for key, res in out.items():
        res["loss_rel_vs_plain"] = [abs(a - b) / abs(b) for a, b in
                                    zip(res["losses"], base["losses"])]
        res["grad_norm_rel_vs_plain"] = [abs(a - b) / abs(b) for a, b in
                                         zip(res["grad_norms"],
                                             base["grad_norms"])]
    return out


def trace_events(c) -> dict:
    """qwen2-0.5b (24 layers) and gpt-neox-20b (1 layer), 2 steps, step 1
    traced recording the card's events alone and then the host's too:
    each run's traced device ms by rank, its step times, and rank 0's
    device time by kernel name in both runs (the names whose ms differ
    most first)."""
    out = {}
    for label, argv, arch in (
            ("qwen2-0.5b", ["--arch", "qwen2-0.5b"] + c.NEOX_TRAIN_ARGS[2:],
             None),
            ("gpt-neox-20b", c.NEOX_TRAIN_ARGS, c.neox_train_arch())):
        argv = argv + ["--profile-step", str(c.NEOX_PROFILE_STEP)]
        runs = {}
        for key, host in (("card", False), ("card+host", True)):
            t0 = time.perf_counter()
            ranks = run_ranks(argv, arch, host_events=host)
            runs[key] = dict(
                device_ms=[r["profile"]["device_ms"] for r in ranks],
                wall_ms=[r["profile"]["wall_ms"] for r in ranks],
                step_s=[r["step_times"] for r in ranks],
                losses=ranks[0]["losses"],
                kernel_calls=[sum(k["calls"] for k in r["profile"]["kernels"])
                              for r in ranks],
                kernels={k["name"]: (k["ms"], k["calls"])
                         for k in ranks[0]["profile"]["kernels"]},
                run_s=time.perf_counter() - t0)
        a, b = runs["card"]["kernels"], runs["card+host"]["kernels"]
        rows = [dict(name=n[:100], card_ms=a.get(n, (0.0, 0))[0],
                     card_host_ms=b.get(n, (0.0, 0))[0],
                     card_calls=a.get(n, (0.0, 0))[1],
                     card_host_calls=b.get(n, (0.0, 0))[1])
                for n in set(a) | set(b)]
        rows.sort(key=lambda r: -abs(r["card_host_ms"] - r["card_ms"]))
        for run in runs.values():
            del run["kernels"]
        out[label] = dict(runs=runs, by_kernel_rank0=rows[:25],
                          names_only_card=len(set(a) - set(b)),
                          names_only_card_host=len(set(b) - set(a)))
        print(f"  trace_events {label}: "
              f"{ {k: v['device_ms'] for k, v in runs.items()} }; rank 0 by "
              f"kernel, largest gaps: {rows[:8]}", flush=True)
    return out


def _traced_prefill(c, s, pre_k, tokens, variant: str) -> dict:
    """One prefill under torch.profiler as ``variant`` runs it: its flash
    launches counted and traced, the calls of every traced device kernel,
    the first / last device event against the host's clock (us), and the
    first few device events in time order."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train.trainer import pad_trace

    act = torch.profiler.ProfilerActivity
    acts = [act.CUDA] + ([act.CPU] if variant == "bare+host" else [])
    before = ops.launches()["flash_attention"]
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    with prof:
        t_in = time.time_ns()
        if variant == "padded":
            pad_trace(s["device"])
        pre_k(s["residency"], {"tokens": tokens})
        torch.cuda.synchronize()
        t_done = time.time_ns()
        if variant == "padded":
            pad_trace(s["device"])
    counted = ops.launches()["flash_attention"] - before
    res = prof.profiler.kineto_results
    dev = sorted((e for e in res.events()
                  if e.device_type() != torch.autograd.DeviceType.CPU),
                 key=lambda e: e.start_ns())
    calls = {}
    for e in dev:
        calls[e.name()] = calls.get(e.name(), 0) + 1
    last = max(dev, key=lambda e: e.end_ns())
    return dict(variant=variant, flash_counted=counted,
                flash_traced=sum(n for k, n in calls.items()
                                 if "flash_attention_" in k),
                events=len(dev), calls=calls,
                trace_start_after_enter_us=(res.trace_start_ns() - t_in) / 1e3,
                first_event_after_enter_us=(dev[0].start_ns() - t_in) / 1e3,
                last_event_before_sync_us=(t_done - last.end_ns()) / 1e3,
                head=[(e.name()[:40], (e.start_ns() - t_in) / 1e3)
                      for e in dev[:4]])


MARGINS = ("trace_start_after_enter_us", "first_event_after_enter_us",
           "last_event_before_sync_us")


def trace_window(c, traces: int) -> dict:
    """gpt-neox-20b's prefill traced ``traces`` times in turns bare,
    padded and bare with the host's events (``_traced_prefill``). For each
    variant: every trace's (device events, flash traced, margins); each
    trace with fewer device events than the variant's most, or fewer
    flash launches than counted, with what it lost against a whole trace
    and its first events."""
    import statistics

    import torch

    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.resident import ResidentServeEngine

    s = c.serve_phase(c.NEOX_SERVE_ARGS, c.SERVE_KERNELS)
    shape = ShapeConfig("p", s["args"].prompt_len, 1, "decode")
    tokens = torch.as_tensor(s["reqs"][0].prompt[None]).long().to(
        s["device"])
    pre_k = ResidentServeEngine(s["model"], s["layout"], shape).make_prefill()
    for _ in range(3):
        pre_k(s["residency"], {"tokens": tokens})
    variants = ("bare", "padded", "bare+host")
    rows = [_traced_prefill(c, s, pre_k, tokens, variants[i % 3])
            for i in range(traces)]
    out = {}
    for v in variants:
        mine = [r for r in rows if r["variant"] == v]
        most = max(r["events"] for r in mine)
        whole = next(r for r in mine if r["events"] == most)
        lossy = [dict(index=rows.index(r), events=r["events"],
                      flash=(r["flash_counted"], r["flash_traced"]),
                      margins={k: r[k] for k in MARGINS}, head=r["head"],
                      whole_head=whole["head"],
                      lost={k[:60]: n - r["calls"].get(k, 0)
                            for k, n in whole["calls"].items()
                            if n != r["calls"].get(k, 0)})
                 for r in mine if r["events"] < most
                 or r["flash_traced"] != r["flash_counted"]]
        margins = {k: dict(min=min(r[k] for r in mine),
                           median=statistics.median(r[k] for r in mine),
                           max=max(r[k] for r in mine)) for k in MARGINS}
        out[v] = dict(traces=len(mine), events_most=most, lossy=lossy,
                      margins=margins,
                      rows=[[r["events"], r["flash_traced"]]
                            + [round(r[k], 1) for k in MARGINS]
                            for r in mine])
        print(f"  trace_window {v}: {len(lossy)} of {len(mine)} traces lost "
              f"events; margins {json.dumps(margins)}; lossy "
              f"{json.dumps(lossy, default=str)[:3000]}", flush=True)
    return out


def depth_search(c, name: str, depths, argv) -> dict:
    """``name`` at each of ``depths`` (ascending) through the kernels until
    a depth leaves under TRAIN_HEADROOM of the card free or fails, then the
    deepest that fit through the plain versions: each run's summed peak,
    bytes a parameter, losses and step times (or its error)."""
    import torch

    card = torch.cuda.get_device_properties(0).total_memory
    out, fit = {}, None
    for n in depths:
        arch = c.cut_train_arch(name, n)
        gc.collect()
        torch.cuda.empty_cache()
        card_free = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        try:
            ranks = run_ranks(argv, arch)
        except RuntimeError as e:
            out[n] = dict(error=str(e)[-2000:], run_s=time.perf_counter() - t0)
            print(f"  depth {name} {n}: failed after {out[n]['run_s']:.1f} s",
                  flush=True)
            break
        peak = sum(r["peak_bytes"] for r in ranks)
        params = c.arch_params(arch)
        out[n] = dict(params=params, peak_bytes_per_rank=[
            r["peak_bytes"] for r in ranks], peak_bytes_sum=peak,
            bytes_per_param=peak / params, spare_gib=(card - peak) / 2 ** 30,
            peak_reserved_sum=sum(r["peak_reserved_bytes"] for r in ranks),
            card_free_at_start=card_free,
            losses=ranks[0]["losses"], grad_norms=ranks[0]["grad_norms"],
            step_s=ranks[0]["step_times"],
            phase_s=ranks[0]["phase_s"], run_s=time.perf_counter() - t0)
        print(f"  depth {name} {n}: {out[n]}", flush=True)
        if card - peak < c.TRAIN_HEADROOM:
            break
        fit = n
    if fit is not None:
        t0 = time.perf_counter()
        arch = c.cut_train_arch(name, fit)
        try:
            ranks = run_ranks(argv + ["--kernel-impl", "plain"], arch)
            peak = sum(r["peak_bytes"] for r in ranks)
            out["plain"] = dict(layers=fit, peak_bytes_sum=peak,
                                spare_gib=(card - peak) / 2 ** 30,
                                peak_reserved_sum=sum(
                                    r["peak_reserved_bytes"] for r in ranks),
                                losses=ranks[0]["losses"],
                                grad_norms=ranks[0]["grad_norms"],
                                run_s=time.perf_counter() - t0)
        except RuntimeError as e:
            out["plain"] = dict(layers=fit, error=str(e)[-2000:])
        print(f"  depth {name} plain: {out['plain']}", flush=True)
    return dict(card_bytes=card, runs=out, deepest_fit=fit)


def ckpt_probe(c) -> dict:
    """The train phase's kernel run (saving step c.CKPT_EVERY), then the
    ckpt phase on its checkpoint; the checkpoint is removed after."""
    import shutil

    from repro_torch.launch import train

    shutil.rmtree(c.CKPT_DIR, ignore_errors=True)
    try:
        kern = train.run(train.build_parser().parse_args(c.TRAIN_ARGS + [
            "--profile-step", str(c.PROFILE_STEP), "--ckpt-dir",
            str(c.CKPT_DIR), "--ckpt-every", str(c.CKPT_EVERY)]))
        print(f"kernel run: losses {kern[0]['losses']} grad norms "
              f"{kern[0]['grad_norms']} step_s {kern[0]['step_times']}",
              flush=True)
        ck = c.ckpt_phase(dict(kernel=kern))
    finally:
        shutil.rmtree(c.CKPT_DIR, ignore_errors=True)
    c.print_ckpt(ck)
    line = c.ckpt_line(ck)
    print("ckpt " + json.dumps(line), flush=True)
    return line


def main():
    import torch

    import chip_smoke as c
    from repro_torch.kernels import cuda as kcuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", nargs="*", default=list(PHASES),
                    choices=PHASES)
    ap.add_argument("--out", default="",
                    help="also write every phase's result to this file")
    ap.add_argument("--neox-layers", type=int, nargs="*", default=[3, 4, 5],
                    help="gpt-neox-20b depths the depth phase tries")
    ap.add_argument("--deepseek-layers", type=int, nargs="*",
                    default=[6, 8, 10],
                    help="deepseek-7b depths the depth phase tries")
    ap.add_argument("--moe-layers", type=int, nargs="*", default=[1, 2],
                    help="phi3.5-moe-42b-a6.6b depths train_moe tries")
    ap.add_argument("--traces", type=int, default=90,
                    help="prefills the trace_window phase traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(f"device: {c.nvidia_smi()}", flush=True)
    kcuda.build_all()
    out = {"device": c.nvidia_smi()}

    def save():
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, default=str, indent=1))

    if "ssm" in args.phase or "gemma" in args.phase:
        c.check_kernels(dev, gen, {})
        # the checks' blocks stay in this process's allocator cache
        # otherwise, beside the ranks' own (gemma's four hold 52 GB of 80)
        gc.collect()
        torch.cuda.empty_cache()
    if "scan_backward" in args.phase:
        out["scan_backward"] = scan_backward_probe(c, gen, dev)
        print(f"scan_backward {json.dumps(out['scan_backward'])}", flush=True)
    if "ssm" in args.phase:
        tsm = c.ssm_train_phase()
        c.print_cut_train(tsm, "selective_scan")
        out["train_ssm"] = c.cut_train_line(tsm, "scan")
        print("train_ssm " + json.dumps(out["train_ssm"]), flush=True)
    if "gemma" in args.phase:
        tgm = c.gemma_train_phase()
        c.print_cut_train(tgm, "tensor-core flash")
        out["train_gemma"] = c.cut_train_line(tgm, "flash")
        print("train_gemma " + json.dumps(out["train_gemma"]), flush=True)
    save()
    if "ssm_ablation" in args.phase:
        out["ssm_ablation"] = ssm_ablation(c)
        save()
    if "serve_deepseek" in args.phase:
        ds, dspf, ds_t = c.deepseek_phase(gen, dev)
        c.print_attn(ds, dspf)
        for key, tm in ds_t.items():
            if key != "shapes":
                c.print_timing(key, tm)
        c.print_shapes(ds_t["shapes"])
        out["serve_deepseek"] = dict(c.serve_attn_line(ds, dspf),
                                     shapes=ds_t["shapes"])
        print("serve_deepseek " + json.dumps(out["serve_deepseek"],
                                             default=str), flush=True)
        save()
    if "serve_moe" in args.phase:
        mo, mopf, mo_t = c.moe_phase(gen, dev, {})
        c.print_moe(mo, mopf, mo_t)
        out["serve_moe"] = dict(c.serve_attn_line(mo, mopf),
                                build_peak_bytes=mo["setup_peak_bytes"],
                                build_peak_predicted=mo["build_peak_predicted"],
                                decode_step_launches=mo["step_launches"],
                                routing_rows_differ=mopf["routing_rows_differ"],
                                timing=mo_t)
        print("serve_moe " + json.dumps(out["serve_moe"], default=str),
              flush=True)
        save()
        mx, mxpf = c.mixtral_phase(gen, dev, {})
        out["serve_mixtral"] = c.mixtral_line(mx, mxpf)
        print("serve_mixtral " + json.dumps(out["serve_mixtral"]), flush=True)
        out["serve_vlm"] = c.vlm_phase(gen, dev)
        c.print_vlm(out["serve_vlm"])
        print("serve_vlm " + json.dumps(out["serve_vlm"]), flush=True)
        save()
    if "jamba" in args.phase:
        jb, jbpf, jb_t = c.jamba_phase(gen, dev, {})
        c.print_jamba(jb, jbpf, jb_t)
        out["serve_jamba"] = c.jamba_line(jb, jbpf, jb_t)
        print("serve_jamba " + json.dumps(out["serve_jamba"], default=str),
              flush=True)
        save()
        tjb = c.jamba_train_phase()
        c.print_cut_train(tjb, "selective_scan")
        out["train_jamba"] = c.cut_train_line(tjb, "scan")
        print("train_jamba " + json.dumps(out["train_jamba"]), flush=True)
        save()
    if "train_moe" in args.phase:
        out["depth_moe"] = depth_search(c, "phi3.5-moe-42b-a6.6b",
                                        args.moe_layers, c.MOE_TRAIN_ARGS)
        save()
        tvl = c.vlm_train_phase()
        c.print_cut_train(tvl, "tensor-core flash")
        out["train_vlm"] = c.cut_train_line(tvl, "flash")
        print("train_vlm " + json.dumps(out["train_vlm"]), flush=True)
        save()
    if "depth" in args.phase:
        out["depth"] = {
            name: depth_search(c, name, layers, argv)
            for name, layers, argv in (
                ("gpt-neox-20b", args.neox_layers, c.NEOX_TRAIN_ARGS),
                ("deepseek-7b", args.deepseek_layers,
                 c.DEEPSEEK_TRAIN_ARGS))}
        save()
    if "ckpt" in args.phase:
        out["ckpt"] = ckpt_probe(c)
        save()
    if "trace_events" in args.phase:
        out["trace_events"] = trace_events(c)
        save()
    if "trace_window" in args.phase:
        out["trace_window"] = trace_window(c, args.traces)
        save()
    if "first_step" in args.phase:
        out["first_step"] = first_step(c)
        save()
    if "replica" in args.phase:
        try:
            rp = c.replica_phase()
            c.print_replica(rp)
            out["replica"] = c.replica_line(rp)
            print("replica " + json.dumps(out["replica"]), flush=True)
        finally:
            shutil.rmtree(c.TRACE_DIR, ignore_errors=True)
        save()
    if "serve_mesh" in args.phase:
        sm = c.serve_mesh_phase()
        c.print_serve_mesh(sm)
        out["serve_mesh"] = c.serve_mesh_line(sm)
        print("serve_mesh " + json.dumps(out["serve_mesh"]), flush=True)
        save()
    if "timing" in args.phase:
        timing = {key: c.flash_timing(gen, dev, c.SCAN_TRAIN_B, c.GEMMA_H,
                                      1024, c.GEMMA_HD, torch.bfloat16,
                                      "gemma training attention",
                                      hkv=c.GEMMA_HKV, window=window)
                  for key, window in (("flash_attention_train_d256_window",
                                       c.GEMMA_W),
                                      ("flash_attention_train_d256", 0))}
        timing["selective_scan_train"] = c.scan_timing(
            gen, dev, c.SCAN_TRAIN_B, 1024,
            "one layer's training scan, a rank")
        for key, tm in timing.items():
            c.print_timing(key, tm)
        out["timing"] = timing
        save()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        # the launcher's fork server, where this run started one
        launcher = sys.modules.get("repro_torch.launch.train")
        if launcher is not None:
            launcher.stop_fork_server()
    sys.exit(code)
