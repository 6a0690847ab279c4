"""Serving launcher: continuous batching over the paged KV pool, from the
INT8 wire residency, on one card.

Port of ``repro.launch.serve`` with the same flags plus ``--device``
(default ``cuda``) and ``--reduced``. The reference always serves the
reduced model on fake CPU devices; this launcher serves the published width
unless ``--reduced`` is given (meant for the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --slots 4 --prompt-len 128 --max-len 256 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --requests 8 --slots 4 --prompt-len 128 --max-len 256 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --requests 8 --slots 4 --prompt-len 640 --max-len 768 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..core.partition import SCHEMES
from ..obs.metrics import (SERVE_REQUIRED_FIELDS, MetricsWriter, read_jsonl,
                           serve_aggregates)


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
    ap.add_argument("--devices", type=int, default=1,
                    help="device count; the port serves on one device")
    ap.add_argument("--quant-block", type=int, default=128)
    ap.add_argument("--backend", default="resident", choices=("resident",),
                    help="weight path: the INT8 wire residency")
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
    return ap


def setup(args):
    """Device, model, residency layout and the INT8 residency built from
    the seeded init. Returns (device, arch, model, layout, residency)."""
    from ..core.partition import single_device_config
    from ..device import resolve
    from ..models.registry import build_model, get_arch
    from ..serve.resident import ResidentLayout, build_resident, iter_primaries

    if args.devices != 1:
        raise SystemExit("--devices: the port serves on one device "
                         "(multi-device residency is not ported yet)")
    device = resolve(args.device)
    arch = get_arch(args.arch)
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


def make_batcher(args, model, layout, device, metrics=None):
    from ..serve.scheduler import ContinuousBatcher, ServeSLO
    slo = ServeSLO(max_queue_steps=args.max_queue_steps,
                   reserve_pages=args.reserve_pages)
    return ContinuousBatcher(
        model, layout, n_slots=args.slots, max_len=args.max_len,
        prompt_len=args.prompt_len, device=device,
        page_size=args.page_size or None, n_pages=args.n_pages, slo=slo,
        metrics=metrics)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, arch, model, layout, residency = setup(args)
    rep = layout.memory_report()
    print(f"residency: axes={rep['res_axes']} degree={rep['res_degree']} "
          f"wire={rep['wire_bytes']}B dense={rep['dense_bytes']}B "
          f"per device ({device})")
    metrics = MetricsWriter(args.metrics_jsonl,
                            fields=SERVE_REQUIRED_FIELDS) \
        if args.metrics_jsonl else None
    cb = make_batcher(args, model, layout, device, metrics)
    print(f"paged pool: {cb.paged.n_pages} pages x {cb.paged.page_size} "
          f"tokens ({cb.paged.blocks_per_slot}/slot)")
    reqs = make_requests(args, arch)
    t0 = time.time()
    cb.run(residency, reqs)
    dt = time.time() - t0
    if metrics is not None:
        metrics.close()
        # the lane read back, its schema checked again, and summarised
        agg = serve_aggregates(read_jsonl(args.metrics_jsonl,
                                          SERVE_REQUIRED_FIELDS))
        print(f"metrics: {args.metrics_jsonl} {json.dumps(agg)}")

    c = cb.counters
    tok = sum(len(r.out) for r in reqs)
    lat = cb.latency_percentiles()
    print(f"arch={arch.name} backend={args.backend} {args.requests} reqs "
          f"-> {tok} tokens in {dt:.2f}s ({tok / max(dt, 1e-9):.1f} tok/s, "
          f"{cb.step_count} steps)")
    print(f"admitted {c['admitted']} rejected {c['rejected']} "
          f"preempted {c['preempted']} retired {c['retired']}; "
          f"p50 {lat['p50_ms']:.1f}ms p99 {lat['p99_ms']:.1f}ms")
    done = next((r for r in reqs if r.out), None)
    if done is not None:
        print("sample:", done.out[:16])


if __name__ == "__main__":
    main()
