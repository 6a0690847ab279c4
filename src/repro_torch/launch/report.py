"""The dry-run and roofline tables from the dry run's JSON records.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir experiments/dryrun_torch]

Port of ``repro.launch.report`` (``load``, ``dryrun_table``,
``roofline_table``, ``advice``): the terms are one rank's step on an H100
(``launch.roofline.H100_SXM``), and the advice names this port's CUDA
kernels.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

from .roofline import H100_SXM


def load(d: Path) -> list[dict]:
    out = []
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        parts = f.stem.split("__")
        r["variant"] = "+".join(parts[4:]) if len(parts) > 4 else "baseline"
        out.append(r)
    return out


def fmt_bytes(b: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(b) >= div:
            return f"{b / div:.2f}{unit}"
    return f"{b:.0f}B"


def dryrun_table(recs: list[dict]) -> str:
    lines = ["| arch | shape | mesh | scheme | variant | chips | params "
             "| temp bytes/dev"
             " | arg bytes/dev | HLO GFLOPs/dev | wire bytes/dev | collectives"
             " (ag/ar/rs/a2a) | compile s |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        c = r["census"]["collective_counts"]
        cc = "/".join(str(int(c.get(k, 0))) for k in
                      ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['scheme']} "
            f"| {r.get('variant', 'baseline')} "
            f"| {r['n_chips']} | {r['n_params'] / 1e9:.2f}B "
            f"| {fmt_bytes(r['memory']['temp_bytes'])} "
            f"| {fmt_bytes(r['memory']['argument_bytes'])} "
            f"| {r['census']['flops'] / 1e9:,.0f} "
            f"| {fmt_bytes(r['census']['total_wire_bytes'])} "
            f"| {cc} | {r['compile_s']:.0f} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict]) -> str:
    lines = ["| arch | shape | scheme | variant | compute s | memory s | "
             "collective s |"
             " bottleneck | useful-FLOP ratio | MFU bound | what would move "
             "the dominant term |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['scheme']} "
            f"| {r.get('variant', 'baseline')} "
            f"| {rl['compute_s']:.3f} | {rl['memory_s']:.3f} "
            f"| {rl['collective_s']:.3f} | **{rl['bottleneck']}** "
            f"| {rl['useful_flop_ratio']:.2f} | {rl['mfu_bound'] * 100:.1f}% "
            f"| {advice(r)} |")
    return "\n".join(lines)


def advice(r: dict) -> str:
    rl = r["roofline"]
    b = rl["bottleneck"]
    if b == "memory":
        if r["arch"].startswith("falcon") or "jamba" in r["arch"]:
            return "move the scan's backward into a CUDA kernel " \
                   "(csrc/selective_scan.cu runs the forward only)"
        if r["shape"].startswith("train"):
            return "a flash-attention backward kernel (the backward is " \
                   "autograd through the plain version)"
        return "fuse the dequant chains into the CUDA kernels " \
               "(csrc/dequant_matmul.cu, csrc/flash_attention.cu)"
    if b == "collective":
        if r["shape"].startswith(("decode", "long")):
            return "resident tensor-parallel weights for serving (gather " \
                   "activations, not parameters)"
        return "deepen quantization / shrink gather group (topo tiers)"
    return "compute-bound: overlap remaining collectives, raise batch"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default="experiments/report_torch.md")
    args = ap.parse_args(argv)
    recs = load(Path(args.dir))
    prod = [r for r in recs if r["mesh"] == "prod"]
    mp = [r for r in recs if r["mesh"] == "prod_mp"]
    other = [r for r in recs if r["mesh"] not in ("prod", "prod_mp")]

    parts = ["## Dry run (one pod: 16x16 = 256 GPUs; rank 0's traced step)",
             "", dryrun_table(prod), "",
             "## Dry run (two pods: 2x16x16 = 512 GPUs)", "",
             dryrun_table(mp), ""]
    if other:
        parts += ["## Dry run (other meshes/schemes)", "",
                  dryrun_table(other), ""]
    t = H100_SXM
    parts += [f"## Roofline (one pod, a GPU; {t.name}: "
              f"{t.peak_flops / 1e12:.0f} TFLOP/s bf16, "
              f"{t.peak_flops_f32 / 1e12:.0f} f32, "
              f"{t.hbm_bw / 1e12:.2f} TB/s HBM, "
              f"{t.link_bw / 1e9:.0f} GB/s NVLink a direction, "
              f"{t.cross_bw / 1e9:.0f} GB/s InfiniBand across "
              f"{t.node}-GPU nodes)", "", roofline_table(prod), ""]
    out = "\n".join(parts)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(out)
    print(f"wrote {args.out} ({len(recs)} records)")

    byb = defaultdict(list)
    for r in prod:
        byb[r["roofline"]["bottleneck"]].append(
            (r["arch"], r["shape"], r["roofline"]["step_time_s"]))
    for b, lst in byb.items():
        worst = max(lst, key=lambda t: t[2])
        print(f"{b:10s}: {len(lst)} combos; worst {worst[0]} {worst[1]} "
              f"({worst[2]:.2f}s)")


if __name__ == "__main__":
    main()
