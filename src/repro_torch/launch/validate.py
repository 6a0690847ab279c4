"""Close the loop: the dry run's collective census against the paper's
analytic Tables VII/VIII, per scheme.

    PYTHONPATH=src python -m repro_torch.launch.validate --arch gpt-neox-20b

Port of ``repro.launch.validate`` (``analytic`` verbatim, ``compare`` on the
port's record, ``main``). For each phase the census' wire bytes (one rank's
traced step, ``launch/census.py``) are held against the analytic model
built from the engine's padded sizes:

  fwd+bwd weight all-gather   n_passes * psi_pad * bytes_w * (d-1)/d
  gradient reduce-scatter     psi_pad * bytes_g * (d-1)/d  (a2a-based)
  cross-replica sync          2 * (psi_pad/g) * (r-1)/r * 4   (allreduce)
  update all-gather           (psi_pad/w) * bytes_u * (1 - w/os)

Remat makes the backward re-gather run twice (checkpointed blocks recompute
their forward), so n_passes = 3 for gathered weights. The check asserts
measured / analytic within a factor window and prints the split.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def analytic(engine, cfg, n_passes_gather: float = 3.0) -> dict[str, float]:
    """Expected per-device wire bytes per step from the engine's real sizes."""
    psi = engine.padded_param_count()
    w, g, os_ = cfg.w_degree, cfg.g_degree, cfg.os_degree
    r = cfg.size(cfg.axes.replica)
    bytes_w = 1.0 if cfg.quantize_weights else 2.0
    # quantized INT4 grads: 0.5 B payload (+ scales, small); else fp32 RS
    bytes_g = 0.5 if cfg.quantize_grads else 4.0
    out = {}
    out["weight_gathers"] = n_passes_gather * psi * bytes_w * (w - 1) / w \
        if w > 1 else 0.0
    if cfg.axes.secondary is not None and cfg.sec_degree and w == 1:
        out["weight_gathers"] = 0.0
    out["grad_rs"] = psi * bytes_g * (g - 1) / g if g > 1 else 0.0
    out["cross_replica"] = 2.0 * (psi / g) * 4.0 * (r - 1) / r if r > 1 else 0.0
    upd_axes = cfg.axes.extra_grad + cfg.axes.replica
    d_upd = cfg.size(upd_axes)
    bytes_u = 1.0 if cfg.quantize_update_gather else 2.0
    out["update_gather"] = (psi / w) * bytes_u * (1 - 1 / d_upd) \
        if d_upd > 1 else 0.0
    out["total"] = sum(out.values())
    return out


def engine_for(arch: str, scheme: str, mesh_name: str, quant_block: int = 2048):
    """The dry run's abstract engine of ``arch`` under ``scheme`` on the
    named production mesh (rank 0 of a fake group of its size)."""
    from ..core.engine import TrainHparams, ZeroEngine
    from ..models.registry import build_model, get_arch
    from .dryrun import MESHES, fake_group
    from .mesh import scheme_config

    mesh = MESHES[mesh_name]()
    fake_group(mesh.size)
    model = build_model(get_arch(arch))
    cfg = scheme_config(scheme, mesh, quant_block=quant_block)
    return ZeroEngine.abstract(model.leaf_specs(), cfg, mesh, TrainHparams())


def compare(arch: str, scheme: str, rec_path: Path, print_fn=print,
            window=(0.5, 2.0)) -> bool:
    rec = json.loads(rec_path.read_text())
    eng = engine_for(arch, scheme, "prod_mp" if rec["mesh"] == "prod_mp"
                     else "prod")
    a = analytic(eng, eng.cfg)
    measured = rec["census"]["total_wire_bytes"]
    ratio = measured / max(a["total"], 1.0)
    print_fn(f"{arch} {scheme} ({rec['mesh']}):")
    for k, v in a.items():
        print_fn(f"  analytic {k:16s} {v / 1e9:8.2f} GB")
    print_fn(f"  measured total         {measured / 1e9:8.2f} GB "
             f"(ratio {ratio:.2f}; window {window})")
    ok = window[0] <= ratio <= window[1]
    if not ok:
        print_fn("  !! outside window — investigate")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.validate")
    ap.add_argument("--arch", default="gpt-neox-20b")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    d = Path(args.dir)
    ok = True
    for scheme in ("zero3", "zeropp", "zero_topo"):
        p = d / f"{args.arch}__train_4k__prod__{scheme}.json"
        if p.exists():
            ok &= compare(args.arch, scheme, p)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
