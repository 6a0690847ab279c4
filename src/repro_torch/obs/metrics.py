"""Structured per-step metrics stream (JSONL) for trained and traced runs.

Port of ``repro.obs.metrics``, with its schema: one JSON object a line a
step. The global scalars (loss, grad norm, tokens) come from the step
already summed over the mesh (``det_psum``); the host fields (per-phase ms,
memory high-water) are per rank, so a multi-rank run writes a *lane* a
rank (``<stem>.rank<k><suffix>``) and readers merge on ``(step, rank)``.
The serving batcher writes the same transport with ``SERVE_REQUIRED_FIELDS``.
"""
from __future__ import annotations

import json
from pathlib import Path

# every training record carries these; absence is a schema violation
REQUIRED_FIELDS = (
    "step", "rank", "loss", "grad_norm", "lr", "tokens",
    "dt_s", "tokens_per_s", "tflops_per_gpu",
    "phase_ms", "overlap_efficiency",
    "memory_hw_bytes", "memory_pred_bytes",
)

# serving records (serve/scheduler.py): throughput, queue and SLO state per
# scheduler step; readers tell the two apart by "loss" (train)
SERVE_REQUIRED_FIELDS = (
    "step", "rank", "tokens", "dt_s", "tokens_per_s",
    "queue_depth", "active_slots",
    "admitted", "rejected", "preempted", "retired", "free_pages",
    "p50_ms", "p99_ms", "phase_ms",
)


def _fields_for(rec: dict) -> tuple[str, ...]:
    return REQUIRED_FIELDS if "loss" in rec else SERVE_REQUIRED_FIELDS


def model_flops_per_token(param_count: int) -> float:
    """Dense-transformer step FLOPs a token: 6 N (forward 2 N, backward
    4 N), the reference's accounting."""
    return 6.0 * float(param_count)


def tflops_per_gpu(param_count: int, tokens: float, dt_s: float,
                   n_devices: int) -> float:
    """Model-TFLOPS a device for one step: ``tokens`` is the global token
    count, so the FLOP total is divided over the devices (the ranks)."""
    if dt_s <= 0.0 or n_devices <= 0:
        return 0.0
    return model_flops_per_token(param_count) * tokens / dt_s / n_devices / 1e12


def lane_path(path, rank: int, n_ranks: int) -> Path:
    """A one-rank run writes ``path`` itself; a multi-rank run writes a lane
    a rank beside it, so no two processes share a file."""
    p = Path(path)
    if n_ranks <= 1:
        return p
    return p.with_name(f"{p.stem}.rank{rank}{p.suffix}")


class MetricsWriter:
    """JSONL writer, one a process (lane); each record must hold every field
    of ``fields`` (``REQUIRED_FIELDS`` by default, ``SERVE_REQUIRED_FIELDS``
    for the batcher), checked as it is written."""

    def __init__(self, path, rank: int = 0, n_ranks: int = 1,
                 fields: tuple[str, ...] = REQUIRED_FIELDS):
        self.rank = rank
        self.fields = fields
        self.path = lane_path(path, rank, n_ranks)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "w")

    def write(self, record: dict) -> dict:
        rec = dict(record)
        rec.setdefault("rank", self.rank)
        missing = [k for k in self.fields if k not in rec]
        if missing:
            raise ValueError(f"metrics record missing fields: {missing}")
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()
        return rec

    def close(self):
        self._fh.close()


def read_jsonl(path, fields: tuple[str, ...] | None = None) -> list[dict]:
    """Read one lane, checking the schema of every line (``fields=None``:
    train or serve by the record)."""
    records = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        want = fields if fields is not None else _fields_for(rec)
        missing = [k for k in want if k not in rec]
        if missing:
            raise ValueError(f"{path}: record missing fields: {missing}")
        records.append(rec)
    return records


def read_lanes(path, fields: tuple[str, ...] | None = None) -> list[dict]:
    """Read a metrics stem and its ``.rank<k>`` lanes, merged and sorted by
    (step, rank)."""
    p = Path(path)
    records = []
    if p.exists():
        records += read_jsonl(p, fields)
    for lane in sorted(p.parent.glob(f"{p.stem}.rank*{p.suffix}")):
        records += read_jsonl(lane, fields)
    return sorted(records, key=lambda r: (r["step"], r["rank"]))


def aggregates(records: list[dict]) -> dict:
    """Run summary. The first recorded step pays for first use (the
    kernels' libraries, cuBLAS, the allocator's growth), so the time and
    throughput means leave it out; the loss and grad norm means keep every
    step."""
    if not records:
        return {}
    steps = sorted({r["step"] for r in records})
    post = [r for r in records if r["step"] != steps[0]] or records
    mean = lambda rows, k: sum(r[k] for r in rows) / len(rows)  # noqa: E731
    return dict(
        n_steps=len(steps),
        n_timed_steps=len(sorted({r["step"] for r in post})),
        loss_mean=mean(records, "loss"),
        grad_norm_mean=mean(records, "grad_norm"),
        dt_s_mean=mean(post, "dt_s"),
        tokens_per_s_mean=mean(post, "tokens_per_s"),
        tflops_per_gpu_mean=mean(post, "tflops_per_gpu"),
    )


def serve_aggregates(records: list[dict]) -> dict:
    """Serving summary of a serve-schema lane: totals from the last record's
    counters, rates without the first record, latency percentiles from the
    last record."""
    if not records:
        return {}
    last = records[-1]
    post = records[1:] or records
    tok = sum(r["tokens"] for r in post)
    dt = sum(r["dt_s"] for r in post)
    return dict(
        n_steps=len(records),
        tokens=sum(r["tokens"] for r in records),
        tokens_per_s=(tok / dt if dt > 0 else 0.0),
        admitted=last["admitted"], rejected=last["rejected"],
        preempted=last["preempted"], retired=last["retired"],
        queue_depth_max=max(r["queue_depth"] for r in records),
        p50_ms=last["p50_ms"], p99_ms=last["p99_ms"],
    )


def last_phase_ms(records: list[dict]) -> dict[str, float]:
    """Per-phase ms of the last record with a non-empty ``phase_ms``."""
    for rec in reversed(records):
        if rec.get("phase_ms"):
            return {k: float(v) for k, v in rec["phase_ms"].items()}
    return {}


def memory_high_water(device=None) -> int:
    """Peak bytes the allocator handed out on ``device`` (a card:
    ``torch.cuda.max_memory_allocated``); 0 on the CPU, which keeps no such
    count."""
    if device is None or getattr(device, "type", device) != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated(device))
