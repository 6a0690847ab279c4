"""Rank heartbeat / stall detector for multi-process trace mode.

Port of ``repro.obs.heartbeat``, with its file names and JSON keys, so
either package reads the other's stamps. Every collective in the step is a
barrier: one slow or dead rank stalls every other with no sign of which.
In trace mode each rank stamps a small file before every step; any process
(or ``ls``) can then read all stamps and name the rank that is behind or
silent. Stamps are written atomically (a temporary file, then a rename).
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path


def stamp_path(directory, rank: int) -> Path:
    return Path(directory) / f"heartbeat.rank{rank}.json"


def stamp(directory, rank: int, step: int) -> Path:
    """Atomically record ``rank`` entering ``step`` at wall-clock now."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = stamp_path(d, rank)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(
        dict(rank=rank, step=step, time=time.time(), pid=os.getpid())))
    os.replace(tmp, path)
    return path


def read_stamps(directory) -> dict[int, dict]:
    out: dict[int, dict] = {}
    for p in sorted(Path(directory).glob("heartbeat.rank*.json")):
        try:
            rec = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue  # mid-replace on a non-atomic filesystem; next read wins
        out[int(rec["rank"])] = rec
    return out


def straggler_report(directory, n_ranks: int, *, stall_s: float = 30.0,
                     now: float | None = None) -> dict:
    """Classify every expected rank by its last heartbeat: ``dead`` (never
    stamped), ``stalled`` (stamp older than ``stall_s``), ``behind`` (its
    step trails the largest), else ``ok``; ``ok`` overall only when every
    rank stamped recently at the largest step."""
    now = time.time() if now is None else now
    stamps = read_stamps(directory)
    max_step = max((r["step"] for r in stamps.values()), default=-1)
    ranks = {}
    for rank in range(n_ranks):
        rec = stamps.get(rank)
        if rec is None:
            ranks[rank] = dict(status="dead", step=None, age_s=None)
        else:
            age = now - rec["time"]
            status = ("stalled" if age > stall_s
                      else "behind" if rec["step"] < max_step else "ok")
            ranks[rank] = dict(status=status, step=rec["step"],
                               age_s=round(age, 3))
    bad = sorted(r for r, v in ranks.items() if v["status"] != "ok")
    return dict(ok=not bad, max_step=max_step, stragglers=bad, ranks=ranks)


def format_report(report: dict) -> str:
    if report["ok"]:
        return f"heartbeat: all ranks ok at step {report['max_step']}"
    lines = [f"heartbeat: STRAGGLERS at step {report['max_step']}: "
             f"ranks {report['stragglers']}"]
    for rank, v in sorted(report["ranks"].items()):
        if v["status"] != "ok":
            lines.append(f"  rank {rank}: {v['status']}"
                         f" (step={v['step']}, age={v['age_s']}s)")
    return "\n".join(lines)
