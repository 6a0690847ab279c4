"""Phase spans: host-side fenced timers and profiler annotations, dead by
default.

Port of ``repro.obs.spans``. The reference's step is one fused program, so
trace mode runs its phased step split into separately jitted segments. The
port's step is eager: ``ZeroEngine.train_step(..., rec=)`` runs each of its
segments under ``SpanRecorder.fenced``, which waits for the card
(``torch.cuda.synchronize``) before it reads the clock. Fencing changes
nothing the step computes, so a traced step is bit for bit the untraced one
(``tests/test_torch_obs.py``), a stronger contract than the reference's
float-close one.

Everything here is off unless running under ``tracing()``: ``scope()`` is
then a null context and no annotation is recorded.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

# top-level segments of the step in trace mode (ZeroEngine.train_step):
# fenced, measured directly, and summing to the traced step's wall time
# (the reference's 10 % bound)
SEGMENTS = ("fwd_bwd", "grad_rs_e", "cross_replica", "gnorm_clip", "update")
# attribution probes (obs.phased.PhasedStep.run_probes): serial
# re-executions of the in-loop collectives, measured out of band and NOT
# counted in the wall sum
PROBES = ("fwd", "fwd_allgather", "bwd_allgather", "grad_rs_w",
          "update_gather")

_state = threading.local()


def enabled() -> bool:
    return getattr(_state, "on", False)


class tracing:
    """Context manager enabling span scopes and annotations for code run
    inside it (thread-local, re-entrant)."""

    def __enter__(self):
        self._prev = enabled()
        _state.on = True
        return self

    def __exit__(self, *exc):
        _state.on = self._prev
        return False


def scope(name: str):
    """``torch.profiler.record_function("obs.<name>")`` under ``tracing()``
    (a range on a profiler's host timeline), else a null context."""
    if not enabled():
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(f"obs.{name}")


@dataclass
class Span:
    name: str
    t0: float        # process-relative seconds (time.perf_counter)
    dur: float       # seconds
    step: int = -1


@dataclass
class SpanRecorder:
    """Collects fenced spans; one recorder spans a whole traced run (``step``
    is set per step so the Chrome export can lane them). ``device``: the
    card whose work a span waits for (None or a CPU device: no wait)."""
    step: int = -1
    spans: list[Span] = field(default_factory=list)
    device: object = None

    def fenced(self, name: str, fn, *args):
        """Run ``fn(*args)``, wait until the card has finished the work it
        queued, and record the wall duration as one span. Without the wait
        the card's queue would charge each phase's time to whichever later
        call waits first."""
        t0 = time.perf_counter()
        with scope(name):
            out = fn(*args)
            dev = self.device
            if dev is not None and getattr(dev, "type", dev) == "cuda":
                import torch
                torch.cuda.synchronize(dev)
        self.spans.append(Span(name, t0, time.perf_counter() - t0, self.step))
        return out

    def step_seconds(self, step: int) -> dict[str, float]:
        """Per-name summed seconds for one step."""
        out: dict[str, float] = {}
        for s in self.spans:
            if s.step == step:
                out[s.name] = out.get(s.name, 0.0) + s.dur
        return out

    def chrome_events(self, rank: int = 0) -> list[dict]:
        """Chrome / Perfetto ``traceEvents`` (complete events, us units):
        pid = rank, tid = span name, args carry the step index."""
        return [dict(name=s.name, ph="X", ts=s.t0 * 1e6, dur=s.dur * 1e6,
                     pid=rank, tid=s.name, args={"step": s.step})
                for s in self.spans]


def write_chrome_trace(events: list[dict], path) -> str:
    """Write a chrome://tracing / Perfetto-loadable trace.json."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}))
    return str(path)


@dataclass
class TraceConfig:
    """Opt-in runtime tracing for ``Trainer.run`` (launch/train.py
    ``--trace``). ``probe_every``: steps between the out-of-band probes (0:
    never). ``heartbeat_dir``: per-rank heartbeat files (obs.heartbeat).
    With ``trace=None`` the Trainer runs the engine's step untouched."""
    metrics_path: str | None = None     # JSONL stream (obs.metrics)
    chrome_trace: str | None = None     # trace.json written at end of run
    heartbeat_dir: str | None = None    # per-rank heartbeat files
    probe_every: int = 4                # 0 = never run attribution probes
