"""Training loop: deterministic batches -> this rank's rows -> the engine's
train step -> per-step log.

Port of ``repro.train.trainer`` (``TrainLog``, ``Trainer.run`` :95,
``Trainer.restore`` :199). Step time is the host clock around one step that
ends in ``torch.cuda.synchronize()`` on a card (the metrics' host copies
synchronize on any device); the first step's time includes the kernels'
first use. ``run(ckpt_dir=, ckpt_every=)`` saves a checkpoint
(train/checkpoint.py) after every ``ckpt_every``-th step of the run, its
seconds kept out of the step's and logged beside it (``ckpt_save_s``).
A run takes batch ``state["step"]`` of the data stream at each step, so a
run resumed at step k sees the batches k, k+1, ... that the uninterrupted
run saw (the reference's ``run`` restarts its stream at batch 0 on every
call, ``src/repro/train/trainer.py:142``). ``run(profile_step=i)`` traces
step i with ``torch.profiler`` (``pad_trace`` at each end on a card,
outside the step's time) and keeps the device time of its kernels in
``TrainLog.meta["profile"]``.

Trace mode (``Trainer(..., trace=TraceConfig(...))``, the reference's
``trainer.py:132-195``): each step stamps the rank's heartbeat
(``launch.distributed.Heartbeat``) before it, runs
``ZeroEngine.train_step`` with a ``SpanRecorder`` (each segment fenced: bit
for bit the untraced step), the out-of-band probes of ``obs.phased`` every
``probe_every`` steps, and writes a metrics record with every field of
``obs.metrics.REQUIRED_FIELDS`` (a lane a rank); the run ends with a stamp
of ``n_steps`` and the Chrome trace (a lane a rank). With ``trace=None``
the step runs with no recorder.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from ..core.engine import ZeroEngine
from ..data.pipeline import BatchSpec, SyntheticTokens, local_rows
from ..launch.distributed import Heartbeat
from ..obs import metrics as obs_metrics
from ..obs.spans import SpanRecorder, TraceConfig, write_chrome_trace
from . import checkpoint


@dataclass
class TrainLog:
    steps: list[int] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)
    grad_norms: list[float] = field(default_factory=list)
    step_times: list[float] = field(default_factory=list)
    lrs: list[float] = field(default_factory=list)
    tokens: list[float] = field(default_factory=list)
    tokens_per_s: list[float] = field(default_factory=list)
    tflops_per_gpu: list[float] = field(default_factory=list)
    ckpt_save_s: dict[int, float] = field(default_factory=dict)  # by step
    meta: dict = field(default_factory=dict)

    def record(self, step: int, metrics: dict, dt: float, *,
               tflops_per_gpu: float = 0.0):
        self.steps.append(step)
        self.losses.append(metrics["loss"])
        self.grad_norms.append(metrics["grad_norm"])
        self.step_times.append(dt)
        self.lrs.append(metrics["lr"])
        self.tokens.append(metrics["tokens"])
        self.tokens_per_s.append(metrics["tokens"] / dt if dt > 0 else 0.0)
        self.tflops_per_gpu.append(tflops_per_gpu)

    def aggregates(self) -> dict:
        """Run summary; time aggregates leave out the first step (it pays
        for the kernels' first use) unless it is the only one."""
        if not self.steps:
            return {}
        timed = slice(1, None) if len(self.steps) > 1 else slice(None)

        def mean(xs):
            return sum(xs) / len(xs) if xs else 0.0

        return dict(n_steps=len(self.steps),
                    n_timed_steps=len(self.step_times[timed]),
                    loss_mean=mean(self.losses),
                    grad_norm_mean=mean(self.grad_norms),
                    dt_s_mean=mean(self.step_times[timed]),
                    tokens_per_s_mean=mean(self.tokens_per_s[timed]),
                    tflops_per_gpu_mean=mean(self.tflops_per_gpu[timed]))

    def save(self, path):
        payload = dict(self.__dict__)
        payload["aggregates"] = self.aggregates()
        Path(path).write_text(json.dumps(payload))


class Trainer:
    def __init__(self, model, engine: ZeroEngine, spec: BatchSpec, *,
                 seed: int = 0, trace: TraceConfig | None = None):
        self.model = model
        self.engine = engine
        self.data = SyntheticTokens(spec, seed=seed)
        self.trace = trace
        self.recorder = self.phased = None   # a traced run's, after it
        self.log = TrainLog(meta=dict(arch=model.arch.name,
                                      scheme=engine.cfg.name,
                                      mesh=dict(engine.mesh.shape),
                                      traced=trace is not None))

    def _batch(self, step: int) -> dict[str, torch.Tensor]:
        """This rank's rows of batch ``step``: the tokens as int64, a VLM's
        patch embeddings as the f32 the stream draws (the model casts them
        to the compute dtype)."""
        rows = local_rows(self.data.batch(step), self.engine.mesh)
        return {k: (torch.from_numpy(v).long() if k == "tokens" else
                    torch.from_numpy(v)).to(self.engine.device)
                for k, v in rows.items()}

    def run(self, state, n_steps: int, *, log_every: int = 1, print_fn=print,
            profile_step: int | None = None, ckpt_dir: str | None = None,
            ckpt_every: int = 0):
        """``n_steps`` steps from ``state``; returns the state after them.
        ``state`` is consumed, as the reference's donated step consumes it
        (``src/repro/core/engine.py:643``; ``ZeroEngine.train_step``): its
        tensors are updated in place, so a caller that needs the state it
        started from keeps a copy of its own. Each step takes batch
        ``state["step"]``; with ``ckpt_dir`` and ``ckpt_every`` the state is
        saved after every ``ckpt_every``-th step of this run."""
        loss_fn = self.model.lm.loss
        eng = self.engine
        n_params = eng.param_count()
        rank, n_ranks = eng.mesh.rank, eng.mesh.size
        trace = self.trace
        rec = writer = phased = hb = None
        if trace is not None:
            from ..obs.phased import PhasedStep
            rec = SpanRecorder(device=eng.device)
            phased = PhasedStep(eng, loss_fn)
            mem_pred = eng.memory_report()["total"]
            if trace.metrics_path:
                writer = obs_metrics.MetricsWriter(trace.metrics_path,
                                                   rank=rank, n_ranks=n_ranks)
            if trace.heartbeat_dir:
                hb = Heartbeat(trace.heartbeat_dir, rank, n_ranks)
        for i in range(n_steps):
            batch = self._batch(state["step"])
            if hb is not None:
                hb.stamp(i)
            prof = _profiler(eng.device) if i == profile_step else None
            if prof is not None:
                prof.__enter__()
                pad_trace(eng.device)
            t0 = time.perf_counter()
            if rec is not None:
                rec.step = i
            state, metrics = eng.train_step(loss_fn, state, batch, rec=rec)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if prof is not None:
                pad_trace(eng.device)
                prof.__exit__(None, None, None)
                self.log.meta["profile"] = _device_summary(prof, i, dt)
            if phased is not None and trace.probe_every \
                    and i % trace.probe_every == 0:
                phased.run_probes(state, batch, rec)
            tfl = obs_metrics.tflops_per_gpu(n_params, metrics["tokens"], dt,
                                             n_ranks)
            self.log.record(state["step"], metrics, dt, tflops_per_gpu=tfl)
            if writer is not None:
                phase = phased.phase_seconds(rec, i)
                writer.write(dict(
                    step=state["step"], rank=rank, loss=metrics["loss"],
                    grad_norm=metrics["grad_norm"], lr=metrics["lr"],
                    tokens=metrics["tokens"], dt_s=dt,
                    tokens_per_s=self.log.tokens_per_s[-1],
                    tflops_per_gpu=tfl,
                    phase_ms={k: v * 1e3 for k, v in phase.items()},
                    overlap_efficiency=phased.overlap_efficiency(rec, i),
                    memory_hw_bytes=obs_metrics.memory_high_water(eng.device),
                    memory_pred_bytes=mem_pred))
            saved = ""
            if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
                t0 = time.perf_counter()
                checkpoint.save(state, ckpt_dir, state["step"],
                                scheme=eng.scheme_fingerprint(), engine=eng)
                save_s = time.perf_counter() - t0
                self.log.ckpt_save_s[state["step"]] = save_s
                saved = f" ckpt {save_s:.3f}s"
            if log_every and i % log_every == 0:
                print_fn(f"step {state['step']:5d} loss {metrics['loss']:.6f} "
                         f"gnorm {metrics['grad_norm']:.6f} "
                         f"lr {metrics['lr']:.3e} {dt:.3f}s/step "
                         f"{metrics['tokens'] / dt:.0f} tok/s{saved}")
        if trace is not None:
            if hb is not None:
                hb.stamp(n_steps)
            if trace.chrome_trace:
                write_chrome_trace(rec.chrome_events(rank=rank),
                                   obs_metrics.lane_path(trace.chrome_trace,
                                                         rank, n_ranks))
            if writer is not None:
                writer.close()
        self.recorder, self.phased = rec, phased
        return state

    def restore(self, ckpt_dir, step: int | None = None, *,
                reshard: bool = True):
        """The state of checkpoint ``step`` (default: the latest) for this
        trainer's engine. ``reshard=True`` (default): a checkpoint written
        under another mesh / process layout or partition scheme is
        resharded onto this engine (checkpoint.py, DESIGN.md §11), which
        makes ``--resume`` elastic; ``reshard=False`` restores strictly,
        failing (``checkpoint.MeshMismatch`` / ``SchemeMismatch``) on any
        layout difference."""
        step = checkpoint.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        return checkpoint.restore(ckpt_dir, step, self.engine,
                                  self.engine.scheme_fingerprint(),
                                  reshard=reshard)


# torch.profiler (Kineto) drops every device event whose timestamp falls
# outside the window between entering and leaving the profiler, and it
# reads the card's timestamps some hundreds of microseconds, and at times
# a few milliseconds, off the host's clock: work launched the moment a
# trace starts can lose its first kernels (probes/train_phases.py --phase
# trace_window). A trace on a card keeps this much idle card at each end.
TRACE_PAD_S = 0.05


def pad_trace(device: torch.device) -> None:
    """Inside a trace on a card, after its work is synchronised or before
    any is launched: TRACE_PAD_S of idle card, so the work's events lie
    inside the profiler's window; nothing on another device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        time.sleep(TRACE_PAD_S)


def _profiler(device: torch.device):
    # on a card, the device's events alone: with the host's recorded too,
    # the collectives' record_function spans (gloo:all_gather, ...) also
    # land on the device timeline as annotations, which _device_summary
    # would sum with the kernels they overlap; and the trace takes far
    # longer to summarise (a falcon-mamba step launches some 115 k kernels
    # a rank)
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU])


def _device_summary(prof, step: int, wall_s: float, top: int = 12) -> dict:
    """Device time of the traced step: the sum over the events that ran on
    the card (kernels, copies, memsets; not the host ops that launched
    them, which would count each kernel twice), the largest by name, and
    every one by its full name (``kernels``)."""
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.device_time_total]
    rows.sort(key=lambda r: -r[1])
    return dict(step=step, wall_ms=wall_s * 1e3,
                device_ms=sum(r[1] for r in rows),
                top=[dict(name=k[:80], ms=ms, calls=c) for k, ms, c in rows[:top]],
                kernels=[dict(name=k, ms=ms, calls=c) for k, ms, c in rows])
