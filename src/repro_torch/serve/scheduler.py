"""Continuous batching: an SLO-driven slot scheduler over the paged decode.

Port of ``repro.serve.scheduler``. Incoming requests are admitted into
free slots under a latency SLO (queue-wait bound + KV-page headroom),
prefilled one row at a time, scattered into their pages, and all active
slots decode in lock-step with per-row positions. Admission, preemption
(youngest first, on page exhaustion) and retirement are the reference's
host-side logic, with the same counters, so the same requests and tokens
give the same decisions.

Two weight backends share the scheduler: ``"gathered"`` (the training
engine's primaries, re-gathered per use: ``serve.engine.ServeEngine``) and
``"resident"`` (the INT8 wire residency: ``ResidentServeEngine``);
``run(params, ...)`` takes the primaries or the residency respectively.

On a mesh every rank runs the batcher. Its host state (the page table, the
free list, slots, positions, counters and SLO decisions) is global and the
same on every rank: the B = 1 prefill runs whole on every rank, its cache
whole, and decode runs each rank's slots (the data axes) over its sequence
range of the pool (the model-tier axes); every step's greedy tokens are
all-gathered over the data axes. A sequence-parallel prefill
(``prefill_seq_parallel``) leaves each rank its chunk of the prompt, which
is not its decode range (at prompt 128 and max length 256 on two sequence
ranks, rank 0 holds prompt positions 0-63 after the prefill but decode
positions 0-127): its admission all-gathers the cache over the sequence
axes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import collectives as col
from ..models.config import ShapeConfig
from .engine import ServeConfig, ServeEngine
from .paged import PagedKV
from .resident import ResidentLayout, ResidentServeEngine


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (P,) int32
    max_new: int
    out: list[int] = field(default_factory=list)
    done: bool = False
    rejected: bool = False             # dropped by the SLO queue-wait bound
    submit_step: int = -1
    t_submit: float = 0.0
    t_first: float = 0.0               # first token emitted (admission)
    t_done: float = 0.0


@dataclass
class ServeSLO:
    """Deterministic admission policy + latency targets.

    ``max_queue_steps``/``reserve_pages`` drive *step-count* decisions, so
    admission/rejection/preemption counts are reproducible;
    ``target_p99_ms`` is reporting-only."""
    max_queue_steps: int = 0           # reject after N scheduler steps (0=off)
    reserve_pages: int = 0             # keep N pages free when admitting
    target_p99_ms: float = 0.0


def refuse_non_text(arch) -> None:
    """The batcher admits {"tokens"} alone, as the reference's does
    (src/repro/serve/scheduler.py:176-181): a model with a patch prefix or
    an encoder (its frames) has no way in, and is refused with a
    ValueError."""
    if arch.n_patches:
        what = f"a patch prefix (n_patches={arch.n_patches})"
    elif arch.enc_layers:
        what = (f"an encoder over {arch.n_frames} frames (enc_layers="
                f"{arch.enc_layers})")
    else:
        return
    raise ValueError(
        f"{arch.name}: the continuous batcher serves text prompts only; a "
        f"model with {what} is served through the engine's prefill and "
        "decode")


def _default_page(max_len: int) -> int:
    return next(d for d in (16, 8, 4, 2, 1) if max_len % d == 0)


class ContinuousBatcher:
    """SLO-driven continuous batching over the paged pool.

    ``engine`` is a ``core.engine.ZeroEngine`` on this rank of ``mesh``
    (the ``backend`` "gathered", the reference's default, or "resident",
    whose layout over ``res_axes`` is ``self.layout``), or a
    ``serve.resident.ResidentLayout`` (the resident backend; on one device
    when ``mesh`` is None, as the one-card launcher builds it, with
    ``device`` given). ``prefill_seq_parallel`` runs the admission prefill
    sequence-parallel."""

    def __init__(self, model, engine, mesh=None, *, n_slots: int,
                 max_len: int, prompt_len: int, device=None,
                 eos_token: int = -1, page_size: int | None = None,
                 n_pages: int = 0, slo: ServeSLO | None = None,
                 backend: str | None = None,
                 res_axes: tuple[str, ...] | None = None,
                 prefill_seq_parallel: bool = False, metrics=None):
        refuse_non_text(model.arch)
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.eos = eos_token
        self.slo = slo or ServeSLO()
        self.metrics = metrics
        shape = ShapeConfig("cb", max_len, n_slots, "decode")
        shape1 = ShapeConfig("cb1", prompt_len, 1, "decode")
        if isinstance(engine, ResidentLayout):
            if backend not in (None, "resident"):
                raise ValueError(f"backend {backend!r} with a residency "
                                 "layout")
            self.backend, self.layout = "resident", engine
        else:
            self.backend = backend or "gathered"
            if self.backend == "resident":
                self.layout = ResidentLayout(engine.specs, engine.cfg,
                                             res_axes, mesh)
            elif self.backend != "gathered":
                raise ValueError(f"backend {self.backend!r}: 'gathered' or "
                                 "'resident'")
            device = device or engine.device
        if device is None:
            raise ValueError("device: a residency layout needs one")
        self.device = torch.device(device)
        if self.backend == "resident":
            self.serve = ResidentServeEngine(model, self.layout, shape, mesh)
        else:
            self.serve = ServeEngine(model, engine, mesh, shape)
        # the B = 1 prefill: sequence axes only when it is sequence-parallel
        sc1 = ServeConfig(self.serve.sc.seq_axes if prefill_seq_parallel
                          else (), ())
        if self.backend == "resident":
            self.serve1 = ResidentServeEngine(model, self.layout, shape1,
                                              mesh, sc1)
        else:
            self.serve1 = ServeEngine(model, engine, mesh, shape1, sc1)
        self._prefill1 = self.serve1.make_prefill(
            seq_parallel=prefill_seq_parallel)
        self._decode = self.serve.make_decode(per_row_pos=True)
        self.paged = PagedKV(model, shape,
                             page_size=page_size or _default_page(max_len),
                             n_pages=n_pages)
        self.paged.shard(self.serve.row0, self.serve.b_loc,
                         (mesh.index(self.serve.sc.seq_axes)
                          if mesh is not None else 0), self.serve.n_seq)
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: list[Request] = []
        self.pool = None
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.admit_order = np.full((n_slots,), -1, np.int64)
        self.step_count = 0
        self.counters = dict(admitted=0, rejected=0, preempted=0, retired=0)
        self._latencies_ms: list[float] = []

    # -- api -----------------------------------------------------------------

    def submit(self, req: Request):
        req.submit_step = self.step_count
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _paged_step(self, params, table, token, row_pos, active):
        """One decode step of every slot (global ``token``, ``row_pos``,
        ``active``); returns this rank's rows' logits."""
        dense = self.paged.assemble(self.pool, table)
        held = self.paged.held_rows(dense)
        logits, new_dense = self._decode(params, dense,
                                         {"token": token, "row_pos": row_pos})
        local = self.serve.local_rows
        self.pool = self.paged.writeback(self.pool, new_dense, table,
                                         local(row_pos), local(active), held)
        return logits

    def _whole_prompt(self, c1):
        """A B = 1 prefill cache with its sequence-sharded entries gathered
        whole over the sequence axes (none unless sequence-parallel)."""
        axes = self.serve1.sc.seq_axes
        if not axes:
            return c1
        return {kind: entry if kind == "pos" else
                {name: (col.gather_dim(t, axes, 2)
                        if (kind, name) in self.paged.seq_keys else t)
                 for name, t in entry.items()}
                for kind, entry in c1.items()}

    # -- admission / eviction -------------------------------------------------

    def _reject_stale(self):
        if not self.slo.max_queue_steps:
            return
        keep = []
        for req in self.queue:
            if self.step_count - req.submit_step > self.slo.max_queue_steps:
                req.rejected = True
                req.done = True
                req.t_done = time.perf_counter()
                self.counters["rejected"] += 1
            else:
                keep.append(req)
        self.queue = keep

    def _can_admit(self) -> bool:
        need = self.paged.pages_needed(self.prompt_len)
        return self.paged.free_pages() - self.slo.reserve_pages >= need

    def _admit(self, params):
        n_pp = self.paged.pages_needed(self.prompt_len)
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            if not self._can_admit():
                break
            req = self.queue.pop(0)
            prompt = np.asarray(req.prompt, np.int32)[: self.prompt_len]
            if len(prompt) < self.prompt_len:   # bucket-pad short prompts
                prompt = np.pad(prompt, (0, self.prompt_len - len(prompt)),
                                mode="edge")
            tokens = torch.as_tensor(prompt[None].astype(np.int64),
                                     device=self.device)
            logits, c1 = self._prefill1(params, {"tokens": tokens})
            c1 = self._whole_prompt(c1)
            ok = self.paged.alloc_prefix(slot, self.prompt_len)
            assert ok, "free-page check raced the allocator"
            pages = torch.as_tensor(self.paged.table[slot, :n_pp].astype(np.int64),
                                    device=self.device)
            self.pool = self.paged.admit_scatter(self.pool, c1, slot, pages)
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            req.t_first = time.perf_counter()
            self.slots[slot] = req
            self.last_tok[slot] = tok
            self.pos[slot] = self.prompt_len
            self.admit_order[slot] = self.counters["admitted"]
            self.counters["admitted"] += 1

    def _preempt_youngest(self) -> int | None:
        """Evict the most recently admitted slot back to the queue front."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return None
        victim = max(active, key=lambda i: self.admit_order[i])
        req = self.slots[victim]
        req.out.clear()                 # restarts from its prompt
        req.submit_step = self.step_count   # wait clock restarts on requeue
        self.queue.insert(0, req)
        self.slots[victim] = None
        self.paged.release(victim)
        self.admit_order[victim] = -1
        self.counters["preempted"] += 1
        return victim

    def _grow_pages(self):
        """Lazily allocate the page each active slot is about to write."""
        for slot in range(self.n_slots):
            if self.slots[slot] is None:
                continue
            block = int(self.pos[slot]) // self.paged.page_size
            while not self.paged.alloc(slot, block):
                victim = self._preempt_youngest()
                if victim is None or victim == slot:
                    break
            # a preempted slot (victim == slot) simply skips this step

    def _retire(self, slot: int):
        req = self.slots[slot]
        req.done = True
        req.t_done = time.perf_counter()
        self._latencies_ms.append((req.t_done - req.t_submit) * 1e3)
        self.counters["retired"] += 1
        self.slots[slot] = None
        self.admit_order[slot] = -1
        self.paged.release(slot)

    # -- stepping -------------------------------------------------------------

    def step(self, params) -> int:
        """Admit + one decode step for all active slots. Returns #active."""
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = self.paged.init_pool(self.model.cache_shapes(
                self.serve.shape), self.device)
        self._reject_stale()
        t_admit0 = time.perf_counter()
        self._admit(params)
        self._grow_pages()
        t_admit = time.perf_counter() - t_admit0
        active = [i for i, r in enumerate(self.slots) if r is not None]
        self.step_count += 1
        if not active:
            self._emit_metrics(0, time.perf_counter() - t0, t_admit, 0.0)
            return 0
        mask = np.zeros((self.n_slots,), bool)
        mask[active] = True
        t_dec0 = time.perf_counter()
        dev = self.device
        logits = self._paged_step(
            params, self.paged.device_table(dev),
            torch.as_tensor(self.last_tok.astype(np.int64), device=dev),
            torch.as_tensor(self.pos.astype(np.int64), device=dev),
            torch.as_tensor(mask, device=dev))
        toks = self.serve.gather_rows(
            logits.argmax(dim=-1).to(torch.int32)).cpu().numpy()
        t_dec = time.perf_counter() - t_dec0
        for i in active:
            req = self.slots[i]
            tok = int(toks[i])
            req.out.append(tok)
            self.last_tok[i] = tok
            self.pos[i] += 1
            if tok == self.eos or len(req.out) >= req.max_new \
                    or int(self.pos[i]) >= self.max_len - 1:
                self._retire(i)
        self._emit_metrics(len(active), time.perf_counter() - t0,
                           t_admit, t_dec)
        return len(active)

    def _emit_metrics(self, n_active: int, dt_s: float, t_admit: float,
                      t_dec: float):
        if self.metrics is None:
            return
        lat = np.asarray(self._latencies_ms) if self._latencies_ms else None
        self.metrics.write(dict(
            step=self.step_count, tokens=n_active, dt_s=dt_s,
            tokens_per_s=(n_active / dt_s if dt_s > 0 else 0.0),
            queue_depth=len(self.queue), active_slots=n_active,
            admitted=self.counters["admitted"],
            rejected=self.counters["rejected"],
            preempted=self.counters["preempted"],
            retired=self.counters["retired"],
            free_pages=self.paged.free_pages(),
            p50_ms=(float(np.percentile(lat, 50)) if lat is not None
                    else 0.0),
            p99_ms=(float(np.percentile(lat, 99)) if lat is not None
                    else 0.0),
            phase_ms={"serve_admit": t_admit * 1e3,
                      "serve_decode": t_dec * 1e3}))

    def run(self, params, requests: list[Request], max_steps: int = 10_000):
        for r in requests:
            self.submit(r)
        steps = 0
        while (any(self.slots) or self.queue) and steps < max_steps:
            self.step(params)
            steps += 1
        return requests

    def latency_percentiles(self) -> dict[str, float]:
        if not self._latencies_ms:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        lat = np.asarray(self._latencies_ms)
        return {"p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99))}
