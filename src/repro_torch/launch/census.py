"""One rank's step counted as it runs on ``meta`` tensors: FLOPs, HBM bytes,
collectives, would-be kernel launches and the memory high-water mark.

The torch counterpart of the reference's ``launch/hlo.py``. The reference
compiles the per-device SPMD program of a step and parses its HLO; torch has
no compiled module to parse. Here one rank's step runs on meta tensors
(shapes and dtypes, no storage) over a fake process group of the production
world size (``launch/dryrun.py``), and ``Census``, a ``TorchDispatchMode``,
counts every aten op as it runs. So loops need no multipliers: the remat
recompute of each per-layer checkpoint is counted when it runs.

* ``flops``: ``torch.utils.flop_counter``'s formulas, ``2 * prod(out) * K``
  for every matmul, batched matmul and convolution (``hlo.py:120``'s), also
  split by the dtype the card computes them in (``flops_by_dtype``: a
  kernel's by its first tensor input, whatever its plain version upcasts).
* ``hbm_bytes``: the operand and output bytes of every op outside a kernel
  (views and uninitialised allocations move nothing; an output that is one
  of the op's inputs, written in place, is billed once). Each
  ``kernels.ops`` call the card would launch as a kernel is billed once,
  at its own inputs and outputs, as ``hlo.py`` bills a fusion: its plain
  version's intermediates add FLOPs and no bytes (``kernel_call``). Each
  would-be launch's bytes and FLOPs are also kept by kernel
  (``kernel_bytes``, ``kernel_flops``), to be held against the card's
  traced kernels.
* collectives, recorded by ``core/collectives.py`` at each call: the
  reference's base op (``collectives.REFERENCE_OP``), the group size ``d``
  and its span in ranks (max - min of its members: a span that reaches the
  node size crosses nodes, ``roofline.collective_seconds``), the output
  bytes of that op and its wire bytes by the reference's ring formulas
  (``hlo.py:14-20``, ``ring_wire``), and the payload handed to the
  transport by label, as ``collectives.PAYLOAD`` counts it. On meta the
  transport is the fake process group and runs the card's calls, so its
  bytes are billed as every op's are: an all-gather's operand and its d
  received copies, then the stack that orders them (read and written), and
  an all-to-all's send and receive buffers.
* ``launches``: would-be launches by kernel (``ops.WOULD_LAUNCH``), where
  the card would launch them.
* hooks: one slot, ``kernels.ops.CENSUS``, which ``kernels.ops`` and
  ``core/collectives.py`` read while a census counts.
* loops: ``trips(n)`` multiplies what runs inside by ``n``, the
  counterpart of ``hlo.py``'s ``known_trip_count``. A loop whose every
  trip runs the same ops at the same shapes runs one trip under it on
  meta (``ops.meta_trips``): the plain selective scan, the plain
  dequant-sums and the collectives' sums over their d parts, which would
  otherwise run tens of thousands of ops a layer.
* memory: ``temp_bytes``, the high-water mark of the bytes of the tensors
  the ops create while the step runs (a weakref finalizer on each returns
  its bytes when it dies; a view keeps its base alive).

``summary()`` has ``HLOAnalysis.summary()``'s keys (``hlo.py:275``) and
adds ``flops_by_dtype``, ``payload``, ``launches``, ``kernel_bytes`` and
``kernel_flops``.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..core import collectives as col
from ..kernels import ops

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that move no bytes: allocations left unwritten, and a reshape that
# aliases its input though its schema does not say so
_UNBILLED = {_aten.empty.memory_format, _aten.empty_like.default,
             _aten.new_empty.default, _aten.empty_strided.default,
             _aten.new_empty_strided.default, _aten._unsafe_view.default}


def ring_wire(op: str, v_out: float, d: int) -> float:
    """Wire bytes a device of one collective of ``d`` members whose output
    is ``v_out`` bytes: the reference's ring formulas (``hlo.py:14-20``)."""
    return {"all-gather": v_out * (d - 1) / d,
            "all-reduce": 2.0 * v_out * (d - 1) / d,
            "reduce-scatter": float(v_out) * (d - 1),
            "all-to-all": v_out * (d - 1) / d}[op]


def _tensors(obj) -> list[torch.Tensor]:
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _first_dtype(obj):
    for t in tree_leaves(obj):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.dtype
    return None


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.").replace("bfloat16", "bf16") \
        .replace("float32", "f32").replace("float16", "f16")


@dataclass
class CollectiveRecord:
    """One collective call: the reference's base op, the port's label, the
    group size and span, the op's output bytes and its ring wire bytes."""
    op: str
    label: str
    d: int
    span: int
    out_bytes: float
    wire: float


class Census(TorchDispatchMode):
    """Counts what runs inside ``with Census() as c:`` on meta tensors (see
    the module docstring); ``c.summary()`` after the block."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_by_dtype: collections.Counter = collections.Counter()
        self.hbm_bytes = 0.0
        self.wire_bytes: collections.Counter = collections.Counter()
        self.counts: collections.Counter = collections.Counter()
        self.groups: dict[str, list[float]] = {}
        self.records: list[CollectiveRecord] = []
        self.payload: collections.Counter = collections.Counter()
        self.launches: dict[str, int] = {}
        self.kernel_bytes: collections.Counter = collections.Counter()
        self.kernel_flops: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.temp_bytes = 0
        self._mult = 1
        self._kernel_depth = 0
        self._kernel_dtype = None
        self._kernel_bytes = 0.0
        self._kernel_flops = 0.0
        self._finalizers: list = []
        self._launched0: dict[str, int] = {}

    # -- the mode ---------------------------------------------------------

    def __enter__(self):
        if ops.CENSUS is not None:
            raise RuntimeError("a census is already counting")
        ops.CENSUS = self
        self._launched0 = dict(ops.WOULD_LAUNCH)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops.CENSUS = None
            self.launches = {k: ops.WOULD_LAUNCH[k] - self._launched0[k]
                             for k in ops.KERNELS}
            for f in self._finalizers:
                f.detach()
            self._finalizers.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flop_fn = flop_registry.get(func._overloadpacket)
        if flop_fn is not None:
            f = float(flop_fn(*args, **kwargs, out_val=out)) * self._mult
            self.flops += f
            if self._kernel_depth:
                self._kernel_flops += f
            dtype = self._kernel_dtype if self._kernel_depth \
                else _first_dtype(args)
            self.flops_by_dtype[_dtype_name(dtype)] += f
        if func.is_view:
            return out
        ins = _tensors((args, kwargs))
        seen = {_storage(t) for t in ins}
        # an output that is an input (written in place, or a collective's
        # output list) is billed and tracked once, as the input
        fresh = [t for t in _tensors(out) if _storage(t) not in seen]
        if func not in _UNBILLED:
            b = (_nbytes(ins) + _nbytes(fresh)) * self._mult
            if self._kernel_depth:
                self._kernel_bytes += b
            else:
                self.hbm_bytes += b
        for t in fresh:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.live_bytes += n
        self.temp_bytes = max(self.temp_bytes, self.live_bytes)
        self._finalizers.append(weakref.finalize(t, self._free, n))

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    @contextlib.contextmanager
    def trips(self, n: int):
        """Count what runs inside ``n`` times: one trip of a loop of ``n``
        identical trips."""
        mult = self._mult
        self._mult = mult * n
        try:
            yield
        finally:
            self._mult = mult

    # -- hooks: kernels.ops and core.collectives ----------------------------

    def kernel_call(self, fn, args, kwargs):
        """A ``kernels.ops`` wrapper's call: billed once at its inputs and
        outputs when the card would launch its kernel (a would-be launch
        counted inside), else op by op as its plain version ran."""
        outer = self._kernel_depth == 0
        if outer:
            before = dict(ops.WOULD_LAUNCH)
            self._kernel_bytes = self._kernel_flops = 0.0
            self._kernel_dtype = _first_dtype((args, kwargs))
        self._kernel_depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._kernel_depth -= 1
        if outer:
            launched = "+".join(k for k in ops.KERNELS
                                if ops.WOULD_LAUNCH[k] != before[k])
            if launched:
                b = (_nbytes((args, kwargs)) + _nbytes(out)) * self._mult
                self.hbm_bytes += b
                self.kernel_bytes[launched] += b
                self.kernel_flops[launched] += self._kernel_flops
            else:
                self.hbm_bytes += self._kernel_bytes
            self._kernel_dtype = None
        return out

    def collective(self, label: str, t: torch.Tensor, group) -> None:
        """One call of ``core/collectives.py`` over ``group`` (a
        ``launch.mesh.Group``) with this rank's payload ``t``."""
        payload = t.numel() * t.element_size()
        self.payload[label] += payload
        op = col.REFERENCE_OP.get(label, "all-gather")
        d = group.size
        v_out = {"all-gather": payload * d,
                 "reduce-scatter": payload / d}.get(op, payload)
        wire = ring_wire(op, v_out, d)
        span = max(group.members) - min(group.members)
        self.wire_bytes[op] += wire
        self.counts[op] += 1
        key = f"{op}|{d}|{span}"
        w, c = self.groups.get(key, (0.0, 0.0))
        self.groups[key] = [w + wire, c + 1]
        self.records.append(CollectiveRecord(op, label, d, span, v_out, wire))

    # -- results ------------------------------------------------------------

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    def summary(self) -> dict:
        return dict(flops=float(self.flops), hbm_bytes=float(self.hbm_bytes),
                    wire_bytes={k: float(v) for k, v in self.wire_bytes.items()},
                    total_wire_bytes=self.total_wire_bytes,
                    collective_counts={k: float(v) for k, v in self.counts.items()
                                       if k in COLLECTIVES},
                    groups={k: [float(w), float(c)]
                            for k, (w, c) in self.groups.items()},
                    unknown_loops=0,
                    flops_by_dtype={k: float(v) for k, v
                                    in sorted(self.flops_by_dtype.items())},
                    payload=dict(sorted(self.payload.items())),
                    launches=dict(self.launches),
                    kernel_bytes=dict(sorted(self.kernel_bytes.items())),
                    kernel_flops=dict(sorted(self.kernel_flops.items())))
