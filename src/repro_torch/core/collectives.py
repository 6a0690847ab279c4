"""Quantization-assisted collectives on ``torch.distributed``.

Port of ``repro.core.collectives``. Every function takes mesh axis tuples
ordered major -> minor, as in the reference; a tuple of size 1 (or empty)
makes the collective the identity, so one engine expresses every scheme and
the one-device serving path needs no process group at all. Larger tuples run
over the process groups of the mesh bound with ``bind`` (launch/mesh.py).

The key primitive is the all-to-all based quantized reduce-scatter (ZeRO++):
the input is split into d chunks, each chunk is quantized once to INT4 (or
INT8 with ``bits=8``), exchanged with one all-to-all, and the receiver
dequantizes and sums the d chunks in one pass (``ops.dequantize_int4_sum`` /
``ops.dequantize_int8_sum``).

Transport. The process group is gloo (four ranks share one card, which
NCCL refuses). Payloads move bit for bit in their own dtype: INT8 q, packed
INT4 bytes, f32 scales, bf16 activations and primaries (gloo takes bf16 but
refuses int16). Gloo carries CUDA tensors for every collective used here
(all_gather, all_to_all_single), copying them through host memory itself, so
the wrappers hand it the tensors on the card as they are; ``PAYLOAD`` counts
the bytes this rank hands it, per collective, and ``SECONDS`` the host time
spent inside the calls (which includes waiting for this rank's queued
kernels, the copies through host memory and the slowest peer). Every
kernel runs on the card.

Reductions (``det_psum``, ``psum_scatter``) sum in axis order, which makes
the loss and the grad norm independent of the process layout; the
reference's ``psum_scatter`` sums in XLA's order, so those float results are
held to it with a tolerance.

Serving on a mesh adds three collectives over the bound mesh's groups,
each counted under its own label: ``seq_max`` and ``seq_sum`` (the
flash-decode combine over the sequence axes; the sum in axis order, so
every rank gets the same bits) and ``gather_dim`` (a tiled all-gather
along a dimension: the sequence-parallel K/V and the admission's prefill
cache under "seq_gather", the greedy tokens over the data axes under
"batch_gather"). The residency's per-product re-gather is counted under
"residency_gather".

The dry run's census (``launch/census.py``, ``ops.CENSUS``) records every
call here: its label, its group and its payload, and the collective the
reference's compiled step runs for it (``REFERENCE_OP``): the port moves
every reduction as an all-gather or an all-to-all, where the reference's
``psum_scatter`` is a reduce-scatter and its ``psum`` / ``pmax`` an
all-reduce. On meta the transport is the dry run's fake process group,
which takes the same calls and moves nothing; the sums over the d received
parts run one part under the census's loop multiplier (``ops.meta_trips``).
"""
from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

from ..kernels import ops
from .partition import AxisTuple, ZeroConfig

_MESH = None
PAYLOAD: collections.Counter = collections.Counter()
SECONDS: collections.Counter = collections.Counter()
# kernel launches made inside ``update_all_gather`` (its INT8 form)
UPDATE_GATHER_LAUNCHES: collections.Counter = collections.Counter()
# the collective of the reference's compiled step (its HLO op) for each
# label whose call is not an all-gather there
REFERENCE_OP = {"all_to_all": "all-to-all", "psum_scatter": "reduce-scatter",
                "reduce_scatter": "reduce-scatter", "all_reduce": "all-reduce",
                "seq_max": "all-reduce", "seq_sum": "all-reduce"}


def bind(mesh) -> None:
    """Run the collectives of this process over ``mesh``'s groups."""
    global _MESH
    _MESH = mesh


def reset_counters() -> None:
    PAYLOAD.clear()
    SECONDS.clear()
    UPDATE_GATHER_LAUNCHES.clear()


def _count(op: str, t: torch.Tensor, g) -> None:
    """Count a call's payload (``t``, what this rank hands the transport)
    under ``op``, and record it in the census when one counts."""
    PAYLOAD[op] += t.numel() * t.element_size()
    if ops.CENSUS is not None:
        ops.CENSUS.collective(op, t, g)


def _group(axes: AxisTuple):
    if _MESH is None:
        raise RuntimeError(f"collective over {tuple(axes)}: no mesh bound "
                           "(core.collectives.bind)")
    return _MESH.group(tuple(axes))


def axis_index(axes: AxisTuple, cfg: ZeroConfig) -> int:
    """This rank's linear index over ``axes`` (0 when their size is 1)."""
    if cfg.size(tuple(axes)) == 1:
        return 0
    return _MESH.index(tuple(axes))


# -- transport ----------------------------------------------------------------

def _gather(t: torch.Tensor, axes: AxisTuple, op: str) -> torch.Tensor:
    """(d,) + t.shape: member j's ``t`` in row j (axis order)."""
    g = _group(axes)
    t = t.contiguous()
    _count(op, t, g)
    outs = [torch.empty_like(t) for _ in range(g.size)]
    t0 = time.perf_counter()
    dist.all_gather(outs, t, group=g.pg)
    SECONDS[op] += time.perf_counter() - t0
    return torch.stack([outs[g.to_group[j]] for j in range(g.size)])


class _Pending:
    """An all-gather in flight (``async_op=True``): ``wait()`` waits on its
    work handle and returns what ``_gather`` returns. It holds the input
    until then, so the memory the transport reads from is not reused."""

    def __init__(self, t: torch.Tensor, axes: AxisTuple, op: str):
        g = _group(axes)
        self._t = t.contiguous()
        self._op = op
        _count(op, self._t, g)
        self._outs = [torch.empty_like(self._t) for _ in range(g.size)]
        self._order = [g.to_group[j] for j in range(g.size)]
        t0 = time.perf_counter()
        self._work = dist.all_gather(self._outs, self._t, group=g.pg,
                                     async_op=True)
        SECONDS[op] += time.perf_counter() - t0

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        self._work.wait()
        SECONDS[self._op] += time.perf_counter() - t0
        out = torch.stack([self._outs[i] for i in self._order])
        self._t = self._outs = None
        return out


def _all_to_all(t: torch.Tensor, axes: AxisTuple, op: str) -> torch.Tensor:
    """t (d, L): row j goes to member j; returns (d, L) whose row j came
    from member j (the reference's untiled ``all_to_all`` over axis 0)."""
    g = _group(axes)
    order = torch.tensor(g.to_group, device=t.device)
    send = torch.empty_like(t)
    send[order] = t
    recv = torch.empty_like(t)
    _count(op, t, g)
    t0 = time.perf_counter()
    dist.all_to_all_single(recv, send, group=g.pg)
    SECONDS[op] += time.perf_counter() - t0
    return recv[order]


def _tiled(stacked: torch.Tensor) -> torch.Tensor:
    """(d, ..., L) -> (..., d * L): concatenate the members' last axes."""
    return torch.cat(list(stacked), dim=-1)


# -- the collectives ------------------------------------------------------------

def _ordered_sum(x: torch.Tensor, axes: AxisTuple, op: str) -> torch.Tensor:
    """Gather the partials over ``axes``, add them in axis order."""
    parts = _gather(x, axes, op)
    acc = parts[0]
    rest, counted = ops.meta_trips(parts.shape[0] - 1, x.device, start=1)
    with counted:
        for j in rest:
            acc = acc + parts[j]
    return acc


def det_psum(x: torch.Tensor, axes: AxisTuple, cfg: ZeroConfig) -> torch.Tensor:
    """Order-deterministic sum of a (near-)scalar over ``axes``: gather the
    partials, add them in axis order."""
    if cfg.size(tuple(axes)) == 1:
        return x
    return _ordered_sum(x, axes, "det_psum")


def psum_scatter(x: torch.Tensor, axes: AxisTuple, cfg: ZeroConfig, *,
                 op: str = "psum_scatter") -> torch.Tensor:
    """Tiled reduce-scatter of a flat tensor: this rank's 1/d slice of the
    sum over ``axes``, summed in f32 in axis order, in x's dtype (its
    payload counted under ``op``)."""
    d = cfg.size(tuple(axes))
    if d == 1:
        return x
    recv = _all_to_all(x.reshape(d, -1), axes, op)
    acc = recv[0].float()
    rest, counted = ops.meta_trips(d - 1, x.device, start=1)
    with counted:
        for j in rest:
            acc = acc + recv[j].float()
    return acc.to(x.dtype)


def all_gather_flat(shard: torch.Tensor, axes: AxisTuple,
                    cfg: ZeroConfig) -> torch.Tensor:
    """Plain (unquantized) tiled all-gather along the last axis."""
    if cfg.size(tuple(axes)) == 1:
        return shard
    return _tiled(_gather(shard, axes, "all_gather"))


def gather_issue_int8(shard: torch.Tensor, axes: AxisTuple, cfg: ZeroConfig):
    """Quantize + all-gather a flat shard, without dequantizing: the
    gathered wire-format (q, scales)."""
    q, s = ops.quantize_int8(shard, cfg.quant_block, impl=cfg.impl)
    if cfg.size(tuple(axes)) > 1:
        q = _tiled(_gather(q, axes, "all_gather"))
        s = _tiled(_gather(s, axes, "all_gather"))
    return q, s


class GatherBuf:
    """Gathers in flight: each of ``parts`` all-gathered over ``axes`` with
    ``async_op=True``. ``wait()`` returns them tiled, as ``all_gather_flat``
    returns one; every caller waits before it reads."""

    def __init__(self, parts, axes: AxisTuple, cfg: ZeroConfig):
        if cfg.size(tuple(axes)) == 1:
            self._done, self._pending = tuple(parts), None
        else:
            self._done = None
            self._pending = tuple(_Pending(p, axes, "all_gather") for p in parts)

    def wait(self) -> tuple:
        if self._done is None:
            self._done = tuple(_tiled(p.wait()) for p in self._pending)
            self._pending = None
        return self._done


def gather_issue_int8_async(shard: torch.Tensor, axes: AxisTuple,
                            cfg: ZeroConfig) -> GatherBuf:
    """``gather_issue_int8`` with the all-gathers left in flight: the
    prefetch half of the forward gather. ``wait()`` gives the same
    (q, scales)."""
    q, s = ops.quantize_int8(shard, cfg.quant_block, impl=cfg.impl)
    return GatherBuf((q, s), axes, cfg)


def gather_wait_int8(qf, sf, cfg: ZeroConfig, out_dtype=torch.bfloat16):
    """Local dequant of a gathered (q, scales) buffer (no communication)."""
    return ops.dequantize_int8(qf, sf, cfg.quant_block, out_dtype,
                               impl=cfg.impl)


def gather_issue_int8_rows(rows: torch.Tensor, axes: AxisTuple,
                           cfg: ZeroConfig):
    """Row-batched ``gather_issue_int8`` for stacked (layers, shard) leaves.

    Every row's shard is a whole number of quant blocks, so quantizing the
    flattened stack in one call gives exactly the per-row blocks: row r of
    the result is ``gather_issue_int8(rows[r], ...)``."""
    stack, shard = rows.shape
    q, s = ops.quantize_int8(rows.reshape(-1), cfg.quant_block, impl=cfg.impl)
    q = q.reshape(stack, shard)
    s = s.reshape(stack, shard // cfg.quant_block)
    if cfg.size(tuple(axes)) > 1:
        q = _tiled(_gather(q, axes, "all_gather"))
        s = _tiled(_gather(s, axes, "all_gather"))
    return q, s


def a2a_rs_issue(x: torch.Tensor, axes: AxisTuple, cfg: ZeroConfig,
                 bits: int = 4):
    """Quantize the d chunks of a flat tensor (INT4 with ``bits=4``, INT8 with
    ``bits=8``) and exchange them with one all-to-all (chunk j -> member j),
    without the receive-side sum. Returns the received (q2, s2) wire
    buffers, row j from member j."""
    if bits == 4:
        q, s = ops.quantize_int4(x.reshape(-1), cfg.quant_block, impl=cfg.impl)
    elif bits == 8:
        q, s = ops.quantize_int8(x.reshape(-1), cfg.quant_block, impl=cfg.impl)
    else:
        raise ValueError(f"a2a_rs_issue: bits {bits}, not 4 or 8")
    return a2a_rs_issue_q(q, s, axes, cfg)


def a2a_rs_issue_q(q: torch.Tensor, s: torch.Tensor, axes: AxisTuple,
                   cfg: ZeroConfig):
    """Exchange pre-quantized wire buffers (from ``ops.matmul_quant``'s
    epilogue): the collective half of ``a2a_rs_issue``."""
    d = cfg.size(tuple(axes))
    q2 = _all_to_all(q.reshape(d, -1), axes, "all_to_all")
    s2 = _all_to_all(s.reshape(d, -1), axes, "all_to_all")
    return q2, s2


def a2a_rs_wait(q2, s2, d: int, cfg: ZeroConfig, bits: int = 4,
                out_dtype=torch.float32) -> torch.Tensor:
    """Receive side: fused (unpack +) dequant + sum over the d chunks."""
    sum_fn = ops.dequantize_int4_sum if bits == 4 else ops.dequantize_int8_sum
    red = sum_fn(q2.reshape(-1), s2.reshape(-1), d, cfg.quant_block,
                 torch.float32, impl=cfg.impl)
    return red.to(out_dtype)


def a2a_quant_reduce_scatter(x, axes: AxisTuple, cfg: ZeroConfig,
                             bits: int = 4, out_dtype=torch.float32):
    """All-to-all based quantized reduce-scatter (INT4 by default, INT8 with
    ``bits=8``): x flat (n,), n % (d * block) == 0 -> this rank's (n // d,)
    slice of the sum over the group."""
    d = cfg.size(tuple(axes))
    if d == 1:
        return x.to(out_dtype)
    q2, s2 = a2a_rs_issue(x, axes, cfg, bits)
    return a2a_rs_wait(q2, s2, d, cfg, bits, out_dtype)


def reduce_scatter_flat(x, axes: AxisTuple, cfg: ZeroConfig, *,
                        out_dtype=torch.float32):
    """Gradient reduce-scatter over ``axes``, INT4-quantized when the config
    quantizes gradients."""
    if cfg.size(tuple(axes)) == 1:
        return x.to(out_dtype)
    if cfg.quantize_grads:
        return a2a_quant_reduce_scatter(x, axes, cfg, out_dtype=out_dtype)
    return psum_scatter(x, axes, cfg).to(out_dtype)


def cross_replica_grad(x, cfg: ZeroConfig, out_dtype=torch.float32):
    """Final gradient sync over the replica tier of a stage-2 shard, flat
    ``(n,)`` or stacked ``(rows, n)``: this rank's 1/R slice of each row's
    sum over R, summed in f32 in axis order.

    ``cfg.cross_replica == "allreduce"`` (the paper's flow): gather the R
    shards, sum them and keep the slice. ``"reduce_scatter"``: each row's R
    chunks are laid out chunk-major (as ``ZeroEngine._stage2_rs`` lays out
    stage 2) and one ``psum_scatter`` lands every row's slice at once, with
    about half the wire bytes. Both add the same values in the same order,
    so they give the same bits."""
    axes = cfg.axes.replica
    r = cfg.size(axes)
    if r == 1:
        return x.to(out_dtype)
    piece = x.shape[-1] // r
    if cfg.cross_replica == "reduce_scatter":
        rows = x.reshape(-1, x.shape[-1])
        chunks = rows.reshape(rows.shape[0], r, piece).transpose(0, 1)
        out = psum_scatter(chunks.reshape(-1), axes, cfg, op="reduce_scatter")
        return out.reshape(x.shape[:-1] + (piece,)).to(out_dtype)
    if cfg.cross_replica != "allreduce":
        raise ValueError(f"cross_replica {cfg.cross_replica!r}: "
                         "'allreduce' or 'reduce_scatter'")
    parts = _gather(x, axes, "all_reduce")
    full = parts[0].float()
    rest, counted = ops.meta_trips(r - 1, x.device, start=1)
    with counted:
        for j in rest:
            full = full + parts[j].float()
    i = axis_index(axes, cfg)
    # a copy, not a view: the step scales and consumes it in place, and a
    # view would keep all R slices alive until then
    return full[..., i * piece:(i + 1) * piece].to(out_dtype, copy=True)


def update_all_gather(master_shard: torch.Tensor, cfg: ZeroConfig,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Rebuild primary shards from updated optimizer shards: all-gather over
    E + R along the last axis (flat or stacked (layers, shard) leaves).

    With ``cfg.quantize_update_gather`` the compute-dtype shard is quantized
    to INT8 flat with the leaf's block (blocks never cross rows: a shard is
    a whole number of blocks), q and the f32 scales are gathered, and the
    gathered blocks are dequantized to the compute dtype, as the reference
    does (``src/repro/core/collectives.py:270-282``). The kernels' launches
    here are also counted in ``UPDATE_GATHER_LAUNCHES``."""
    axes = cfg.axes.extra_grad + cfg.axes.replica
    x = master_shard.to(out_dtype)
    if cfg.size(axes) == 1:
        return x
    if not cfg.quantize_update_gather:
        return _tiled(_gather(x, axes, "update_gather"))
    before = ops.launches()
    q, s = ops.quantize_int8(x.reshape(-1), cfg.quant_block, impl=cfg.impl)
    del x
    q = q.reshape(master_shard.shape)
    s = s.reshape(master_shard.shape[:-1] + (-1,))
    qf = _tiled(_gather(q, axes, "update_gather"))
    sf = _tiled(_gather(s, axes, "update_gather"))
    del q, s
    out = ops.dequantize_int8(qf.reshape(-1), sf.reshape(-1),
                              cfg.quant_block, out_dtype, impl=cfg.impl)
    for k, v in ops.launches().items():
        if v > before[k]:
            UPDATE_GATHER_LAUNCHES[k] += v - before[k]
    return out.reshape(master_shard.shape[:-1] + (-1,))


def secondary_slice(qf, sf, axes: AxisTuple, cfg: ZeroConfig):
    """This rank's secondary partition of gathered (q, scales): whole quant
    blocks and their scales, copied out so the gathered buffer can go."""
    s_deg = cfg.size(tuple(axes))
    if s_deg == 1:
        return qf, sf
    idx = axis_index(axes, cfg)
    qlen = qf.shape[-1] // s_deg
    slen = sf.shape[-1] // s_deg
    return (qf[..., idx * qlen:(idx + 1) * qlen].clone(),
            sf[..., idx * slen:(idx + 1) * slen].clone())


def gather_secondary_q(sec_q, sec_s, axes: AxisTuple, cfg: ZeroConfig):
    """Backward weight all-gather from the INT8 secondary partition, kept in
    wire format for the fused dequant-matmul."""
    if cfg.size(tuple(axes)) == 1:
        return sec_q, sec_s
    return (_tiled(_gather(sec_q, axes, "all_gather")),
            _tiled(_gather(sec_s, axes, "all_gather")))


def residency_slice(qf, sf, axes: AxisTuple, cfg: ZeroConfig):
    """This device's serving residency partition of gathered (q, scales)."""
    return secondary_slice(qf, sf, axes, cfg)


def gather_residency_q(res_q, res_s, axes: AxisTuple, cfg: ZeroConfig):
    """Decode-path wire re-gather: residency shards -> full (q, scales),
    its payload counted under "residency_gather"."""
    if cfg.size(tuple(axes)) == 1:
        return res_q, res_s
    return (_tiled(_gather(res_q, axes, "residency_gather")),
            _tiled(_gather(res_s, axes, "residency_gather")))


# -- serving over the mesh's sequence and data axes ----------------------------
# These take no scheme config: the axes' sizes are the bound mesh's, and an
# empty tuple (or one of size 1) makes each the identity.

def mesh_size(axes: AxisTuple) -> int:
    """The size of ``axes`` on the bound mesh (1 for no axes)."""
    if not axes:
        return 1
    if _MESH is None:
        raise RuntimeError(f"axes {tuple(axes)}: no mesh bound "
                           "(core.collectives.bind)")
    return _MESH.axis_size(tuple(axes))


def mesh_coord(axis: str) -> int:
    """This rank's coordinate on ``axis`` of the bound mesh."""
    if _MESH is None:
        raise RuntimeError(f"axis {axis}: no mesh bound "
                           "(core.collectives.bind)")
    return _MESH.coords[axis]


def seq_max(x: torch.Tensor, axes: AxisTuple) -> torch.Tensor:
    """Elementwise max over ``axes`` (exact in any order)."""
    if mesh_size(axes) == 1:
        return x
    return _gather(x, axes, "seq_max").amax(dim=0)


def seq_sum(x: torch.Tensor, axes: AxisTuple) -> torch.Tensor:
    """Sum over ``axes`` in axis order, as ``det_psum``: every rank of the
    group gets the same bits."""
    if mesh_size(axes) == 1:
        return x
    return _ordered_sum(x, axes, "seq_sum")


def gather_dim(x: torch.Tensor, axes: AxisTuple, dim: int,
               op: str = "seq_gather") -> torch.Tensor:
    """Tiled all-gather along ``dim``: the members' ``x`` concatenated in
    axis order (the sequence-parallel K/V, the prefill cache at admission;
    the decode tokens over the data axes under ``op="batch_gather"``)."""
    if mesh_size(axes) == 1:
        return x
    return torch.cat(list(_gather(x, axes, op)), dim=dim)
