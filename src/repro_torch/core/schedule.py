"""The comm-schedule layer: the forward gather prefetch, the backward
re-gather and the gradient reduce-scatter as issue / wait pairs.

Port of ``repro.core.schedule``:

1. Forward gather prefetch (machine 1, ``ZeroConfig.overlap``):
   ``issue_buffers`` starts one layer's quantize + all-gathers with
   ``async_op=True`` work handles (``collectives.GatherBuf``), and
   ``loop_layers`` rotates two slots through the layer loop: it issues layer
   j+1's gathers before layer j computes, and layer j waits on its own where
   it consumes them (``ParamView.mm`` / ``get``). The reference threads the
   buffer through ``lax.scan``; here the loop is eager, so the rotation is a
   Python loop. Every collective is issued in the same order on every rank,
   and the gather count and bytes stay those of the inline path.
2. Backward re-gather (machine 2): ``regather_issue`` ends at the
   collective that rebuilds a weight in wire format for the backward,
   ``regather_wait`` dequantizes it.
3. Gradient reduce-scatter (machine 3): ``grad_rs_issue`` quantizes (INT4
   by default, INT8 with ``bits=8``) and exchanges a gradient, or passes it
   through when the group has size 1, and ``grad_rs_wait`` runs the local
   fused dequant-sum. The token carries the group size and the bit width, so
   issue and wait cannot disagree. On the streaming path the stage-2 pair
   runs inside each layer's backward (core/linear.py ``_os_tail``).

Every split composes op for op into its fused primitive, so the overlapped
and streaming schedules give the numbers of the inline one.
"""
from __future__ import annotations

import torch

from . import collectives as col
from .partition import AxisTuple, ZeroConfig


# -- machine 1: the forward gather prefetch --------------------------------------

def prefetchable_names(fns, names) -> tuple[str, ...]:
    """Leaves with an issue half (MATMUL / GATHER_Q); PLAIN leaves are
    norm-scale sized and keep their inline gather."""
    return tuple(n for n in names if fns[n].issue is not None)


def issue_buffers(fns, primaries, names) -> dict:
    """Issue the gathers of one layer's prefetchable leaves: {name:
    GatherBuf}, their collectives in flight. The primaries are read outside
    autograd: no gradient flows back through a buffer."""
    with torch.no_grad():
        return {n: fns[n].issue(primaries[n].detach()) for n in names}


def loop_layers(view, body, carry, steps, *, overlap: bool | None = None):
    """Run ``body(view.sub(layer, bufs), carry, tag) -> carry`` over
    ``steps`` = [(tag, layer index within the tag's stack)] in order.

    With overlap (``None``: the view's setting), layer j+1's gathers are
    issued before layer j's body runs, so each layer finds its buffers in
    flight or done; a layer consumes each buffer once (``ParamView``), and
    whatever it left unread is waited on and dropped before the next layer,
    so no work handle or buffer outlives its layer (the recompute of a
    checkpointed layer then gathers inline)."""
    if overlap is None:
        overlap = view.overlap

    def issue(j):
        tag, i = steps[j]
        names = prefetchable_names(view.fns, view.stacked_names(tag))
        return issue_buffers(view.fns, view.layer_primaries(names, i), names)

    nxt = issue(0) if overlap and steps else None
    for j, (tag, i) in enumerate(steps):
        bufs, nxt = nxt, None
        if overlap and j + 1 < len(steps):
            nxt = issue(j + 1)
        carry = body(view.sub(i, bufs), carry, tag)
        while bufs:                  # what the layer left unread
            bufs.popitem()[1].wait()
    return carry


# -- machine 2: the backward re-gather ----------------------------------------------

def regather_issue(primary, sec_q, sec_s, cfg: ZeroConfig):
    """Backward weight re-materialization in wire format (q, scales): the
    INT8 secondary partition gathered over the secondary axes when there is
    one, else the primary re-quantized and gathered over the weight axes."""
    if sec_q is not None:
        return col.gather_secondary_q(sec_q, sec_s, cfg.axes.secondary, cfg)
    return col.gather_issue_int8(primary, cfg.axes.weight, cfg)


def regather_wait(qf, sf, cfg: ZeroConfig, out_dtype=torch.bfloat16):
    """Local dequant of a re-gathered wire buffer (unfused path)."""
    return col.gather_wait_int8(qf, sf, cfg, out_dtype)


# -- machine 3: the gradient reduce-scatter ---------------------------------------

def grad_rs_issue(flat: torch.Tensor, axes: AxisTuple, cfg: ZeroConfig, *,
                  bits: int = 4):
    """Issue half of a gradient reduce-scatter over ``axes``: quantize
    (INT4, or INT8 with ``bits=8``) + all-to-all when the config quantizes
    gradients, the reduce-scatter itself otherwise, nothing for a group of
    size 1."""
    if cfg.size(tuple(axes)) == 1:
        return ("nop", flat)
    if not cfg.quantize_grads:
        return ("rs", col.psum_scatter(flat, axes, cfg))
    return ("a2a", col.a2a_rs_issue(flat, axes, cfg, bits),
            cfg.size(tuple(axes)), bits)


def grad_rs_issue_q(q, s, axes: AxisTuple, cfg: ZeroConfig, *, bits: int = 4):
    """Issue half for a gradient already in wire format (the matmul_quant
    epilogue, INT4 or INT8 as ``bits`` says): only the all-to-all remains."""
    if cfg.size(tuple(axes)) == 1:
        raise ValueError(f"grad_rs_issue_q over {tuple(axes)} of size 1")
    return ("a2a", col.a2a_rs_issue_q(q, s, axes, cfg),
            cfg.size(tuple(axes)), bits)


def grad_rs_wait(token, cfg: ZeroConfig, *, out_dtype=torch.float32):
    """Wait half: the local fused dequant + sum of the received chunks, in
    the bit width the token carries."""
    if token[0] in ("nop", "rs"):
        return token[1].to(out_dtype)
    _, (q2, s2), d, bits = token
    return col.a2a_rs_wait(q2, s2, d, cfg, bits, out_dtype)
