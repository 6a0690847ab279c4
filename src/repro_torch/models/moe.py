"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch.

Port of ``repro.models.moe`` (``_dispatch_combine`` :28, ``moe_ffn`` :58),
the paper-faithful baseline: the expert stacks are ordinary ZeRO leaves
(GATHER_Q), read whole through the view's ``get`` (the INT8 gather in
training, the residency's dequantize in serving), and every rank computes
the dispatch, expert FFN and combine for its own tokens. Tokens run in
chunks of ``_best_chunk(T, token_chunk)``, so the (T, E, C) one-hot tensors
stay bounded; past one chunk each chunk runs under its own checkpoint, as
the reference's ``jax.checkpoint`` inside ``lax.scan``.

Expert choice: ``lax.top_k`` takes the larger gate first and, between equal
gates, the lower expert index; ``torch.topk`` promises no order among
ties, so the experts come from a stable descending sort.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .config import ArchConfig
from .layers import _best_chunk


def _top_k(gates, k: int):
    """(values, indices) of the k largest gates a row, larger first, ties
    to the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _slots(xc):
    """The tokens as the dispatch einsum takes them: bf16 whatever the
    compute dtype (the reference's ``xc.astype(bfloat16)``)."""
    return xc.to(torch.bfloat16)


def _one_hot(idx, n: int):
    """f32 one-hot of (possibly out-of-range) integer-valued ``idx``: a row
    whose value is not in [0, n) is all zeros (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _dispatch_combine(gates, top_k: int, capacity: int):
    """gates (T, E) softmax probs -> dispatch (T, E, C) bf16, combine
    (T, E, C) f32 and the Switch-style load-balance term E * sum(f_e P_e)
    (f from the top-1 choices). A token's j-th choice takes the next free
    slot of its expert after every earlier token's and every earlier
    choice's; past ``capacity`` it is dropped."""
    t, e = gates.shape
    vals, idx = _top_k(gates, top_k)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bfloat16,
                           device=gates.device)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32,
                          device=gates.device)
    fill = torch.zeros((e,), dtype=torch.float32, device=gates.device)
    for j in range(top_k):
        oh = _one_hot(idx[:, j], e)                          # (T, E)
        pos = torch.cumsum(oh, dim=0) - oh + fill            # (T, E)
        fill = fill + oh.sum(dim=0)
        pos_t = (pos * oh).sum(-1)                           # (T,)
        in_cap = (pos_t < capacity).float()
        slot = _one_hot(pos_t, capacity)                     # (T, C)
        d_j = (oh[:, :, None] * slot[:, None, :]) * in_cap[:, None, None]
        dispatch = dispatch + d_j.to(torch.bfloat16)
        combine = combine + d_j * vals[:, j][:, None, None]
    f_e = _one_hot(idx[:, 0], e).mean(dim=0)
    p_e = gates.mean(dim=0)
    aux = e * (f_e * p_e).sum()
    return dispatch, combine, aux


def moe_ffn(view, prefix: str, cfg: ArchConfig, x):
    """x (B, S, d) -> (y (B, S, d), aux loss scalar f32).

    Leaves: ``{prefix}router`` (d, E); ``{prefix}w_gate`` / ``w_up`` (E, d,
    ff) and ``{prefix}w_down`` (E, ff, d), dense through the view
    (``view.expert_ffn``). The slots are formed from x in bf16 whatever
    the compute dtype, and summed back in f32, as in the reference."""
    m = cfg.moe
    b, s, d = x.shape
    router = view.get(prefix + "router")
    xt = x.reshape(b * s, d)
    t_total = b * s
    chunk = _best_chunk(t_total, m.token_chunk)
    n_chunks = t_total // chunk
    capacity = max(int(m.capacity_factor * m.top_k * chunk / m.n_experts), 4)

    def body(xc):
        gates = torch.softmax(xc.float() @ router.float(), dim=-1)
        disp, comb, aux = _dispatch_combine(gates, m.top_k, capacity)
        e_in = torch.einsum("tec,td->ecd", disp, _slots(xc))
        e_out = view.expert_ffn(prefix, e_in)
        yc = torch.einsum("tec,ecd->td", comb, e_out.float())
        return aux, yc.to(x.dtype)

    if n_chunks == 1:
        aux, y = body(xt)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for xc in xt.reshape(n_chunks, chunk, d):
            a, yc = checkpoint(body, xc, use_reentrant=False)
            aux = aux + a
            ys.append(yc)
        y = torch.cat(ys)
    return y.reshape(b, s, d), aux * m.aux_coef / n_chunks


def expert_glu(get, prefix: str, e_in):
    """The expert GLU FFN on dispatched slots e_in (E, C, d) -> (E, C, d):
    silu(e_in @ w_gate) * (e_in @ w_up) @ w_down, each expert stack read
    whole through ``get``, each product at the promoted dtype of its
    operands (the reference's einsums: bf16 slots against f32 weights run
    in f32)."""
    wg = get(prefix + "w_gate")
    wu = get(prefix + "w_up")
    wd = get(prefix + "w_down")
    h = torch.nn.functional.silu(_bmm(e_in, wg)) * _bmm(e_in, wu)
    return _bmm(h, wd)


def _bmm(a, b):
    """a @ b at the promoted dtype, each operand cast on its own, so that
    each product's gradient comes back in its operand's dtype before the
    gradients of one operand are summed (as the reference's einsums'
    transposes do: a bf16 operand's two cotangents sum in bf16)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.to(dt), b.to(dt))
