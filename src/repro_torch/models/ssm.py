"""Mamba-1 selective-state-space mixer (the ``mamba`` block kind).

Port of ``repro.models.ssm``. The full-sequence mixer runs the selective
scan through ``ops.selective_scan`` (the CUDA kernel on the card, the plain
version on the CPU); decode is O(1), one state update per token. The
depthwise causal conv is written as the reference writes it, a sum of
shifted copies accumulated in f32 in order k = 0..K-1 (``F.conv1d`` would
sum in another order, and on the card in TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ArchConfig


def _ssm_params(view, prefix: str):
    a_log = view.get(prefix + "A_log").float()         # (din, n)
    d_skip = view.get(prefix + "D").float()            # (din,)
    dt_bias = view.get(prefix + "dt_bias").float()     # (din,)
    return a_log, d_skip, dt_bias


def _conv_train(x, w, b, d_conv: int):
    """Causal depthwise conv: x (B,S,din), w (din,K), b (din,) -> f32."""
    seq = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(d_conv):
        shift = d_conv - 1 - k
        xs = F.pad(x, (0, 0, shift, 0))[:, :seq]
        out = out + xs.float() * w[:, k].float()
    return out + b.float()


def mamba_mixer(view, prefix: str, cfg: ArchConfig, x):
    """Full-sequence mixer. x (B,S,d) -> (y (B,S,d), (h_last, conv_tail))."""
    s = cfg.ssm
    din, n, dtr = cfg.d_inner, s.d_state, cfg.dt_rank
    b, seq, _ = x.shape

    xz = view.mm(prefix + "w_in", x)                           # (B,S,2*din)
    x_in, z = xz[..., :din], xz[..., din:]
    x_c = F.silu(_conv_train(x_in, view.get(prefix + "conv_w"),
                             view.get(prefix + "conv_b"), s.d_conv))
    x_c = x_c.to(x.dtype)

    xdb = view.mm(prefix + "w_xproj", x_c)                      # (B,S,dtr+2n)
    dt_r = xdb[..., :dtr]
    b_ssm = xdb[..., dtr:dtr + n].float()                       # (B,S,n)
    c_ssm = xdb[..., dtr + n:].float()
    dt_full = view.mm(prefix + "w_dt", dt_r)                    # (B,S,din)
    a_log, d_skip, dt_bias = _ssm_params(view, prefix)
    dt = F.softplus(dt_full.float() + dt_bias)                  # (B,S,din)
    a = -torch.exp(a_log)                                       # (din,n)

    h0 = torch.zeros((b, din, n), dtype=torch.float32, device=x.device)
    y, h_last = ops.selective_scan(dt, x_c.float(), b_ssm, c_ssm, a, h0,
                                   impl=view.impl)
    y = y + d_skip * x_c.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = view.mm(prefix + "w_out", y)
    k1 = s.d_conv - 1
    if seq >= k1:
        conv_tail = x_in[:, seq - k1:].float()
    else:                       # a short prompt: zeros on the left
        conv_tail = F.pad(x_in.float(), (0, 0, k1 - seq, 0))
    return out, (h_last, conv_tail)


def mamba_decode(view, prefix: str, cfg: ArchConfig, x_tok, state):
    """Single-token step. x_tok (B,1,d); state = (h (B,din,n) f32,
    conv_tail (B,K-1,din) f32). Returns (y (B,1,d), (h_new, new_tail)); the
    caller writes the new state back."""
    s = cfg.ssm
    din, n, dtr = cfg.d_inner, s.d_state, cfg.dt_rank
    h, conv_tail = state

    xz = view.mm(prefix + "w_in", x_tok)                        # (B,1,2din)
    x_in, z = xz[..., :din], xz[..., din:]
    conv_w = view.get(prefix + "conv_w").float()                # (din,K)
    conv_b = view.get(prefix + "conv_b").float()
    window = torch.cat([conv_tail, x_in.float()], dim=1)        # (B,K,din)
    x_c = F.silu(torch.einsum("bkd,dk->bd", window, conv_w) + conv_b)
    new_tail = window[:, 1:]

    xdb = view.mm(prefix + "w_xproj", x_c[:, None].to(x_tok.dtype))
    dt_r = xdb[..., :dtr]
    b_ssm = xdb[:, 0, dtr:dtr + n].float()                      # (B,n)
    c_ssm = xdb[:, 0, dtr + n:].float()
    dt_full = view.mm(prefix + "w_dt", dt_r)[:, 0]              # (B,din)
    a_log, d_skip, dt_bias = _ssm_params(view, prefix)
    dt = F.softplus(dt_full.float() + dt_bias)
    a = -torch.exp(a_log)
    da = torch.exp(dt[..., None] * a)                           # (B,din,n)
    dbx = (dt * x_c)[..., None] * b_ssm[:, None, :]
    h_new = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h_new, c_ssm) + d_skip * x_c
    y = y * F.silu(z[:, 0].float())
    out = view.mm(prefix + "w_out", y[:, None].to(x_tok.dtype))
    return out, (h_new, new_tail)


def mamba_state_spec(cfg: ArchConfig, batch: int):
    """(shape, dtype) of the decode state (h, conv_tail) for ``batch`` rows."""
    s = cfg.ssm
    return (((batch, cfg.d_inner, s.d_state), torch.float32),
            ((batch, s.d_conv - 1, cfg.d_inner), torch.float32))
