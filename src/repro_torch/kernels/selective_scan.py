"""Mamba-1 selective scan on the card (csrc/selective_scan.cu).

Port of ``repro.kernels.selective_scan.selective_scan_pallas`` (:56),
forward only (``ops.selective_scan``'s backward is autograd through the
plain version, as the reference's is). The source note in csrc/selective_scan.cu gives the bound and
the design; ``ref.selective_scan_ref`` is the plain version. Callers go
through ``kernels/ops.py``, which counts the launches.
"""
from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from . import cuda

SIGNATURES = {
    "selective_scan": (c_int, [c_void_p] * 8 + [c_int] * 4 + [c_void_p]),
}
STATES = (16,)      # the d_state widths the kernel is compiled for


def selective_scan_cuda(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """dt, x (B, S, D); b, c (B, S, N); a (D, N); h0 (B, D, N), contiguous
    f32 -> (y (B, S, D) f32, h_last (B, D, N) f32). The shapes are checked
    by ``ops.selective_scan``; here only d_state."""
    for name, t in (("dt", dt), ("x", x), ("b", b), ("c", c), ("a", a),
                    ("h0", h0)):
        cuda.require(t, name, (torch.float32,))
    bsz, s, d = dt.shape
    n = a.shape[-1]
    if n not in STATES:
        raise ValueError(f"selective_scan: d_state {n}, the kernel is built "
                         f"for {STATES}")
    lib = cuda.library("selective_scan", SIGNATURES)
    y = torch.empty_like(dt)
    h_last = torch.empty_like(h0)
    rc = lib.selective_scan(dt.data_ptr(), x.data_ptr(), b.data_ptr(),
                            c.data_ptr(), a.data_ptr(), h0.data_ptr(),
                            y.data_ptr(), h_last.data_ptr(), bsz, s, d, n,
                            cuda.stream(dt))
    cuda.check(rc, "selective_scan")
    return y, h_last
