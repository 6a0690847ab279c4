#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch/).

    python3 chip_smoke.py [--out report.json]

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
either is missing or any phase fails. Phases, in order:

1. build  : compiles every kernel of src/repro_torch/csrc/ (one nvcc per
            source, in parallel) and prints the build time.
2. kernels: holds each kernel against its plain PyTorch version on the card,
            at the shapes the serving path gives it and at small ragged
            shapes. INT8 q and scales must match bit for bit; bf16 outputs
            within one bf16 ulp of the largest plain output (2**-7 * max|ref|:
            both sides round an f32 sum, summed in another order); f32
            outputs within 1e-5 * max|ref|.
            The training kernels are held at the training step's shapes:
            quantize_int4 and dequantize_int4_sum (d = 2) bit for bit;
            matmul_quant (bits 4 and 8, with and without pad_to) with scales
            within 1e-5 relative, q within +-1 in at most 1e-3 of the entries
            and the dequantized C within one quant step of the plain product
            (the two sum M in another order).
            selective_scan is held in f32 within 1e-5 * max|ref| for y and
            h_last (a last-bit difference of exp per step in a decaying
            recurrence, and another order of the N-sum) at the prefill shape
            (B=1, S=128, D=8192, N=16, h0 = 0), at S=2048 and ragged.
            falcon-mamba-7b's shapes too: dequant_matmul at w_in, w_dt and
            w_out for M = 4 and 128 and its LM head at M = 1 and 4;
            dequantize_int8 of w_xproj; quantize_int8 and dequantize_int8
            of the whole 2^32-element w_in stack (plain versions per chunk).
3. serve  : zeroes the launch counters, builds the qwen2-0.5b INT8 residency
            at published width from the seeded init and serves 8 requests
            (4 slots, prompt 128, 32 new tokens, max_len 256) through the
            continuous batcher, then reads the counters: every serving kernel
            must have launched. The first request's prefill logits are held
            against the same prefill through the plain versions on the card
            (bf16 compute across 24 layers: max|d| <= 5e-2 * max|ref|), and
            one prefill is traced by torch.profiler (device ms, top kernels).
3b. ssm   : the same for falcon-mamba-7b at published width and depth (64
            mamba layers, d_inner 8192, INT8 residency of 7.0 GB built leaf
            by leaf): the same traffic, its own kernel list (quantize_int8,
            dequantize_int8, dequant_matmul, selective_scan), prefill logits
            against the plain versions (64 layers of bf16: max|d| <=
            5e-2 * max|ref|) and again with f32 activations on the same
            weights (max|d| <= PREFILL_F32_TOL * max|ref|, which rounding
            alone meets and a fault would not), peak device memory, the
            decode step replayed as
            a CUDA graph and the scan's device time at S=128 and S=2048; then
            its residency is freed before the training ranks start.
4. train  : repro_torch.launch.train with --devices 4: qwen2-0.5b at full
            width and depth under zero_topo on the mesh (data, node, gcd) =
            (1, 2, 2), four ranks (processes) on this one card over gloo,
            quant block 128, bf16, global batch 8 x seq 1024, 5 steps from
            seed 0, the last one traced by torch.profiler. Each rank zeroes
            its counters before its steps and reads them after: every kernel
            of TRAIN_KERNELS must have launched on every rank (the report
            gives every kernel's count). Then the same steps from the same
            state with --kernel-impl plain (no kernel may launch);
            per-step loss and grad norm must agree (TRAIN_LOSS_RTOL,
            TRAIN_GNORM_RTOL).
5. timing : device time of each kernel, its plain version and, where one
            PyTorch call computes the same function, that call, at the
            serving and training shapes (CUDA graphs of repeated launches,
            CUDA events).
6. report : a JSON line of the kernels, serve, serve_ssm and train lines, the card's
            name and power limit (nvidia-smi), and last the line
            {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM, ops/s by type
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12}
BF16_TOL = 2.0 ** -7
F32_TOL = 1e-5
PREFILL_TOL = 5e-2
# the same prefill with f32 activations on the same INT8 weights: kernels and
# plain versions then differ only by f32 rounding (another order of the
# matmul sums, exp's last bit), about 1e-7 relative per operation; even grown
# 100x through 64 layers that stays 10x under this limit, while a wrong tile,
# split or offset at the served shapes moves whole products
PREFILL_F32_TOL = 1e-4

SERVE_ARGS = ["--arch", "qwen2-0.5b", "--requests", "8", "--slots", "4",
              "--prompt-len", "128", "--gen", "32", "--max-len", "256",
              "--seed", "0"]
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--scheme", "zero_topo", "--devices", "4",
              "--batch", "8", "--seq", "1024", "--steps", "5",
              "--quant-block", "128", "--compute-dtype", "bfloat16",
              "--seed", "0", "--timeout", "600"]
PROFILE_STEP = 4        # the kernel run traces its last step
# kernels vs plain versions through 5 bf16 training steps of 24 layers:
# about 20x (loss) and 9x (grad norm) the largest relative differences of
# the first runs on the H100 (4.8e-5 and 1.1e-3). The loss is a mean over
# 8,192 tokens, so bf16 rounding differences average out; the grad norm
# also carries INT4 rounding flips of the gradients.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 1e-2
SERVE_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
                 "flash_attention")
SSM_SERVE_ARGS = ["--arch", "falcon-mamba-7b"] + SERVE_ARGS[2:]
SSM_SERVE_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
                     "selective_scan")
# each path is held to the kernels it runs, so a kernel that only another
# path launches never fails it
TRAIN_KERNELS = ("quantize_int8", "dequantize_int8", "dequant_matmul",
                 "flash_attention", "quantize_int4", "dequantize_int4_sum",
                 "matmul_quant")
SCAN_D, SCAN_N = 8192, 16           # falcon-mamba-7b's d_inner and d_state
MAMBA_D, MAMBA_DTR, MAMBA_V, MAMBA_L = 4096, 256, 65_024, 64

KERNEL_INFO = {
    "quantize_int8": ("src/repro_torch/csrc/quant_int8.cu",
                      "src/repro/kernels/quant_blockwise.py:40"),
    "dequantize_int8": ("src/repro_torch/csrc/quant_int8.cu",
                        "src/repro/kernels/quant_blockwise.py:63"),
    "dequant_matmul": ("src/repro_torch/csrc/dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:113"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:92"),
    "quantize_int4": ("src/repro_torch/csrc/quant_int4.cu",
                      "src/repro/kernels/quant_int4.py:46"),
    "dequantize_int4_sum": ("src/repro_torch/csrc/quant_int4.cu",
                            "src/repro/kernels/quant_int4.py:105"),
    "matmul_quant": ("src/repro_torch/csrc/matmul_quant.cu",
                     "src/repro/kernels/dequant_matmul.py:209"),
    "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:56"),
}
# (K, N) of one layer's seven dW products (wq wk wv wo w_gate w_up w_down)
LAYER_KN = ((896, 896), (896, 128), (896, 128), (896, 896), (896, 4864),
            (896, 4864), (4864, 896))
TRAIN_M = 2048                      # tokens per rank: 8 x 1024 over 4 ranks
EMBED_N = 151_936 * 896             # the tied embedding's padded length


class Failed(RuntimeError):
    pass


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops / PEAK[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / (reps * replays)
    del graph
    torch.cuda.synchronize()
    return ms


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|), in f32."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise Failed("non-finite kernel output")
    return float((g - w).abs().max()), float(w.abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, gen, checks):
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    def record(name, what, err, tol):
        checks.setdefault(name, []).append(dict(case=what, max_abs_err=err,
                                                tolerance=tol))
        print(f"  {name:16s} {what:44s} max_abs_err={err:.3e} tol={tol}")

    def quant_case(what, n_blocks, block, dtype, scale_spread=True):
        x = torch.randn((n_blocks, block), generator=gen, device=dev)
        if scale_spread:
            x *= torch.rand((n_blocks, 1), generator=gen, device=dev) * 50
        x[n_blocks // 2] = 0.0
        x = x.to(dtype).reshape(-1)
        qk, sk = ops.quantize_int8(x, block)
        qp, sp = ops.quantize_int8(x, block, impl="plain")
        if not (torch.equal(qk, qp) and torch.equal(sk.view(torch.int32),
                                                    sp.view(torch.int32))):
            raise Failed(f"quantize_int8 {what}: not bitwise equal")
        record("quantize_int8", what, 0.0, "bitwise")
        for odt in (torch.bfloat16, torch.float32):
            dk = ops.dequantize_int8(qk, sk, block, odt)
            dp = ops.dequantize_int8(qk, sk, block, odt, impl="plain")
            if not torch.equal(dk, dp):
                raise Failed(f"dequantize_int8 {what} -> {odt}: not bitwise")
            record("dequantize_int8", f"{what} -> {str(odt)[6:]}", 0.0,
                   "bitwise")

    # w_gate stack of qwen2-0.5b (24 x 896*4864) in bf16, the residency's
    # largest quantize; the prefill embedding rows (128 x 896); ragged
    quant_case("(24*896*4864/128, 128) bf16", 24 * 896 * 4864 // 128, 128,
               torch.bfloat16, scale_spread=False)
    quant_case("(128*896/128, 128) bf16", 128 * 896 // 128, 128, torch.bfloat16)
    quant_case("(37, 128) f32 ragged", 37, 128, torch.float32)
    quant_case("(37, 64) bf16 ragged", 37, 64, torch.bfloat16)
    # falcon-mamba-7b's w_xproj (8192 x 288: not a whole number of blocks per
    # row, so every layer dequantizes it whole to bf16)
    quant_case(f"({SCAN_D}*288/128, 128) bf16 (w_xproj)", SCAN_D * 288 // 128,
               128, torch.bfloat16)

    def stack_case(what, n, block, chunk=1 << 28):
        """One n-element bf16 quantize_int8 and dequantize_int8 (to bf16)
        call, as the residency's largest stack runs them, held bit for bit
        against the plain versions run per chunk of whole blocks (blocks are
        independent; chunks keep the plain f32 temporaries small)."""
        x = torch.empty(n, dtype=torch.bfloat16, device=dev)
        for part in x.split(chunk):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev))
        qk, sk = ops.quantize_int8(x, block)
        dk = ops.dequantize_int8(qk, sk, block, torch.bfloat16)
        for i in range(0, n, chunk):
            j, bi, bj = min(n, i + chunk), i // block, min(n, i + chunk) // block
            qp, sp = ops.quantize_int8(x[i:j], block, impl="plain")
            if not (torch.equal(qk[i:j], qp) and torch.equal(
                    sk[bi:bj].view(torch.int32), sp.view(torch.int32))):
                raise Failed(f"quantize_int8 {what}: not bitwise equal at "
                             f"elements {i}..{j}")
            dp = ops.dequantize_int8(qk[i:j], sk[bi:bj], block, torch.bfloat16,
                                     impl="plain")
            if not torch.equal(dk[i:j], dp):
                raise Failed(f"dequantize_int8 {what} -> bfloat16: not bitwise "
                             f"at elements {i}..{j}")
        record("quantize_int8", what, 0.0, "bitwise")
        record("dequantize_int8", f"{what} -> bfloat16", 0.0, "bitwise")

    # falcon-mamba-7b's w_in stack (64 x 4096*16384 = 2^32 elements), the
    # residency's largest quantize: offsets past 2^31 and 2^32
    stack_case(f"({MAMBA_L}*{MAMBA_D}*{2 * SCAN_D}/128, 128) bf16 (w_in stack)",
               MAMBA_L * MAMBA_D * 2 * SCAN_D, 128)

    def mm_case(what, m, k, n, block, transpose, dtype):
        w = torch.randn(k * n + 3 * block, generator=gen, device=dev) * 0.05
        q, s = ops.quantize_int8(w, block)
        x = torch.randn((m, n if transpose else k), generator=gen,
                        device=dev).to(dtype)
        yk = ops.dequant_matmul(x, q, s, (k, n), block, transpose=transpose,
                                dtype=dtype)
        yp = ops.dequant_matmul(x, q, s, (k, n), block, transpose=transpose,
                                dtype=dtype, impl="plain")
        err, scale = rel_err(yk, yp)
        tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) * scale
        if yk.shape != yp.shape or err > tol:
            raise Failed(f"dequant_matmul {what}: err {err} > {tol}")
        record("dequant_matmul", what, err, f"{tol:.3e}")

    d, ff, hd, V = 896, 4864, 64, 151_936
    for m in (4, 128):
        for k, n in ((d, 14 * hd), (d, 2 * hd), (14 * hd, d), (d, ff), (ff, d)):
            mm_case(f"M={m} ({k}, {n}) bf16", m, k, n, 128, False, torch.bfloat16)
    for m in (1, 4):
        mm_case(f"M={m} ({V}, {d}).T bf16 (LM head)", m, V, d, 128, True,
                torch.bfloat16)
    # falcon-mamba-7b: w_in, w_dt, w_out at decode (M = 4 slots) and prefill
    # (M = 128) sizes, the tied LM head at M = 1 and 4
    for m in (4, 128):
        for k, n in ((MAMBA_D, 2 * SCAN_D), (MAMBA_DTR, SCAN_D),
                     (SCAN_D, MAMBA_D)):
            mm_case(f"M={m} ({k}, {n}) bf16 (falcon-mamba)", m, k, n, 128,
                    False, torch.bfloat16)
    for m in (1, 4):
        mm_case(f"M={m} ({MAMBA_V}, {MAMBA_D}).T bf16 (falcon-mamba LM head)",
                m, MAMBA_V, MAMBA_D, 128, True, torch.bfloat16)
    mm_case("M=3 (200, 192) f32 ragged", 3, 200, 192, 64, False, torch.float32)
    mm_case("M=7 (333, 192).T f32 ragged", 7, 333, 192, 64, True, torch.float32)
    mm_case("M=130 (72, 256) bf16 ragged", 130, 72, 256, 64, False,
            torch.bfloat16)

    def attn_case(what, b, h, hkv, sq, sk, q_offset, window, dtype):
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, sk, hkv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, sk, hkv, hd), generator=gen, device=dev).to(dtype)
        ok = layers.flash_attention(q, k, v, causal=True, window=window,
                                    q_offset=q_offset)
        op = layers.flash_attention(q, k, v, causal=True, window=window,
                                    q_offset=q_offset, impl="plain")
        err, scale = rel_err(ok, op)
        tol = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL) * scale
        if ok.shape != op.shape or err > tol:
            raise Failed(f"flash_attention {what}: err {err} > {tol}")
        record("flash_attention", what, err, f"{tol:.3e}")

    attn_case("B=1 H=14/2 S=128 causal bf16 (prefill)", 1, 14, 2, 128, 128, 0,
              0, torch.bfloat16)
    attn_case("B=2 H=6/2 S=100 causal f32 ragged", 2, 6, 2, 100, 100, 0, 0,
              torch.float32)
    attn_case("B=1 H=4/1 Sq=64 Sk=128 q_offset=64 f32", 1, 4, 1, 64, 128, 64, 0,
              torch.float32)
    attn_case("B=1 H=14/2 S=256 window=32 bf16", 1, 14, 2, 256, 256, 0, 32,
              torch.bfloat16)

    def int4_case(what, n_blocks, block, dtype, d=2):
        x = torch.randn((n_blocks, block), generator=gen, device=dev)
        x *= torch.rand((n_blocks, 1), generator=gen, device=dev) * 50
        x[n_blocks // 2] = 0.0
        x = x.to(dtype).reshape(-1)
        qk, sk = ops.quantize_int4(x, block)
        qp, sp = ops.quantize_int4(x, block, impl="plain")
        if not (torch.equal(qk, qp) and torch.equal(sk.view(torch.int32),
                                                    sp.view(torch.int32))):
            raise Failed(f"quantize_int4 {what}: not bitwise equal")
        record("quantize_int4", what, 0.0, "bitwise")
        rk = ops.dequantize_int4_sum(qk, sk, d, block)
        rp = ops.dequantize_int4_sum(qk, sk, d, block, impl="plain")
        if not torch.equal(rk.view(torch.int32), rp.view(torch.int32)):
            raise Failed(f"dequantize_int4_sum {what} d={d}: not bitwise")
        record("dequantize_int4_sum", f"{what} d={d}", 0.0, "bitwise")

    # the tied embedding's stage-1 grad (bf16, 151,936 x 896), ragged
    int4_case("(151936*896/128, 128) bf16 (embed grad)", EMBED_N // 128, 128,
              torch.bfloat16)
    int4_case("(36, 8) f32 ragged", 36, 8, torch.float32, d=4)
    int4_case("(34, 4) bf16 ragged", 34, 4, torch.bfloat16)
    int4_case("(38, 64) f32 ragged", 38, 64, torch.float32)

    def mq_case(what, m, k, n, block, bits, pad=0):
        x = torch.randn((m, k), generator=gen, device=dev)
        g = torch.randn((m, n), generator=gen, device=dev) * 1e-2
        pad_to = k * n + pad if pad else None
        qk, sk = ops.matmul_quant(x, g, block, bits=bits, pad_to=pad_to)
        qp, sp = ops.matmul_quant(x, g, block, bits=bits, pad_to=pad_to,
                                  impl="plain")
        if qk.shape != qp.shape or sk.shape != sp.shape:
            raise Failed(f"matmul_quant {what}: shapes")
        srel = float(((sk - sp).abs() / sp.abs()).max())

        def levels(q):
            if bits == 8:
                return q.int()
            return torch.stack([(q & 0xF).int() - 8, (q >> 4).int() - 8],
                               dim=-1).reshape(-1)

        lk, lp = levels(qk), levels(qp)
        diff = (lk - lp).abs()
        frac = float((diff != 0).float().mean())
        step = sk.repeat_interleave(block)
        c = (x.T @ g).reshape(-1)
        deq_err = float(((lk[:c.numel()] * step[:c.numel()] - c).abs()
                         / step[:c.numel()]).max())
        if srel > 1e-5 or int(diff.max()) > 1 or frac > 1e-3 or deq_err > 1.0:
            raise Failed(f"matmul_quant {what}: scale rel {srel}, q diff "
                         f"{int(diff.max())} in {frac}, dequant {deq_err} steps")
        record("matmul_quant", what, float(((lk * step - lp * sp.repeat_interleave(
            block)).abs()).max()), f"scales 1e-5 rel, q +-1 in <= 1e-3 "
               f"(here {frac:.1e}), C within 1 step (here {deq_err:.2f})")

    for k, n in sorted(set(LAYER_KN)):
        for bits in (4, 8):
            mq_case(f"M={TRAIN_M} ({k}, {n}) bits={bits}", TRAIN_M, k, n, 128,
                    bits)
    mq_case(f"M={TRAIN_M} (896, 128) bits=4 pad_to +512", TRAIN_M, 896, 128, 128,
            4, pad=512)
    mq_case("M=100 (72, 192) bits=8 pad_to +64 ragged", 100, 72, 192, 64, 8,
            pad=64)
    mq_case("M=33 (10, 512) bits=4 block 256 ragged", 33, 10, 512, 256, 4)
    mq_case("M=20 (70, 1024) bits=8 block 512 ragged", 20, 70, 1024, 512, 8)

    def scan_case(what, b, seq, d, h0_zero, dt_shift):
        dt, x, bm, cm, a, h0 = scan_inputs(gen, dev, b, seq, d, h0_zero,
                                           dt_shift)
        yk, hk = ops.selective_scan(dt, x, bm, cm, a, h0)
        yp, hp = ops.selective_scan(dt, x, bm, cm, a, h0, impl="plain")
        for out, got, want in (("y", yk, yp), ("h_last", hk, hp)):
            err, scale = rel_err(got, want)
            tol = F32_TOL * scale
            if got.shape != want.shape or err > tol:
                raise Failed(f"selective_scan {what} {out}: err {err} > {tol}")
            record("selective_scan", f"{what} {out}", err, f"{tol:.3e}")

    scan_case(f"B=1 S=128 D={SCAN_D} h0=0 (prefill)", 1, 128, SCAN_D, True, 3.0)
    scan_case(f"B=1 S=2048 D={SCAN_D} h0=0", 1, 2048, SCAN_D, True, 3.0)
    scan_case("B=3 S=37 D=96 h0!=0 ragged", 3, 37, 96, False, 0.0)


def scan_inputs(gen, dev, b, seq, d, h0_zero=True, dt_shift=3.0):
    """Scan inputs with d_state 16: dt = softplus(normal - dt_shift) (a
    shift of 3 puts dt near the [1e-3, 1e-1] of falcon-mamba's dt_bias),
    A = -exp(log(1..N) + noise), x, B, C normal."""
    n = SCAN_N
    dt = torch.nn.functional.softplus(
        torch.randn((b, seq, d), generator=gen, device=dev) - dt_shift)
    x = torch.randn((b, seq, d), generator=gen, device=dev)
    bm = torch.randn((b, seq, n), generator=gen, device=dev)
    cm = torch.randn((b, seq, n), generator=gen, device=dev)
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev).float())
                   + 0.1 * torch.randn((d, n), generator=gen, device=dev))
    h0 = torch.randn((b, d, n), generator=gen, device=dev)
    if h0_zero:
        h0.zero_()
    return dt, x, bm, cm, a, h0


def scan_work(b, seq, d, n=SCAN_N):
    """(bytes, f32 operations) of one scan: dt, x and y, B and C, A, h0 and
    h_last once each; per (t, d, n) dt*a, exp, da*h, dx*b, the add, h*c and
    the N-sum's add (exp counted as one operation), per (t, d) dt*x."""
    n_bytes = 4 * (3 * b * seq * d + 2 * b * seq * n + d * n + 2 * b * d * n)
    return n_bytes, b * seq * d * (7 * n + 1)


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

class Collect:
    """Per-step batcher records, kept in memory."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def serve_phase(argv, kernels):
    """Serve ``argv``'s traffic from its seeded residency; every kernel of
    ``kernels`` must launch in the run (the counters are zeroed just before
    the residency is built and read just after the last request)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    device, arch, model, layout, residency = serve.setup(args)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    metrics = Collect()
    cb = serve.make_batcher(args, model, layout, device, metrics)
    reqs = serve.make_requests(args, arch)
    t0 = time.perf_counter()
    cb.run(residency, reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()

    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise Failed(f"{arch.name}: kernels not launched on the serving "
                     f"path: {missing}")
    c = cb.counters
    if c["retired"] != len(reqs) or c["rejected"] or \
            c["admitted"] != c["retired"] + c["preempted"]:
        raise Failed(f"batcher counters {c}")
    for r in reqs:
        if len(r.out) != args.gen or not all(0 <= t < arch.vocab for t in r.out):
            raise Failed(f"request {r.rid}: tokens {r.out}")
    n_tok = sum(len(r.out) for r in reqs)
    full = [r["phase_ms"]["serve_decode"] for r in metrics.records
            if r["active_slots"] == args.slots]
    return dict(args=args, device=device, arch=arch, model=model,
                layout=layout, residency=residency, reqs=reqs, batcher=cb,
                launches=launches, counters=c, setup_s=t_setup, run_s=t_run,
                tokens=n_tok, steps=cb.step_count,
                decode_step_ms=statistics.median(full),
                decode_steps_full=len(full),
                memory=layout.memory_report(), peak_bytes=peak)


def check_prefill(s):
    """The first request's prefill through the kernels vs the plain versions,
    and one kernel prefill traced by torch.profiler (its device time and
    largest kernels)."""
    from repro_torch.serve.resident import ResidentLayout, ResidentServeEngine
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.trainer import _device_summary, _profiler

    layout = s["layout"]
    plain = ResidentLayout(layout.specs,
                           dataclasses.replace(layout.cfg, impl="plain"),
                           layout.res_axes)
    shape = ShapeConfig("p", s["args"].prompt_len, 1, "decode")
    tokens = torch.as_tensor(s["reqs"][0].prompt[None]).long().to(s["device"])
    pre_k = ResidentServeEngine(s["model"], layout, shape).make_prefill()
    pre_p = ResidentServeEngine(s["model"], plain, shape).make_prefill()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, _ = pre_k(s["residency"], {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = _profiler(s["device"])
    with prof:
        t0 = time.perf_counter()
        pre_k(s["residency"], {"tokens": tokens})
        torch.cuda.synchronize()
    traced = _device_summary(prof, 0, time.perf_counter() - t0, top=8)
    lp, _ = pre_p(s["residency"], {"tokens": tokens})
    if lk.shape != (1, s["arch"].vocab) or lk.dtype != torch.float32:
        raise Failed(f"prefill logits {lk.shape} {lk.dtype}")
    err, scale = rel_err(lk, lp)
    if err > PREFILL_TOL * scale:
        raise Failed(f"prefill logits: err {err} > {PREFILL_TOL} * {scale}")
    return dict(prefill_ms=statistics.median(times), logits_err=err,
                logits_scale=scale, traced=traced,
                argmax_equal=bool(lk.argmax() == lp.argmax()))


def check_prefill_f32(s):
    """The first request's prefill with f32 activations, through the kernels
    and through the plain versions, on the same INT8 weights (the residency's
    dense leaves widened to f32): they must agree within PREFILL_F32_TOL *
    max|ref|. Also reports how far each bf16 prefill (kernels, plain) lies
    from the f32 plain one, which shows how much of the bf16 kernel-vs-plain
    gap is bf16 rounding shared by both."""
    from repro_torch.serve.resident import ResidentLayout, ResidentServeEngine
    from repro_torch.models.config import ShapeConfig

    layout = s["layout"]
    res32 = {k: v if isinstance(v, dict) else v.float()
             for k, v in s["residency"].items()}
    shape = ShapeConfig("p", s["args"].prompt_len, 1, "decode")
    tokens = torch.as_tensor(s["reqs"][0].prompt[None]).long().to(s["device"])
    out = {}
    for impl in (None, "plain"):
        for dt in ("float32", layout.cfg.compute_dtype):
            cfg = dataclasses.replace(layout.cfg, impl=impl, compute_dtype=dt)
            lay = ResidentLayout(layout.specs, cfg, layout.res_axes)
            pre = ResidentServeEngine(s["model"], lay, shape).make_prefill()
            logits, _ = pre(res32 if dt == "float32" else s["residency"],
                            {"tokens": tokens})
            out[impl or "kernel", dt] = logits
    ref32 = out["plain", "float32"]
    err, scale = rel_err(out["kernel", "float32"], ref32)
    if err > PREFILL_F32_TOL * scale:
        raise Failed(f"f32 prefill logits: err {err} > {PREFILL_F32_TOL} * "
                     f"{scale}")
    bf = layout.cfg.compute_dtype
    return dict(f32_logits_err=err, f32_logits_scale=scale,
                bf16_kernel_vs_f32_plain=rel_err(out["kernel", bf], ref32)[0],
                bf16_plain_vs_f32_plain=rel_err(out["plain", bf], ref32)[0])


def decode_graph_ms(s):
    """Device time of the batcher's whole paged decode step (assemble, the
    layers, LM head, writeback) with every slot active, replayed as a CUDA
    graph: the step without host launch overhead."""
    cb, dev = s["batcher"], s["device"]
    slots, plen = s["args"].slots, s["args"].prompt_len
    table = cb.paged.device_table(dev)
    tok = torch.zeros((slots,), dtype=torch.long, device=dev)
    pos = torch.arange(plen, plen + slots, dtype=torch.long, device=dev)
    active = torch.ones((slots,), dtype=torch.bool, device=dev)
    return device_ms(lambda: cb._paged_step(s["residency"], table, tok, pos,
                                            active), reps=3)


def ssm_phase(gen, dev):
    """falcon-mamba-7b served at published width and depth, its prefill
    held against the plain versions, its decode step and scan timed. Returns
    the serve record and the scan's timing; the residency is freed."""
    from repro_torch.kernels import ops

    s = serve_phase(SSM_SERVE_ARGS, SSM_SERVE_KERNELS)
    pf = check_prefill(s)
    pf.update(check_prefill_f32(s))
    s["decode_step_graph_ms"] = decode_graph_ms(s)
    plen = s["args"].prompt_len
    timing = {}
    for seq in (plen, 2048):
        args = scan_inputs(gen, dev, 1, seq, SCAN_D)
        n_bytes, n_ops = scan_work(1, seq, SCAN_D)
        timing[seq] = dict(
            work=f"one layer's prefill scan: B=1, S={seq}, D={SCAN_D}, "
                 f"N={SCAN_N}, f32",
            ms=device_ms(lambda: ops.selective_scan(*args), reps=20),
            plain_ms=device_ms(lambda: ops.selective_scan(*args, impl="plain"),
                               reps=1, replays=2),
            library_ms=None, bound=bound_ms(n_bytes, n_ops, "f32"))
        del args
    record = {k: s[k] for k in ("args", "arch", "reqs", "launches", "counters",
                                "setup_s", "run_s", "tokens", "steps",
                                "decode_step_ms", "decode_steps_full",
                                "decode_step_graph_ms", "memory",
                                "peak_bytes")}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return record, pf, timing


# ---------------------------------------------------------------------------
# phase 4: the training step
# ---------------------------------------------------------------------------

def train_phase():
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ap = train.build_parser()
    t0 = time.perf_counter()
    kern = train.run(ap.parse_args(TRAIN_ARGS + ["--profile-step",
                                                 str(PROFILE_STEP)]))
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = train.run(ap.parse_args(TRAIN_ARGS + ["--kernel-impl", "plain"]))
    t_plain = time.perf_counter() - t0
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    for r in kern:
        missing = [k for k in TRAIN_KERNELS if r["launches"][k] == 0]
        if missing:
            raise Failed(f"rank {r['rank']}: kernels not launched on the "
                         f"training path: {missing}")
    for r in plain:
        if any(r["launches"].values()):
            raise Failed(f"rank {r['rank']}: kernels launched in the plain run")
    for run in (kern, plain):
        for r in run:
            vals = r["losses"] + r["grad_norms"]
            if len(r["losses"]) != steps or \
                    not all(math.isfinite(v) for v in vals):
                raise Failed(f"rank {r['rank']}: losses {r['losses']}, grad "
                             f"norms {r['grad_norms']}")
            if (r["losses"], r["grad_norms"]) != (run[0]["losses"],
                                                  run[0]["grad_norms"]):
                raise Failed("ranks disagree on the global loss or grad norm")
    k0, p0 = kern[0], plain[0]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(k0["losses"], p0["losses"])]
    gn_rel = [abs(a - b) / abs(b)
              for a, b in zip(k0["grad_norms"], p0["grad_norms"])]
    if max(loss_rel) > TRAIN_LOSS_RTOL or max(gn_rel) > TRAIN_GNORM_RTOL:
        raise Failed(f"kernel vs plain training: loss rel {loss_rel}, grad "
                     f"norm rel {gn_rel}")
    launches = {k: sum(r["launches"][k] for r in kern) for k in ops.KERNELS}
    return dict(kernel=kern, plain=plain, steps=steps, launches=launches,
                per_rank_step_launches={k: kern[0]["launches"][k] / steps
                                        for k in ops.KERNELS},
                loss_rel=loss_rel, grad_norm_rel=gn_rel, run_s=t_kern,
                plain_run_s=t_plain)


# ---------------------------------------------------------------------------
# phase 5: timing at the serving and training shapes
# ---------------------------------------------------------------------------

def matmul_calls(s, m_layers: int, m_head: int, gen):
    """The dequant_matmul calls of one serving step on the residency's own
    weights: 24 layers x 7 projections at M=m_layers, the tied LM head at
    M=m_head. Returns [(x, q, s, (k, n), block, transpose)]."""
    from repro_torch.core.linear import _w_kn

    layout, res, dev = s["layout"], s["residency"], s["device"]
    calls = []
    for i in range(s["arch"].n_layers):
        for leaf in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            name = f"attn.{leaf}"
            k, n = _w_kn(layout.specs[name])
            x = torch.randn((m_layers, k), generator=gen, device=dev)
            calls.append((x.to(torch.bfloat16), res[name]["q"][i],
                          res[name]["s"][i], (k, n),
                          layout.leaf_cfg[name].quant_block, False))
    k, n = _w_kn(layout.specs["embed"])
    x = torch.randn((m_head, n), generator=gen, device=dev).to(torch.bfloat16)
    calls.append((x, res["embed"]["q"], res["embed"]["s"], (k, n),
                  layout.leaf_cfg["embed"].quant_block, True))
    return calls


def matmul_work(calls):
    n_bytes = n_ops = 0
    for x, _, _, (k, n), block, transpose in calls:
        m = x.shape[0]
        out = k if transpose else n
        n_bytes += k * n + 4 * k * n // block + 2 * x.numel() + 2 * m * out
        n_ops += 2 * m * k * n
    return n_bytes, n_ops


def run_matmuls(calls, impl=None):
    from repro_torch.kernels import ops

    def fn():
        for x, q, sc, kn, block, transpose in calls:
            ops.dequant_matmul(x, q, sc, kn, block, transpose=transpose,
                               dtype=torch.bfloat16, impl=impl)
    return fn


def timing_phase(s, gen):
    from repro_torch.kernels import ops
    from repro_torch.serve.resident import init_primaries

    layout, res, dev = s["layout"], s["residency"], s["device"]
    out = {}

    # quantize: the residency's largest call (the stacked w_gate leaf, bf16)
    prim = init_primaries(layout, s["args"].seed, dev)["attn.w_gate"].reshape(-1)
    block = layout.leaf_cfg["attn.w_gate"].quant_block
    n = prim.numel()
    out["quantize_int8"] = dict(
        work=f"attn.w_gate stack: {n} bf16 elements, block {block}",
        ms=device_ms(lambda: ops.quantize_int8(prim, block), reps=5),
        plain_ms=device_ms(lambda: ops.quantize_int8(prim, block, impl="plain"),
                           reps=5),
        library_ms=None,
        bound=bound_ms(2 * n + n + 4 * n / block, 4 * n, "f32"))
    del prim

    # dequantize: the prefill's embedding lookup (128 rows of 896)
    ids = torch.as_tensor(s["reqs"][0].prompt).long().to(dev)
    vocab, d = layout.specs["embed"].shape
    block = layout.leaf_cfg["embed"].quant_block
    rows = res["embed"]["q"][: vocab * d].view(vocab, d)[ids].reshape(-1)
    srows = res["embed"]["s"][: vocab * d // block].view(vocab, d // block)[ids] \
        .reshape(-1)
    n = rows.numel()
    out["dequantize_int8"] = dict(
        work=f"prefill embedding rows: {n} int8 -> bf16, block {block}",
        ms=device_ms(lambda: ops.dequantize_int8(rows, srows, block,
                                                 torch.bfloat16), reps=50),
        plain_ms=device_ms(lambda: ops.dequantize_int8(
            rows, srows, block, torch.bfloat16, impl="plain"), reps=50),
        library_ms=None,
        bound=bound_ms(n + 4 * n / block + 2 * n, n, "f32"))

    # dequant_matmul: one decode step's 169 calls (M = slots) and one
    # prefill's (M = prompt_len, LM head M = 1), on the residency's weights
    slots, plen = s["args"].slots, s["args"].prompt_len
    dec = matmul_calls(s, slots, slots, gen)
    b, o = matmul_work(dec)
    out["dequant_matmul"] = dict(
        work=f"one decode step: {len(dec)} calls at M={slots}",
        ms=device_ms(run_matmuls(dec), reps=5),
        plain_ms=device_ms(run_matmuls(dec, "plain"), reps=2, replays=2),
        library_ms=None, bound=bound_ms(b, o, "bf16"))
    pre = matmul_calls(s, plen, 1, gen)
    b, o = matmul_work(pre)
    out["dequant_matmul_prefill"] = dict(
        work=f"one prefill: {len(pre)} calls at M={plen} (head M=1)",
        ms=device_ms(run_matmuls(pre), reps=3), bound=bound_ms(b, o, "bf16"))
    shapes = []
    for label, calls in (("decode", dec), ("prefill", pre)):
        for j in range(7):
            per = calls[j:-1:7]                      # one shape, all 24 layers
            b, o = matmul_work(per)
            x, _, _, kn, _, _ = per[0]
            shapes.append(dict(step=label, M=x.shape[0], K=kn[0], N=kn[1],
                               transpose=False,
                               ms_per_call=device_ms(run_matmuls(per), reps=3)
                               / len(per),
                               bound_ms_per_call=bound_ms(b, o, "bf16")[0]
                               / len(per)))
        head = calls[-1:]
        b, o = matmul_work(head)
        shapes.append(dict(step=label, M=head[0][0].shape[0], K=head[0][3][0],
                           N=head[0][3][1], transpose=True,
                           ms_per_call=device_ms(run_matmuls(head), reps=10),
                           bound_ms_per_call=bound_ms(b, o, "bf16")[0]))
    out["dequant_matmul_shapes"] = shapes

    # the whole decode step as a CUDA graph, beside the host-clock
    # decode_step_ms
    out["decode_step_graph_ms"] = decode_graph_ms(s)

    # flash_attention: one layer's prefill attention (B=1, 14 heads over 2,
    # S=128, D=64, causal, bf16); the library yardstick is PyTorch's SDPA
    h, hkv, hd, S = 14, 2, 64, plen
    q = torch.randn((h, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((hkv, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((hkv, S, hd), generator=gen, device=dev).to(torch.bfloat16)
    q4 = q[None]
    k4 = k.repeat_interleave(h // hkv, dim=0)[None].contiguous()
    v4 = v.repeat_interleave(h // hkv, dim=0)[None].contiguous()
    pairs = h * S * (S + 1) // 2
    out["flash_attention"] = dict(
        work=f"prefill attention: {h} heads over {hkv}, S={S}, D={hd}, "
             "causal, bf16",
        ms=device_ms(lambda: ops.flash_attention(q, k, v), reps=50),
        plain_ms=device_ms(lambda: ops.flash_attention(q, k, v, impl="plain"),
                           reps=50),
        library_ms=device_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True),
                             reps=50),
        bound=bound_ms(2 * (2 * h + 2 * hkv) * S * hd, 4 * hd * pairs, "bf16"))
    return out


def train_timing(gen, dev):
    """The training kernels at the step's shapes: the tied embedding's
    stage-1 quantize and receive-side sum, one layer's seven dW products."""
    from repro_torch.kernels import ops

    out = {}
    n, block = EMBED_N, 128
    g = (torch.randn((n,), generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    out["quantize_int4"] = dict(
        work=f"embed grad stage 1: {n} bf16 elements, block {block}",
        ms=device_ms(lambda: ops.quantize_int4(g, block), reps=5),
        plain_ms=device_ms(lambda: ops.quantize_int4(g, block, impl="plain"),
                           reps=2),
        library_ms=None,
        bound=bound_ms(2 * n + n / 2 + 4 * n / block, 4 * n, "f32"))
    # W = 2: each rank receives d = 2 chunks of n / 2 elements and sums them
    q, s = ops.quantize_int4(g, block)
    del g
    half = n // 2
    out["dequantize_int4_sum"] = dict(
        work=f"embed grad stage 1 receive: d=2 chunks of {half} elements",
        ms=device_ms(lambda: ops.dequantize_int4_sum(q, s, 2, block), reps=5),
        plain_ms=device_ms(lambda: ops.dequantize_int4_sum(
            q, s, 2, block, impl="plain"), reps=2),
        library_ms=None,
        bound=bound_ms(n / 2 + 4 * n / block + 4 * half, 2 * n, "f32"))
    del q, s

    calls = [(torch.randn((TRAIN_M, k), generator=gen, device=dev),
              torch.randn((TRAIN_M, nn), generator=gen, device=dev) * 1e-2)
             for k, nn in LAYER_KN]

    def run(impl=None):
        def fn():
            for x, gg in calls:
                ops.matmul_quant(x, gg, block, bits=4, impl=impl)
        return fn

    def cublas():
        for x, gg in calls:
            x.T @ gg

    n_bytes = sum(4 * TRAIN_M * (k + nn) + k * nn / 2 + 4 * k * nn / block
                  for k, nn in LAYER_KN)
    n_ops = sum(2 * TRAIN_M * k * nn for k, nn in LAYER_KN)
    per = []
    for j in (0, 1, 4, 6):           # the four distinct shapes
        (k, nn), (x, gg) = LAYER_KN[j], calls[j]
        per.append(dict(M=TRAIN_M, K=k, N=nn, ms=device_ms(
            lambda: ops.matmul_quant(x, gg, block, bits=4), reps=5),
            cublas_ms=device_ms(lambda: x.T @ gg, reps=5),
            bound_ms=bound_ms(4 * TRAIN_M * (k + nn) + k * nn / 2
                              + 4 * k * nn / block, 2 * TRAIN_M * k * nn,
                              "f32")[0]))
    out["matmul_quant"] = dict(
        work=f"one layer's 7 dW products at M={TRAIN_M}, bits 4, block {block}",
        ms=device_ms(run(), reps=3), plain_ms=device_ms(run("plain"), reps=3),
        library_ms=device_ms(cublas, reps=3),
        library="x.T @ g (cuBLAS f32, no quantize epilogue)",
        bound=bound_ms(n_bytes, n_ops, "f32"), per_shape=per)
    return out


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write the full report (per-shape timings, "
                         "ptxas output) to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda as kcuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = nvidia_smi()

    print("phase build", flush=True)
    t0 = time.perf_counter()
    kcuda.build_all()
    print(f"  built {kcuda.BUILD_LOG['built']} in {time.perf_counter() - t0:.1f} s"
          f" -> {kcuda.BUILD_LOG['dir']}")
    for stem, log in kcuda.BUILD_LOG["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or re.search(r"[1-9]\d* bytes spill", line):
                print(f"  ptxas {stem}: {line.strip()}")

    print("phase kernels", flush=True)
    checks: dict[str, list] = {}
    check_kernels(dev, gen, checks)

    print("phase serve", flush=True)
    s = serve_phase(SERVE_ARGS, SERVE_KERNELS)
    pf = check_prefill(s)
    print(f"  launches {s['launches']}; counters {s['counters']}; prefill "
          f"logits max_abs_err {pf['logits_err']:.3e} (max|ref| "
          f"{pf['logits_scale']:.3e}, argmax equal {pf['argmax_equal']})")

    print("phase ssm", flush=True)
    m, mpf, scan_t = ssm_phase(gen, dev)
    print(f"  launches {m['launches']}; counters {m['counters']}; prefill "
          f"logits max_abs_err {mpf['logits_err']:.3e} (max|ref| "
          f"{mpf['logits_scale']:.3e}, argmax equal {mpf['argmax_equal']})")
    print(f"  f32 prefill logits max_abs_err {mpf['f32_logits_err']:.3e} (max|ref| "
          f"{mpf['f32_logits_scale']:.3e}, tol {PREFILL_F32_TOL}); bf16 vs f32 "
          f"plain: kernels {mpf['bf16_kernel_vs_f32_plain']:.3e}, plain "
          f"{mpf['bf16_plain_vs_f32_plain']:.3e}")
    print(f"  prefill_ms {mpf['prefill_ms']:.3f} decode_step_ms "
          f"{m['decode_step_ms']:.3f} decode_step_graph_ms "
          f"{m['decode_step_graph_ms']:.3f} tok_s {m['tokens'] / m['run_s']:.3f} "
          f"setup_s {m['setup_s']:.1f} max_memory_allocated {m['peak_bytes']} "
          f"residency_bytes {m['memory']['wire_bytes']}")
    for seq, tm in scan_t.items():
        print(f"  selective_scan S={seq}: {tm['ms']:.4f} ms, plain "
              f"{tm['plain_ms']:.4f} ms, bound {tm['bound'][0]:.4f} ms "
              f"({tm['bound'][1]})")

    print("phase train", flush=True)
    tr = train_phase()
    for label, run in (("kernels", tr["kernel"]), ("plain", tr["plain"])):
        for r in run:
            print(f"  {label} rank {r['rank']}: loss {r['losses']} grad_norm "
                  f"{r['grad_norms']} step_s {r['step_times']} tok/s "
                  f"{r['tokens_per_s']} peak_bytes {r['peak_bytes']} "
                  f"launches {r['launches']} payload_bytes {r['payload_bytes']}")
    print(f"  kernel vs plain: loss rel {tr['loss_rel']}, grad norm rel "
          f"{tr['grad_norm_rel']}")

    print("phase timing", flush=True)
    t = timing_phase(s, gen)
    t.update(train_timing(gen, dev))
    plen = m["args"].prompt_len
    t["selective_scan"] = scan_t[plen]

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        tm = t[name]
        bms, by = tm["bound"]
        by_path = dict(serve=s["launches"][name],
                       serve_ssm=m["launches"][name],
                       train=tr["launches"][name])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            launches_per_train_step_per_rank=tr["per_rank_step_launches"][name],
            max_abs_err=max(c["max_abs_err"] for c in checks[name]),
            tolerance=[c["tolerance"] for c in checks[name]],
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=bms, bound_by=by,
            library_ms=tm["library_ms"], work=tm["work"]))
    serve_line = dict(
        arch=s["arch"].name, requests=len(s["reqs"]), slots=s["args"].slots,
        prompt_len=s["args"].prompt_len, gen=s["args"].gen,
        max_len=s["args"].max_len, tokens=s["tokens"], steps=s["steps"],
        prefill_ms=pf["prefill_ms"], decode_step_ms=s["decode_step_ms"],
        decode_step_graph_ms=t["decode_step_graph_ms"],
        tok_s=s["tokens"] / s["run_s"], run_s=s["run_s"],
        setup_s=s["setup_s"], residency_bytes=s["memory"]["wire_bytes"],
        prefill_logits_max_abs_err=pf["logits_err"],
        prefill_logits_max_abs_ref=pf["logits_scale"],
        traced_prefill_wall_ms=pf["traced"]["wall_ms"],
        traced_prefill_device_ms=pf["traced"]["device_ms"],
        traced_prefill_top_kernels=pf["traced"]["top"])
    ssm_line = dict(
        arch=m["arch"].name, requests=len(m["reqs"]), slots=m["args"].slots,
        prompt_len=plen, gen=m["args"].gen, max_len=m["args"].max_len,
        tokens=m["tokens"], steps=m["steps"], prefill_ms=mpf["prefill_ms"],
        decode_step_ms=m["decode_step_ms"],
        decode_step_graph_ms=m["decode_step_graph_ms"],
        tok_s=m["tokens"] / m["run_s"], run_s=m["run_s"], setup_s=m["setup_s"],
        residency_bytes=m["memory"]["wire_bytes"],
        dense_bytes=m["memory"]["dense_bytes"],
        max_memory_allocated=m["peak_bytes"],
        prefill_logits_max_abs_err=mpf["logits_err"],
        prefill_logits_max_abs_ref=mpf["logits_scale"],
        prefill_argmax_equal=mpf["argmax_equal"],
        prefill_f32_logits_max_abs_err=mpf["f32_logits_err"],
        prefill_f32_logits_max_abs_ref=mpf["f32_logits_scale"],
        prefill_bf16_kernel_vs_f32_plain=mpf["bf16_kernel_vs_f32_plain"],
        prefill_bf16_plain_vs_f32_plain=mpf["bf16_plain_vs_f32_plain"],
        traced_prefill_wall_ms=mpf["traced"]["wall_ms"],
        traced_prefill_device_ms=mpf["traced"]["device_ms"],
        traced_prefill_top_kernels=mpf["traced"]["top"],
        scan={str(seq): dict(ms=tm["ms"], plain_ms=tm["plain_ms"],
                             bound_ms=tm["bound"][0], bound_by=tm["bound"][1])
              for seq, tm in scan_t.items()})
    k0 = tr["kernel"][0]
    # the first step pays for the kernels' first use, the last is traced
    timed = slice(1, PROFILE_STEP)
    train_line = dict(
        arch="qwen2-0.5b", scheme="zero_topo", mesh=[1, 2, 2], ranks=4,
        global_batch=8, seq=1024, steps=tr["steps"], losses=k0["losses"],
        grad_norms=k0["grad_norms"], plain_losses=tr["plain"][0]["losses"],
        plain_grad_norms=tr["plain"][0]["grad_norms"],
        step_s=k0["step_times"],
        step_s_median=statistics.median(k0["step_times"][timed]),
        tok_s_median=statistics.median(k0["tokens_per_s"][timed]),
        plain_step_s=tr["plain"][0]["step_times"],
        peak_bytes_per_rank=[r["peak_bytes"] for r in tr["kernel"]],
        payload_bytes_per_step_per_rank={
            op: b / tr["steps"] for op, b in k0["payload_bytes"].items()},
        phase_s_per_step=[{k: v / tr["steps"] for k, v in r["phase_s"].items()}
                          for r in tr["kernel"]],
        collective_s_per_step=[{k: v / tr["steps"]
                                for k, v in r["collective_s"].items()}
                               for r in tr["kernel"]],
        traced_step_wall_ms=[r["profile"]["wall_ms"] for r in tr["kernel"]],
        traced_step_device_ms=[r["profile"]["device_ms"] for r in tr["kernel"]],
        traced_step_top_kernels_rank0=k0["profile"]["top"],
        state_bytes_per_rank=k0["memory"], run_s=tr["run_s"],
        plain_run_s=tr["plain_run_s"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, kernels=kernels, serve=serve_line, serve_ssm=ssm_line,
            train=train_line,
            train_ranks=tr["kernel"], train_plain_ranks=tr["plain"],
            checks=checks, timing={k: v for k, v in t.items()},
            launches=s["launches"], launches_ssm=m["launches"],
            build=kcuda.BUILD_LOG,
            torch=torch.__version__, cuda=torch.version.cuda),
            indent=1, default=str))

    print("serve " + json.dumps(serve_line))
    print("serve_ssm " + json.dumps(ssm_line))
    print("train " + json.dumps(train_line))
    print(json.dumps({"kernels": kernels}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
