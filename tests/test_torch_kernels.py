"""The port's kernel entry points (repro_torch.kernels.ops) against the JAX
package's, on the same numpy-seeded inputs.

On the CPU the port runs each kernel's plain PyTorch version; the JAX side
runs as its own tests run it: the jitted jnp oracle, and the Pallas kernel
in interpret mode. Wire payloads (INT8 q and f32 scales) must match bit for
bit; float outputs match within a tolerance stated per test.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul_pallas
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.models import layers

IMPLS = ("jnp", "pallas_interpret")


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _blocks_input(rng, nb, block, dtype):
    """Unit normals scaled per block by up to 50x, one all-zero block."""
    x = rng.standard_normal((nb, block)).astype(np.float32)
    x *= rng.uniform(0.01, 50.0, (nb, 1)).astype(np.float32)
    x[nb // 2] = 0.0
    return np.asarray(jnp.asarray(x.reshape(-1), dtype))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_int8_bitwise(impl, dtype):
    rng = np.random.default_rng(0)
    block = 128
    x = _blocks_input(rng, 24, block, dtype)
    qj, sj = jax.jit(lambda v: jops.quantize_int8(v, block, impl=impl))(x)
    qt, st = ops.quantize_int8(_torch(x), block)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dequantize_int8_bitwise(impl, dtype):
    rng = np.random.default_rng(1)
    block = 64
    x = _blocks_input(rng, 16, block, jnp.float32)
    q, s = jax.jit(lambda v: jops.quantize_int8(v, block, impl="jnp"))(x)
    q, s = np.asarray(q), np.asarray(s)
    dj = jax.jit(lambda a, b: jops.dequantize_int8(a, b, block, dtype,
                                                   impl=impl))(q, s)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    dt = ops.dequantize_int8(_torch(q), _torch(s), block, tdtype)
    assert dt.dtype == tdtype
    np.testing.assert_array_equal(dt.view(torch.int16 if tdtype == torch.bfloat16
                                          else torch.int32).numpy(),
                                  np.asarray(dj).view(np.int16 if tdtype ==
                                                      torch.bfloat16 else np.int32))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("transpose", [False, True])
def test_dequant_matmul_flat(impl, transpose):
    """f32 at rtol=atol=1e-5: the reference accumulates in contraction
    blocks (ops._loop_split), the port's plain version in one f32 matmul,
    so the sums are taken in another order."""
    rng = np.random.default_rng(2)
    k, n, block, m = 96, 192, 64, 5
    pad = k * n + 3 * block          # flat buffers are padded past K*N
    w = rng.standard_normal(pad).astype(np.float32) * 0.1
    q, s = jax.jit(lambda v: jops.quantize_int8(v, block, impl="jnp"))(w)
    q, s = np.asarray(q), np.asarray(s)
    x = rng.standard_normal((m, k if not transpose else n)).astype(np.float32)
    yj = jax.jit(lambda a, b, c: jops.dequant_matmul(
        a, b, c, (k, n), block, transpose=transpose, dtype=jnp.float32,
        impl=impl))(x, q, s)
    yt = ops.dequant_matmul(_torch(x), _torch(q), _torch(s), (k, n), block,
                            transpose=transpose, dtype=torch.float32)
    assert yt.shape == (m, k if transpose else n)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (32, 32, 0, 0),      # causal prefill
    (16, 32, 16, 0),     # causal with a query offset (second half of a prompt)
    (32, 32, 0, 8),      # sliding window
])
def test_flash_attention_gqa(impl, sq, sk, q_offset, window):
    """Causal attention with the GQA fold (4 query heads over 2 KV heads)
    at atol=1e-5 in f32: the same math, but the reference's oracle and the
    port's plain version round their dots and exps in different orders."""
    rng = np.random.default_rng(3)
    b, h, hkv, d = 2, 4, 2, 64
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)

    def ref(q, k, v):
        kf = jlayers._repeat_kv(k, h // hkv)
        vf = jlayers._repeat_kv(v, h // hkv)
        qt = q.transpose(0, 2, 1, 3).reshape(b * h, sq, d)
        kt = kf.transpose(0, 2, 1, 3).reshape(b * h, sk, d)
        vt = vf.transpose(0, 2, 1, 3).reshape(b * h, sk, d)
        o = jops.flash_attention(qt, kt, vt, causal=True, window=window,
                                 q_offset=q_offset, impl=impl)
        return o.reshape(b, h, sq, d).transpose(0, 2, 1, 3)

    oj = jax.jit(ref)(q, k, v)
    ot = layers.flash_attention(_torch(q), _torch(k), _torch(v), causal=True,
                                window=window, q_offset=q_offset)
    assert ot.shape == (b, sq, h, d)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-5)


def test_flash_attention_gate_raises(monkeypatch):
    """A shape the reference's gate rejects never reaches the kernel
    dispatch: it is recorded under the reference's key and reason and runs
    the chunked plain path, within 1e-5 of the reference's."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 100, 2, 64)).astype(np.float32)
    k = rng.standard_normal((1, 300, 2, 64)).astype(np.float32)

    def no_kernel(*a, **kw):
        raise AssertionError("ops.flash_attention called for a rejected shape")

    monkeypatch.setattr(ops, "flash_attention", no_kernel)
    jops.reset_dispatch_counters()
    ops.reset_dispatch_counters()
    with pytest.warns(UserWarning, match="seq_unaligned"):
        ot = layers.flash_attention(_torch(q), _torch(k), _torch(k))
    oj = jlayers.flash_attention(q, k, k)
    want = {"attention/fallback/seq_unaligned": 1}
    assert ops.dispatch_counters() == want
    assert {n: c for n, c in jops.dispatch_counters().items()
            if "/fallback/" in n} == want
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sq,sk,h,hkv,q_offset,window,q_chunk,kv_chunk", [
    (4, 4, 4, 2, 0, 0, 512, 1024),       # a 4-token prompt: one chunk
    (200, 200, 4, 2, 0, 0, 64, 64),      # 200 = 4 x 50 chunks each way
    (12, 200, 2, 2, 188, 0, 512, 64),    # the last 12 queries of 200
    (200, 200, 2, 1, 0, 48, 40, 100),    # a window over chunks
], ids=["prompt4", "chunked200", "q_offset", "window"])
def test_chunked_attention_matches_reference(sq, sk, h, hkv, q_offset, window,
                                             q_chunk, kv_chunk):
    """The chunked fallback against the reference's, forward and the
    gradients of q, k, v through its per-chunk recompute, in f32 within
    1e-5 of max|ref| (the same math, dots and exps rounded in another
    order)."""
    rng = np.random.default_rng(sq + sk + window)
    b, d = 2, 32
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    assert not ops.attention_fusable(sq, sk, d, d)[0]

    def jf(a, b_, c):
        return jnp.sum(jlayers.flash_attention(a, b_, c, **kw) * g)

    oj = np.asarray(jlayers.flash_attention(q, k, v, **kw))
    gj = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    args = [_torch(a).requires_grad_() for a in (q, k, v)]
    ot = layers.flash_attention(*args, **kw)
    (ot * _torch(g)).sum().backward()
    assert ot.shape == oj.shape
    np.testing.assert_allclose(ot.detach().numpy(), oj, rtol=0,
                               atol=1e-5 * float(np.abs(oj).max()))
    for t, want in zip(args, gj):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("block", [128, 8, 16, 64, 256, 2048])
def test_quantize_int4_bitwise(impl, dtype, block):
    """Packed nibbles and scales bit for bit against the jitted reference,
    at the block sizes of both of the kernel's variants (a lane group of 1
    ... 32 lanes, 1 ... 8 units of 8 elements a lane)."""
    rng = np.random.default_rng(4)
    x = _blocks_input(rng, 24, block, dtype)
    qj, sj = jax.jit(lambda v: jops.quantize_int4(v, block, impl=impl))(x)
    qt, st = ops.quantize_int4(_torch(x), block)
    assert qt.dtype == torch.uint8 and qt.shape == (x.size // 2,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("d", [2, 4])
def test_dequantize_int4_sum(impl, d):
    """Sum of d received chunks within one f32 ulp of the largest |value|:
    under jit XLA may contract q * s + acc into an FMA, which the port's
    plain version (and its kernel) never does (ROADMAP caveat b)."""
    rng = np.random.default_rng(5)
    block, nb = 64, 12
    chunks = [_blocks_input(rng, nb, block, jnp.float32) for _ in range(d)]
    q, s = jax.jit(lambda v: jops.quantize_int4(v, block, impl="jnp"))(
        np.concatenate(chunks))
    q, s = np.asarray(q), np.asarray(s)
    rj = np.asarray(jax.jit(lambda a, b: jops.dequantize_int4_sum(
        a, b, d, block, jnp.float32, impl=impl))(q, s))
    rt = ops.dequantize_int4_sum(_torch(q), _torch(s), d, block).numpy()
    assert rt.shape == (nb * block,) and rt.dtype == np.float32
    ulp = np.spacing(np.float32(np.abs(rj).max()))
    np.testing.assert_allclose(rt, rj, rtol=0, atol=ulp)


def _hold_matmul_quant(qt, st, qj, sj, x, g, block, bits):
    """The port's (q, scales) against the reference's, for C = x.T @ g
    (numpy f32): scales within 1e-5 relative; q within +-1 in at most 1e-3
    of the entries (a C value on a rounding boundary, summed in another
    order); the dequantized C within one quant step of the f32 product.
    Returns the port's levels."""
    assert qt.dtype == qj.dtype and qt.shape == qj.shape and st.shape == sj.shape
    np.testing.assert_allclose(st, sj, rtol=1e-5)

    def levels(q):
        if bits == 8:
            return q.astype(np.int32)
        lo = (q & 0xF).astype(np.int32) - 8
        hi = (q >> 4).astype(np.int32) - 8
        return np.stack([lo, hi], axis=-1).reshape(-1)

    lt, lj = levels(qt), levels(qj)
    assert np.abs(lt - lj).max() <= 1
    assert np.count_nonzero(lt != lj) <= 1e-3 * lt.size
    step = np.repeat(st, block)
    c = (x.T @ g).reshape(-1)
    deq = lt * step
    assert np.all(np.abs(deq[:c.size] - c) <= step[:c.size])
    return lt


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("pad", [0, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_quant(impl, bits, pad, dtype):
    """C = x.T @ g quantized in the epilogue. The reference sums M in
    blocked steps, the port in one f32 matmul, so C differs in its last
    bits (``_hold_matmul_quant``). The pad_to tail is exact. bf16 operands
    go to the port as bf16 (the training step's fused dW) and to the
    reference widened to f32: the products of bf16 values are exact in f32,
    so both compute the same C up to the order of the sums."""
    rng = np.random.default_rng(6)
    m, k, n, block = 48, 40, 192, 64
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), dtype))
    g = np.asarray(jnp.asarray(rng.standard_normal((m, n)), dtype))
    pad_to = k * n + pad if pad else None
    x32, g32 = x.astype(np.float32), g.astype(np.float32)
    qj, sj = jax.jit(lambda a, b: jops.matmul_quant(
        a, b, block, bits=bits, pad_to=pad_to, impl=impl))(x32, g32)
    qt, st = ops.matmul_quant(_torch(x), _torch(g), block, bits=bits,
                              pad_to=pad_to)
    lt = _hold_matmul_quant(qt.numpy(), st.numpy(), np.asarray(qj),
                            np.asarray(sj), x32, g32, block, bits)
    if pad:
        np.testing.assert_array_equal(lt[k * n:], 0)
        np.testing.assert_array_equal(st.numpy()[k * n // block:], 1.0)


def test_attention_grads():
    """The attention Function's gradients against ``jax.vjp`` of the
    reference's oracle (f32, GQA 4 over 2, causal), atol 1e-5: the same
    math summed in another order."""
    rng = np.random.default_rng(7)
    b, h, hkv, s, d = 2, 4, 2, 32, 64
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    ct = rng.standard_normal((b, s, h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jlayers.flash_attention(q, k, v,
                                                             causal=True),
                     q, k, v)
    gj = vjp(ct)
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    out = layers.flash_attention(tq, tk, tv, causal=True)
    out.backward(_torch(ct))
    for gt, gjx in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gjx), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("impl", ("eager",) + IMPLS)
@pytest.mark.parametrize("nb", [1, 3, 12, 20])
@pytest.mark.parametrize("d", [2, 8])
def test_dequantize_int8_sum(impl, nb, d):
    """The INT8 sum of d received chunks: bit for bit the reference's oracle
    run eagerly (the same multiply, then add, in chunk order); within one
    f32 ulp of the largest |value| of the jitted oracle and the interpret
    kernel, which XLA may contract into FMAs (ROADMAP caveat b; at nb = 1
    those two differ from each other by 1.19e-7). The block counts are the
    reference's own cases (tests/test_kernels.py)."""
    rng = np.random.default_rng(8)
    block = 128
    x = _blocks_input(rng, d * nb, block, jnp.float32)
    q, s = jax.jit(lambda v: jops.quantize_int8(v, block, impl="jnp"))(x)
    q, s = np.asarray(q), np.asarray(s)
    rt = ops.dequantize_int8_sum(_torch(q), _torch(s), d, block).numpy()
    assert rt.shape == (nb * block,) and rt.dtype == np.float32
    if impl == "eager":
        rj = np.asarray(jref.dequantize_int8_sum_ref(
            jnp.asarray(q).reshape(d, nb, block),
            jnp.asarray(s).reshape(d, nb, 1))).reshape(-1)
        np.testing.assert_array_equal(rt.view(np.uint32), rj.view(np.uint32))
        return
    rj = np.asarray(jax.jit(lambda a, b: jops.dequantize_int8_sum(
        a, b, d, block, jnp.float32, impl=impl))(q, s))
    ulp = np.spacing(np.float32(np.abs(rj).max()))
    np.testing.assert_allclose(rt, rj, rtol=0, atol=ulp)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("block", [64, 16384])
@pytest.mark.parametrize("nb", [1, 3, 12, 20])
def test_dequantize_int4_bitwise(impl, dtype, block, nb):
    """INT4 unpack + dequant bit for bit against the jitted oracle and the
    interpret kernel, to f32 and bf16, at the smallest and largest blocks
    of the reference's quant_error sweep."""
    rng = np.random.default_rng(9)
    x = _blocks_input(rng, nb, block, jnp.float32)
    q, s = jax.jit(lambda v: jops.quantize_int4(v, block, impl="jnp"))(x)
    q, s = np.asarray(q), np.asarray(s)
    dj = np.asarray(jax.jit(lambda a, b: jops.dequantize_int4(
        a, b, block, dtype, impl=impl))(q, s))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    dt = ops.dequantize_int4(_torch(q), _torch(s), block, tdtype)
    assert dt.dtype == tdtype and dt.shape == (nb * block,)
    bits = (torch.int32, np.int32) if tdtype == torch.float32 \
        else (torch.int16, np.int16)
    np.testing.assert_array_equal(dt.view(bits[0]).numpy(), dj.view(bits[1]))


# the reference test's three shapes (tests/test_kernels.py), K = 3 bk, and
# bk = 64, where a mixed-up scale layout cannot pass
BLOCKED_CASES = [((128, 128, 128), 128), ((256, 128, 256), 128),
                 ((128, 256, 384), 128), ((128, 384, 128), 128),
                 ((64, 256, 128), 64)]


def _blocked_inputs(m, k, n, bk):
    """x (m, k) f32 and a (k, n) weight quantized down K in runs of bk rows
    (q int8, scales (k // bk, n) f32), and the interpret kernel's x @
    dequant(q), as the reference test makes them."""
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((m, k)) * 3.0).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 3.0).astype(np.float32)
    wb = w.reshape(k // bk, bk, n)
    absmax = np.abs(wb).max(axis=1)
    scales = np.where(absmax == 0, 1.0, absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(wb / scales[:, None, :]), -127, 127).astype(np.int8)
    q = q.reshape(k, n)
    yj = np.asarray(dequant_matmul_pallas(x, q, scales, bm=min(m, 128), bn=128,
                                          bk=bk, interpret=True))
    return x, q, scales, yj


@pytest.mark.parametrize("mkn,bk", BLOCKED_CASES)
def test_dequant_matmul_blocked(mkn, bk):
    """x @ dequant(q) with 2-D blocked scales (one per column for each run
    of bk rows) against the interpret kernel, with the reference test's
    tolerance (rtol 2e-5, atol 5e-4: the sums run in another order)."""
    m, k, n = mkn
    x, q, scales, yj = _blocked_inputs(m, k, n, bk)
    yt = ops.dequant_matmul_blocked(_torch(x), _torch(q), _torch(scales))
    assert yt.shape == (m, n) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=2e-5, atol=5e-4)


def test_new_kernels_do_not_fall_back():
    """A tensor on neither the CPU, a card nor ``meta`` raises; nothing runs
    the plain version in place of a kernel. On meta (the dry run's device,
    launch/dryrun.py) each wrapper takes the card's route: it counts the
    launch the card would make in ``WOULD_LAUNCH``, never in ``LAUNCHES``,
    and computes only shapes."""
    q = torch.zeros(256, dtype=torch.int8, device="meta")
    s = torch.ones(4, device="meta")
    launched, would = ops.launches(), dict(ops.WOULD_LAUNCH)
    ops.dequantize_int8_sum(q, s, 2, 64)
    ops.dequantize_int4(q.view(torch.uint8), s, 128)
    ops.dequant_matmul_blocked(torch.zeros((2, 64), device="meta"),
                               q.reshape(64, 4), s.reshape(1, 4))
    assert ops.launches() == launched
    for name in ("dequantize_int8_sum", "dequantize_int4",
                 "dequant_matmul_blocked"):
        assert ops.WOULD_LAUNCH[name] == would[name] + 1

    class Elsewhere:        # a tensor's device as the dispatch reads it
        device = torch.device("xpu")
        is_cuda = is_meta = False

    for name in ("dequantize_int8_sum", "dequantize_int4",
                 "dequant_matmul_blocked"):
        with pytest.raises(ValueError, match="no kernel for device"):
            ops._kernel(Elsewhere(), None, name)


# The tensor-core paths' arithmetic, replayed in plain torch on the CPU (the
# CUDA kernels run only on the card) and held against the reference's oracle
# and its Pallas kernel in interpret mode on the same bf16 inputs.

def _tc_dequant_matmul(x, q, s, block, transpose):
    """What csrc/dequant_matmul.cu's tensor-core path computes, in f32 before
    its final bf16 cast. Transposed: per quant block, the exact products of
    bf16 x and the raw int8 q summed in f32, then scaled by that block's
    scale and added in block order. Forward: w = q * s in f32, split into
    hi = bf16(w) and lo = bf16(w - hi), x @ hi + x @ lo."""
    xf, qf = x.float(), q.float()
    k, n = q.shape
    if transpose:
        acc = torch.zeros((x.shape[0], k))
        for b in range(n // block):
            cols = slice(b * block, (b + 1) * block)
            acc = acc + (xf[:, cols] @ qf[:, cols].T) * s[:, b]
        return acc
    w = qf * s.repeat_interleave(block, dim=1)
    hi = w.to(torch.bfloat16).float()
    lo = (w - hi).to(torch.bfloat16).float()
    return xf @ hi + xf @ lo


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("m,k,n,block", [
    (16, 96, 192, 64),      # the threshold M
    (33, 72, 256, 64),      # ragged against a 128 x 128 tile
    (20, 256, 256, 128),    # qwen2's block
])
def test_dequant_matmul_tensor_core_rounding(impl, transpose, m, k, n, block):
    """Against the oracle in f32 on bf16 x. Transposed: the products are
    exact, so only the order of the f32 sums differs (1e-5 of max|ref|).
    Forward: |w - hi - lo| <= 2^-16 |w|, so each output is within
    2^-16 * (|x| @ |w|) of the f32 product, plus the same f32 order term;
    one bf16 rounding of w would allow 2^-8 * (|x| @ |w|), 256 times more."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal(k * n + 2 * block).astype(np.float32) * 0.1
    q, s = jax.jit(lambda v: jops.quantize_int8(v, block, impl="jnp"))(w)
    q, s = np.asarray(q), np.asarray(s)
    x = np.asarray(jnp.asarray(
        rng.standard_normal((m, n if transpose else k)), jnp.bfloat16))
    yj = np.asarray(jax.jit(lambda a, b, c: jops.dequant_matmul(
        a, b, c, (k, n), block, transpose=transpose, dtype=jnp.float32,
        impl=impl))(x, q, s))
    q2 = _torch(q)[: k * n].view(k, n)
    s2 = _torch(s)[: k * n // block].view(k, n // block)
    yt = _tc_dequant_matmul(_torch(x), q2, s2, block, transpose)
    assert yt.shape == yj.shape == (m, k if transpose else n)
    order = 1e-5 * float(np.abs(yj).max())
    if transpose:
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=order)
    else:
        w_abs = (q2.float() * s2.repeat_interleave(block, 1)).abs()
        bound = 2.0 ** -16 * (_torch(x).float().abs() @ w_abs) + order
        assert bool(((yt - _torch(yj)).abs() <= bound).all())


def _tc_matmul_quant(x, g, block, bits):
    """What csrc/matmul_quant.cu's tensor-core path computes: for each stage
    of 64 rows of M, the exact products of the bf16 operands summed in f32,
    each stage's sum added to an f32 accumulator in stage order; then the
    epilogue's block quantize (scale = absmax * (1/qmax), 1 for a zero
    block; q = clamp(rint(c / scale))). x (M, K), g (M, N) bf16 -> (q (K, N)
    int8 | (K, N // 2) uint8 packed, scales (K, N // block) f32)."""
    xf, gf = x.float(), g.float()
    k, n = x.shape[1], g.shape[1]
    acc = torch.zeros((k, n))
    for m0 in range(0, x.shape[0], 64):
        acc = acc + xf[m0:m0 + 64].T @ gf[m0:m0 + 64]
    qmax = 7.0 if bits == 4 else 127.0
    c = acc.reshape(k, n // block, block)
    absmax = c.abs().amax(-1, keepdim=True)
    scales = torch.where(absmax == 0, 1.0, absmax * (1.0 / qmax))
    qv = torch.clamp(torch.round(c / scales), -qmax, qmax).reshape(k, n)
    if bits == 4:
        u = (qv + 8).to(torch.uint8).reshape(k, n // 2, 2)
        q = u[..., 0] | (u[..., 1] << 4)
    else:
        q = qv.to(torch.int8)
    return q, scales.reshape(k, n // block)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_matmul_quant_tensor_core_rounding(impl, block, bits):
    """The tensor-core path's arithmetic against the reference on bf16
    operands widened to f32, at a shape ragged against its 128 x 128 tile
    and its 64-row stages (M = 130, K = 72, N = 256): the products are
    exact, so only the order of the f32 sums differs, and the tolerances
    are test_matmul_quant's."""
    rng = np.random.default_rng(13)
    m, k, n = 130, 72, 256
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16))
    g = np.asarray(jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16))
    x32, g32 = x.astype(np.float32), g.astype(np.float32)
    qj, sj = jax.jit(lambda a, b: jops.matmul_quant(
        a, b, block, bits=bits, impl=impl))(x32, g32)
    qt, st = _tc_matmul_quant(_torch(x), _torch(g), block, bits)
    _hold_matmul_quant(qt.numpy().reshape(-1), st.numpy().reshape(-1),
                       np.asarray(qj), np.asarray(sj), x32, g32, block, bits)


def _tc_attention(q, k, v, causal, window, q_offset):
    """csrc/flash_attention.cu's bf16 kernel in plain torch: the f32 scores
    of the exact bf16 q and k times 1/sqrt(D), key tiles of 64 (32 at D =
    256) with an online softmax in f32 (masked scores NEG_INF, keys past Sk
    never reached), P rounded to bf16 for the P V product, the output acc /
    max(l, 1e-30) in f32 before its bf16 cast. q (BH, Sq, D), k, v (BH, Sk,
    D) bf16, D = 64, 96, 128 or 256."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    q_pos = q_offset + torch.arange(sq)[:, None]
    m_r = torch.full((bh, sq, 1), -1e30)
    l_r = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    tk = 32 if d > 128 else 64      # csrc/flash_attention.cu's tc_keys
    for t0 in range(0, sk, tk):
        kp = torch.arange(t0, min(sk, t0 + tk))[None, :]
        keep = torch.ones((sq, kp.shape[1]), dtype=torch.bool)
        if causal:
            keep &= q_pos >= kp
        if window:
            keep &= q_pos - kp < window
        sc = torch.where(keep, (qf @ kf[:, t0:t0 + tk].transpose(1, 2)) * scale,
                         -1e30)
        m_new = torch.maximum(m_r, sc.amax(-1, keepdim=True))
        corr = torch.exp(m_r - m_new)
        p = torch.exp(sc - m_new)
        l_r = l_r * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, t0:t0 + tk]
        m_r = m_new
    return acc / l_r.clamp_min(1e-30)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (128, 128, 0, 0),     # two key tiles, causal
    (100, 100, 0, 0),     # ragged
    (64, 128, 64, 0),     # a query offset
    (128, 128, 0, 32),    # a window
])
def test_flash_attention_tensor_core_rounding(impl, sq, sk, q_offset, window):
    """Against the oracle on bf16 inputs, compared in f32 (the oracle fed the
    same values as f32, which bf16 holds exactly). Rounding P to bf16 moves
    each weight by at most 2^-8 of itself, so each output by at most 2^-8 of
    max|v| (the weights sum to 1); the order of the f32 sums adds 1e-5, and
    the scale taken on the f32 scores instead of on f32 q a few f32 ulps."""
    _hold_tc_attention(impl, sq, sk, q_offset, window, 64)


def _hold_tc_attention(impl, sq, sk, q_offset, window, d):
    rng = np.random.default_rng(12)
    bh = 6

    def bf16(shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape),
                                      jnp.bfloat16)).astype(np.float32)

    q, k, v = bf16((bh, sq, d)), bf16((bh, sk, d)), bf16((bh, sk, d))
    oj = np.asarray(jax.jit(lambda a, b, c: jops.flash_attention(
        a, b, c, causal=True, window=window, q_offset=q_offset,
        impl=impl))(q, k, v))
    ot = _tc_attention(*(_torch(a).to(torch.bfloat16) for a in (q, k, v)),
                       True, window, q_offset)
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(v).max()) + 1e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (128, 128, 0, 0),     # NeoX's prefill square: two key tiles, causal
    (100, 100, 0, 0),     # ragged
    (64, 128, 64, 0),     # a query offset
    (128, 128, 0, 32),    # a window
])
def test_flash_attention_tensor_core_rounding_d96(impl, sq, sk, q_offset,
                                                  window):
    """The same at GPT-NeoX's head width, D = 96, where 1/sqrt(D) is no
    power of two: the kernel keeps the exact bf16 q and scales the f32
    scores, within the same tolerance of the reference's f32 fold."""
    _hold_tc_attention(impl, sq, sk, q_offset, window, 96)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (128, 128, 0, 0),     # GPT-NeoX-10B's prefill square: two key tiles
    (100, 100, 0, 0),     # ragged
    (64, 128, 64, 0),     # a query offset
    (128, 128, 0, 32),    # a window
])
def test_flash_attention_tensor_core_rounding_d128(impl, sq, sk, q_offset,
                                                   window):
    """The same at GPT-NeoX-10B's head width, D = 128 (16 k16 slices of q a
    warp, 16 n8 tiles of the accumulator): 1/sqrt(128) is no power of two
    either, and the tolerance is the D = 96 test's."""
    _hold_tc_attention(impl, sq, sk, q_offset, window, 128)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (128, 128, 0, 0),     # four key tiles of 32, causal
    (100, 100, 0, 0),     # ragged
    (64, 128, 64, 0),     # a query offset
    (128, 128, 0, 32),    # a window
])
def test_flash_attention_tensor_core_rounding_d256(impl, sq, sk, q_offset,
                                                   window):
    """The same at gemma3-1b's head width, D = 256, on the kernel's key
    tiles of 32 (Q read from shared memory for each tile gives the same
    fragments as Q kept in registers): 1/sqrt(256) is a power of two, and
    the tolerance is the D = 96 test's."""
    _hold_tc_attention(impl, sq, sk, q_offset, window, 256)


def _fma(a, b, c):
    """f32 fmaf(a, b, c): the product of two f32 is exact in f64, and the sum
    rounds once to f32 (as a fused multiply-add does, but for a rare double
    rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _tc_dequant_matmul_blocked(x, q, s, bk, terms=3):
    """What csrc/dequant_matmul_blocked.cu's tensor-core path computes: each
    f32 x split into bf16 terms h = bf16(x), m = bf16(x - h), l = bf16(x - h
    - m) (``terms`` of them); for each stage of 64 rows of K, the exact
    products of the terms and q summed in f32, folded into the f32 result
    scaled by the stage's s[kb, n] (acc = fmaf(part, s, acc)). x (M, K) f32,
    q (K, N) int8, s (K // bk, N) f32."""
    xf, qf = x.float(), q.float()
    parts, rest = [], xf
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        parts.append(t)
        rest = rest - t
    acc = torch.zeros((x.shape[0], q.shape[1]))
    for k0 in range(0, q.shape[0], 64):
        rows = slice(k0, k0 + 64)
        part = sum(t[:, rows] @ qf[rows] for t in parts)
        acc = _fma(part, s[k0 // bk][None], acc)
    return acc


@pytest.mark.parametrize("mkn,bk", BLOCKED_CASES)
def test_dequant_matmul_blocked_tensor_core_rounding(mkn, bk):
    """The tensor-core path's arithmetic against the interpret kernel:
    three bf16 terms hold every bit of x, and the products with q are exact,
    so only the order of the f32 sums differs (1e-5 of max|ref|). Two terms
    keep 16 bits of x and land measurably further off (these inputs have
    full 24-bit mantissas)."""
    m, k, n = mkn
    x, q, scales, yj = _blocked_inputs(m, k, n, bk)
    args = (_torch(x), _torch(q), _torch(scales), bk)
    scale = float(np.abs(yj).max())
    err3 = float(np.abs(_tc_dequant_matmul_blocked(*args).numpy() - yj).max())
    err2 = float(np.abs(_tc_dequant_matmul_blocked(*args, terms=2).numpy()
                        - yj).max())
    assert err3 <= 1e-5 * scale
    assert err2 > 4 * err3 and err2 > 1e-6 * scale


# The decode path's sum order (csrc/dequant_matmul.cu, x @ W.T only): one
# 16-byte chunk of a q row a lane, 32 lanes a warp, rows reduced 4 at a time.


def _decode_tree(p):
    """A warp's sums of DEC_TN_BATCH = 4 rows: p (..., 4 rows, 32 lanes) ->
    (..., 4): halving by lane bits 4 and 3 (the lane keeping a row adds its
    partner's value to its own), then an xor tree over bits 2, 1, 0; row i
    as lane 8 i holds it."""
    lanes = torch.arange(32)
    out = []
    for i in range(4):
        v = p[..., i, :]
        v = v + v[..., lanes ^ 16]           # lanes with bit 4 = i >> 1
        v = v + v[..., lanes ^ 8]            # lanes with bit 3 = i & 1
        for off in (4, 2, 1):
            v = v + v[..., lanes ^ off]
        out.append(v[..., 8 * i])
    return torch.stack(out, -1)


def _decode_dequant_matmul(x, q, s, block):
    """What csrc/dequant_matmul.cu's decode path computes for x @ W.T, in f32
    before its final cast: a lane's partial of row k is its chunk's 16
    products (fmaf in order) times the chunk's block scale; a warp reduces
    them in _decode_tree's order and a row's warps are added in warp
    order."""
    xf, qf = x.float(), q.float()
    k, n = q.shape
    nch = n // 16
    wpr = 1
    while 32 * wpr < nch:
        wpr *= 2
    lanes = 32 * wpr
    xc = torch.zeros((x.shape[0], lanes, 16))
    xc[:, :nch] = xf.reshape(x.shape[0], nch, 16)
    qc = torch.zeros((k, lanes, 16))
    qc[:, :nch] = qf.reshape(k, nch, 16)
    sc = torch.zeros((k, lanes))
    sc[:, :nch] = s.repeat_interleave(block // 16, 1)
    d = torch.zeros((x.shape[0], k, lanes))
    for e in range(16):
        d = _fma(xc[:, None, :, e], qc[None, :, :, e], d)
    p = d * sc[None]                                 # (M, K, lanes)
    kp = -(-k // 4) * 4
    p = torch.nn.functional.pad(p, (0, 0, 0, kp - k))
    p = p.reshape(x.shape[0], kp // 4, 4, wpr, 32).transpose(2, 3)
    rows = _decode_tree(p)                           # (M, K / 4, wpr, 4)
    out = rows[:, :, 0]
    for w in range(1, wpr):
        out = out + rows[:, :, w]
    return out.reshape(x.shape[0], kp)[:, :k]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("m", [1, 2, 4, 16])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("k,n", [(520, 256), (72, 1024)])
def test_dequant_matmul_decode_rounding(impl, m, block, k, n):
    """The decode path's sum order (x @ W.T) against the oracle on bf16 x,
    compared in f32: rows of one warp (N = 256) and of two (N = 1,024), at
    M = 1, 2, 4 and 16 (the kernel's row tiles of 1, 2 and 4); the products
    and sums are f32, so the order of the sums is the only difference (1e-5
    of max|ref|)."""
    rng = np.random.default_rng(14)
    w = rng.standard_normal(k * n + 2 * block).astype(np.float32) * 0.1
    q, s = jax.jit(lambda v: jops.quantize_int8(v, block, impl="jnp"))(w)
    q, s = np.asarray(q), np.asarray(s)
    x = np.asarray(jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16))
    yj = np.asarray(jax.jit(lambda a, b, c: jops.dequant_matmul(
        a, b, c, (k, n), block, transpose=True, dtype=jnp.float32,
        impl=impl))(x, q, s))
    q2 = _torch(q)[: k * n].view(k, n)
    s2 = _torch(s)[: k * n // block].view(k, n // block)
    yt = _decode_dequant_matmul(_torch(x), q2, s2, block)
    assert yt.shape == yj.shape == (m, k)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-5 * float(np.abs(yj).max()))


def _decode_wide_dequant_matmul(x, q, s, block):
    """What csrc/dequant_matmul.cu's decode path computes for bf16 x @ W.T
    past N = 4,096 (dmm_dec_tn_wide_kernel), in f32 before its final cast:
    the exact products of each quant block (bf16 x, int8 q) summed in f32
    (the mma chain; its order inside a block is the tensor core's), times
    s[k, b], added to the row's f32 sum in block order (fmaf)."""
    xf, qf = x.float(), q.float()
    acc = torch.zeros((x.shape[0], q.shape[0]))
    for b in range(q.shape[1] // block):
        c = slice(b * block, (b + 1) * block)
        acc = _fma(xf[:, c] @ qf[:, c].T, s[None, :, b], acc)
    return acc


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("k,n", [(72, 4224), (520, 6144)])
def test_dequant_matmul_decode_wide_rounding(impl, m, block, k, n):
    """The wide decode path's sum order (x @ W.T past N = 4,096) against the
    oracle on bf16 x, compared in f32: N = 4,224 (the first width past
    4,096 at block 128) and 6,144 (the gpt-neox-20b head's), K = 72 and 520
    (a last row tile of 8 rows);
    the products are exact and the sums f32, so only the order of the sums
    differs (1e-5 of max|ref|)."""
    rng = np.random.default_rng(23)
    w = rng.standard_normal(k * n + 2 * block).astype(np.float32) * 0.1
    q, s = jax.jit(lambda v: jops.quantize_int8(v, block, impl="jnp"))(w)
    q, s = np.asarray(q), np.asarray(s)
    x = np.asarray(jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16))
    yj = np.asarray(jax.jit(lambda a, b, c: jops.dequant_matmul(
        a, b, c, (k, n), block, transpose=True, dtype=jnp.float32,
        impl=impl))(x, q, s))
    q2 = _torch(q)[: k * n].view(k, n)
    s2 = _torch(s)[: k * n // block].view(k, n // block)
    yt = _decode_wide_dequant_matmul(_torch(x), q2, s2, block)
    assert yt.shape == yj.shape == (m, k)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-5 * float(np.abs(yj).max()))


# The decode path's x @ W (csrc/dequant_matmul.cu, dmm_dec_nt_kernel):
# 64-column CTAs whose 4 warps take every fourth k16 slice of the CTA's
# run of K (warp w: rows 16 w ... 16 w + 15 of every 64), a warp's chain
# folded into f32 every 4 of its slices, the K split into whole runs of 64
# rows (at least 2) over a cluster of at most 8 CTAs, enough for 264 CTAs
# and no more than one wave of the H100's 132 SMs x 4 CTAs holds.
DNT_COLS, DNT_ROWS, DNT_WARPS, DNT_FOLD, DNT_MT = 64, 64, 4, 4, 4
DNT_MAX_SPLIT, DNT_MIN_STEPS, DNT_TARGET, DNT_CAPACITY = 8, 2, 264, 132 * 4


def _dnt_chunk(m, k, n):
    """Rows of K a split takes (csrc's dnt_split)."""
    natural = -(-n // DNT_COLS) * -(-m // DNT_MT)
    steps = -(-k // DNT_ROWS)
    splits = max(1, min(-(-DNT_TARGET // natural), DNT_CAPACITY // natural,
                        DNT_MAX_SPLIT, steps // DNT_MIN_STEPS))
    return -(-steps // splits) * DNT_ROWS


def _decode_nt_dequant_matmul(x, q, s, block, terms=2):
    """What csrc/dequant_matmul.cu's decode path computes for bf16 x @ W, in
    f32 before its final cast: xs = x * s[k, n // block] in f32, split into
    ``terms`` bf16 terms (hi = bf16(xs), lo = bf16(xs - hi)); for each K
    split, each warp's rows (16 w ... 16 w + 15 of every 64) times the
    exact q, each term on its own, in chains of DNT_FOLD of its slices
    added in f32; the terms added, then the warps in warp order, then the splits in
    split order. x (M, K) bf16, q (K, N) int8, s (K, N // block) f32."""
    xf, qf = x.float(), q.float()
    m, k = x.shape
    n = q.shape[1]
    parts, rest = [], xf[:, :, None] * s[None]     # (M, K, N // block)
    for _ in range(terms):
        term = rest.to(torch.bfloat16).float()
        parts.append(term.repeat_interleave(block, dim=2))
        rest = rest - term
    chunk = _dnt_chunk(m, k, n)
    out = None
    for k0 in range(0, k, chunk):
        kend = min(k, k0 + chunk)
        cta = None
        for w in range(DNT_WARPS):
            accs = [torch.zeros((m, n)) for _ in parts]
            for f0 in range(k0, kend, DNT_ROWS * DNT_FOLD):
                r = torch.arange(f0, min(kend, f0 + DNT_ROWS * DNT_FOLD))
                r = r[(r - k0) % DNT_ROWS // 16 == w]
                for acc, part in zip(accs, parts):
                    acc += torch.einsum("mrn,rn->mn", part[:, r], qf[r])
            v = accs[0]
            for acc in accs[1:]:
                v = v + acc
            cta = v if cta is None else cta + v
        out = cta if out is None else out + cta
    return out


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("k,n", [(520, 256), (2600, 128)])
def test_dequant_matmul_decode_nt_rounding(impl, m, block, k, n):
    """The decode path's x @ W against the oracle on bf16 x, compared in
    f32, at M = 1 ... 4: K = 520 ends in a ragged slice (3 splits of 192
    rows), K = 2,600 gives 7 splits of 384 rows (a fold inside a split).
    Two bf16 terms keep 16 bits of each x * s, so each output is within
    2^-16 * (|x| @ |w|) of the f32 product, plus 1e-5 of max|ref| for the
    order of the f32 sums; one bf16 term lands measurably further off."""
    rng = np.random.default_rng(19)
    w = rng.standard_normal(k * n + 2 * block).astype(np.float32) * 0.1
    q, s = jax.jit(lambda v: jops.quantize_int8(v, block, impl="jnp"))(w)
    q, s = np.asarray(q), np.asarray(s)
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16))
    yj = np.asarray(jax.jit(lambda a, b, c: jops.dequant_matmul(
        a, b, c, (k, n), block, transpose=False, dtype=jnp.float32,
        impl=impl))(x, q, s))
    q2 = _torch(q)[: k * n].view(k, n)
    s2 = _torch(s)[: k * n // block].view(k, n // block)
    xt = _torch(x)
    y2 = _decode_nt_dequant_matmul(xt, q2, s2, block)
    y1 = _decode_nt_dequant_matmul(xt, q2, s2, block, terms=1)
    assert y2.shape == yj.shape == (m, n)
    w_abs = (q2.float() * s2.repeat_interleave(block, 1)).abs()
    bound = 2.0 ** -16 * (xt.float().abs() @ w_abs) \
        + 1e-5 * float(np.abs(yj).max())
    err2 = (y2 - _torch(yj)).abs()
    err1 = (y1 - _torch(yj)).abs()
    assert bool((err2 <= bound).all())
    assert float(err1.max()) > 16 * float(err2.max())
    assert not bool((err1 <= bound).all())
