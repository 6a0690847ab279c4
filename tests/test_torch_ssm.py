"""The port's SSM serving slice (falcon-mamba-7b) against the JAX package.

The reference is set up as its own tests set it up: falcon-mamba-7b
reduced (d_model 256, d_inner 512, dt_rank 16, d_state 16, 2 layers, vocab
512), zero_topo, quant_block=64, compute_dtype float32 on the one-device
(1, 1, 1) mesh. Its primaries go across through
``convert.from_jax_primaries``. Tolerances:

- the scan, y and h_last: rtol = atol = 1e-5 against the reference's jnp
  oracle and its Pallas kernel in interpret mode. Both sides run the same
  f32 ops per step; XLA's and torch's ``exp`` may differ in the last bit,
  and the N-sum runs in another order.
- the residency: bit for bit (q, scales and the PLAIN leaves).
- prefill and teacher-forced decode logits and states: rtol = atol = 1e-4,
  as the qwen2 slice is held (the matmuls sum in another order).
- the continuous batcher: the same greedy tokens and counters.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.engine import TrainHparams, ZeroEngine
from repro.kernels import ops as jops
from repro.launch.mesh import make_test_mesh, scheme_config
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import build_model as jbuild, get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.resident import build_resident as jbuild_resident
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeSLO as JSLO

from repro_torch.convert import from_jax_primaries
from repro_torch.core import linear
from repro_torch.core.partition import single_device_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.launch import serve as serve_cli
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.serve.paged import seq_entry_keys
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident, init_primaries,
                                        iter_primaries)
from repro_torch.serve.scheduler import ContinuousBatcher, Request, ServeSLO

ARCH = "falcon-mamba-7b"
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
AX = ("data", "node", "gcd")


@functools.lru_cache(maxsize=1)
def _pair():
    """(reference setup, port setup) sharing one set of weights."""
    mesh = make_test_mesh(shape=(1, 1, 1), axes=AX)
    jarch = jget(ARCH).reduced()
    jmodel = jbuild(jarch)
    jcfg = scheme_config("zero_topo", mesh, quant_block=64,
                         compute_dtype="float32")
    eng = ZeroEngine(jmodel.leaf_specs(), jcfg, mesh, TrainHparams())
    state = eng.init_state(jax.random.key(0))
    jres = jbuild_resident(eng, state, mesh)[1]
    ref = dict(mesh=mesh, arch=jarch, model=jmodel, eng=eng, state=state,
               res=jres)

    arch = get_arch(ARCH).reduced()
    model = build_model(arch)
    layout = ResidentLayout(model.leaf_specs(), single_device_config(
        "zero_topo", quant_block=64, compute_dtype="float32"))
    prim = from_jax_primaries(
        {n: np.asarray(a) for n, a in state["primaries"].items()}, arch,
        device="cpu")
    port = dict(arch=arch, model=model, layout=layout, prim=prim,
                res=build_resident(layout, prim.items()))
    return ref, port


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _scan_inputs(bsz, s, d, n, seed=0, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, d)) - dt_shift)).astype(f32)
    x = rng.standard_normal((bsz, s, d)).astype(f32)
    b = rng.standard_normal((bsz, s, n)).astype(f32)
    c = rng.standard_normal((bsz, s, n)).astype(f32)
    a_log = np.log(np.arange(1, n + 1, dtype=f32))[None] \
        + 0.1 * rng.standard_normal((d, n)).astype(f32)
    a = (-np.exp(a_log)).astype(f32)
    h0 = rng.standard_normal((bsz, d, n)).astype(f32)
    return dt, x, b, c, a, h0


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(2, 40, 24, 16), (1, 300, 8, 16),
                                   (2, 1, 24, 16)],
                         ids=["B2-S40", "S300-block4", "S1"])
def test_selective_scan_matches_reference(impl, shape):
    """The port's scan (the plain version on the CPU) against the
    reference's jnp oracle and its Pallas kernel: y and h_last. At S=300
    the reference's time block halves to 4 (75 blocks carry the state)."""
    args = _scan_inputs(*shape)
    jy, jh = jops.selective_scan(*(jnp.asarray(t) for t in args), impl=impl)
    y, h = ops.selective_scan(*(torch.from_numpy(t) for t in args))
    assert y.shape == shape[:3] and h.shape == (shape[0], shape[2], shape[3])
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


# The card kernel's arithmetic (csrc/selective_scan.cu): the plain version's
# per-step operations (exp, multiply, then add, unfused); a channel's 16
# states over SCAN_LANES lanes, lane j holding states j, j + 4, j + 8, j + 12;
# each lane's products h * c summed in state order, then (p0 + p1) + (p2 + p3)
# across the lanes.
SCAN_LANES = 4


def _scan_kernel_order(dt, x, b, c, a, h0, lanes=SCAN_LANES):
    """What csrc/selective_scan.cu computes, step by step in f32:
    da = exp(fl(dt * a)), h = fl(fl(da * h) + fl(fl(dt * x) * b)), y = the
    lanes' partial sums of h * c (states j + lanes * i, in order i) added as
    (p0 + p1) + (p2 + p3)."""
    bsz, seq, d = dt.shape
    n = a.shape[-1]
    h = h0.clone()
    y = torch.empty((bsz, seq, d), dtype=torch.float32)
    for t in range(seq):
        da = torch.exp(dt[:, t, :, None] * a[None])
        h = da * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        hc = (h * c[:, t, None, :]).reshape(bsz, d, n // lanes, lanes)
        p = torch.zeros((bsz, d, lanes), dtype=torch.float32)
        for i in range(n // lanes):
            p = p + hc[..., i, :]
        while p.shape[-1] > 1:      # lanes j and j ^ 1 first, then j ^ 2
            p = p[..., 0::2] + p[..., 1::2]
        y[:, t] = p[..., 0]
    return y, h


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape,dt_shift", [((2, 40, 24, 16), 0.0),
                                            ((1, 300, 8, 16), 0.0),
                                            ((1, 2048, 16, 16), 6.0)],
                         ids=["B2-S40", "S300", "S2048-small-dt"])
def test_selective_scan_kernel_order(impl, shape, dt_shift):
    """The card kernel's arithmetic and sum order, rehearsed on the CPU,
    against the reference's jnp oracle and its Pallas kernel in interpret
    mode: y and h_last within SCAN_TOL. At S=2048 dt is about 2.5e-3, so
    exp(dt * a) is near 1 and a rounding difference in the decay lasts the
    longest."""
    args = _scan_inputs(*shape, seed=2, dt_shift=dt_shift)
    jy, jh = jops.selective_scan(*(jnp.asarray(t) for t in args), impl=impl)
    y, h = _scan_kernel_order(*(torch.from_numpy(t) for t in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


def test_selective_scan_checks_and_no_fallback():
    """Shapes are checked; the CUDA wrapper refuses a CPU tensor instead of
    running anything else; the kernel is counted only where it launches."""
    args = [torch.from_numpy(t) for t in _scan_inputs(1, 5, 8, 16)]
    with pytest.raises(ValueError):
        ops.selective_scan(args[0], args[1][:, :4], *args[2:])
    with pytest.raises(ValueError):
        ops.selective_scan(*args, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        selective_scan_cuda(*args)
    ops.reset_launches()
    ops.selective_scan(*args)
    ops.selective_scan(*args, impl="plain")
    assert ops.launches()["selective_scan"] == 0
    assert "selective_scan" in ops.KERNELS


def _force_scan_kernel(monkeypatch):
    """Take the scan's kernel branch on the CPU. ``_kernel`` says yes for a
    3-D f32 tensor (the scan's dt: every other dispatch of the SSM family
    sees 1-D or 2-D tensors), and the stand-in for ``selective_scan_cuda``
    returns the plain result detached, as the CUDA kernel's output carries
    no graph of its own. Returns the list of the stand-in's calls."""
    calls = []
    orig = ops._kernel

    def kernel(t, impl, name):
        if impl is None and t.ndim == 3 and t.dtype == torch.float32:
            return True
        return orig(t, impl, name)

    def stand_in(*args):
        calls.append(args)
        with torch.no_grad():
            y, h = kref.selective_scan_ref(*args)
        return y.detach(), h.detach()

    monkeypatch.setattr(ops, "_kernel", kernel)
    monkeypatch.setattr(ops, "selective_scan_cuda", stand_in)
    return calls


def test_selective_scan_grads_through_kernel_branch(monkeypatch):
    """The kernel branch of ``ops.selective_scan`` is differentiable: the
    gradients of dt, x, b, c, a and h0 through both outputs equal autograd
    through the plain version, exactly (the backward is autograd through
    ``ref.selective_scan_ref`` at the saved inputs, as the reference's
    custom_vjp is ``jax.vjp`` of its oracle). Under no_grad the forward is
    the kernel's output as it is."""
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(t) for t in _scan_inputs(2, 7, 8, 16, seed=3)]
    gy = torch.from_numpy(rng.standard_normal((2, 7, 8)).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in args]
        y, h = fn(*leaves)
        return (y, h), torch.autograd.grad((y, h), leaves, (gy, gh))

    (yp, hp), want = grads(kref.selective_scan_ref)
    calls = _force_scan_kernel(monkeypatch)
    ops.reset_launches()
    (yk, hk), got = grads(ops.selective_scan)
    assert len(calls) == 1 and ops.launches()["selective_scan"] == 1
    assert torch.equal(yk, yp) and torch.equal(hk, hp)
    for name, g, w in zip(("dt", "x", "b", "c", "a", "h0"), got, want):
        assert g.dtype == w.dtype == torch.float32, name
        assert torch.equal(g, w), name
    with torch.no_grad():
        y, h = ops.selective_scan(*args)
    assert not y.requires_grad and torch.equal(y, yp) and torch.equal(h, hp)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_selective_scan_grads_match_reference(monkeypatch, impl):
    """The kernel branch's gradients against the reference's: dt, x, b, c, a
    and h0 through both outputs, from ``jax.vjp`` of the reference's scan
    (a custom_vjp whose backward is ``jax.vjp`` of its oracle) on the same
    inputs and cotangents, at the reduced falcon-mamba's widths (d_inner
    512, d_state 16) with a non-zero h0, each within 1e-5 of max|ref|."""
    rng = np.random.default_rng(11)
    args = _scan_inputs(2, 16, 512, 16, seed=7)
    assert np.abs(args[-1]).max() > 0
    gy = rng.standard_normal((2, 16, 512)).astype(np.float32)
    gh = rng.standard_normal((2, 512, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda *t: jops.selective_scan(*t, impl=impl),
                     *(jnp.asarray(t) for t in args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))

    calls = _force_scan_kernel(monkeypatch)
    leaves = [torch.from_numpy(t).requires_grad_() for t in args]
    y, h = ops.selective_scan(*leaves)
    got = torch.autograd.grad((y, h), leaves,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    assert len(calls) == 1
    for name, g, w in zip(("dt", "x", "b", "c", "a", "h0"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("seq", [300, 512])
def test_selective_scan_blocked_backward(seq):
    """The scan's backward rematerialises 256-step blocks
    (``ref.selective_scan_ref_vjp``, what ``ops.selective_scan``'s backward
    runs) and gives the gradients of autograd through the whole unblocked
    sequence: at S = 300 (a block and a short one) and 512 (two whole
    blocks), with a non-zero h0. The plain version run block by block from
    each block's start state (what the backward re-runs) gives the whole
    sequence's y and h_last bit for bit; each gradient is within 1e-6 of
    its max|grad| (the gradient of ``a`` sums the blocks' shares in another
    order; the others run the same ops). Through ``ops.selective_scan``
    the gradients are the blocked ones exactly."""
    rng = np.random.default_rng(seq)
    args = [torch.from_numpy(t) for t in _scan_inputs(2, seq, 24, 16, seed=9)]
    gy = torch.from_numpy(rng.standard_normal((2, seq, 24)).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((2, 24, 16)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = kref.selective_scan_ref(*leaves)
    want = torch.autograd.grad((y, h), leaves, (gy, gh))

    block = kref.SCAN_BWD_BLOCK
    assert block == 256 and seq > block
    dt, x, b, c, a, hb = args
    yb = []
    for t0 in range(0, seq, block):
        part, hb = kref.selective_scan_ref(
            *(t[:, t0:t0 + block] for t in (dt, x, b, c)), a, hb)
        yb.append(part)
    assert torch.equal(torch.cat(yb, 1), y.detach())
    assert torch.equal(hb, h.detach())

    got = kref.selective_scan_ref_vjp(*args, gy, gh)
    for name, g, w in zip(("dt", "x", "b", "c", "a", "h0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * float(w.abs().max()),
                                   err_msg=name)
    leaves = [t.clone().requires_grad_() for t in args]
    yo, ho = ops.selective_scan(*leaves)
    assert torch.equal(yo, y.detach()) and torch.equal(ho, h.detach())
    through_ops = torch.autograd.grad((yo, ho), leaves, (gy, gh))
    for name, g, w in zip(("dt", "x", "b", "c", "a", "h0"), through_ops, got):
        assert torch.equal(g, w), name


def test_mamba_loss_grads_through_kernel_branch(monkeypatch):
    """One reduced falcon-mamba ``LM.loss`` backward with the scan's kernel
    branch forced gives the plain branch's gradients for every leaf (the
    same f32 ops in the same order: equal), so every leaf upstream of the
    scan (w_in, the conv, w_xproj, w_dt, A_log, dt_bias) gets its gradient
    on the card too."""
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.data.pipeline import BatchSpec, SyntheticTokens
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config

    arch = get_arch(ARCH).reduced()
    model = build_model(arch)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    eng = ZeroEngine(model.leaf_specs(), scheme_config(
        "zero_topo", mesh, quant_block=64, compute_dtype="float32"), mesh,
        device="cpu")
    state = eng.init_state(0)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticTokens(
        BatchSpec(2, 8, arch.vocab), seed=0).batch(0).items()}

    def run():
        g, loss, _ = eng.local_grads(model.lm.loss, state["primaries"], batch)
        return g, loss

    want, loss_p = run()
    calls = _force_scan_kernel(monkeypatch)
    got, loss_k = run()
    assert len(calls) == 2 * arch.n_layers    # forward and its recompute
    assert torch.equal(loss_k, loss_p)
    upstream = [n for n in want if any(k in n for k in (
        "w_in", "conv_w", "w_xproj", "w_dt", "A_log", "dt_bias"))]
    assert len(upstream) >= 6
    for n in want:
        assert torch.equal(got[n], want[n]), n
    for n in upstream:
        assert bool(got[n].abs().max() > 0), n


# ---------------------------------------------------------------------------
# the residency and its inits
# ---------------------------------------------------------------------------

def test_residency_bitwise():
    ref, port = _pair()
    layout = port["layout"]
    assert set(port["res"]) == set(ref["res"])
    wire = []
    for name, entry in ref["res"].items():
        mine = port["res"][name]
        if layout.mode(name) == "wire":
            wire.append(name)
            np.testing.assert_array_equal(mine["q"].numpy(),
                                          np.asarray(entry["q"]))
            np.testing.assert_array_equal(
                mine["s"].numpy().view(np.uint32),
                np.asarray(entry["s"]).view(np.uint32))
        else:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(entry))
    assert sorted(wire) == ["embed", "mamba.w_dt", "mamba.w_in",
                            "mamba.w_out", "mamba.w_xproj"]
    # w_xproj (512, 48): 48 is not a whole number of 64-blocks, so it is
    # dequantized whole and multiplied dense
    spec = layout.specs["mamba.w_xproj"]
    assert spec.shape == (512, 48)
    assert not linear._fusable(spec, layout.leaf_cfg["mamba.w_xproj"])
    assert linear._fusable(layout.specs["mamba.w_in"],
                           layout.leaf_cfg["mamba.w_in"])


def test_init_primaries_ssm_leaves():
    """A_log = log(1..N) on every row; softplus(dt_bias) in [1e-3, 1e-1]
    (to 1e-4 relative: exp(dt) - 1 rounds in f32 near 1); the one-leaf
    iterator builds the same residency as the dict."""
    _, port = _pair()
    layout, arch = port["layout"], port["arch"]
    din, n = arch.d_inner, arch.ssm.d_state
    prim = init_primaries(layout, 0, "cpu")
    a_log = prim["mamba.A_log"][:, : din * n].reshape(-1, din, n)
    want = np.log(np.arange(1, n + 1, dtype=np.float32))
    np.testing.assert_allclose(a_log.numpy(),
                               np.broadcast_to(want, a_log.shape),
                               rtol=2 ** -23, atol=0)
    dt = torch.nn.functional.softplus(prim["mamba.dt_bias"][:, :din])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-4)
    assert float(dt.max()) / float(dt.min()) > 50       # spread, log-uniform
    res_dict = build_resident(layout, prim.items())
    res_iter = build_resident(layout, iter_primaries(layout, 0, "cpu"))
    for name, entry in res_dict.items():
        if isinstance(entry, dict):
            for k in ("q", "s"):
                assert torch.equal(entry[k], res_iter[name][k]), name
        else:
            assert torch.equal(entry, res_iter[name]), name


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def _prefill_both(ref, port, tokens):
    b, s = tokens.shape
    jpre = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("p", s, b, "decode")).make_prefill()
    jl, jc = jpre(ref["res"], {"tokens": jnp.asarray(tokens)})
    pre = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("p", s, b, "decode")).make_prefill()
    tl, tc = pre(port["res"], {"tokens": torch.as_tensor(tokens).long()})
    return (jl, jc), (tl, tc)


def _assert_states(tc, jc, what):
    for name in ("h", "conv"):
        np.testing.assert_allclose(tc["mamba"][name].numpy(),
                                   np.asarray(jc["mamba"][name]), **TOL,
                                   err_msg=f"{name} {what}")


@pytest.mark.parametrize("plen", [16, 2], ids=["prompt16", "prompt2"])
def test_prefill_and_teacher_forced_decode(plen):
    """Prefill logits and states (h (L,B,din,N), conv (L,B,K-1,din)); then 4
    decode steps of fixed tokens, each side from its own state, logits and
    states per step. A prompt of 2 < d_conv - 1 left-pads the conv tail."""
    ref, port = _pair()
    arch = port["arch"]
    steps, b = 4, 2
    tokens = _tokens(plen, (b, plen), arch.vocab)
    forced = _tokens(100 + plen, (steps, b), arch.vocab)
    (jl, jc), (tl, tc) = _prefill_both(ref, port, tokens)
    assert tl.shape == (b, arch.vocab) and tl.dtype == torch.float32
    assert tc["mamba"]["h"].shape == (2, b, arch.d_inner, arch.ssm.d_state)
    assert tc["mamba"]["conv"].shape == (2, b, arch.ssm.d_conv - 1,
                                         arch.d_inner)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_states(tc, jc, "after prefill")
    assert int(tc["pos"]) == int(jc["pos"]) == plen

    shape = ShapeConfig("d", plen + steps, b, "decode")
    jdec = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("d", plen + steps, b, "decode")).make_decode()
    dec = ResidentServeEngine(port["model"], port["layout"],
                              shape).make_decode()
    for i in range(steps):
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        _assert_states(tc, jc, f"after decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1


def test_decode_matches_prefill():
    """Inside the port: prefill(tokens[:n]) then teacher-forced decode of
    tokens[n:] gives prefill(tokens)'s logits and states (f32, the scan and
    the conv run in another order than the per-token update: 1e-4). A
    decode that did not write its state back would fail here."""
    _, port = _pair()
    b, n_prompt, n_extra = 2, 12, 4
    total = n_prompt + n_extra
    toks = _tokens(7, (b, total), port["arch"].vocab)
    eng = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("t", total, b, "decode"))
    full_l, full_c = eng.make_prefill()(
        port["res"], {"tokens": torch.as_tensor(toks).long()})
    logits, caches = eng.make_prefill()(
        port["res"], {"tokens": torch.as_tensor(toks[:, :n_prompt]).long()})
    decode = eng.make_decode()
    for i in range(n_extra):
        logits, caches = decode(port["res"], caches, {
            "token": torch.as_tensor(toks[:, n_prompt + i]).long()})
    np.testing.assert_allclose(logits.numpy(), full_l.numpy(), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(caches["mamba"][name].numpy(),
                                   full_c["mamba"][name].numpy(), **TOL)


# ---------------------------------------------------------------------------
# the continuous batcher and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # 3 requests recycle 2 slots (the reference's test_scheduler setting)
    dict(n_slots=2, max_len=24, prompt_len=8, page_size=0, n_pages=0,
         n_req=3, max_new=6, expect=None),
    # no cache entry pages, but the page accounting still runs: too few
    # pages preempt the youngest slot, as in the reference
    dict(n_slots=3, max_len=32, prompt_len=8, page_size=8, n_pages=4,
         n_req=4, max_new=8, expect="preempted"),
], ids=["provisioned", "oversubscribed"])
def test_batcher_tokens_and_counters(case):
    ref, port = _pair()
    vocab = port["arch"].vocab
    prompts = [_tokens(20 + i, (case["prompt_len"],), vocab)
               for i in range(case["n_req"])]
    common = dict(n_slots=case["n_slots"], max_len=case["max_len"],
                  prompt_len=case["prompt_len"],
                  page_size=case["page_size"] or None,
                  n_pages=case["n_pages"])
    slo = dict(max_queue_steps=50 if case["expect"] else 0)

    jcb = JBatcher(ref["model"], ref["eng"], ref["mesh"], backend="resident",
                   slo=JSLO(**slo), **common)
    jreqs = [JRequest(rid=i, prompt=p, max_new=case["max_new"])
             for i, p in enumerate(prompts)]
    jcb.run(ref["res"], jreqs)

    cb = ContinuousBatcher(port["model"], port["layout"], device="cpu",
                           slo=ServeSLO(**slo), **common)
    assert not cb.paged.seq_keys
    assert not seq_entry_keys(port["model"], ShapeConfig("p", 16, 2, "decode"))
    reqs = [Request(rid=i, prompt=p, max_new=case["max_new"])
            for i, p in enumerate(prompts)]
    cb.run(port["res"], reqs)

    assert cb.counters == jcb.counters
    assert cb.step_count == jcb.step_count
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert cb.paged.free_pages() == cb.paged.n_pages
    assert all(len(r.out) == case["max_new"] for r in reqs)
    if case["expect"]:
        assert cb.counters[case["expect"]] > 0


def test_serve_cli_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--requests", "3", "--slots", "2", "--prompt-len", "8",
                    "--max-len", "24", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=falcon-mamba-7b-reduced" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    assert "-> 12 tokens" in out
