"""The port's MoE family against the JAX package: phi3.5-moe-42b-a6.6b and
mixtral-8x7b on their ``reduced()`` (2 ``moe`` layers, d_model 256, 4
heads of 64, 4 experts of 512, top 2, token_chunk 256, vocab 512; phi3.5
with LayerNorm, mixtral with RMSNorm and a window of 64).

The reference is set up as its serving tests set it up: zero_topo,
quant_block 64, f32, the one-device (1, 1, 1) mesh; its primaries go
across through ``convert.from_jax_primaries``. Tolerances:

- ``_dispatch_combine``: dispatch and combine bit for bit on the same
  gates, at top_k 1 and 2, with tokens past capacity and with uniform
  gates (every expert tied: the lower index first); the load-balance term
  within AUX_RTOL (4 f32 ulp: its means over the tokens sum in another
  order than XLA's).
- ``moe_ffn`` over 3 chunks (T = 600, chunk 200): y and the aux term within
  1e-5 of max|ref| (f32 products in another order), the weights' gradients
  within 1e-5 of their max; x's gradient passes the bf16 slots, where an
  f32 difference can flip a bf16 rounding by one ulp (2**-8), so it is held
  in norm within 1e-3. The executed gathers per leaf equal the
  reference's (the router once, each expert stack once a chunk).
- the residency bit for bit; the resident backend bit for bit the gathered
  one (prefill and decode logits).
- prefill and teacher-forced decode logits within 1e-4 (rtol and atol), as
  the other slices; mixtral's prompts past its window too.
- the batcher: phi3.5's tokens and counters equal the reference batcher's;
  mixtral's equal each request decoded alone through the reference's
  engines (the reference's batcher cannot write a ring at per-row
  positions).
- the zero_topo step: each step from the reference's state before it
  (forced) within slice 2's tolerances (loss 3e-5, grad norm 2e-4), aux
  included, at (1, 1, 1) for both (measured within 1.6e-6 and 3e-5); the
  free-running trajectories within TRAJECTORY_GNORM_RTOL (3e-3) in loss and
  grad norm: a step moves near-zero-gradient elements by up to lr on one
  side (test_torch_train's docstring; phi3.5's step 3 free-running: 4.9e-4
  in loss, 1.4e-3 in grad norm). At (1, 2, 2) the gradients are INT4
  over W and E, and the bf16 slots' flips (x's gradient 6e-5 apart in
  norm) push about 0.3 % of the expert gradient's elements across an INT4
  rounding boundary (one level: a seventh of the block's max) where a
  dense model's f32 noise pushes almost none: phi3.5's forced steps
  differ by 1.1e-4, 9.2e-5 and 4.3e-4 in grad norm (losses within 3e-5).
  They are held within MOE_INT4_GNORM_RTOL (2e-3). ``--overlap
  --stream-grads`` bit for bit the plain run on (1, 2, 2).
  ``from_jax_state`` bit for bit for the router and experts.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.engine import ParamView as JParamView
from repro.models import moe as jmoe
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.scheduler import _grow_seq

from repro_torch.convert import from_jax_primaries
from repro_torch.core.engine import TrainHparams, ZeroEngine
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
from repro_torch.models import moe
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.serve import resident
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident, init_primaries,
                                        iter_primaries)
from repro_torch.serve.scheduler import ContinuousBatcher, Request
import test_torch_serve as ts
import test_torch_train as tt
from test_torch_train import (LOSS_RTOL, GNORM_RTOL, RUN,  # noqa: F401
                              TRAJECTORY_GNORM_RTOL, _check,
                              assert_state_converts, one_torch_thread,
                              reduced_arch, reference_run)

PHI = "phi3.5-moe-42b-a6.6b"
MIXTRAL = "mixtral-8x7b"
ARCHS = [PHI, MIXTRAL]
IDS = ["phi35", "mixtral"]
TOL = dict(rtol=1e-4, atol=1e-4)
# the load-balance term: 4 f32 ulp
AUX_RTOL = 4 * 2.0 ** -23
WIRE = ["embed", "lm_head", "moe.w_down", "moe.w_gate", "moe.w_up",
        "moe.wk", "moe.wo", "moe.wq", "moe.wv"]
EXPERTS = ("moe.router", "moe.w_gate", "moe.w_up", "moe.w_down")
MOE_INT4_GNORM_RTOL = 2e-3      # the module docstring says why


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_config_is_the_reference_one(arch):
    a, j = get_arch(arch), jget(arch)
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "hdim", "d_ff",
              "vocab", "rope_theta", "norm", "act", "qkv_bias",
              "tie_embeddings", "sliding_window", "pattern", "source"):
        assert getattr(a, f) == getattr(j, f), f
    for f in ("n_experts", "top_k", "d_ff", "capacity_factor", "aux_coef",
              "token_chunk"):
        assert getattr(a.moe, f) == getattr(j.moe, f), f
    r, jr = a.reduced(), j.reduced()
    assert (r.moe.n_experts, r.moe.d_ff, r.moe.token_chunk) \
        == (jr.moe.n_experts, jr.moe.d_ff, jr.moe.token_chunk) == (4, 512, 256)


# ---------------------------------------------------------------------------
# dispatch / combine and the FFN
# ---------------------------------------------------------------------------

def _gates(kind: str, t: int, e: int) -> np.ndarray:
    if kind == "uniform":
        logits = np.zeros((t, e), np.float32)
    else:
        logits = np.random.default_rng(3).standard_normal((t, e)) * 2
    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


@pytest.mark.parametrize("kind", ["spread", "overflow", "uniform"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_dispatch_combine_bitwise(top_k, kind):
    """The same gates through both ``_dispatch_combine``s: dispatch,
    combine bit for bit, aux within AUX_RTOL. Spread gates route every choice; a small
    capacity drops some; uniform gates (every expert tied) send every
    token's choices to experts 0 .. k-1 (``lax.top_k``'s tie order), each
    of which fills its capacity with the first tokens."""
    t, e = 64, 4
    gates = _gates(kind, t, e)
    cap = 6 if kind == "overflow" else max(int(1.25 * top_k * t / e), 4)
    jd, jc, ja = jmoe._dispatch_combine(jnp.asarray(gates), top_k, cap)
    td, tc, ta = moe._dispatch_combine(torch.from_numpy(gates.copy()), top_k,
                                       cap)
    assert td.dtype == torch.bfloat16 and tc.dtype == torch.float32
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd).astype(np.float32))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32),
                                  np.asarray(jc).view(np.uint32))
    assert ta.dtype == torch.float32
    np.testing.assert_allclose(ta.item(), float(ja), rtol=AUX_RTOL, atol=0)
    per_token = td.float().sum(dim=(1, 2))
    per_expert = td.float().sum(dim=(0, 2))
    if kind == "spread":
        assert torch.equal(per_token, torch.full((t,), float(top_k)))
    elif kind == "overflow":
        assert float(per_token.sum()) < t * top_k
    else:
        want = torch.zeros(e)
        want[:top_k] = cap
        assert torch.equal(per_expert, want)
        assert torch.equal(per_token[:cap], torch.full((cap,), float(top_k)))


class _JView:
    """Dense weights for the reference's ``moe_ffn``, each executed ``get``
    counted (a debug callback runs once for every iteration of the
    reference's chunk scan)."""

    expert_ffn = JParamView.expert_ffn

    def __init__(self, w, counts=None):
        self.w, self.counts = w, counts

    def get(self, name):
        leaf = name.split(".")[-1]
        if self.counts is not None:
            jax.debug.callback(
                lambda: self.counts.__setitem__(
                    leaf, self.counts.get(leaf, 0) + 1), ordered=True)
        return self.w[leaf]


class _TView:
    def __init__(self, w, counts=None):
        self.w, self.counts = w, counts

    def get(self, name):
        leaf = name.split(".")[-1]
        if self.counts is not None:
            self.counts[leaf] = self.counts.get(leaf, 0) + 1
        return self.w[leaf]

    def expert_ffn(self, prefix, e_in):
        return moe.expert_glu(self.get, prefix, e_in)


def _ffn_weights(arch, zero_router: bool):
    e, d, ff = arch.moe.n_experts, arch.d_model, arch.moe.d_ff
    rng = np.random.default_rng(4)
    w = {"router": rng.standard_normal((d, e)) * 0.02,
         "w_gate": rng.standard_normal((e, d, ff)) * 0.25,
         "w_up": rng.standard_normal((e, d, ff)) * 0.25,
         "w_down": rng.standard_normal((e, ff, d)) * 0.25}
    if zero_router:
        w["router"] = np.zeros_like(w["router"])
    return {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["router", "tied"])
def test_moe_ffn_chunks_gathers_and_grads(zero_router):
    """phi3.5's reduction over 600 tokens (3 chunks of 200): y, aux and
    the gradients against the reference's; the gathers each executes."""
    ja, ta = reduced_arch(jget, PHI), reduced_arch(get_arch, PHI)
    w = _ffn_weights(ta, zero_router)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 300, ta.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    jcounts, tcounts = {}, {}
    jy, jaux = jmoe.moe_ffn(_JView({k: jnp.asarray(v) for k, v in w.items()},
                                   jcounts), "moe.", ja, jnp.asarray(x))
    jax.effects_barrier()
    with torch.no_grad():
        moe.moe_ffn(_TView({k: torch.from_numpy(v) for k, v in w.items()},
                           tcounts), "moe.", ta, torch.from_numpy(x))
    assert tcounts == jcounts == {"router": 1, "w_gate": 3, "w_up": 3,
                                  "w_down": 3}

    def jloss(wd, xx):
        y, aux = jmoe.moe_ffn(_JView(wd), "moe.", ja, xx)
        return jnp.sum(y * r) + aux * 100.0

    jg_w, jg_x = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, taux = moe.moe_ffn(_TView(tw), "moe.", ta, tx)
    ((ty * torch.from_numpy(r)).sum() + taux * 100.0).backward()

    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    for k, g in jg_w.items():
        g = np.asarray(g)
        np.testing.assert_allclose(tw[k].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
    g = np.asarray(jg_x)
    assert np.linalg.norm(tx.grad.numpy() - g) <= 1e-3 * np.linalg.norm(g)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_residency_bitwise(arch):
    ref, port = ts._pair(arch)
    ts.hold_convert(ref, port)
    ts.hold_residency(ref, port, WIRE)


def _prefill_both(ref, port, tokens):
    return ts._prefill_both(ref, port, tokens)


@pytest.mark.parametrize("arch,plen", [(PHI, 16), (MIXTRAL, 16),
                                       (MIXTRAL, 80)],
                         ids=["phi35", "mixtral", "mixtral-past-window"])
def test_prefill_logits_and_caches(arch, plen):
    """Logits within 1e-4; the first layer's K/V (before any MoE) too. A
    later layer's K/V follows the MoE before it, whose slots are rounded
    to bf16 (in an f32 run too, as the reference does): where a slot value
    sits at a bf16 rounding boundary, f32 noise moves it by one bf16 ulp
    and that token's next K/V by up to about 2**-8 of its size (mixtral at
    80: 70 of 65,536 elements past 1e-4, at most 4.3e-4); held within
    2**-7 of max|ref|."""
    ref, port = ts._pair(arch)
    tokens = ts._tokens(0, (2, plen), port["arch"].vocab)
    (jl, jc), (tl, tc) = _prefill_both(ref, port, tokens)
    assert tl.shape == (2, port["arch"].vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        want = np.asarray(jc["moe"][n])
        assert tc["moe"][n].shape == want.shape
        np.testing.assert_allclose(tc["moe"][n][0].numpy(), want[0], **TOL)
        np.testing.assert_allclose(tc["moe"][n].numpy(), want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max())
    assert int(tc["pos"]) == int(jc["pos"]) == plen


@pytest.mark.parametrize("arch,plen", [(PHI, 8), (MIXTRAL, 60)],
                         ids=["phi35", "mixtral-across-wrap"])
def test_decode_teacher_forced(arch, plen, monkeypatch):
    """A fixed token sequence decoded at a shared position over the bf16
    caches the server keeps, each port step from the reference's caches of
    that step (tests/test_torch_serve.py's hold_decode); mixtral's ring of
    64 fills and wraps.

    The MoE forms its slots from x rounded to bf16 (in an f32 run too, as
    the reference does); where an element of x sits at a bf16 rounding
    boundary, f32 noise (and a flipped bf16 rounding of the step's new K/V)
    moves it by one bf16 ulp, and the logits follow by up to 1.3e-3
    (phi3.5, measured). So each step runs twice: with the slots the
    reference formed at that step (recorded from its einsum and handed to
    the port's ``moe._slots``) the logits agree within 1e-4 (measured
    5.4e-6 at most); with its own slots, within 4e-3."""
    ref, port = ts._pair(arch)
    max_len, steps = plen + 8, 8
    vocab = port["arch"].vocab
    tokens = ts._tokens(1, (2, plen), vocab)
    forced = ts._tokens(2, (steps, 2), vocab)
    (_, jc), _ = _prefill_both(ref, port, tokens)
    jc = _grow_seq(jc, ref["model"], max_len)
    jc = {k: (v if k == "pos" else
              {n: a.astype(jnp.bfloat16) for n, a in v.items()})
          for k, v in jc.items()}

    slots, handed = [], []
    jeinsum, own_slots = jnp.einsum, moe._slots

    def record(eq, *ops, **kw):
        if eq == "tec,td->ecd":
            jax.debug.callback(lambda a: slots.append(np.asarray(a)),
                               ops[1].astype(jnp.float32), ordered=True)
        return jeinsum(eq, *ops, **kw)

    def hand(xc):
        if handed:
            return torch.from_numpy(handed.pop(0)).to(torch.bfloat16)
        return own_slots(xc)

    monkeypatch.setattr(jnp, "einsum", record)
    monkeypatch.setattr(moe, "_slots", hand)
    jdec = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("d", max_len, 2, "decode")).make_decode()
    dec = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("d", max_len, 2, "decode")
                              ).make_decode()
    for i in range(steps):
        tok = torch.as_tensor(forced[i]).long()
        # the reference's step consumes (donates) its caches: copy first
        cache = {n: ts._bf16_torch(jc["moe"][n]) for n in ("k", "v")}
        pos = int(jc["pos"])
        slots.clear()
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        jax.effects_barrier()
        jl = np.asarray(jl)
        assert len(slots) == port["arch"].n_layers
        for own in (False, True):
            tc = {"moe": {n: t.clone() for n, t in cache.items()},
                  "pos": torch.tensor(pos, dtype=torch.int32)}
            handed[:] = [] if own else list(slots)
            tl, tc = dec(port["res"], tc, {"token": tok})
            assert not handed
            np.testing.assert_allclose(
                tl.numpy(), jl, **(dict(rtol=0, atol=4e-3) if own else TOL),
                err_msg=f"decode step {i}, own slots {own}")
            assert int(tc["pos"]) == plen + i + 1


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_resident_is_gathered_bitwise(arch):
    """The gathered backend (the engine's primaries through ``ParamView``'s
    INT8 gather, ``expert_ffn`` on the gathered stacks) and the resident
    one give the same logits bit for bit, prefill and 3 decode steps."""
    _, port = ts._pair(arch)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=64,
                        compute_dtype="float32")
    eng = ZeroEngine(port["model"].leaf_specs(), cfg, mesh, TrainHparams(),
                     device="cpu")
    layout = ResidentLayout(eng.specs, cfg)
    res = build_resident(layout, port["prim"].items())
    shape = ShapeConfig("t", 24, 2, "decode")
    tokens = torch.as_tensor(ts._tokens(6, (2, 16), port["arch"].vocab)).long()
    engines = [(ServeEngine(port["model"], eng, mesh, shape), port["prim"]),
               (ResidentServeEngine(port["model"], layout, shape), res)]
    outs = []
    for se, params in engines:
        logits, caches = se.make_prefill()(params, {"tokens": tokens})
        caches = {k: v if k == "pos" else
                  {n: torch.nn.functional.pad(
                      t, (0, 0, 0, 0, 0, 24 - t.shape[2]))
                   for n, t in v.items()} for k, v in caches.items()}
        got = [logits]
        dec = se.make_decode()
        for i in range(3):
            tok = torch.full((2,), 7 + i, dtype=torch.long)
            logits, caches = dec(params, caches, {"token": tok})
            got.append(logits)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_residency_draws_one_row_at_a_time(monkeypatch):
    """Every stacked leaf is drawn one layer row at a time, each row's f32
    draw let go before the next is drawn, so the build's peak is the
    residency plus one row's draw and its copy (phi3.5's expert stacks on
    the card). Quantized a row at a time, the residency equals the one
    built from the whole stacks (``init_primaries``); the plain versions
    build the same."""
    layout = ts._pair(PHI)[1]["layout"]
    real, draws = resident._draw_rows, []

    def spy(draw, gen, rows, n, device):
        for row in real(draw, gen, rows, n, device):
            assert all(ref() is None for ref in draws), \
                "an earlier row's f32 draw is still alive"
            assert row.shape == (n,) and row.dtype == torch.float32
            draws.append(weakref.ref(row))
            yield row
            del row

    whole = build_resident(layout, init_primaries(layout, 0, "cpu").items())
    monkeypatch.setattr(resident, "_draw_rows", spy)
    by_row = build_resident(layout, iter_primaries(layout, 0, "cpu"))
    random = [n for n, sp in layout.specs.items()
              if sp.init not in ("zeros", "ones")]
    assert len(draws) == sum(layout.specs[n].stack or 1 for n in random)
    assert layout.specs["moe.w_gate"].stack == 2
    plain = ResidentLayout(layout.specs,
                           dataclasses.replace(layout.cfg, impl="plain"))
    res_plain = build_resident(plain, iter_primaries(plain, 0, "cpu"))
    for other in (whole, res_plain):
        for name, entry in by_row.items():
            if isinstance(entry, dict):
                for k in ("q", "s"):
                    assert torch.equal(entry[k], other[name][k]), name
            else:
                assert torch.equal(entry, other[name]), name


@pytest.mark.parametrize("case", ts.BATCHER_CASES, ids=ts.BATCHER_IDS)
def test_phi35_batcher_tokens_and_counters(case):
    ts.hold_batcher(*ts._pair(PHI), case)


@functools.lru_cache(maxsize=4)
def _reference_fn(which: str, length: int, batch: int):
    ref = ts._pair(MIXTRAL)[0]
    eng = JEngine(ref["model"], ref["eng"], ref["mesh"],
                  JShape(which, length, batch, "decode"))
    return eng.make_prefill() if which == "p" else eng.make_decode()


def _reference_alone(ref, prompt, max_new: int, max_len: int):
    """One request through the reference's engines: a B = 1 prefill, its
    caches grown to max_len and stored bf16 as the pool stores them, then
    greedy decode at the shared scalar position."""
    logits, c = _reference_fn("p", len(prompt), 1)(
        ref["res"], {"tokens": jnp.asarray(prompt[None])})
    c = _grow_seq(c, ref["model"], max_len)
    c = {k: (v if k == "pos" else
             {n: a.astype(jnp.bfloat16) for n, a in v.items()})
         for k, v in c.items()}
    out = [int(jnp.argmax(logits[0]))]
    dec = _reference_fn("d", max_len, 1)
    while len(out) < max_new:
        logits, c = dec(ref["res"], c,
                        {"token": jnp.asarray([out[-1]], jnp.int32)})
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_mixtral_batcher_one_request_at_a_time():
    """Prompts of 80 past the window of 64 (the rings wrap in prefill), 3
    requests over 2 slots: each request's tokens are those it gets decoded
    alone through the reference's engines."""
    ref, port = ts._pair(MIXTRAL)
    n_slots, max_len, plen, max_new = 2, 96, 80, 6
    prompts = [ts._tokens(20 + i, (plen,), port["arch"].vocab)
               for i in range(3)]
    cb = ContinuousBatcher(port["model"], port["layout"], device="cpu",
                           n_slots=n_slots, max_len=max_len, prompt_len=plen,
                           page_size=8)
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    cb.run(port["res"], reqs)
    assert cb.counters["retired"] == 3 and cb.counters["rejected"] == 0
    for r, p in zip(reqs, prompts):
        assert r.out == _reference_alone(ref, p, max_new, max_len), r.rid


def test_serve_cli_cpu(capsys):
    serve_cli.main(["--arch", PHI, "--device", "cpu", "--reduced",
                    "--requests", "3", "--slots", "2", "--prompt-len", "8",
                    "--max-len", "24", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={PHI}-reduced" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _hold_forced_and_free(ref, forced, free, gnorm_rtol=GNORM_RTOL):
    _check(ref, forced, gnorm_rtol=gnorm_rtol)
    np.testing.assert_allclose(free["losses"], ref["losses"],
                               rtol=TRAJECTORY_GNORM_RTOL)
    np.testing.assert_allclose(free["grad_norms"], ref["grad_norms"],
                               rtol=TRAJECTORY_GNORM_RTOL)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_train_step_one_device(mesh1, tmp_path, arch):
    """(1, 1, 1): each step from the reference's state before it, then the
    free-running trajectory; the aux term is in the loss (an MoE layer's
    load-balance term is about 1e-2 a layer)."""
    ref = reference_run(mesh1, tmp_path, arch=arch, forced=True)
    forced = tt.port_forced_rank(0, (1, 1, 1), arch, RUN["seq"], tmp_path)
    (free,) = tt.port_run(tmp_path, (1, 1, 1), arch=arch)
    _hold_forced_and_free(ref, forced, free)
    assert free["fallbacks"] == {}


def test_convert_carries_expert_state(mesh1, tmp_path):
    reference_run(mesh1, tmp_path, arch=PHI)
    assert_state_converts(PHI, tmp_path / "state.npz",
                          EXPERTS + ("moe.wq", "moe.ln2", "moe.ln2_b"))


def _moe_rank(rank: int, ref_dir: Path) -> dict:
    """One rank of (1, 2, 2): the forced steps, then 3 free-running steps
    with and without ``--overlap --stream-grads`` (losses, grad norms and
    the expert masters)."""
    from repro_torch.convert import from_jax_state, load_global_state

    out = dict(forced=tt.port_forced_rank(rank, (1, 2, 2), PHI, RUN["seq"],
                                          ref_dir))
    for key, on in (("plain", False), ("overlap_stream", True)):
        _, eng, tr = tt._port_setup(PHI, Mesh((1, 2, 2), TEST_AXES, rank),
                                    RUN["seq"], overlap=on, stream_grads=on)
        state = from_jax_state(load_global_state(ref_dir / "state.npz"), eng)
        state = tr.run(state, RUN["steps"], log_every=0)
        out[key] = dict(losses=tr.log.losses, grad_norms=tr.log.grad_norms,
                        masters={n: state["master"][n] for n in EXPERTS})
    return out


def test_train_step_four_ranks(tmp_path):
    """(1, 2, 2) on phi3.5's reduction: the reference on 4 host devices in
    a subprocess, then one spawn of 4 gloo ranks: the forced steps within
    LOSS_RTOL and MOE_INT4_GNORM_RTOL, the free-running trajectory within
    TRAJECTORY_GNORM_RTOL, and the same run with the gather prefetch and
    streamed gradients bit for bit (losses, grad norms, expert masters)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, tt.__file__, str(tmp_path), "1,2,2",
                          "zero_topo", PHI, str(RUN["seq"]), "1"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    ref = json.loads((tmp_path / "metrics.json").read_text())
    ranks = tt.run_ranks(_moe_rank, 4, tmp_path / "ranks", tmp_path)
    for r in ranks:
        assert r["forced"] == ranks[0]["forced"]
        for key in ("plain", "overlap_stream"):
            assert r[key]["losses"] == ranks[0]["plain"]["losses"]
            assert r[key]["grad_norms"] == ranks[0]["plain"]["grad_norms"]
        for n in EXPERTS:
            assert torch.equal(r["plain"]["masters"][n],
                               r["overlap_stream"]["masters"][n]), n
    _hold_forced_and_free(ref, ranks[0]["forced"], ranks[0]["plain"],
                          gnorm_rtol=MOE_INT4_GNORM_RTOL)


def test_train_cli_cpu(capfd):
    from repro_torch.launch import train as train_cli
    train_cli.main(["--arch", MIXTRAL, "--device", "cpu", "--reduced",
                    "--devices", "4", "--steps", "2", "--seq", "32",
                    "--batch", "4"])
    out = capfd.readouterr().out
    assert f"arch={MIXTRAL}-reduced" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "final loss: " in out
