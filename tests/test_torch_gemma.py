"""The port's gemma3-1b serving slice against the JAX package.

The reference is set up as its serving tests set it up: zero_topo,
quant_block=64, compute_dtype float32 on the one-device (1, 1, 1) mesh, on
gemma3-1b's ``reduced()`` (one ``attn_local`` layer with a sliding window
of 64 and one ``attn_global`` layer, d_model 256, d_ff 512, vocab 512) at
the published head width and GQA: 2 query heads of 256 over 1 KV head.
Its primaries go across through ``convert.from_jax_primaries``.
Tolerances:

- the residency: bit for bit (q, scales and the PLAIN leaves).
- ``LM._embed`` in bf16 at the published d_model 1,152: bit for bit (the
  reference rounds sqrt(d) to bf16 before it multiplies).
- prefill logits and both cache kinds (the global K/V and the rings):
  rtol = atol = 1e-4, as the other slices are held (the matmuls sum in
  another order).
- teacher-forced decode across the ring's wrap: the NeoX slice's
  tolerances (logits 1e-4, the bf16 caches one bf16 rounding).
- the per-row ring write and ``ring_decode``: the ring bit for bit, the
  output within 1e-5 (f32 dots and exps in another order).
- the continuous batcher: the same greedy tokens as each request decoded
  alone through the reference's engines (the reference's own batcher
  cannot write a ring at per-row positions), and its counters.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.engine import TrainHparams, ZeroEngine
from repro.launch.mesh import make_test_mesh, scheme_config
from repro.models import layers as jlayers
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import build_model as jbuild, get_arch as jget
from repro.models.transformer import LM as JLM
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.resident import build_resident as jbuild_resident
from repro.serve.scheduler import _grow_seq

from repro_torch.convert import from_jax_primaries
from repro_torch.core.partition import single_device_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.models.transformer import LM
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident)
from repro_torch.serve.scheduler import ContinuousBatcher, Request, ServeSLO

ARCH = "gemma3-1b"
TOL = dict(rtol=1e-4, atol=1e-4)
AX = ("data", "node", "gcd")
KINDS = ("attn_local", "attn_global")


def _reduced(get):
    return dataclasses.replace(get(ARCH).reduced(), n_heads=2, n_kv_heads=1,
                               head_dim=256)


@functools.lru_cache(maxsize=1)
def _pair():
    """(reference setup, port setup) sharing one set of weights."""
    mesh = make_test_mesh(shape=(1, 1, 1), axes=AX)
    jarch = _reduced(jget)
    jmodel = jbuild(jarch)
    jcfg = scheme_config("zero_topo", mesh, quant_block=64,
                         compute_dtype="float32")
    eng = ZeroEngine(jmodel.leaf_specs(), jcfg, mesh, TrainHparams())
    state = eng.init_state(jax.random.key(0))
    jres = jbuild_resident(eng, state, mesh)[1]
    ref = dict(mesh=mesh, arch=jarch, model=jmodel, eng=eng, state=state,
               res=jres)

    arch = _reduced(get_arch)
    assert arch.pattern == KINDS and arch.sliding_window == 64
    assert (arch.hdim, arch.n_heads, arch.kv_heads) == (256, 2, 1)
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


def _bf16_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# the published config and embed_scale
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    mine, theirs = get_arch(ARCH), jget(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.kind_counts() == {"attn_local": 22, "attn_global": 4}
    assert [i for i, k in enumerate(mine.pattern) if k == "attn_global"] \
        == [5, 11, 17, 23]


class _Rows:
    """A view whose embedding lookup takes rows of a dense table."""

    def __init__(self, table):
        self.table = table

    def embed_lookup(self, name, ids):
        return self.table[ids]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_scale_bitwise(dtype):
    """``LM._embed`` at the published d_model 1,152 against the reference's,
    bit for bit. In bf16 the reference multiplies by sqrt(1152) rounded to
    bf16 (34.0); the product taken in f32 and rounded after (33.94) differs
    in a third of these entries."""
    cfg, jcfg = get_arch(ARCH), jget(ARCH)
    rng = np.random.default_rng(7)
    table = jnp.asarray(rng.standard_normal((64, cfg.d_model)), dtype)
    ids = rng.integers(0, 64, (2, 5)).astype(np.int32)
    want = np.asarray(JLM(jcfg)._embed(_Rows(table), jnp.asarray(ids)))
    t = torch.from_numpy(np.asarray(table).view(
        np.int16 if dtype == "bfloat16" else np.float32).copy())
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    got = LM(cfg)._embed(_Rows(t), torch.as_tensor(ids).long())
    assert got.dtype == t.dtype and got.shape == (2, 5, cfg.d_model)
    bits = np.int16 if dtype == "bfloat16" else np.int32
    got_bits = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    np.testing.assert_array_equal(got_bits.numpy(), want.view(bits))
    if dtype == "bfloat16":
        naive = (t[torch.as_tensor(ids).long()] * (cfg.d_model ** 0.5))
        assert (naive.view(torch.int16).numpy() != want.view(bits)).mean() > 0.1


# ---------------------------------------------------------------------------
# weights and the residency
# ---------------------------------------------------------------------------

def test_residency_bitwise():
    ref, port = _pair()
    layout = port["layout"]
    assert set(port["prim"]) == set(ref["state"]["primaries"])
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
    assert sorted(wire) == sorted(["embed"] + [
        f"{k}.{n}" for k in KINDS
        for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")])


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


def test_prefill_logits_and_caches():
    """A prompt of 128, twice the window: the local layer's flash call
    masks key tiles on both sides, and its ring holds the last 64
    positions, already wrapped (position p at slot p % 64)."""
    ref, port = _pair()
    arch = port["arch"]
    tokens = _tokens(0, (2, 128), arch.vocab)
    (jl, jc), (tl, tc) = _prefill_both(ref, port, tokens)
    assert tl.shape == (2, arch.vocab) and tl.dtype == torch.float32
    assert set(tc) == set(jc) == set(KINDS) | {"pos"}
    for kind, length in (("attn_local", 64), ("attn_global", 128)):
        for name in ("k", "v"):
            assert tc[kind][name].shape == (1, 2, length, 1, 256)
            np.testing.assert_allclose(tc[kind][name].numpy(),
                                       np.asarray(jc[kind][name]), **TOL,
                                       err_msg=f"{kind} {name}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 128


def test_decode_teacher_forced_across_wrap():
    """Decode a fixed token sequence from a prompt of 60 to position 67, at
    a shared scalar position, over the bf16 caches the server keeps: the
    ring fills its last slots and wraps at 64. Each port step starts from
    the reference's caches of that step, as the NeoX slice's test does."""
    ref, port = _pair()
    plen, max_len, steps = 60, 72, 8
    tokens = _tokens(1, (2, plen), port["arch"].vocab)
    forced = _tokens(2, (steps, 2), port["arch"].vocab)
    (_, jc), _ = _prefill_both(ref, port, tokens)
    jc = _grow_seq(jc, ref["model"], max_len)
    jc = {k: (v if k == "pos" else
              {n: a.astype(jnp.bfloat16) for n, a in v.items()})
          for k, v in jc.items()}
    assert jc["attn_local"]["k"].shape[2] == 64
    jdec = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("d", max_len, 2, "decode")).make_decode()
    dec = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("d", max_len, 2, "decode")).make_decode()
    for i in range(steps):
        tc = {kind: {n: _bf16_torch(jc[kind][n]) for n in ("k", "v")}
              for kind in KINDS}
        tc["pos"] = torch.tensor(int(jc["pos"]), dtype=torch.int32)
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1
        for kind in KINDS:
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    tc[kind][n].float().numpy(),
                    np.asarray(jc[kind][n]).astype(np.float32),
                    rtol=2 ** -7, atol=1e-4,
                    err_msg=f"{kind} cache {n}, step {i}")


@pytest.mark.parametrize("pos", [(70, 3), 70], ids=["per-row", "scalar"])
def test_ring_write_and_decode(pos):
    """The ring write at each row's slot pos % W, then ``ring_decode``,
    against the reference's ``ring_decode`` over a ring written in numpy:
    per row on either side of the wrap (position 70 in slot 6 with the
    ring full, position 3 before it has filled), and at a shared scalar
    position."""
    rng = np.random.default_rng(5)
    b, w, h, hkv, d = 2, 64, 4, 1, 256
    ring_k, ring_v = (rng.standard_normal((b, w, hkv, d)).astype(np.float32)
                      for _ in range(2))
    new_k, new_v = (rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
                    for _ in range(2))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    rows = np.broadcast_to(np.asarray(pos), (b,))
    want_k, want_v = ring_k.copy(), ring_v.copy()
    for r in range(b):
        want_k[r, rows[r] % w] = new_k[r, 0]
        want_v[r, rows[r] % w] = new_v[r, 0]
    want = np.asarray(jlayers.ring_decode(
        jnp.asarray(q), jnp.asarray(want_k), jnp.asarray(want_v),
        jnp.asarray(pos, jnp.int32), w))

    tpos = torch.as_tensor(pos)
    ck = layers.ring_cache_write(torch.from_numpy(ring_k.copy()),
                                 torch.from_numpy(new_k), tpos)
    cv = layers.ring_cache_write(torch.from_numpy(ring_v.copy()),
                                 torch.from_numpy(new_v), tpos)
    np.testing.assert_array_equal(ck.numpy(), want_k)
    np.testing.assert_array_equal(cv.numpy(), want_v)
    got = layers.ring_decode(torch.from_numpy(q), ck, cv, tpos, w)
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the continuous batcher and the CLI
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _reference_fn(which: str, length: int, batch: int):
    """The reference engine's jitted prefill ("p") or decode ("d") at one
    shape, built once for the file."""
    ref = _pair()[0]
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


@pytest.mark.parametrize("case", [
    # prompts past the window (the rings wrap in prefill), 3 requests over
    # 2 slots: a freed slot's ring row is rewritten whole at admission
    dict(n_slots=2, max_len=96, prompt_len=80, page_size=8, n_pages=0,
         n_req=3, max_new=6),
    # prompts shorter than the window (zero-padded rings) decoded past it,
    # oversubscribed: the youngest slot is preempted and restarts
    dict(n_slots=2, max_len=72, prompt_len=16, page_size=8, n_pages=12,
         n_req=3, max_new=52),
], ids=["past-window", "wrap-in-decode-preempted"])
def test_batcher_tokens_against_reference_engines(case):
    ref, port = _pair()
    vocab = port["arch"].vocab
    prompts = [_tokens(30 + i, (case["prompt_len"],), vocab)
               for i in range(case["n_req"])]
    cb = ContinuousBatcher(port["model"], port["layout"], device="cpu",
                           n_slots=case["n_slots"], max_len=case["max_len"],
                           prompt_len=case["prompt_len"],
                           page_size=case["page_size"],
                           n_pages=case["n_pages"], slo=ServeSLO())
    reqs = [Request(rid=i, prompt=p, max_new=case["max_new"])
            for i, p in enumerate(prompts)]
    cb.run(port["res"], reqs)

    c = cb.counters
    assert c["retired"] == case["n_req"] and c["rejected"] == 0
    assert c["admitted"] == c["retired"] + c["preempted"]
    assert (c["preempted"] > 0) == bool(case["n_pages"])
    assert cb.paged.free_pages() == cb.paged.n_pages
    for r, p in zip(reqs, prompts):
        assert r.out == _reference_alone(ref, p, case["max_new"],
                                         case["max_len"]), f"request {r.rid}"


def test_serve_cli_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--prompt-len", "128", "--max-len", "160",
                    "--requests", "3", "--slots", "2", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=gemma3-1b-reduced" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    assert "-> 12 tokens" in out
