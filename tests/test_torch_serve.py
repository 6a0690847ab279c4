"""The port's serving slice against the JAX package's, end to end.

qwen2-0.5b reduced, zero_topo, quant_block=64, compute_dtype float32 on the
one-device (1, 1, 1) mesh, as tests/test_paged.py sets the reference up.
The reference's primaries go across through ``convert.from_jax_primaries``;
the residency must then match bit for bit, prefill and teacher-forced decode
logits within rtol=atol=1e-4 (the matmuls sum in another order), and the
continuous batcher must emit the same greedy tokens with the same
admission / rejection / preemption / retirement counts.

Each test's body is a ``hold_*`` function of (reference setup, port setup),
so other dense full-attention models run the same checks on their own
``_pair(arch)`` (tests/test_torch_deepseek.py).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.engine import TrainHparams, ZeroEngine
from repro.launch.mesh import make_test_mesh, scheme_config
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import build_model as jbuild, get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.resident import build_resident as jbuild_resident
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeSLO as JSLO
from repro.serve.scheduler import _grow_seq

from repro_torch.convert import from_jax_primaries
from repro_torch.core.partition import single_device_config
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident)
from repro_torch.serve.scheduler import ContinuousBatcher, Request, ServeSLO
from test_torch_train import reduced_arch

TOL = dict(rtol=1e-4, atol=1e-4)
AX = ("data", "node", "gcd")
ARCH = "qwen2-0.5b"


@functools.lru_cache(maxsize=2)
def _pair(arch: str = ARCH):
    """(reference setup, port setup) sharing one set of weights, on the
    reduction ``arch`` names (test_torch_train.reduced_arch)."""
    mesh = make_test_mesh(shape=(1, 1, 1), axes=AX)
    jarch = reduced_arch(jget, arch)
    jmodel = jbuild(jarch)
    jcfg = scheme_config("zero_topo", mesh, quant_block=64,
                         compute_dtype="float32")
    eng = ZeroEngine(jmodel.leaf_specs(), jcfg, mesh, TrainHparams())
    state = eng.init_state(jax.random.key(0))
    jres = jbuild_resident(eng, state, mesh)[1]
    ref = dict(mesh=mesh, arch=jarch, model=jmodel, eng=eng, state=state,
               res=jres)

    arch = reduced_arch(get_arch, arch)
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


def test_convert_carries_primaries():
    hold_convert(*_pair())


def hold_convert(ref, port):
    assert set(port["prim"]) == set(ref["state"]["primaries"])
    for name, a in ref["state"]["primaries"].items():
        t = port["prim"][name]
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_residency_bitwise():
    # embed + the 7 projections of the block
    hold_residency(*_pair(), ["attn.w_down", "attn.w_gate", "attn.w_up",
                              "attn.wk", "attn.wo", "attn.wq", "attn.wv",
                              "embed"])


def hold_residency(ref, port, wire_names):
    """Every residency entry bit for bit; the INT8 (wire) leaves are
    exactly ``wire_names``."""
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
    assert sorted(wire) == sorted(wire_names)


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
    hold_prefill(*_pair())


def hold_prefill(ref, port):
    tokens = _tokens(0, (2, 16), port["arch"].vocab)
    (jl, jc), (tl, tc) = _prefill_both(ref, port, tokens)
    assert tl.shape == (2, port["arch"].vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["attn"][name].numpy(),
                                   np.asarray(jc["attn"][name]), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 16


def test_decode_teacher_forced():
    """Decode a fixed token sequence (not the model's own argmax) over the
    bf16 cache the server keeps; logits agree per step. Each port step
    starts from the reference's cache of that step: a 1e-6 difference in an
    f32 K/V value can move its bf16 rounding by one ulp (2**-8 relative),
    more than the tolerance. So the caches are held to one bf16 rounding of
    values that agree to 1e-5 (rtol=2**-7, atol=1e-5), and the logits to
    1e-4 per step."""
    hold_decode(*_pair())


def hold_decode(ref, port):
    """``test_decode_teacher_forced`` on a pair."""
    plen, max_len, steps = 8, 16, 6
    vocab = port["arch"].vocab
    tokens = _tokens(1, (2, plen), vocab)
    forced = _tokens(2, (steps, 2), vocab)
    (_, jc), _ = _prefill_both(ref, port, tokens)
    jc = _grow_seq(jc, ref["model"], max_len)
    jc = {k: (v if k == "pos" else
              {n: a.astype(jnp.bfloat16) for n, a in v.items()})
          for k, v in jc.items()}

    jdec = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("d", max_len, 2, "decode")).make_decode()
    dec = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("d", max_len, 2, "decode")).make_decode()
    for i in range(steps):
        tc = {"attn": {n: _bf16_torch(jc["attn"][n]) for n in ("k", "v")},
              "pos": torch.tensor(int(jc["pos"]), dtype=torch.int32)}
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1
        for n in ("k", "v"):
            np.testing.assert_allclose(
                tc["attn"][n].float().numpy(),
                np.asarray(jc["attn"][n]).astype(np.float32),
                rtol=2 ** -7, atol=1e-5, err_msg=f"cache {n}, step {i}")


def _bf16_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


BATCHER_CASES = [
    # fully provisioned: 3 requests recycle 2 slots
    dict(n_slots=2, max_len=24, prompt_len=8, page_size=4, n_pages=0,
         n_req=3, max_new=5, max_queue_steps=0, expect=None),
    # oversubscribed: lazy page growth runs the free list dry mid-decode,
    # the youngest slot is preempted and requeued
    dict(n_slots=3, max_len=32, prompt_len=8, page_size=8, n_pages=4,
         n_req=4, max_new=8, max_queue_steps=50, expect="preempted"),
    # one slot and a short queue-wait bound: late requests are rejected
    dict(n_slots=1, max_len=32, prompt_len=8, page_size=0, n_pages=0,
         n_req=6, max_new=8, max_queue_steps=3, expect="rejected"),
]
BATCHER_IDS = ["provisioned", "oversubscribed", "slo_reject"]


@pytest.mark.parametrize("case", BATCHER_CASES, ids=BATCHER_IDS)
def test_batcher_tokens_and_counters(case):
    hold_batcher(*_pair(), case)


def hold_batcher(ref, port, case):
    vocab = port["arch"].vocab
    prompts = [_tokens(10 + i, (case["prompt_len"],), vocab)
               for i in range(case["n_req"])]
    common = dict(n_slots=case["n_slots"], max_len=case["max_len"],
                  prompt_len=case["prompt_len"],
                  page_size=case["page_size"] or None,
                  n_pages=case["n_pages"])

    jcb = JBatcher(ref["model"], ref["eng"], ref["mesh"], backend="resident",
                   slo=JSLO(max_queue_steps=case["max_queue_steps"]), **common)
    jreqs = [JRequest(rid=i, prompt=p, max_new=case["max_new"])
             for i, p in enumerate(prompts)]
    jcb.run(ref["res"], jreqs)

    cb = ContinuousBatcher(port["model"], port["layout"], device="cpu",
                           slo=ServeSLO(max_queue_steps=case["max_queue_steps"]),
                           **common)
    reqs = [Request(rid=i, prompt=p, max_new=case["max_new"])
            for i, p in enumerate(prompts)]
    cb.run(port["res"], reqs)

    assert cb.counters == jcb.counters
    assert cb.step_count == jcb.step_count
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert [r.rejected for r in reqs] == [r.rejected for r in jreqs]
    assert cb.paged.free_pages() == cb.paged.n_pages
    assert any(r.out for r in reqs)
    if case["expect"]:
        assert cb.counters[case["expect"]] > 0


def test_generate_greedy_tokens():
    """``ResidentServeEngine.generate`` (prefill, then scalar-position
    decode over the prefill cache) emits the reference's greedy tokens."""
    hold_generate(*_pair())


def hold_generate(ref, port):
    tokens = _tokens(3, (2, 8), port["arch"].vocab)
    jtoks = JEngine(ref["model"], ref["eng"], ref["mesh"],
                    JShape("g", 8, 2, "decode")).generate(
        ref["res"], {"tokens": jnp.asarray(tokens)}, 4)
    ttoks = ResidentServeEngine(port["model"], port["layout"],
                                ShapeConfig("g", 8, 2, "decode")).generate(
        port["res"], {"tokens": torch.as_tensor(tokens).long()}, 4)
    assert ttoks.shape == (2, 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
