"""The port's GPT-NeoX serving slice against the JAX package.

The reference is set up as its serving tests set it up: zero_topo,
quant_block=64, compute_dtype float32 on the one-device (1, 1, 1) mesh, on
three reductions: gpt-neox-20b's ``reduced()`` (d_model 256, 4 heads of 64,
d_ff 512, 2 ``neox`` layers, vocab 512), the same at d_model 384 with 4
heads of 96 (d_ff 768), 20B's published head width, and gpt-neox-10b's
at d_model 512 with 4 heads of 128 (d_ff 1,024), 10B's published head
width. Its primaries go across through ``convert.from_jax_primaries``.
Tolerances:

- LayerNorm and the tanh GELU: 1e-6 (the same f32 ops; XLA and torch may
  round tanh and rsqrt in another last bit).
- attention at D = 96 and 128: 1e-5 against the reference's Pallas kernel
  in interpret mode (dots and exps rounded in another order).
- the residency: bit for bit (q, scales and the PLAIN leaves).
- prefill and teacher-forced decode logits and the prefill's K/V caches:
  rtol = atol = 1e-4, as the qwen2 slice is held (the matmuls sum in
  another order); the bf16 caches a decode step writes: one bf16 rounding
  (rtol 2**-7) and atol 1e-4 (see test_decode_teacher_forced).
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
from repro.kernels.flash_attention import flash_attention_pallas
from repro.launch.mesh import make_test_mesh, scheme_config
from repro.models import layers as jlayers
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
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.models.transformer import LM
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident)
from repro_torch.serve.scheduler import ContinuousBatcher, Request, ServeSLO
from test_torch_train import reduced_arch

ARCH = "gpt-neox-20b"
TOL = dict(rtol=1e-4, atol=1e-4)
AX = ("data", "node", "gcd")
HEADS = ["hd64", "hd96", "hd128"]
# each head width's reduction (test_torch_train.reduced_arch)
REDUCTIONS = {"hd64": ARCH, "hd96": ARCH + "@hd96",
              "hd128": "gpt-neox-10b@hd128"}


@functools.lru_cache(maxsize=3)
def _pair(heads: str):
    """(reference setup, port setup) sharing one set of weights."""
    mesh = make_test_mesh(shape=(1, 1, 1), axes=AX)
    jarch = reduced_arch(jget, REDUCTIONS[heads])
    jmodel = jbuild(jarch)
    jcfg = scheme_config("zero_topo", mesh, quant_block=64,
                         compute_dtype="float32")
    eng = ZeroEngine(jmodel.leaf_specs(), jcfg, mesh, TrainHparams())
    state = eng.init_state(jax.random.key(0))
    jres = jbuild_resident(eng, state, mesh)[1]
    ref = dict(mesh=mesh, arch=jarch, model=jmodel, eng=eng, state=state,
               res=jres)

    arch = reduced_arch(get_arch, REDUCTIONS[heads])
    assert arch.hdim == jarch.hdim == int(heads[2:])
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
# the block's plain ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [256, 384])
def test_layer_norm_and_gelu(d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((3, 5, d)) * 3 + 0.5).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    want = np.asarray(jax.jit(jlayers.layer_norm)(x, scale, bias))
    got = layers.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(layers.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.jit(jax.nn.gelu)(x)),
                               rtol=1e-6, atol=1e-6)
    # the tanh form, not the erf one: the two differ by more than 1e-4 here
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(x))).max() > 1e-4


FLASH_CASES = [
    (128, 128, 0, 0, None),     # the prefill's causal square, full extents
    (128, 128, 0, 0, 64),       # the same over 2 x 2 tiles of 64
    (64, 128, 64, 0, None),     # a query offset (the second half)
    (128, 128, 0, 32, 64),      # a window over tiles
]
FLASH_IDS = ["causal", "causal-tiled", "q_offset", "window-tiled"]


def _hold_flash(d, sq, sk, q_offset, window, tiles):
    assert d in HEAD_DIMS
    rng = np.random.default_rng(sq + q_offset + window)
    bh = 6
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    if tiles is None:
        oj = jax.jit(lambda a, b, c: jops.flash_attention(
            a, b, c, causal=True, window=window, q_offset=q_offset,
            impl="pallas_interpret"))(q, k, v)
    else:
        oj = flash_attention_pallas(q, k, v, causal=True, window=window,
                                    q_offset=q_offset, bb=1, bq=tiles,
                                    bk=tiles, interpret=True)
    ot = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=True, window=window, q_offset=q_offset)
    assert ot.shape == (bh, sq, d)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sq,sk,q_offset,window,tiles", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_attention_d96(sq, sk, q_offset, window, tiles):
    """The port's attention at NeoX's head width (its plain version on the
    CPU) against the reference's Pallas kernel in interpret mode: at full
    extents (the reference's own test configuration) and over 64 x 64 tiles
    (its online softmax across key tiles), within 1e-5."""
    _hold_flash(96, sq, sk, q_offset, window, tiles)


@pytest.mark.parametrize("sq,sk,q_offset,window,tiles", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_attention_d128(sq, sk, q_offset, window, tiles):
    """The same at gpt-neox-10b's head width, 128."""
    _hold_flash(128, sq, sk, q_offset, window, tiles)


@pytest.mark.parametrize("sq,sk,q_offset,window,tiles", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_attention_d256(sq, sk, q_offset, window, tiles):
    """The same at gemma3-1b's head width, 256."""
    _hold_flash(256, sq, sk, q_offset, window, tiles)


# ---------------------------------------------------------------------------
# the block kinds the port refuses
# ---------------------------------------------------------------------------

def _small(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=2,
                d_ff=128, vocab=64)
    base.update(kw)
    return ArchConfig(**base)


@pytest.mark.parametrize("cfg", [
    _small(family="moe", act="gelu", moe=MoEConfig(n_experts=4, d_ff=64)),
    _small(block_pattern=("mla",) * 2, mla=MLAConfig(32, 16, 16, 8, 16),
           norm="ln"),
    _small(block_pattern=("neox",) * 2, norm="rms", act="gelu"),
    _small(block_pattern=("neox",) * 2, norm="ln", act="silu_glu"),
    _small(norm="rms", act="gelu"),
    _small(block_pattern=("mamba_mlp",) * 2, act="gelu"),
    _small(block_pattern=("attn_moe",) * 2,
           moe=MoEConfig(n_experts=4, d_ff=64)),
    _small(block_pattern=("dec",) * 2, norm="ln", act="gelu"),
], ids=["moe-gelu", "mla", "neox-rms", "neox-glu", "attn-rms-gelu",
        "mamba-mlp-gelu", "attn-moe-no-rope", "dec-without-encoder"])
def test_unported_kinds_raise(cfg):
    """The kinds still unported raise. (The MoE FFN with SiLU-GLU experts,
    the patch prefix, MLA under RMSNorm with a GLU MLP, the
    encoder-decoder and jamba's mamba mixer with a GLU MLP or the MoE FFN
    are ported: tests/test_torch_moe.py, tests/test_torch_vlm.py,
    tests/test_torch_mla.py, tests/test_torch_whisper.py,
    tests/test_torch_jamba.py; an MoE of GELU experts, MLA under
    LayerNorm, a GELU MLP under RMSNorm (the reference gives it no biases
    there), a mamba mixer with the GELU MLP (the reference's
    ``block_specs`` overwrites the mixer's ``w_in``, (d, 2 d_inner), with
    the MLP's, (d, d_ff)), the MoE FFN behind attention without RoPE (no
    config has it) and a cross-attention block with no encoder are
    not.)"""
    with pytest.raises(NotImplementedError, match="not ported"):
        LM(cfg).leaf_specs()


@pytest.mark.parametrize("cfg,leaves", [
    (_small(block_pattern=("mla",) * 2, mla=MLAConfig(32, 16, 16, 8, 16)),
     {"mla.w_dq", "mla.q_norm", "mla.w_uq", "mla.w_dkv", "mla.kv_norm",
      "mla.w_ukv", "mla.wo"}),
    (_small(norm="ln", act="gelu"),
     {"attn.w_in", "attn.b_in", "attn.w_out_ff", "attn.b_out", "attn.ln2_b"}),
    (_small(block_pattern=("mamba_mlp",) * 2),
     {"mamba_mlp.w_in", "mamba_mlp.w_xproj", "mamba_mlp.A_log",
      "mamba_mlp.ln2", "mamba_mlp.w_gate", "mamba_mlp.w_up",
      "mamba_mlp.w_down"}),
    (_small(family="vlm", n_patches=4, block_pattern=("mamba_moe",) * 2,
            moe=MoEConfig(n_experts=4, d_ff=64)),
     {"mamba_moe.w_in", "mamba_moe.w_out", "mamba_moe.ln2",
      "mamba_moe.router", "mamba_moe.w_gate", "mamba_moe.w_up",
      "mamba_moe.w_down"}),
], ids=["mla", "attn-ln-gelu", "mamba-mlp", "patches-mamba-moe"])
def test_ported_kinds_build(cfg, leaves):
    """Kinds this test once held unported and the port now runs: MLA under
    RMSNorm with a GLU MLP, sequential attention with the GELU MLP and
    its biases under LayerNorm (whisper's decoder block, without the
    cross-attention), and jamba's mamba mixer with a GLU MLP or the MoE FFN
    (here behind a patch prefix): their leaves build, the reference's
    leaves in the reference's order."""
    from repro.models.config import ArchConfig as JArch
    from repro.models.config import MLAConfig as JMLA
    from repro.models.config import MoEConfig as JMoE
    from repro.models.transformer import LM as JLM

    specs = LM(cfg).leaf_specs()
    assert leaves <= set(specs)
    kw = {f: getattr(cfg, f) for f in ("name", "family", "n_layers",
                                       "d_model", "n_heads", "d_ff", "vocab",
                                       "block_pattern", "norm", "act",
                                       "n_patches")}
    if cfg.mla is not None:
        kw["mla"] = JMLA(32, 16, 16, 8, 16)
    if cfg.moe.n_experts:
        kw["moe"] = JMoE(n_experts=4, d_ff=64)
    want = JLM(JArch(**kw)).leaf_specs()
    assert list(specs) == list(want)
    for n, sp in specs.items():
        assert (sp.shape, sp.kind, sp.stack) == (want[n].shape, want[n].kind,
                                                 want[n].stack), n


# ---------------------------------------------------------------------------
# weights and the residency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", HEADS)
def test_convert_carries_primaries(heads):
    ref, port = _pair(heads)
    names = set(ref["state"]["primaries"])
    assert set(port["prim"]) == names
    assert {"final_norm_b", "neox.ln1_b", "neox.ln2_b", "neox.b_in",
            "neox.b_out", "neox.w_in", "neox.w_out_ff", "lm_head"} <= names
    for name, a in ref["state"]["primaries"].items():
        t = port["prim"][name]
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("heads", HEADS)
def test_residency_bitwise(heads):
    ref, port = _pair(heads)
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
    assert sorted(wire) == ["embed", "lm_head", "neox.w_in", "neox.w_out_ff",
                            "neox.wk", "neox.wo", "neox.wq", "neox.wv"]


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


@pytest.mark.parametrize("heads", HEADS)
def test_prefill_logits_and_caches(heads):
    ref, port = _pair(heads)
    arch = port["arch"]
    tokens = _tokens(0, (2, 16), arch.vocab)
    (jl, jc), (tl, tc) = _prefill_both(ref, port, tokens)
    assert tl.shape == (2, arch.vocab) and tl.dtype == torch.float32
    assert set(tc) == set(jc) == {"neox", "pos"}
    for name in ("k", "v"):
        assert tc["neox"][name].shape == (2, 2, 16, arch.kv_heads, arch.hdim)
        np.testing.assert_allclose(tc["neox"][name].numpy(),
                                   np.asarray(jc["neox"][name]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 16


def _bf16_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("heads", HEADS)
def test_decode_teacher_forced(heads):
    """Decode a fixed token sequence over the bf16 cache the server keeps;
    logits agree per step within 1e-4. Each port step starts from the
    reference's cache of that step (a 1e-6 difference in an f32 K/V value
    can move its bf16 rounding by one ulp), and the caches each side writes
    are held to one bf16 rounding (rtol 2**-7) of values that agree to 1e-4,
    the logits' tolerance: a layer's new K/V value that rounds to the other
    bf16 neighbour on the two sides is attended in the same step, and so
    moves the next layer's new K/V (by 3e-5 at most, at values up to 4.2,
    in these cases)."""
    ref, port = _pair(heads)
    plen, max_len, steps = 8, 16, 4
    tokens = _tokens(1, (2, plen), port["arch"].vocab)
    forced = _tokens(2, (steps, 2), port["arch"].vocab)
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
        tc = {"neox": {n: _bf16_torch(jc["neox"][n]) for n in ("k", "v")},
              "pos": torch.tensor(int(jc["pos"]), dtype=torch.int32)}
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1
        for n in ("k", "v"):
            np.testing.assert_allclose(
                tc["neox"][n].float().numpy(),
                np.asarray(jc["neox"][n]).astype(np.float32),
                rtol=2 ** -7, atol=1e-4, err_msg=f"cache {n}, step {i}")


# ---------------------------------------------------------------------------
# the continuous batcher and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("case", [
    # 3 requests recycle 2 slots
    dict(n_slots=2, max_len=24, prompt_len=8, page_size=4, n_pages=0,
         n_req=3, max_new=5, max_queue_steps=0, expect=None),
    # oversubscribed: lazy page growth runs the free list dry mid-decode,
    # the youngest slot is preempted and requeued
    dict(n_slots=3, max_len=32, prompt_len=8, page_size=8, n_pages=4,
         n_req=4, max_new=8, max_queue_steps=50, expect="preempted"),
], ids=["provisioned", "oversubscribed"])
def test_batcher_tokens_and_counters(case, heads):
    ref, port = _pair(heads)
    vocab = port["arch"].vocab
    prompts = [_tokens(30 + i, (case["prompt_len"],), vocab)
               for i in range(case["n_req"])]
    common = dict(n_slots=case["n_slots"], max_len=case["max_len"],
                  prompt_len=case["prompt_len"],
                  page_size=case["page_size"] or None,
                  n_pages=case["n_pages"])
    slo = dict(max_queue_steps=case["max_queue_steps"])

    jcb = JBatcher(ref["model"], ref["eng"], ref["mesh"], backend="resident",
                   slo=JSLO(**slo), **common)
    jreqs = [JRequest(rid=i, prompt=p, max_new=case["max_new"])
             for i, p in enumerate(prompts)]
    jcb.run(ref["res"], jreqs)

    cb = ContinuousBatcher(port["model"], port["layout"], device="cpu",
                           slo=ServeSLO(**slo), **common)
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
    assert "arch=gpt-neox-20b-reduced" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    assert "-> 12 tokens" in out
