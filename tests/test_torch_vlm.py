"""internvl2-1b in the port against the JAX package: the VLM patch prefix.

internvl2-1b (arXiv:2404.16821) is qwen2-0.5b's decoder (GQA 14/2, QKV
bias, tied vocab of 151,655) behind 256 precomputed patch embeddings (the
vision tower is a stub in both packages: its output is an input). On
``reduced()`` (2 layers, d_model 256, 4 heads of 64 over 2, vocab 512, 16
patches), with the reference set up as its serving tests set it up
(zero_topo, quant_block 64, f32, (1, 1, 1)):

- ``SyntheticTokens`` with patches (``spec_for``: the text is the sequence
  less the patches) bit for bit the reference's batches;
- the residency bit for bit; prefill logits and caches (patches and text
  positions) within 1e-4; teacher-forced decode after the prefix within
  1e-4 (the bf16 caches one bf16 rounding); ``generate``'s greedy tokens
  equal; the gathered backend bit for bit the resident one;
- the zero_topo step at (1, 1, 1) within slice 2's tolerances (loss 3e-5,
  grad norm 2e-4), the loss over the text positions only;
- the continuous batcher takes text prompts only in both packages (the
  reference's admits {"tokens"} alone, src/repro/serve/scheduler.py:180):
  both refuse a patch model, the port's with a clear error, and so does the
  port's serving CLI.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data.pipeline import SyntheticTokens as JTokens
from repro.data.pipeline import spec_for as jspec_for
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import _grow_seq

from repro_torch.core.engine import TrainHparams, ZeroEngine
from repro_torch.data.pipeline import SyntheticTokens, spec_for
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident)
from repro_torch.serve.scheduler import ContinuousBatcher
import test_torch_serve as ts
from test_torch_train import (_check, one_torch_thread,  # noqa: F401
                              port_run, reference_run)

ARCH = "internvl2-1b"
TOL = dict(rtol=1e-4, atol=1e-4)
WIRE = ["attn.w_down", "attn.w_gate", "attn.w_up", "attn.wk", "attn.wo",
        "attn.wq", "attn.wv", "embed"]


def test_config_is_the_reference_one():
    a, j = get_arch(ARCH), jget(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "hdim", "d_ff",
              "vocab", "rope_theta", "norm", "act", "qkv_bias",
              "tie_embeddings", "n_patches", "pattern", "source"):
        assert getattr(a, f) == getattr(j, f), f
    assert (a.n_patches, a.d_model, a.vocab) == (256, 896, 151_655)
    assert a.reduced().n_patches == j.reduced().n_patches == 16


@pytest.mark.parametrize("seq", [32, 300])
def test_batches_with_patches_bitwise(seq):
    """The port's stream draws the patches after the tokens from the same
    generator: every array of every batch bit for bit the reference's."""
    for arch in (get_arch(ARCH), get_arch(ARCH).reduced()):
        if seq <= arch.n_patches:
            continue
        spec = spec_for(arch, 4, seq)
        jspec = jspec_for(jget(ARCH) if arch.n_patches == 256
                          else jget(ARCH).reduced(), JShape("t", seq, 4,
                                                            "train"))
        assert spec.seq_len == jspec.seq_len == seq - arch.n_patches
        for step in (0, 3):
            got = SyntheticTokens(spec, seed=1).batch(step)
            want = JTokens(jspec, seed=1).batch(step)
            assert set(got) == set(want) == {"tokens", "patches"}
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            assert got["patches"].shape == (4, arch.n_patches, arch.d_model)


def test_batch_shapes_count_the_patches():
    model = build_model(get_arch(ARCH))
    shape = ShapeConfig("t", 384, 2, "train")
    assert model.train_batch_shapes(shape)["tokens"][0] == (2, 129)
    assert model.prefill_batch_shapes(shape) == {
        "tokens": ((2, 128), torch.int32),
        "patches": ((2, 256, 896), torch.bfloat16)}
    assert model.cache_shapes(shape)["attn"]["k"][0] == (24, 2, 384, 2, 64)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _inputs(port, b: int, s_text: int, seed: int):
    a = port["arch"]
    tokens = ts._tokens(seed, (b, s_text), a.vocab)
    patches = (np.random.default_rng(seed + 100).standard_normal(
        (b, a.n_patches, a.d_model)) * 0.02).astype(np.float32)
    return tokens, patches


def _prefill_both(ref, port, tokens, patches):
    b, s = tokens.shape
    s_all = s + port["arch"].n_patches
    jpre = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("p", s_all, b, "decode")).make_prefill()
    jl, jc = jpre(ref["res"], {"tokens": jnp.asarray(tokens),
                               "patches": jnp.asarray(patches)})
    pre = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("p", s_all, b, "decode")
                              ).make_prefill()
    tl, tc = pre(port["res"], {"tokens": torch.as_tensor(tokens).long(),
                               "patches": torch.from_numpy(patches)})
    return (jl, jc), (tl, tc)


def test_residency_bitwise():
    ref, port = ts._pair(ARCH)
    ts.hold_convert(ref, port)
    ts.hold_residency(ref, port, WIRE)


def test_prefill_logits_and_caches():
    ref, port = ts._pair(ARCH)
    tokens, patches = _inputs(port, 2, 16, 0)
    (jl, jc), (tl, tc) = _prefill_both(ref, port, tokens, patches)
    assert tl.shape == (2, port["arch"].vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        assert tc["attn"][n].shape[2] == 32            # 16 patches + 16 text
        np.testing.assert_allclose(tc["attn"][n].numpy(),
                                   np.asarray(jc["attn"][n]), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 32


def test_decode_teacher_forced():
    """Decode after the prefix at positions 24 ... 29 over the bf16 caches,
    each port step from the reference's caches (hold_decode's
    tolerances)."""
    ref, port = ts._pair(ARCH)
    tokens, patches = _inputs(port, 2, 8, 1)
    plen, max_len, steps = 8 + port["arch"].n_patches, 32, 6
    forced = ts._tokens(2, (steps, 2), port["arch"].vocab)
    (_, jc), _ = _prefill_both(ref, port, tokens, patches)
    jc = _grow_seq(jc, ref["model"], max_len)
    jc = {k: (v if k == "pos" else
              {n: a.astype(jnp.bfloat16) for n, a in v.items()})
          for k, v in jc.items()}
    jdec = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("d", max_len, 2, "decode")).make_decode()
    dec = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("d", max_len, 2, "decode")
                              ).make_decode()
    for i in range(steps):
        tc = {"attn": {n: ts._bf16_torch(jc["attn"][n]) for n in ("k", "v")},
              "pos": torch.tensor(int(jc["pos"]), dtype=torch.int32)}
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1


def test_generate_greedy_tokens():
    ref, port = ts._pair(ARCH)
    tokens, patches = _inputs(port, 2, 8, 3)
    s_all = 8 + port["arch"].n_patches
    jtoks = JEngine(ref["model"], ref["eng"], ref["mesh"],
                    JShape("g", s_all + 4, 2, "decode")).generate(
        ref["res"], {"tokens": jnp.asarray(tokens),
                     "patches": jnp.asarray(patches)}, 4)
    ttoks = ResidentServeEngine(port["model"], port["layout"],
                                ShapeConfig("g", s_all + 4, 2, "decode")
                                ).generate(
        port["res"], {"tokens": torch.as_tensor(tokens).long(),
                      "patches": torch.from_numpy(patches)}, 4)
    assert ttoks.shape == (2, 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_resident_is_gathered_bitwise():
    """Prefill with the patch prefix and 3 decode steps: the gathered
    backend's logits bit for bit the resident one's."""
    _, port = ts._pair(ARCH)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=64,
                        compute_dtype="float32")
    eng = ZeroEngine(port["model"].leaf_specs(), cfg, mesh, TrainHparams(),
                     device="cpu")
    layout = ResidentLayout(eng.specs, cfg)
    res = build_resident(layout, port["prim"].items())
    tokens, patches = _inputs(port, 2, 8, 4)
    s_all = 8 + port["arch"].n_patches
    shape = ShapeConfig("t", s_all + 3, 2, "decode")
    batch = {"tokens": torch.as_tensor(tokens).long(),
             "patches": torch.from_numpy(patches)}
    outs = []
    for se, params in ((ServeEngine(port["model"], eng, mesh, shape),
                        port["prim"]),
                       (ResidentServeEngine(port["model"], layout, shape),
                        res)):
        logits, caches = se.make_prefill()(params, batch)
        caches = {k: v if k == "pos" else
                  {n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 3))
                   for n, t in v.items()} for k, v in caches.items()}
        got = [logits]
        for i in range(3):
            logits, caches = se.make_decode()(
                params, caches, {"token": torch.full((2,), 5 + i,
                                                     dtype=torch.long)})
            got.append(logits)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_batchers_refuse_a_patch_model():
    """Both packages' continuous batchers take text prompts only: the
    reference's fails at its first prefill (its batch of {"tokens"} does
    not match the prefill's inputs, which hold the patches), the
    port's refuses at construction; the port's serving CLI refuses before
    it builds anything."""
    ref, port = ts._pair(ARCH)
    jcb = JBatcher(ref["model"], ref["eng"], ref["mesh"], backend="resident",
                   n_slots=2, max_len=48, prompt_len=8)
    with pytest.raises(ValueError, match="patches"):
        jcb.run(ref["res"], [JRequest(rid=0, prompt=ts._tokens(0, (8,), 512),
                                      max_new=2)])
    with pytest.raises(ValueError, match="text prompts only"):
        ContinuousBatcher(port["model"], port["layout"], device="cpu",
                          n_slots=2, max_len=48, prompt_len=8)
    with pytest.raises(SystemExit, match="text prompts only"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                        "--requests", "1"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_one_device(mesh1, tmp_path):
    """3 steps at (1, 1, 1), sequence 32 = 16 patches + 16 text tokens."""
    ref = reference_run(mesh1, tmp_path, arch=ARCH)
    (port,) = port_run(tmp_path, (1, 1, 1), arch=ARCH)
    _check(ref, port)
    assert port["fallbacks"] == {}
