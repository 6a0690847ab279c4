"""whisper-medium (the encoder-decoder) in the port against the JAX package.

whisper-medium (arXiv:2212.04356): 24 ``enc`` layers over 1,500
precomputed frame embeddings (the conv / mel front end is a stub in both
packages) plus sinusoidal positions, non-causal, no RoPE; 24 ``dec``
layers, each self-attention (causal, no RoPE), cross-attention over the
encoder's output, then the GELU MLP with biases; d_model 1,024, 16 heads of
64, LayerNorm, QKV bias, untied vocab 51,865. On ``reduced()`` (2 + 2
layers, d_model 256, 4 heads of 64, 32 frames, vocab 512), with the
reference set up as its serving tests set it up (zero_topo, quant_block 64,
f32; ``test_torch_serve._pair``).

Both attention routes: 32 frames are a whole tile, so the encoder and the
cross-attention take the kernel route (its plain version here, as the
reference's Pallas kernel runs its jnp oracle); 160 frames are not (past
128, not a multiple of it), so both take the chunked plain path (``seq_unaligned``: one fallback an encoder
layer and one a decoder layer's cross-attention), as 1,500 frames do at
published size. The decoder's self-attention takes the kernel route at
every prompt here.

Tolerances and their causes:

- the batches with frames (``SyntheticTokens``, drawn after the tokens from
  the same generator) and the residency bit for bit;
- prefill logits and every cache (self K/V, cross ``kx`` / ``vx``) within
  1e-4 (rtol and atol): f32 matmuls in another order, and the sinusoid's
  ``exp``, ``sin`` and ``cos`` a few f32 ulp apart;
- teacher-forced decode logits within 1e-4 a step, each port step from the
  reference's bf16 caches of that step (hold_decode's reason), the self
  K/V held to one bf16 rounding; greedy tokens equal;
- the zero_topo step at (1, 1, 1) (both frame counts) and forced on four
  ranks at (1, 2, 2) (each step from the reference's state before it):
  loss within 3e-5, grad norm within 2e-4 relative (slice 2's tolerances;
  tests/test_torch_train.py says why);
- both packages' continuous batchers refuse the model (text prompts only),
  and so does the port's serving CLI.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data.pipeline import SyntheticTokens as JTokens
from repro.data.pipeline import spec_for as jspec_for
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatcher as JBatcher
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import _grow_seq

from repro_torch.core.engine import TrainHparams, ZeroEngine
from repro_torch.data.pipeline import SyntheticTokens, spec_for
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident)
from repro_torch.serve.scheduler import ContinuousBatcher
import test_torch_serve as ts
import test_torch_train as tt
from test_torch_train import (RUN, _check,  # noqa: F401
                              assert_state_converts, one_torch_thread,
                              port_run, reference_run)

ARCH = "whisper-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
WIRE = ["dec.w_in", "dec.w_out_ff", "dec.wk", "dec.wk_x", "dec.wo",
        "dec.wo_x", "dec.wq", "dec.wq_x", "dec.wv", "dec.wv_x", "embed",
        "enc.w_in", "enc.w_out_ff", "enc.wk", "enc.wo", "enc.wq", "enc.wv",
        "lm_head"]
UNALIGNED = "attention/fallback/seq_unaligned"
FRAMES = [32, 160]                 # the kernel route, the chunked path


def test_config_is_the_reference_one():
    a, j = get_arch(ARCH), jget(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "hdim", "d_ff",
              "vocab", "norm", "act", "qkv_bias", "tie_embeddings",
              "pattern", "family", "enc_layers", "n_frames", "source"):
        assert getattr(a, f) == getattr(j, f), f
        assert getattr(a.reduced(), f) == getattr(j.reduced(), f), f
    assert (a.enc_layers, a.n_frames, a.reduced().n_frames) == (24, 1500, 32)


@pytest.mark.parametrize("seq", [32, 128])
def test_batches_with_frames_bitwise(seq):
    """The port's stream draws the frames after the tokens from the same
    generator: every array of every batch bit for bit the reference's."""
    for arch, jarch in ((get_arch(ARCH), jget(ARCH)),
                        (get_arch(ARCH).reduced(), jget(ARCH).reduced())):
        spec = spec_for(arch, 2, seq)
        jspec = jspec_for(jarch, JShape("t", seq, 2, "train"))
        for step in (0, 3):
            got = SyntheticTokens(spec, seed=1).batch(step)
            want = JTokens(jspec, seed=1).batch(step)
            assert set(got) == set(want) == {"tokens", "frames"}
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            assert got["frames"].shape == (2, arch.n_frames, arch.d_model)


def test_batch_and_cache_shapes_as_the_reference():
    """Prefill and train batches add ``frames`` (B, F, d) bf16; a decoder
    block caches its self K/V (sequence-indexed) and its cross K/V over
    all frames (not sequence-indexed: never paged, never sharded)."""
    model, jmodel = build_model(get_arch(ARCH)), jbuild(jget(ARCH))
    shape, jshape = ShapeConfig("t", 448, 2, "train"), JShape("t", 448, 2,
                                                             "train")
    for fn in ("train_batch_shapes", "prefill_batch_shapes"):
        got, want = getattr(model, fn)(shape), getattr(jmodel, fn)(jshape)
        assert {k: v[0] for k, v in got.items()} == \
            {k: v[0] for k, v in want.items()}
        assert got["frames"] == ((2, 1500, 1024), torch.bfloat16)
    got = model.cache_shapes(shape)
    want = jmodel.cache_shapes(jshape)
    assert set(got) == set(want) == {"dec"}
    for n, (sh, _, seq) in got["dec"].items():
        assert (sh, seq) == (want["dec"][n][0], want["dec"][n][2]), n
    assert got["dec"]["kx"][0] == (24, 2, 1500, 16, 64)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _inputs(arch, b: int, s: int, n_frames: int, seed: int):
    tokens = ts._tokens(seed, (b, s), arch.vocab)
    frames = (np.random.default_rng(seed + 100).standard_normal(
        (b, n_frames, arch.d_model)) * 0.02).astype(np.float32)
    return tokens, frames


def _prefill_both(ref, port, tokens, frames):
    b, s = tokens.shape
    jpre = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("p", s, b, "decode")).make_prefill()
    jl, jc = jpre(ref["res"], {"tokens": jnp.asarray(tokens),
                               "frames": jnp.asarray(frames)})
    pre = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("p", s, b, "decode")).make_prefill()
    ops.reset_dispatch_counters()
    tl, tc = pre(port["res"], {"tokens": torch.as_tensor(tokens).long(),
                               "frames": torch.from_numpy(frames)})
    return (jl, jc), (tl, tc)


def _expected_fallbacks(arch, n_frames: int) -> dict:
    """A prefill's fallbacks: none where the frames fill whole tiles, else
    one an encoder layer and one a decoder layer's cross-attention."""
    if ops.attention_fusable(n_frames, n_frames, arch.hdim, arch.hdim)[0]:
        return {}
    return {UNALIGNED: arch.enc_layers + arch.n_layers}


def test_residency_bitwise():
    ref, port = ts._pair(ARCH)
    ts.hold_convert(ref, port)
    ts.hold_residency(ref, port, WIRE)


@pytest.mark.parametrize("n_frames", FRAMES)
def test_prefill_logits_and_caches(n_frames):
    ref, port = ts._pair(ARCH)
    tokens, frames = _inputs(port["arch"], 2, 16, n_frames, 0)
    (jl, jc), (tl, tc) = _prefill_both(ref, port, tokens, frames)
    assert ops.dispatch_counters() == _expected_fallbacks(port["arch"],
                                                          n_frames)
    assert tl.shape == (2, port["arch"].vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc["dec"]) == {"k", "v", "kx", "vx"}
    for n in ("k", "v", "kx", "vx"):
        np.testing.assert_allclose(tc["dec"][n].numpy(),
                                   np.asarray(jc["dec"][n]), **TOL, err_msg=n)
    assert tc["dec"]["kx"].shape == (2, 2, n_frames, 4, 64)
    assert int(tc["pos"]) == int(jc["pos"]) == 16


@pytest.mark.parametrize("n_frames", FRAMES)
def test_decode_teacher_forced(n_frames):
    """Decode at a shared position over the bf16 caches (the cross caches
    as the prefill left them), each port step from the reference's caches
    of that step."""
    ref, port = ts._pair(ARCH)
    plen, max_len, steps = 8, 16, 6
    tokens, frames = _inputs(port["arch"], 2, plen, n_frames, 1)
    forced = ts._tokens(2, (steps, 2), port["arch"].vocab)
    (_, jc), _ = _prefill_both(ref, port, tokens, frames)
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
        tc = {"dec": {n: ts._bf16_torch(a) for n, a in jc["dec"].items()},
              "pos": torch.tensor(int(jc["pos"]), dtype=torch.int32)}
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1
        for n in ("k", "v"):
            np.testing.assert_allclose(
                tc["dec"][n].float().numpy(),
                np.asarray(jc["dec"][n]).astype(np.float32),
                rtol=2 ** -7, atol=1e-5, err_msg=f"cache {n}, step {i}")


def test_generate_greedy_tokens():
    ref, port = ts._pair(ARCH)
    tokens, frames = _inputs(port["arch"], 2, 8, 160, 3)
    batch = {"tokens": tokens, "frames": frames}
    jtoks = JEngine(ref["model"], ref["eng"], ref["mesh"],
                    JShape("g", 12, 2, "decode")).generate(
        ref["res"], {k: jnp.asarray(v) for k, v in batch.items()}, 4)
    ttoks = ResidentServeEngine(port["model"], port["layout"],
                                ShapeConfig("g", 12, 2, "decode")).generate(
        port["res"], {k: torch.from_numpy(v) for k, v in batch.items()}, 4)
    assert ttoks.shape == (2, 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_resident_is_gathered_bitwise():
    """Prefill with frames and 3 decode steps: the gathered backend's
    logits bit for bit the resident one's."""
    _, port = ts._pair(ARCH)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=64,
                        compute_dtype="float32")
    eng = ZeroEngine(port["model"].leaf_specs(), cfg, mesh, TrainHparams(),
                     device="cpu")
    layout = ResidentLayout(eng.specs, cfg)
    res = build_resident(layout, port["prim"].items())
    tokens, frames = _inputs(port["arch"], 2, 8, 32, 4)
    shape = ShapeConfig("t", 11, 2, "decode")
    batch = {"tokens": torch.as_tensor(tokens).long(),
             "frames": torch.from_numpy(frames)}
    outs = []
    for se, params in ((ServeEngine(port["model"], eng, mesh, shape),
                        port["prim"]),
                       (ResidentServeEngine(port["model"], layout, shape),
                        res)):
        logits, caches = se.make_prefill()(params, batch)
        for n in ("k", "v"):
            caches["dec"][n] = torch.nn.functional.pad(
                caches["dec"][n], (0, 0, 0, 0, 0, 3))
        got = [logits]
        for i in range(3):
            logits, caches = se.make_decode()(
                params, caches, {"token": torch.full((2,), 5 + i,
                                                     dtype=torch.long)})
            got.append(logits)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_batchers_and_cli_refuse_whisper():
    """The reference's batcher admits {"tokens"} alone: its first prefill
    fails without the frames. The port's refuses at construction, and its
    serving CLI before it builds anything."""
    ref, port = ts._pair(ARCH)
    jcb = JBatcher(ref["model"], ref["eng"], ref["mesh"], backend="resident",
                   n_slots=2, max_len=32, prompt_len=8)
    with pytest.raises(ValueError, match="frames"):
        jcb.run(ref["res"], [JRequest(rid=0, prompt=ts._tokens(0, (8,), 512),
                                      max_new=2)])
    with pytest.raises(ValueError, match="text prompts only.*encoder"):
        ContinuousBatcher(port["model"], port["layout"], device="cpu",
                          n_slots=2, max_len=32, prompt_len=8)
    with pytest.raises(SystemExit, match="text prompts only.*encoder"):
        serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                        "--requests", "1"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runs(mesh1, tmp_path_factory):
    """The reference's forced 3 steps on (1, 1, 1) at each frame count, run
    once: {n_frames: its directory}."""
    runs = {}

    def run(n_frames: int):
        if n_frames not in runs:
            out = tmp_path_factory.mktemp(f"ref{n_frames}")
            reference_run(mesh1, out, arch=f"{ARCH}@f{n_frames}", forced=True)
            runs[n_frames] = out
        return runs[n_frames]
    return run


@pytest.mark.parametrize("n_frames", FRAMES)
def test_train_step_one_device(ref_runs, n_frames):
    """(1, 1, 1), seq 32: each step from the reference's state before it;
    at 160 frames two fallbacks an encoder layer and two a decoder layer a
    step (the forward and its checkpointed recompute). At 32 frames also
    the free-running run through the train CLI's ``run``."""
    arch, out = f"{ARCH}@f{n_frames}", ref_runs(n_frames)
    ref = json.loads((out / "metrics.json").read_text())
    ops.reset_dispatch_counters()
    forced = tt.port_forced_rank(0, (1, 1, 1), arch, RUN["seq"], out)
    want = _expected_fallbacks(get_arch(ARCH).reduced(), n_frames)
    assert ops.dispatch_counters() == {k: 2 * RUN["steps"] * n
                                       for k, n in want.items()}
    _check(ref, forced)
    if n_frames == 32:
        (free,) = port_run(out, (1, 1, 1), arch=arch)
        _check(ref, free)
        assert free["fallbacks"] == {}


def test_convert_carries_encoder_state(ref_runs):
    """``from_jax_state``: the encoder's leaves, its final norm and the
    cross leaves bit for bit in every state dict."""
    assert_state_converts(ARCH, ref_runs(32) / "state.npz",
                          ("enc.wq", "enc.bq", "enc.ln1_b", "enc.w_out_ff",
                           "enc_norm", "enc_norm_b", "dec.wq_x", "dec.wo_x",
                           "dec.ln_x", "dec.ln_x_b"))


def test_train_step_four_ranks(tmp_path):
    """(1, 2, 2): the reference on 4 host devices in a subprocess (forced:
    its state before every step), the port's steps from those states on 4
    gloo ranks within slice 2's tolerances, the same global loss and grad
    norm on every rank."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, tt.__file__, str(tmp_path), "1,2,2",
                          "zero_topo", ARCH, str(RUN["seq"]), "1"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    ref = json.loads((tmp_path / "metrics.json").read_text())
    forced = tt.run_ranks(tt.port_forced_rank, 4, tmp_path / "forced",
                          (1, 2, 2), ARCH, RUN["seq"], tmp_path)
    for f in forced:
        assert f == forced[0]
    _check(ref, forced[0])


def test_train_cli_cpu(capfd):
    from repro_torch.launch import train as train_cli
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--devices", "4", "--steps", "2", "--seq", "32",
                    "--batch", "4"])
    out = capfd.readouterr().out
    assert f"arch={ARCH}-reduced" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "final loss: " in out
