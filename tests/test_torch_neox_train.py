"""The port's GPT-NeoX training step, and the chunked attention fallback,
against the JAX package.

The NeoX step is test_torch_train.py's run (zero_topo, quant_block=64,
compute_dtype float32, lr 1e-3 with warmup 2 of 3 steps, global batch 4 x
seq 32 of ``SyntheticTokens`` seed 0, both sides from the reference's
``init_state``) with the arch a parameter, on three reductions of the
paper's models (test_torch_train.reduced_arch): gpt-neox-20b's
``reduced()`` (4 heads of 64), gpt-neox-20b at 4 heads of 96 and
gpt-neox-10b at 4 heads of 128. NeoX's block trains an untied ``lm_head``
and the LayerNorm biases (``neox.ln1_b``, ``neox.ln2_b``, ``final_norm_b``)
that qwen2's does not. Tolerances are slice 2's (LOSS_RTOL 3e-5,
GNORM_RTOL 2e-4); on (1, 2, 2) the INT4 a2a, the fused ``matmul_quant`` dW
and the secondary re-gather run, with the untied head's gradient on the
unfused quantize path.

The chunked fallback (models/layers.py ``_chunked_attention``): prefill
logits and K/V caches at prompt lengths 4 and 200 (rtol = atol = 1e-4, the
serving slices' tolerance), a train step at seq 200 (slice 2's), and the
fallback counter. The reference counts at trace time and its uniform
models trace the layer body once (``lax.scan``); the port runs eagerly and
counts each layer's call, so a port prefill counts ``n_layers`` times the
reference's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.engine import TrainHparams as JHparams
from repro.core.engine import ZeroEngine as JZeroEngine
from repro.kernels import ops as jops
from repro.launch.mesh import make_test_mesh, scheme_config as jscheme
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import build_model as jbuild, get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.resident import build_resident as jbuild_resident

from repro_torch.convert import from_jax_primaries, load_global_state
from repro_torch.core.partition import single_device_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident)
from test_torch_train import (AX, RUN, _check,  # noqa: F401
                              assert_state_converts, four_rank_run,
                              one_torch_thread, port_run, port_train_state,
                              reduced_arch, reference_run)

NEOX = ["gpt-neox-20b", "gpt-neox-20b@hd96", "gpt-neox-10b@hd128"]
HD128 = "gpt-neox-10b@hd128"
NEOX_ONLY = ("lm_head", "final_norm_b", "neox.ln1_b", "neox.ln2_b")
TOL = dict(rtol=1e-4, atol=1e-4)
FALLBACK = "attention/fallback/seq_unaligned"


def _fallbacks(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if "/fallback/" in k}


# ---------------------------------------------------------------------------
# the NeoX training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,hd", zip(NEOX, (64, 96, 128)),
                         ids=["hd64", "hd96", "hd128"])
def test_neox_train_step_one_device(mesh1, tmp_path, arch, hd):
    assert reduced_arch(get_arch, arch).hdim == hd
    ref = reference_run(mesh1, tmp_path, arch=arch)
    (port,) = port_run(tmp_path, (1, 1, 1), arch=arch)
    _check(ref, port)
    assert port["fallbacks"] == {}


def test_neox_train_step_four_ranks(tmp_path):
    """(1, 2, 2) at head dim 128: 4 gloo ranks against the reference on 4
    host devices; every rank reports the same global loss and grad norm."""
    ref, ports = four_rank_run(tmp_path, (1, 2, 2), arch=HD128)
    assert [p["rank"] for p in ports] == [0, 1, 2, 3]
    for p in ports:
        assert p["losses"] == ports[0]["losses"]
        assert p["grad_norms"] == ports[0]["grad_norms"]
        assert p["fallbacks"] == {}
    _check(ref, ports[0])


@pytest.fixture(scope="module")
def hd128_run(mesh1, tmp_path_factory):
    """The reference's 3 steps at head dim 128 on (1, 1, 1): its initial
    state (``state.npz``) and the final masters of NEOX_ONLY
    (``final.npz``), in the returned directory."""
    out = tmp_path_factory.mktemp("hd128")
    reference_run(mesh1, out, arch=HD128, final_leaves=NEOX_ONLY)
    return out


def test_neox_only_leaves_train(hd128_run):
    """The untied head and the LayerNorm biases move over 3 steps (the
    first at lr 0) and land where the reference's do, at head dim 128.
    AdamW moves an element about lr = 1e-3 a step (median 1.1e-3 over the
    two steps here). The biases agree within 5e-6 (measured 5.2e-7 at most);
    ``lm_head`` within 1e-4 (measured 1.02e-5, on 27 of its 262,144
    elements over 1e-6, on one torch thread or all): an element whose
    gradient is near 0 turns a f32 difference of order in its sum into a
    visible change of m / sqrt(v)."""
    init = load_global_state(hd128_run / "state.npz")["master"]
    state = port_train_state(HD128, hd128_run / "state.npz", RUN["steps"])
    with np.load(hd128_run / "final.npz") as z:
        for name in NEOX_ONLY:
            got = state["master"][name].numpy()
            want = z[name]
            moved = np.abs(want - init[name].numpy()).max()
            assert moved > 1e-4, (name, moved)
            atol = 1e-4 if name == "lm_head" else 5e-6
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=name)


def test_convert_carries_neox_state(hd128_run):
    """``from_jax_state`` on the D = 128 reduction: ``lm_head`` and the
    ``_b`` leaves bit for bit in every state dict."""
    assert_state_converts(HD128, hd128_run / "state.npz",
                          NEOX_ONLY + ("neox.b_in", "neox.b_out"))


# ---------------------------------------------------------------------------
# the chunked attention fallback
# ---------------------------------------------------------------------------

def _serve_pair(arch: str):
    """(reference setup, port setup) on (1, 1, 1) sharing one set of
    weights, as tests/test_torch_serve.py sets them up."""
    mesh = make_test_mesh(shape=(1, 1, 1), axes=AX)
    jmodel = jbuild(reduced_arch(jget, arch))
    jcfg = jscheme("zero_topo", mesh, quant_block=64, compute_dtype="float32")
    eng = JZeroEngine(jmodel.leaf_specs(), jcfg, mesh, JHparams())
    state = eng.init_state(jax.random.key(0))
    ref = dict(mesh=mesh, model=jmodel, eng=eng,
               res=jbuild_resident(eng, state, mesh)[1])
    a = reduced_arch(get_arch, arch)
    model = build_model(a)
    layout = ResidentLayout(model.leaf_specs(), single_device_config(
        "zero_topo", quant_block=64, compute_dtype="float32"))
    prim = from_jax_primaries(
        {n: np.asarray(v) for n, v in state["primaries"].items()}, a,
        device="cpu")
    port = dict(arch=a, model=model, layout=layout,
                res=build_resident(layout, prim.items()))
    return ref, port


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gpt-neox-20b"],
                         ids=["qwen2", "neox"])
def test_chunked_prefill(arch):
    """Prefill logits and K/V caches at prompt lengths 4 and 200 (both
    rejected by the gate: under 8, and over 128 off its multiple) through
    the chunked fallback, within 1e-4 of the reference; the fallback is
    counted under the reference's key, once per layer call; a prompt of 128
    (fusable) still reaches the kernel dispatch, once a layer."""
    ref, port = _serve_pair(arch)
    a = port["arch"]
    kind = a.pattern[0]
    for plen in (4, 200):
        tokens = np.random.default_rng(plen).integers(
            0, a.vocab, (2, plen)).astype(np.int32)
        jops.reset_dispatch_counters()
        jl, jc = JEngine(ref["model"], ref["eng"], ref["mesh"],
                         JShape("p", plen, 2, "decode")).make_prefill()(
            ref["res"], {"tokens": jnp.asarray(tokens)})
        ops.reset_dispatch_counters()
        tl, tc = ResidentServeEngine(
            port["model"], port["layout"],
            ShapeConfig("p", plen, 2, "decode")).make_prefill()(
            port["res"], {"tokens": torch.as_tensor(tokens).long()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"logits, prompt {plen}")
        for n in ("k", "v"):
            assert tc[kind][n].shape == (a.n_layers, 2, plen, a.kv_heads,
                                         a.hdim)
            np.testing.assert_allclose(tc[kind][n].numpy(),
                                       np.asarray(jc[kind][n]), **TOL,
                                       err_msg=f"cache {n}, prompt {plen}")
        want = _fallbacks(jops.dispatch_counters())
        assert set(want) == {FALLBACK}
        assert ops.dispatch_counters() == {FALLBACK:
                                           a.n_layers * want[FALLBACK]}

    calls = []
    real = ops.flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    ops.reset_dispatch_counters()
    ops.flash_attention = spy
    try:
        tokens = torch.zeros((1, 128), dtype=torch.long)
        ResidentServeEngine(port["model"], port["layout"],
                            ShapeConfig("p", 128, 1, "decode")).make_prefill()(
            port["res"], {"tokens": tokens})
    finally:
        ops.flash_attention = real
    assert len(calls) == a.n_layers and ops.dispatch_counters() == {}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gpt-neox-20b"],
                         ids=["qwen2", "neox"])
def test_chunked_train_step(mesh1, tmp_path, arch):
    """A train step at seq 200 (the gate rejects it) on (1, 1, 1), within
    slice 2's tolerances; both sides record the fallback under the same
    key (the port once per layer call, its recompute included)."""
    jops.reset_dispatch_counters()
    ref = reference_run(mesh1, tmp_path, arch=arch, seq=200)
    want = _fallbacks(jops.dispatch_counters())
    (port,) = port_run(tmp_path, (1, 1, 1), arch=arch, seq=200)
    _check(ref, port)
    assert set(want) == set(port["fallbacks"]) == {FALLBACK}
    assert port["fallbacks"][FALLBACK] > 0


def test_serve_cli_short_prompt(capsys):
    """``--prompt-len 4`` through the serve CLI: every request served."""
    serve_cli.main(["--arch", "gpt-neox-20b", "--device", "cpu", "--reduced",
                    "--requests", "3", "--slots", "2", "--prompt-len", "4",
                    "--max-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    assert "-> 12 tokens" in out
