"""deepseek-7b in the port against the JAX package: served and trained.

deepseek-7b (arXiv:2401.02954) is the dense full-attention case of the
reference's own serving tests: uniform ``attn`` blocks, MHA (32 heads over
32 KV heads of 128), SiLU-GLU, RMSNorm, RoPE theta 1e4, no QKV bias and an
untied LM head (``lm_head``, read whole into CE and into the decode head).
Two reductions (test_torch_train.reduced_arch): ``reduced()`` (d_model 256,
4 heads of 64, d_ff 512, 2 layers, vocab 512) and ``deepseek-7b@hd128``
(d_model 512, 4 heads of 128, the published head width).

Serving runs tests/test_torch_serve.py's checks on each reduction's own
pair (the reference set up as its serving tests set it up: zero_topo,
quant_block 64, f32, (1, 1, 1)): the converted primaries and the residency
bit for bit (``lm_head`` an INT8 wire leaf beside ``embed``), prefill
logits and caches within 1e-4, teacher-forced decode, the continuous
batcher's tokens and counters, greedy generation, and the CLI.

Training is tests/test_torch_train.py's run: the zero_topo step at (1, 1,
1) on both reductions at slice 2's tolerances, and at (1, 2, 2) each step
from the reference's state before it (forced) at the same tolerances, the
free-running trajectory's grad norms within TRAJECTORY_GNORM_RTOL; the
untied head's and the embedding's final masters after the last step, run
from the reference's state before it; ``from_jax_state`` bit for bit.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.convert import load_global_state
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import get_arch
import test_torch_serve as ts
from test_torch_train import (RUN, TRAJECTORY_GNORM_RTOL, _check,  # noqa: F401
                              assert_state_converts, forced_four_rank_run,
                              forced_state, one_torch_thread, port_run,
                              port_train_state,
                              reduced_arch, reference_run)

ARCH = "deepseek-7b"
HD128 = ARCH + "@hd128"
REDUCTIONS = [ARCH, HD128]
IDS = ["hd64", "hd128"]
WIRE = ["attn.w_down", "attn.w_gate", "attn.w_up", "attn.wk", "attn.wo",
        "attn.wq", "attn.wv", "embed", "lm_head"]
TRAINED = ("embed", "lm_head")
# the final masters after the last of 3 steps (the first at lr 0; AdamW moves
# an element about lr = 1e-3 a step), run from the reference's state before
# it (forced): free-running, an element whose summed gradient is near 0
# turns the f32 order of that sum into Adam's m / sqrt(v) of about +-1 at
# step 2, a move of up to lr on one side alone (2 embedding elements of
# 262,144 landed 1.13e-3 apart while each step's gradient agrees within
# 3e-9 in m). From the same state the step lands within 3.7e-5 on the
# embedding, whose rows sum every occurrence of their token: the untied head
# at gpt-neox's bound (tests/test_torch_neox_train.py), the embedding at
# half of one step's move
FINAL_ATOL = {"lm_head": 1e-4, "embed": 5e-4}


def test_config_is_the_reference_one():
    from repro.models.registry import get_arch as jget

    a, j = get_arch(ARCH), jget(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "hdim", "d_ff",
              "vocab", "rope_theta", "norm", "act", "qkv_bias",
              "tie_embeddings", "pattern", "source"):
        assert getattr(a, f) == getattr(j, f), f
    assert (a.n_layers, a.d_model, a.n_heads, a.kv_heads, a.hdim, a.d_ff,
            a.vocab) == (30, 4096, 32, 32, 128, 11008, 102_400)
    assert not a.tie_embeddings and not a.qkv_bias
    assert reduced_arch(get_arch, HD128).hdim == 128


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REDUCTIONS, ids=IDS)
def test_convert_carries_primaries(arch):
    ref, port = ts._pair(arch)
    assert "lm_head" in port["prim"]
    ts.hold_convert(ref, port)


@pytest.mark.parametrize("arch", REDUCTIONS, ids=IDS)
def test_residency_bitwise(arch):
    ts.hold_residency(*ts._pair(arch), WIRE)


@pytest.mark.parametrize("arch", REDUCTIONS, ids=IDS)
def test_prefill_logits_and_caches(arch):
    ts.hold_prefill(*ts._pair(arch))


@pytest.mark.parametrize("arch", REDUCTIONS, ids=IDS)
def test_decode_teacher_forced(arch):
    ts.hold_decode(*ts._pair(arch))


@pytest.mark.parametrize("case", ts.BATCHER_CASES, ids=ts.BATCHER_IDS)
@pytest.mark.parametrize("arch", REDUCTIONS, ids=IDS)
def test_batcher_tokens_and_counters(arch, case):
    ts.hold_batcher(*ts._pair(arch), case)


@pytest.mark.parametrize("arch", REDUCTIONS, ids=IDS)
def test_generate_greedy_tokens(arch):
    ts.hold_generate(*ts._pair(arch))


def test_serve_cli_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--requests", "3", "--slots", "2", "--prompt-len", "8",
                    "--max-len", "24", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=deepseek-7b-reduced" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    assert "-> 12 tokens" in out


def test_clis_without_device_raise_here():
    """Without --device cpu both CLIs ask for the card and raise on a host
    with no card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the CLIs would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", ARCH, "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", ARCH, "--reduced", "--devices", "4",
                        "--steps", "1"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REDUCTIONS, ids=IDS)
def test_train_step_one_device(mesh1, tmp_path, arch):
    ref = reference_run(mesh1, tmp_path, arch=arch)
    (port,) = port_run(tmp_path, (1, 1, 1), arch=arch)
    _check(ref, port)
    assert port["fallbacks"] == {}


def test_train_step_four_ranks(tmp_path):
    """(1, 2, 2) at head dim 128: each step from the reference's state
    before it within slice 2's tolerances, every rank reporting the same
    global loss and grad norm; the free-running run's losses too, its grad
    norms within TRAJECTORY_GNORM_RTOL."""
    ref, ports, forced = forced_four_rank_run(tmp_path, HD128)
    for f in forced:
        assert f == forced[0]
    _check(ref, forced[0])
    assert [p["rank"] for p in ports] == [0, 1, 2, 3]
    for p in ports:
        assert p["losses"] == ports[0]["losses"]
        assert p["grad_norms"] == ports[0]["grad_norms"]
        assert p["fallbacks"] == {}
    _check(ref, ports[0], gnorm_rtol=TRAJECTORY_GNORM_RTOL)


@pytest.fixture(scope="module")
def hd128_run(mesh1, tmp_path_factory):
    """The reference's 3 steps at head dim 128 on (1, 1, 1): its initial
    state (``state.npz``), its state before each later step
    (``forced_state``), metrics and the final masters of TRAINED
    (``final.npz``), in the returned directory."""
    out = tmp_path_factory.mktemp("deepseek")
    reference_run(mesh1, out, arch=HD128, final_leaves=TRAINED, forced=True)
    return out


def test_untied_head_and_embedding_train(hd128_run):
    """The untied head and the embedding move over 3 steps (the first at
    lr 0), and the last step, from the reference's state before it, lands
    them where the reference's do."""
    init = load_global_state(hd128_run / "state.npz")["master"]
    init = {n: init[n].numpy().copy() for n in TRAINED}
    last = RUN["steps"] - 1
    state = port_train_state(HD128, forced_state(hd128_run, last), 1)
    assert int(state["step"]) == RUN["steps"]
    with np.load(hd128_run / "final.npz") as z:
        for name in TRAINED:
            want = z[name]
            assert np.abs(want - init[name]).max() > 1e-4, name
            np.testing.assert_allclose(state["master"][name].numpy(), want,
                                       rtol=0, atol=FINAL_ATOL[name],
                                       err_msg=name)
    ref = json.loads((hd128_run / "metrics.json").read_text())
    assert len(ref["losses"]) == RUN["steps"]


def test_convert_carries_deepseek_state(hd128_run):
    """``from_jax_state``: the untied head, the embedding and a leaf of
    attention and of the GLU MLP bit for bit in every state dict."""
    assert_state_converts(HD128, hd128_run / "state.npz",
                          TRAINED + ("attn.wq", "attn.w_down", "final_norm"))


def test_train_cli_cpu(capfd):
    """The train CLI on deepseek-7b's reduction, 4 ranks on (1, 2, 2)."""
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--devices", "4", "--steps", "2", "--seq", "32",
                    "--batch", "4"])
    out = capfd.readouterr().out
    assert "arch=deepseek-7b-reduced" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "final loss: " in out
