"""The port's gemma3-1b training step against the JAX package.

test_torch_train.py's run (zero_topo, quant_block=64, compute_dtype
float32, lr 1e-3 with warmup 2 of 3 steps, global batch 4 of
``SyntheticTokens`` seed 0, both sides from the reference's
``init_state``) on gemma3-1b's ``reduced()``: one ``attn_local`` layer
with a sliding window of 64 and one ``attn_global`` layer (two kinds: the
layers run through ``loop_layers``), d_model 256, 4 heads of 64 over 1 KV
head, GELU-GLU d_ff 512, ``embed_scale``, tied vocab 512, at seq 128: at
RUN's seq 32 the window would mask nothing. Both attention kinds run the
flash dispatch at this length (no fallback); their backward is autograd
through the plain version, K and V repeated to the query heads.

Tolerances are slice 2's (LOSS_RTOL 3e-5, GNORM_RTOL 2e-4). On (1, 2, 2)
each step is held from the reference's state before it (forced steps),
and the free-running trajectory's grad norms at TRAJECTORY_GNORM_RTOL
(tests/test_torch_train.py says why). The tied ``embed`` is gathered twice
a step (the lookup and the head), each use with its own stage-1
reduce-scatter: its final master within 5e-5 (measured 5.0e-6; AdamW moves
an element about lr = 1e-3 a step).
"""
import json

import numpy as np
import pytest

from repro_torch.convert import load_global_state
from repro_torch.models.registry import get_arch
from test_torch_train import (RUN, TRAJECTORY_GNORM_RTOL, _check,  # noqa: F401
                              assert_state_converts, forced_four_rank_run,
                              one_torch_thread, port_run, port_train_state,
                              reference_run)

ARCH = "gemma3-1b"
SEQ = 128
GEMMA_LEAVES = ("embed", "attn_local.wq", "attn_local.w_gate",
                "attn_global.wk", "attn_global.w_down")
EMBED_ATOL = 5e-5


@pytest.fixture(scope="module")
def gemma_run(mesh1, tmp_path_factory):
    """The reference's 3 steps at seq 128 on (1, 1, 1): its initial state
    (``state.npz``), metrics and the final master of the tied ``embed``
    (``final.npz``), in the returned directory."""
    out = tmp_path_factory.mktemp("gemma")
    reference_run(mesh1, out, arch=ARCH, seq=SEQ, final_leaves=("embed",))
    return out


def test_window_masks_at_this_length():
    arch = get_arch(ARCH).reduced()
    assert arch.pattern == ("attn_local", "attn_global")
    assert 0 < arch.sliding_window < SEQ


def test_gemma_train_step_one_device(gemma_run):
    ref = json.loads((gemma_run / "metrics.json").read_text())
    (port,) = port_run(gemma_run, (1, 1, 1), arch=ARCH, seq=SEQ)
    _check(ref, port)
    assert port["fallbacks"] == {}


def test_gemma_train_step_four_ranks(tmp_path):
    """(1, 2, 2): 4 gloo ranks against the reference on 4 host devices;
    every rank reports the same global loss and grad norm and no attention
    fallback. Each step from the reference's state before it within slice
    2's tolerances; the free-running run's losses too, its grad norms
    within TRAJECTORY_GNORM_RTOL."""
    ref, ports, forced = forced_four_rank_run(tmp_path, ARCH, SEQ)
    assert [p["rank"] for p in ports] == [0, 1, 2, 3]
    for p in ports:
        assert p["losses"] == ports[0]["losses"]
        assert p["grad_norms"] == ports[0]["grad_norms"]
        assert p["fallbacks"] == {}
    _check(ref, ports[0], gnorm_rtol=TRAJECTORY_GNORM_RTOL)
    for f in forced:
        assert f == forced[0]
    _check(ref, forced[0])


def test_tied_embed_trains(gemma_run):
    """The tied embedding moves over 3 steps (the first at lr 0) and lands
    where the reference's does."""
    init = load_global_state(gemma_run / "state.npz")["master"]["embed"]
    state = port_train_state(ARCH, gemma_run / "state.npz", RUN["steps"],
                             seq=SEQ)
    with np.load(gemma_run / "final.npz") as z:
        want = z["embed"]
    assert np.abs(want - init.numpy()).max() > 1e-4
    np.testing.assert_allclose(state["master"]["embed"].numpy(), want, rtol=0,
                               atol=EMBED_ATOL)


def test_convert_carries_gemma_state(gemma_run):
    """``from_jax_state``: the tied embedding and a leaf of each kind's
    attention and GLU MLP bit for bit in every state dict."""
    assert_state_converts(ARCH, gemma_run / "state.npz", GEMMA_LEAVES)
