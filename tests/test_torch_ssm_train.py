"""The port's falcon-mamba-7b (SSM) training step against the JAX package.

test_torch_train.py's run (zero_topo, quant_block=64, compute_dtype
float32, lr 1e-3 with warmup 2 of 3 steps, global batch 4 x seq 32 of
``SyntheticTokens`` seed 0, both sides from the reference's
``init_state``) on falcon-mamba-7b's ``reduced()``: 2 ``mamba`` layers,
d_model 256, d_inner 512, dt_rank 16, d_state 16, tied vocab 512. The
mamba block trains leaves no attention block has: ``A_log``, ``dt_bias``,
``D``, the depthwise conv (``conv_w``, ``conv_b``) and the projections
``w_xproj`` (512 x 48: not whole quant blocks, so never fused) and
``w_dt``; the scan's backward is autograd through its plain version, one
256-step block at a time, as the reference's is ``jax.vjp`` of its oracle.

Tolerances are slice 2's (LOSS_RTOL 3e-5, GNORM_RTOL 2e-4). On (1, 2, 2)
each step is held from the reference's state before it (forced steps),
and the free-running trajectory's grad norms at TRAJECTORY_GNORM_RTOL
(tests/test_torch_train.py says why). The final masters of the mamba-only
leaves: within 2e-5 (measured 2.3e-6 at most, on ``w_xproj``; AdamW moves
an element about lr = 1e-3 a step).
"""
import json

import numpy as np
import pytest

from repro_torch.convert import load_global_state
from repro_torch.core.partition import padded_flat_size
from test_torch_train import (RUN, TRAJECTORY_GNORM_RTOL, _check,  # noqa: F401
                              assert_state_converts, forced_four_rank_run,
                              one_torch_thread, port_run, port_train_state,
                              reference_run, run_ranks)

ARCH = "falcon-mamba-7b"
MAMBA_ONLY = ("mamba.A_log", "mamba.dt_bias", "mamba.D", "mamba.conv_w",
              "mamba.conv_b", "mamba.w_xproj", "mamba.w_dt")
MASTER_ATOL = 2e-5


@pytest.fixture(scope="module")
def mamba_run(mesh1, tmp_path_factory):
    """The reference's 3 steps on (1, 1, 1): its initial state
    (``state.npz``), metrics and the final masters of MAMBA_ONLY
    (``final.npz``), in the returned directory."""
    out = tmp_path_factory.mktemp("mamba")
    reference_run(mesh1, out, arch=ARCH, final_leaves=MAMBA_ONLY)
    return out


def test_mamba_train_step_one_device(mamba_run):
    ref = json.loads((mamba_run / "metrics.json").read_text())
    (port,) = port_run(mamba_run, (1, 1, 1), arch=ARCH)
    _check(ref, port)
    assert port["fallbacks"] == {}


def test_mamba_train_step_four_ranks(tmp_path):
    """(1, 2, 2): 4 gloo ranks against the reference on 4 host devices;
    every rank reports the same global loss and grad norm. Each step from
    the reference's state before it within slice 2's tolerances; the
    free-running run's losses too, its grad norms within
    TRAJECTORY_GNORM_RTOL."""
    ref, ports, forced = forced_four_rank_run(tmp_path, ARCH)
    assert [p["rank"] for p in ports] == [0, 1, 2, 3]
    for p in ports:
        assert p["losses"] == ports[0]["losses"]
        assert p["grad_norms"] == ports[0]["grad_norms"]
    _check(ref, ports[0], gnorm_rtol=TRAJECTORY_GNORM_RTOL)
    for f in forced:
        assert f == forced[0]
    _check(ref, forced[0])


def test_mamba_only_leaves_train(mamba_run):
    """The mamba-only leaves move over 3 steps (the first at lr 0) and land
    where the reference's do."""
    init = load_global_state(mamba_run / "state.npz")["master"]
    state = port_train_state(ARCH, mamba_run / "state.npz", RUN["steps"])
    with np.load(mamba_run / "final.npz") as z:
        for name in MAMBA_ONLY:
            got, want = state["master"][name].numpy(), z[name]
            moved = np.abs(want - init[name].numpy()).max()
            assert moved > 1e-4, (name, moved)
            np.testing.assert_allclose(got, want, rtol=0, atol=MASTER_ATOL,
                                       err_msg=name)


def test_convert_carries_mamba_state(mamba_run):
    """``from_jax_state``: the mamba-only leaves bit for bit in every state
    dict."""
    assert_state_converts(ARCH, mamba_run / "state.npz", MAMBA_ONLY)


def _dw_paths_rank(rank: int) -> dict:
    """One bf16 step of the reduced falcon-mamba on (1, 1, 2), W = 2, with
    ``ops.matmul_quant`` (the fused dW) and ``ops.quantize_int4`` (stage 1
    of a dense dW) wrapped to record their calls: the (K, N) of each fused
    dW and the length of each quantized flat gradient."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    fused, quantized = [], []
    mq, q4 = ops.matmul_quant, ops.quantize_int4

    def spy_mq(x2, g2, block, **kw):
        fused.append((x2.shape[1], g2.shape[1]))
        return mq(x2, g2, block, **kw)

    def spy_q4(x, block, **kw):
        quantized.append(x.numel())
        return q4(x, block, **kw)

    ops.matmul_quant, ops.quantize_int4 = spy_mq, spy_q4
    args = train.build_parser().parse_args([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--devices", "2",
        "--steps", "1", "--batch", str(RUN["batch"]), "--seq",
        str(RUN["seq"]), "--quant-block", str(RUN["quant_block"]),
        "--compute-dtype", "bfloat16"])
    res = train.train_rank(rank, 2, args)
    return dict(fused=fused, quantized=quantized, losses=res["losses"])


def test_mamba_dw_paths(tmp_path):
    """With W = 2 the stage-1 reduce-scatter is quantized: every mamba
    matmul leaf whose rows are whole quant blocks (w_in, w_dt, w_out) takes
    the fused ``matmul_quant`` dW, once a layer; ``w_xproj`` (48 columns)
    takes the dense product and ``quantize_int4`` of its padded flat
    gradient, once a layer, as does the tied ``embed`` (read whole, twice a
    step). Nothing else is quantized."""
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    arch = get_arch(ARCH).reduced()
    specs = build_model(arch).leaf_specs()
    cfg = scheme_config("zero_topo", Mesh((1, 1, 2), TEST_AXES, 0),
                        quant_block=RUN["quant_block"])
    ranks = run_ranks(_dw_paths_rank, 2, tmp_path)
    n = arch.n_layers
    fusable = sorted([specs[f"mamba.{w}"].shape
                      for w in ("w_in", "w_dt", "w_out")] * n)
    xproj = padded_flat_size(specs["mamba.w_xproj"].logical_size, cfg)
    embed = padded_flat_size(specs["embed"].logical_size, cfg)
    assert xproj % RUN["quant_block"] == 0 and \
        specs["mamba.w_xproj"].shape[-1] % RUN["quant_block"]
    for r in ranks:
        assert all(np.isfinite(r["losses"]))
        assert sorted(r["fused"]) == fusable
        assert sorted(r["quantized"]) == sorted([xproj] * n + [embed] * 2)
