"""The port's ``bits=8`` quantized reduce-scatter and its training regimes
(``--overlap``, ``--stream-grads``) against the JAX package.

* The a2a reduce-scatter, bits 4 and 8, over W = ("gcd",), E = ("node",)
  and all four ranks, on the mesh (data, node, gcd) = (1, 2, 2): 4 gloo
  ranks against the reference on 4 forced host devices (a subprocess: this
  file under ``__main__``), on the same numpy shards. The received INT8 /
  packed INT4 payloads and f32 scales are bit for bit the reference's; the
  reduced shard is within one f32 ulp of its largest value (ROADMAP caveat
  b: XLA may contract the jitted sum's multiply-adds); the reference
  scenario's bound holds (``tests/_scenarios.py`` ``collectives``: the
  error is at most d half-steps of the largest block).
* The regimes inside the port (the reference's own invariant,
  ``tests/test_overlap.py``, ``tests/test_stream_grads.py``): the four
  combinations of overlap and streaming give bit-equal losses, grad norms
  and master shards over 3 steps, at (1, 1, 1) with 1 and 2 microbatches
  (bf16 compute) and on 4 ranks at (1, 2, 2) with 1 (f32); the collectives
  move the same bytes. On three reductions (ARCHS): qwen2-0.5b (the
  uniform stack), gemma3-1b (two kinds, ``attn_local`` with a window of 64
  and ``attn_global``, through ``loop_layers``; at seq 128, where the
  window masks, as the reference holds its heterogeneous loop path,
  ``tests/_scenarios.py``) and falcon-mamba-7b (the mamba stack, whose
  streamed leaves include the unfusable ``w_xproj``). On 4 ranks qwen2 and
  gemma start from the reference's ``init_state``, falcon-mamba from the
  port's own. Two more reductions at one step each (ONE_STEP_ARCHS, the
  port's own init), at (1, 1, 1) in bf16 and on 4 ranks in f32:
  minicpm3-4b (MLA, its unfusable ``w_dkv`` streamed), whisper-medium
  (two stacks a step: the encoder's ``loop_layers`` over ("enc", i) turns
  the prefetch rotation and the streaming sinks a second time) and
  jamba-v0.1-52b (three kinds with three leaf sets in one rotation:
  ``mamba_mlp``, ``mamba_moe`` with its expert stacks, ``attn_mlp``).
* The regimes against the reference at (1, 2, 2), over 3 steps, within
  tests/test_torch_train.py's tolerances: the port's overlapped streaming
  step against the reference's seed step at 1 microbatch (qwen2-0.5b and
  gemma3-1b: each step from the reference's state before it, the
  free-running trajectory at TRAJECTORY_GNORM_RTOL), and against the
  reference's streaming step at 2 (global batch 8; the stage-2
  quantization then applies per microbatch, as in the reference). The reference's overlap is not
  used: its own overlap test fails with the installed jax (ROADMAP
  caveat c).
* ``memory_report`` (grad_buffer, prefetch_buffer and the rest) equals the
  reference's for qwen2-0.5b reduced at (1, 2, 2) in all four combinations.
* The train CLI prints the same loss lines with and without the two flags.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train import (AX, GNORM_RTOL, LOSS_RTOL, RUN,
                              TRAJECTORY_GNORM_RTOL, port_forced_rank,
                              reference_run, run_ranks)

SHAPE = (1, 2, 2)
COMBOS = [(False, False), (True, False), (False, True), (True, True)]
# arch -> sequence length; gemma3-1b's window of 64 masks only past 64
ARCHS = {"qwen2-0.5b": RUN["seq"], "gemma3-1b": 128,
         "falcon-mamba-7b": RUN["seq"]}
# one step each, from the port's own init (seed 0)
ONE_STEP_ARCHS = {"minicpm3-4b": RUN["seq"], "whisper-medium": RUN["seq"],
                  "jamba-v0.1-52b": RUN["seq"]}
# the archs the 4-rank runs start from the reference's init_state (the
# others from the port's own, seed 0)
REF_INIT = ("qwen2-0.5b", "gemma3-1b")
RS_BLOCK, RS_N = 64, 4 * 64 * 8        # quant block, elements per rank
RS_AXES = {"W": "weight", "E": "extra_grad", "all": "all"}


def _combo_id(c):
    return f"overlap{int(c[0])}-stream{int(c[1])}"


def _cases(combos):
    """(arch, combo) for every arch of ARCHS; qwen2-0.5b's ids are the
    combo's alone, as before the other archs joined."""
    return [pytest.param(arch, c, id=_combo_id(c) if arch == "qwen2-0.5b"
                         else f"{arch}-{_combo_id(c)}")
            for arch in ARCHS for c in combos]


def _run_id(arch: str, c) -> str:
    return _combo_id(c) if arch == "qwen2-0.5b" else f"{arch}-{_combo_id(c)}"


def _rs_input() -> np.ndarray:
    """(4, RS_N) f32: row r is rank r's shard; unit normals, 1 % of them
    x10 (heavy-tailed, as the reference's quant_error experiment)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, RS_N)).astype(np.float32)
    return np.where(rng.random(x.shape) < 0.01, x * 10, x).astype(np.float32)


# -- the reference, on 4 host devices ------------------------------------------

def _reference_main(out_dir: Path) -> None:
    """The reference's side of every test here, in one process."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import collectives as col
    from repro.core.engine import ZeroEngine
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.models.registry import build_model, get_arch

    mesh = make_test_mesh(shape=SHAPE, axes=AX)
    cfg = scheme_config("zero_topo", mesh, quant_block=RS_BLOCK)
    x = _rs_input()
    out = {}
    for name, cat in RS_AXES.items():
        axes = getattr(cfg.axes, cat)
        d = cfg.size(axes)
        for bits in (4, 8):
            qmax = 7.0 if bits == 4 else 127.0

            def f(s, axes=axes, bits=bits, d=d, qmax=qmax):
                s = s.reshape(-1)
                q2, s2 = col.a2a_rs_issue(s, axes, cfg, bits)
                red = col.a2a_quant_reduce_scatter(s, axes, cfg, bits=bits)
                exact = lax.psum_scatter(s, tuple(axes), tiled=True)
                gmax = lax.pmax(jnp.max(jnp.abs(s)), tuple(axes))
                ratio = jnp.max(jnp.abs(red - exact)) / \
                    (d * (gmax / (2 * qmax) + 1e-6))
                return q2[None], s2[None], red[None], ratio[None]

            sm = shard_map(f, mesh=mesh, in_specs=P(AX), out_specs=P(AX),
                           check_vma=False)
            for key, val in zip(("q2", "s2", "red", "ratio"),
                                jax.jit(sm)(x.reshape(-1))):
                out[f"{name}_{bits}_{key}"] = np.asarray(val)
    np.savez(out_dir / "rs.npz", **out)

    specs = build_model(get_arch("qwen2-0.5b").reduced()).leaf_specs()
    mem = {}
    for c in COMBOS:
        ccfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                             compute_dtype="float32", overlap=c[0],
                             stream_grads=c[1])
        mem[_combo_id(c)] = {k: int(v) for k, v in
                             ZeroEngine(specs, ccfg, mesh).memory_report().items()}
    (out_dir / "memory.json").write_text(json.dumps(mem))

    (out_dir / "seed").mkdir()
    reference_run(mesh, out_dir / "seed", forced=True)
    (out_dir / "seed-gemma3-1b").mkdir()
    reference_run(mesh, out_dir / "seed-gemma3-1b", arch="gemma3-1b",
                  seq=ARCHS["gemma3-1b"], forced=True)
    (out_dir / "stream2").mkdir()
    reference_run(mesh, out_dir / "stream2", 2, batch=2 * RUN["batch"],
                  stream_grads=True)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stdout + res.stderr
    return out


# -- the port, on 4 gloo ranks --------------------------------------------------

def _train(rank: int, n_mb: int, overlap: bool, stream: bool, init: Path,
           compute_dtype: str = "float32", batch: int = RUN["batch"],
           arch_name: str = "qwen2-0.5b", steps: int = RUN["steps"]):
    """``steps`` of the port's zero_topo step on this rank of (1, 2, 2) (or
    one device when rank is None), on ``arch_name``'s reduction at its
    sequence length (ARCHS, ONE_STEP_ARCHS), from ``init`` (else the
    port's seed-0 init).
    Returns (losses, grad norms, master shards, payload bytes per
    collective, memory_report)."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.core import collectives as col
    from repro_torch.core.engine import TrainHparams, ZeroEngine
    from repro_torch.data.pipeline import spec_for
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.train.trainer import Trainer

    arch = get_arch(arch_name).reduced()
    model = build_model(arch)
    mesh = Mesh(SHAPE, TEST_AXES, rank) if rank is not None \
        else Mesh((1, 1, 1), TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                        compute_dtype=compute_dtype)
    hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"],
                      warmup_steps=max(RUN["steps"] // 20, 2),
                      n_microbatch=n_mb, overlap=overlap, stream_grads=stream)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device="cpu")
    state = from_jax_state(load_global_state(init), eng) if init \
        else eng.init_state(0)
    col.reset_counters()
    seq = {**ARCHS, **ONE_STEP_ARCHS}[arch_name]
    tr = Trainer(model, eng, spec_for(arch, batch, seq))
    state = tr.run(state, steps, log_every=0)
    return dict(losses=tr.log.losses, grad_norms=tr.log.grad_norms,
                master={n: t.clone() for n, t in state["master"].items()},
                payload=dict(col.PAYLOAD), memory=eng.memory_report())


def _port_rs(rank: int) -> dict:
    from repro_torch.core import collectives as col
    from repro_torch.launch.mesh import TEST_AXES, Mesh, config_axis_tuples, \
        scheme_config

    mesh = Mesh(SHAPE, TEST_AXES, rank)
    cfg = scheme_config("zero_topo", mesh, quant_block=RS_BLOCK)
    mesh.bind(config_axis_tuples(cfg))
    col.bind(mesh)
    x = torch.from_numpy(_rs_input()[rank])
    out = {}
    for name, cat in RS_AXES.items():
        axes = getattr(cfg.axes, cat)
        d = cfg.size(axes)
        for bits in (4, 8):
            q2, s2 = col.a2a_rs_issue(x, axes, cfg, bits)
            red = col.a2a_rs_wait(q2, s2, d, cfg, bits)
            fused = col.a2a_quant_reduce_scatter(x, axes, cfg, bits=bits)
            assert torch.equal(red, fused)
            out[f"{name}_{bits}"] = (q2, s2, red)
    return out


def _port_main(rank: int, ref_dir: Path) -> dict:
    """The port's side of every test here, on this rank of 4."""
    runs = {}
    for arch in ARCHS:
        init = None if arch not in REF_INIT else ref_dir / (
            "seed" if arch == "qwen2-0.5b" else f"seed-{arch}") / "state.npz"
        runs.update({_run_id(arch, c): _train(rank, 1, *c, init,
                                              arch_name=arch)
                     for c in COMBOS})
    runs["qwen2-0.5b-forced"] = port_forced_rank(
        rank, SHAPE, "qwen2-0.5b", ARCHS["qwen2-0.5b"], ref_dir / "seed",
        overlap=True, stream=True)
    runs["gemma3-1b-forced"] = port_forced_rank(
        rank, SHAPE, "gemma3-1b", ARCHS["gemma3-1b"],
        ref_dir / "seed-gemma3-1b", overlap=True, stream=True)
    runs["stream2"] = _train(rank, 2, True, True,
                             ref_dir / "stream2" / "state.npz",
                             batch=2 * RUN["batch"])
    for arch in ONE_STEP_ARCHS:
        runs.update({_run_id(arch, c): _train(rank, 1, *c, None,
                                              arch_name=arch, steps=1)
                     for c in COMBOS})
    return dict(runs=runs, rs=_port_rs(rank))


@pytest.fixture(scope="module")
def port_ranks(ref_dir, tmp_path_factory):
    return run_ranks(_port_main, 4, tmp_path_factory.mktemp("port"), ref_dir)


# -- the bits=8 (and bits=4) reduce-scatter -------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("axes", list(RS_AXES))
def test_quant_reduce_scatter_four_ranks(ref_dir, port_ranks, axes, bits):
    ref = np.load(ref_dir / "rs.npz")
    key = f"{axes}_{bits}"
    assert (ref[key + "_ratio"] <= 1.0).all()
    for rank, res in enumerate(port_ranks):
        q2, s2, red = res["rs"][key]
        np.testing.assert_array_equal(q2.numpy(), ref[key + "_q2"][rank])
        np.testing.assert_array_equal(s2.numpy().view(np.uint32),
                                      ref[key + "_s2"][rank].view(np.uint32))
        rred = ref[key + "_red"][rank]
        ulp = np.spacing(np.float32(np.abs(rred).max()))
        np.testing.assert_allclose(red.numpy(), rred, rtol=0, atol=ulp)
        # the scenario's bound, on the port's own result
        d = q2.shape[0]
        qmax = 7.0 if bits == 4 else 127.0
        x = _rs_input()
        members = _rs_members(axes, rank)
        exact = x[members].sum(axis=0).reshape(d, -1)[members.index(rank)]
        gmax = np.abs(x[members]).max()
        assert np.abs(red.numpy() - exact).max() <= d * (gmax / (2 * qmax)
                                                         + 1e-6)


def _rs_members(axes: str, rank: int) -> list[int]:
    """Global ranks of ``rank``'s group over ``axes`` on (1, 2, 2), in the
    group's axis order (rank = 2 * node + gcd)."""
    node, gcd = divmod(rank, 2)
    if axes == "W":
        return [2 * node, 2 * node + 1]
    if axes == "E":
        return [gcd, 2 + gcd]
    return [0, 2, 1, 3]             # ("gcd", "node", "data"): gcd major


# -- the regimes inside the port -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _local_run(arch: str, n_mb: int, overlap: bool, stream: bool,
               steps: int = RUN["steps"]):
    # one thread, as the ranks run: the reduced model gains nothing from more,
    # and beside other test workers more threads only contend
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _train(None, n_mb, overlap, stream, None, "bfloat16",
                      arch_name=arch, steps=steps)
    finally:
        torch.set_num_threads(threads)


def _assert_same_run(a: dict, b: dict):
    assert a["losses"] == b["losses"]
    assert a["grad_norms"] == b["grad_norms"]
    assert a["master"].keys() == b["master"].keys()
    for n in a["master"]:
        assert torch.equal(a["master"][n], b["master"][n]), n


@pytest.mark.parametrize("arch,combo", _cases(COMBOS[1:]))
@pytest.mark.parametrize("n_mb", [1, 2])
def test_regimes_bitwise_one_device(n_mb, arch, combo):
    _assert_same_run(_local_run(arch, n_mb, *combo),
                     _local_run(arch, n_mb, False, False))


@pytest.mark.parametrize("arch,combo", _cases(COMBOS[1:]))
def test_regimes_bitwise_four_ranks(port_ranks, arch, combo):
    for res in port_ranks:
        run = res["runs"][_run_id(arch, combo)]
        seed = res["runs"][_run_id(arch, COMBOS[0])]
        _assert_same_run(run, seed)
        # only the schedule moves: the same bytes through every collective
        assert run["payload"] == seed["payload"]


ONE_STEP_CASES = [pytest.param(arch, c, id=f"{arch}-{_combo_id(c)}")
                  for arch in ONE_STEP_ARCHS for c in COMBOS[1:]]


@pytest.mark.parametrize("arch,combo", ONE_STEP_CASES)
def test_regimes_bitwise_one_step_one_device(arch, combo):
    """minicpm3-4b, whisper-medium and jamba, one bf16 step at (1, 1, 1):
    every combination of overlap and streaming gives the seed run's loss,
    grad norm and masters bit for bit (whisper's encoder leaves and each
    of jamba's three kinds included)."""
    run = _local_run(arch, 1, *combo, steps=1)
    _assert_same_run(run, _local_run(arch, 1, False, False, steps=1))
    if arch == "whisper-medium":
        assert any(n.startswith("enc.") for n in run["master"])
    if arch == "jamba-v0.1-52b":
        assert {n.split(".")[0] for n in run["master"]} >= {
            "mamba_mlp", "mamba_moe", "attn_mlp"}


@pytest.mark.parametrize("arch,combo", ONE_STEP_CASES)
def test_regimes_bitwise_one_step_four_ranks(port_ranks, arch, combo):
    """The same on 4 ranks at (1, 2, 2) in f32, the same bytes through
    every collective."""
    for res in port_ranks:
        run = res["runs"][_run_id(arch, combo)]
        seed = res["runs"][_run_id(arch, COMBOS[0])]
        _assert_same_run(run, seed)
        assert run["payload"] == seed["payload"]


def _check_ref(ref: dict, port: dict, gnorm_rtol: float = GNORM_RTOL):
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["grad_norms"], ref["grad_norms"],
                               rtol=gnorm_rtol)


def test_overlap_stream_against_reference_seed(ref_dir, port_ranks):
    """qwen2-0.5b's overlapped streaming step against the reference's seed
    step, as the gemma3-1b case below is held: each step from the
    reference's state before it within tests/test_torch_train.py's
    tolerances (forced steps), then the free-running run from the same
    ``init_state`` with its grad norms within TRAJECTORY_GNORM_RTOL (its
    step 3 drifts past GNORM_RTOL on some hosts; test_torch_train.py says
    why)."""
    ref = json.loads((ref_dir / "seed" / "metrics.json").read_text())
    for res in port_ranks:
        _check_ref(ref, res["runs"]["qwen2-0.5b-forced"])
        _check_ref(ref, res["runs"][_combo_id((True, True))],
                   TRAJECTORY_GNORM_RTOL)


def test_gemma_overlap_stream_against_reference_seed(ref_dir, port_ranks):
    """gemma3-1b's overlapped streaming step at seq 128 (its loop path
    over two kinds, the windowed layer masking) against the reference's
    seed step: each step from the reference's state before it within
    tests/test_torch_train.py's tolerances (forced steps), and the
    free-running run from the same ``init_state`` with its grad norms
    within TRAJECTORY_GNORM_RTOL (test_torch_train.py says why)."""
    ref = json.loads((ref_dir / "seed-gemma3-1b" / "metrics.json")
                     .read_text())
    for res in port_ranks:
        _check_ref(ref, res["runs"]["gemma3-1b-forced"])
        _check_ref(ref, res["runs"][_run_id("gemma3-1b", (True, True))],
                   TRAJECTORY_GNORM_RTOL)


def test_stream_two_microbatches_against_reference(ref_dir, port_ranks):
    ref = json.loads((ref_dir / "stream2" / "metrics.json").read_text())
    for res in port_ranks:
        _check_ref(ref, res["runs"]["stream2"])


@pytest.mark.parametrize("combo", COMBOS, ids=_combo_id)
def test_memory_report_matches_reference(ref_dir, port_ranks, combo):
    ref = json.loads((ref_dir / "memory.json").read_text())[_combo_id(combo)]
    assert port_ranks[0]["runs"][_combo_id(combo)]["memory"] == ref
    if combo[0]:
        assert ref["prefetch_buffer"] > 0


def test_train_cli_flags_print_same_losses(capfd):
    from repro_torch.launch import train
    base = ["--device", "cpu", "--reduced", "--devices", "4", "--steps", "3",
            "--seq", "32", "--batch", "4"]
    lines = []
    for flags in ([], ["--overlap", "--stream-grads"]):
        train.main(base + flags)
        out = capfd.readouterr().out    # rank 0 prints from its own process
        assert f"overlap={bool(flags)} stream_grads={bool(flags)}" in out
        lines.append([" ".join(ln.split()[:6]) for ln in out.splitlines()
                      if ln.startswith("step ")])
    assert len(lines[0]) == 3 and lines[0] == lines[1]


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    jax.config.update("jax_default_matmul_precision", "float32")
    _reference_main(Path(sys.argv[1]))
