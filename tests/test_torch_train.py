"""The port's training step against the JAX package's, end to end.

qwen2-0.5b reduced, zero_topo, quant_block=64, compute_dtype float32, lr
1e-3 (warmup 2 of 3 steps), global batch 4 x seq 32 of ``SyntheticTokens``
seed 0. Both sides start from the reference's ``init_state`` (handed over as
numpy: ``jax.random`` streams cannot be reproduced in torch) and train 3
steps; the per-step loss and grad norm must agree.

* (1, 1, 1): the reference on the one-device mesh in this process, the port
  in this process, with 1 and 2 microbatches (f32 gradient accumulation).
* (1, 2, 2): W = gcd (2), E = node (2), secondary over (gcd, node). The
  reference runs on 4 forced host devices in a subprocess (this file under
  ``__main__``); the port runs 4 ranks over gloo (``--devices 4``). This is
  the configuration where the INT4 a2a reduce-scatters, the fused
  ``matmul_quant`` dW and the secondary re-gather all run.
* (2, 1, 2): W = gcd (2), no E, a replica tier R = data (2): stage 3, the
  cross-replica all-reduce and select, runs instead of stage 2.
* (1, 2, 2) under ``zeropp`` (W over all 4 ranks, INT8 gathers, secondary
  over the intra tier, INT4 stage 1 only), ``zero3`` (unquantized dense
  gathers, reduce-scatter in f32), ``zero1`` (weights and gradients whole
  on every rank, the optimizer state over all 4: the reference's
  ``cross_replica="allreduce"``, the port's one cross-replica flow) and
  ``zero2`` (the gradients reduce-scattered over all 4 in f32): the other
  schemes' collective paths. Together these are every scheme the train CLI
  offers (tests/test_torch_port_rules.py holds that).

Tolerances: rtol 3e-5 on the loss and 2e-4 on the grad norm, about ten
times the differences measured at (1, 2, 2) (3e-6 and 2e-5). The port's
matmuls and reductions sum in another order than XLA's (f32 differences of
~1e-6 relative), and the INT4 gradient quantization turns such a difference
into a whole quant step wherever a value sits at a rounding boundary; those
few flipped elements move the grad norm and, through AdamW, the next losses
by more than the float noise.

Forced steps (``reference_run(forced=True)``, ``port_forced_rank``): the
reference also saves its global state before every step, and the port runs
each step k from the reference's state before it, on batch k. A step is
then held at the tolerances above from the same state, whatever the steps
before it did. Free-running, a flipped INT4 element of the step-1 gradient
moves its m; where the element's gradient is near 0, Adam's first update
(m / sqrt(v) about +-1 there) then moves that weight by up to lr on one
side and not the other, and step 3's grad norm follows: falcon-mamba-7b's
and gemma3-1b's reductions at (1, 2, 2) differ by 3.1e-4 and 2.7e-4 there
while the same step from the reference's state differs by 1.5e-5 and
2.4e-6; qwen2-0.5b's zero_topo run at (1, 2, 2) by 3.57e-4 on one host
(4.3e-7 forced) and within GNORM_RTOL on another, the same code. Such
trajectories are held at TRAJECTORY_GNORM_RTOL, ten times the measured,
and every step also forced.
"""
import json
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

AX = ("data", "node", "gcd")
RUN = dict(seq=32, batch=4, steps=3, lr=1e-3, quant_block=64)
LOSS_RTOL, GNORM_RTOL = 3e-5, 2e-4
TRAJECTORY_GNORM_RTOL = 3e-3
ARCH = "qwen2-0.5b"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's in-process runs on one thread, as its ranks run: the
    reduced models gain nothing from more, and beside the other test
    workers more threads only contend (modules that import it share it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reduced_arch(get, arch: str = ARCH):
    """The reduction ``arch`` names, through ``get`` (the reference's or the
    port's ``get_arch``): "<name>" is the arch's ``reduced()``; "<name>@hd<D>"
    the same at d_model 4 D over 4 heads of D (all KV heads), the published
    head width of a model whose ``reduced()`` keeps 64; "<name>@f<F>" the
    ``reduced()`` of an encoder-decoder over F frames (``reduced()`` keeps
    32, which the attention kernel takes; 160 it does not)."""
    import dataclasses
    name, _, frames = arch.partition("@f")
    if frames:
        return dataclasses.replace(get(name).reduced(), n_frames=int(frames))
    name, _, hd = arch.partition("@hd")
    if not hd:
        return get(name).reduced()
    d = int(hd)
    return dataclasses.replace(get(name).reduced(d_model=4 * d), n_heads=4,
                               n_kv_heads=4)


def _save_reference_state(path: Path, state) -> None:
    from repro_torch.convert import save_global_state
    save_global_state(path, {
        k: (np.asarray(state[k]) if k == "step" else
            {n: np.asarray(a) for n, a in state[k].items()})
        for k in ("primaries", "master", "opt_m", "opt_v", "step")})


def forced_state(out_dir: Path, k: int) -> Path:
    """The reference's global state before step k (``forced=True``)."""
    return out_dir / ("state.npz" if k == 0 else f"state{k}.npz")


def reference_run(mesh, out_dir: Path, n_microbatch: int = 1,
                  scheme: str = "zero_topo", batch: int = RUN["batch"],
                  arch: str = ARCH, seq: int = RUN["seq"],
                  final_leaves: tuple[str, ...] = (), forced: bool = False,
                  **over) -> dict:
    """Train the reference; save its initial global state and metrics, and
    the final fp32 masters of ``final_leaves`` (``final.npz``). ``over``
    overrides the scheme config (e.g. ``stream_grads=True``). ``forced``:
    also save the state before every later step (``forced_state``); the
    steps are the trainer's own step function on its batches in order, as
    ``Trainer.run`` takes them."""
    import jax

    from repro.core.engine import TrainHparams, ZeroEngine
    from repro.launch.mesh import scheme_config
    from repro.models.config import ShapeConfig
    from repro.models.registry import build_model, get_arch
    from repro.train.trainer import Trainer

    model = build_model(reduced_arch(get_arch, arch))
    cfg = scheme_config(scheme, mesh, quant_block=RUN["quant_block"],
                        compute_dtype="float32", **over)
    hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"],
                      warmup_steps=max(RUN["steps"] // 20, 2),
                      n_microbatch=n_microbatch)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp)
    state = eng.init_state(jax.random.key(0))
    _save_reference_state(out_dir / "state.npz", state)
    tr = Trainer(model, eng, mesh, ShapeConfig("t", seq, batch, "train"))
    if forced:
        out = dict(losses=[], grad_norms=[])
        for k in range(RUN["steps"]):
            if k:
                _save_reference_state(forced_state(out_dir, k), state)
            state, metrics = tr.step_fn(state,
                                        tr._shard_batch(tr.data.batch(k)))
            metrics = eng.metrics_to_host(metrics)
            out["losses"].append(float(metrics["loss"]))
            out["grad_norms"].append(float(metrics["grad_norm"]))
    else:
        state = tr.run(state, RUN["steps"], log_every=0)
        out = dict(losses=tr.log.losses, grad_norms=tr.log.grad_norms)
    if final_leaves:
        np.savez(out_dir / "final.npz", **{
            n: np.asarray(state["master"][n]) for n in final_leaves})
    (out_dir / "metrics.json").write_text(json.dumps(out))
    return out


def port_run(out_dir: Path, shape: tuple[int, int, int],
             n_microbatch: int = 1, scheme: str = "zero_topo",
             arch: str = ARCH, seq: int = RUN["seq"]) -> list[dict]:
    from repro_torch.launch import train
    from repro_torch.models.registry import get_arch
    args = train.build_parser().parse_args([
        "--arch", arch.partition("@")[0],
        "--scheme", scheme, "--microbatches", str(n_microbatch),
        "--mesh-shape", ",".join(map(str, shape)),
        "--device", "cpu", "--devices", str(np.prod(shape)),
        "--steps", str(RUN["steps"]), "--batch", str(RUN["batch"]),
        "--seq", str(seq), "--lr", str(RUN["lr"]),
        "--quant-block", str(RUN["quant_block"]), "--compute-dtype", "float32",
        "--init-npz", str(out_dir / "state.npz"), "--timeout", "120"])
    return train.run(args, reduced_arch(get_arch, arch))


def _port_setup(arch: str, mesh, seq: int, **hp_over):
    """The port's model, engine and trainer on ``mesh``, set up as
    ``launch.train.train_rank`` sets them up for port_run's arguments;
    ``hp_over`` overrides TrainHparams (e.g. ``overlap=True``)."""
    from repro_torch.core.engine import TrainHparams, ZeroEngine
    from repro_torch.data.pipeline import spec_for
    from repro_torch.launch.mesh import scheme_config
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.train.trainer import Trainer

    a = reduced_arch(get_arch, arch)
    model = build_model(a)
    cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                        compute_dtype="float32")
    hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"],
                      warmup_steps=max(RUN["steps"] // 20, 2), **hp_over)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device="cpu")
    return model, eng, Trainer(model, eng, spec_for(a, RUN["batch"], seq),
                               seed=0)


def port_train_state(arch: str, state_npz, steps: int,
                     seq: int = RUN["seq"]) -> dict:
    """The port on (1, 1, 1) in this process from the reference's initial
    state; returns the state after ``steps``."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.launch.mesh import TEST_AXES, Mesh

    _, eng, tr = _port_setup(arch, Mesh((1, 1, 1), TEST_AXES), seq)
    state = from_jax_state(load_global_state(state_npz), eng)
    return tr.run(state, steps, log_every=0)


def assert_state_converts(arch: str, state_npz, names) -> None:
    """``from_jax_state`` on (1, 1, 1): the leaves ``names`` of every state
    dict (primaries, masters, m, v) bit for bit as the reference saved
    them."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    mesh = Mesh((1, 1, 1), TEST_AXES)
    eng = ZeroEngine(build_model(reduced_arch(get_arch, arch)).leaf_specs(),
                     scheme_config("zero_topo", mesh,
                                   quant_block=RUN["quant_block"],
                                   compute_dtype="float32"), mesh,
                     device="cpu")
    port = from_jax_state(load_global_state(state_npz), eng)
    with np.load(state_npz) as z:
        for key in ("primaries", "master", "opt_m", "opt_v"):
            for name in names:
                want = z[f"{key}/{name}"]
                assert tuple(port[key][name].shape) == want.shape
                np.testing.assert_array_equal(port[key][name].numpy(), want,
                                              err_msg=f"{key}/{name}")


def _check(ref: dict, port: dict, gnorm_rtol: float = GNORM_RTOL):
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["grad_norms"], ref["grad_norms"],
                               rtol=gnorm_rtol)


def port_forced_rank(rank: int, shape, arch: str, seq: int, ref_dir: Path,
                     overlap: bool = False, stream: bool = False) -> dict:
    """This rank's forced steps (``reference_run(forced=True)``): step k of
    the port's zero_topo step from the reference's global state before it,
    on batch k (with ``overlap`` / ``stream``). Returns the steps' global
    losses and grad norms."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.launch.mesh import TEST_AXES, Mesh

    model, eng, tr = _port_setup(arch, Mesh(shape, TEST_AXES, rank), seq,
                                 overlap=overlap, stream_grads=stream)
    out = dict(losses=[], grad_norms=[])
    for k in range(RUN["steps"]):
        state = from_jax_state(load_global_state(forced_state(ref_dir, k)),
                               eng)
        _, metrics = eng.train_step(model.lm.loss, state, tr._batch(k))
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
    return out


def _rank_entry(rank: int, world: int, port: int, out_dir: Path, fn,
                args) -> None:
    import torch.distributed as dist

    from repro_torch.launch import train
    torch.set_num_threads(1)
    train.init_group(rank, world, 120, port)
    try:
        torch.save(fn(rank, *args), out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, out_dir: Path, *args) -> list:
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks (one torch
    thread each, 300 s each at most), meeting at the train launcher's
    rendezvous; returns their results by rank."""
    from repro_torch.launch import train

    out_dir.mkdir(parents=True, exist_ok=True)
    store = train.rendezvous(world, 120)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, store.port, out_dir, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


def forced_four_rank_run(tmp_path, arch: str, seq: int = RUN["seq"]
                         ) -> tuple[dict, list[dict], list[dict]]:
    """four_rank_run on (1, 2, 2) with the reference's forced states, then
    the port's forced steps on 4 gloo ranks: (reference metrics, the
    port's free-running rank results, its forced rank results)."""
    ref, ports = four_rank_run(tmp_path, (1, 2, 2), arch=arch, seq=seq,
                               forced=True)
    forced = run_ranks(port_forced_rank, 4, tmp_path / "forced", (1, 2, 2),
                       arch, seq, tmp_path)
    return ref, ports, forced


def test_state_carries_across_bf16(mesh1, tmp_path):
    """``init_state`` at bf16 -> .npz -> this rank's port state: every
    primary, master, m and v bit for bit, at the reference's layout."""
    import jax

    from repro.core.engine import ZeroEngine as JEngine
    from repro.launch.mesh import scheme_config as jscheme
    from repro.models.registry import build_model as jbuild
    from repro.models.registry import get_arch as jget
    from repro_torch.convert import (from_jax_state, load_global_state,
                                     save_global_state)
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    jmodel = jbuild(jget("qwen2-0.5b").reduced())
    jeng = JEngine(jmodel.leaf_specs(), jscheme("zero_topo", mesh1,
                                                quant_block=64), mesh1)
    state = jeng.init_state(jax.random.key(1))
    ref = {k: (np.asarray(state[k]) if k == "step" else
               {n: np.asarray(a) for n, a in state[k].items()})
           for k in ("primaries", "master", "opt_m", "opt_v", "step")}
    save_global_state(tmp_path / "s.npz", ref)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    eng = ZeroEngine(build_model(get_arch("qwen2-0.5b").reduced()).leaf_specs(),
                     scheme_config("zero_topo", mesh, quant_block=64), mesh,
                     device="cpu")
    port = from_jax_state(load_global_state(tmp_path / "s.npz"), eng)
    assert port["step"] == 0
    for key in ("primaries", "master", "opt_m", "opt_v"):
        for n, a in ref[key].items():
            t = port[key][n]
            assert tuple(t.shape) == a.shape
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("n_microbatch", [1, 2])
def test_train_step_one_device(mesh1, tmp_path, n_microbatch):
    ref = reference_run(mesh1, tmp_path, n_microbatch)
    (port,) = port_run(tmp_path, (1, 1, 1), n_microbatch)
    _check(ref, port)


def four_rank_run(tmp_path, shape, scheme: str = "zero_topo",
                  arch: str = ARCH, seq: int = RUN["seq"],
                  forced: bool = False) -> tuple[dict, list[dict]]:
    """The reference on 4 host devices in a subprocess (this file under
    ``__main__``), then the port on 4 gloo ranks from its initial state:
    (reference metrics, the port's rank results)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, __file__, str(tmp_path),
                          ",".join(map(str, shape)), scheme, arch, str(seq),
                          str(int(forced))],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    ref = json.loads((tmp_path / "metrics.json").read_text())
    return ref, port_run(tmp_path, shape, scheme=scheme, arch=arch, seq=seq)


FOUR_RANK_CASES = [((1, 2, 2), "zero_topo"), ((2, 1, 2), "zero_topo"),
                   ((1, 2, 2), "zeropp"), ((1, 2, 2), "zero3"),
                   ((1, 2, 2), "zero1"), ((1, 2, 2), "zero2")]


# the cases held by forced steps: their free-running trajectories drift
# past GNORM_RTOL at step 3 on some hosts (qwen2's zero_topo at (1, 2, 2):
# 3.57e-4, while the same step from the reference's state differs by
# 4.3e-7; the module docstring says why)
FORCED_CASES = (((1, 2, 2), "zero_topo"),)


@pytest.mark.parametrize("shape,scheme", FOUR_RANK_CASES)
def test_train_step_four_ranks(tmp_path, shape, scheme):
    """4 gloo ranks against the reference on 4 host devices: every scheme
    the train CLI offers (``zero1``: the optimizer state over all four
    ranks, the cross-replica all-reduce and select; ``zero2``: the
    gradients reduce-scattered over all four in f32). The FORCED_CASES
    hold each step from the reference's state before it at slice 2's
    tolerances first, then the free-running run's grad norms within
    TRAJECTORY_GNORM_RTOL."""
    forced = (shape, scheme) in FORCED_CASES
    if forced:
        ref, ports, steps = forced_four_rank_run(tmp_path, ARCH)
        for f in steps:
            assert f == steps[0]
        _check(ref, steps[0])
    else:
        ref, ports = four_rank_run(tmp_path, shape, scheme)
    assert [p["rank"] for p in ports] == [0, 1, 2, 3]
    for p in ports:   # the metrics are global: every rank reports the same
        assert p["losses"] == ports[0]["losses"]
        assert p["grad_norms"] == ports[0]["grad_norms"]
    _check(ref, ports[0],
           gnorm_rtol=TRAJECTORY_GNORM_RTOL if forced else GNORM_RTOL)


def _bf16_dw_rank(rank: int) -> list:
    """One of 2 gloo ranks on the mesh (1, 1, 2), W = 2, where every fusable
    dW takes the fused path: one bf16 step with ``ops.matmul_quant`` wrapped
    to record its operands' dtypes and whether its wire output equals that
    of the same call on the operands widened to f32."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    real, seen = ops.matmul_quant, []

    def spy(x2, g2, block, **kw):
        q, s = real(x2, g2, block, **kw)
        q32, s32 = real(x2.float(), g2.float(), block, **kw)
        seen.append((x2.dtype, g2.dtype, torch.equal(q, q32),
                     torch.equal(s.view(torch.int32), s32.view(torch.int32))))
        return q, s

    ops.matmul_quant = spy
    args = train.build_parser().parse_args([
        "--device", "cpu", "--reduced", "--devices", "2", "--steps", "1",
        "--batch", str(RUN["batch"]), "--seq", str(RUN["seq"]),
        "--quant-block", str(RUN["quant_block"]), "--compute-dtype",
        "bfloat16", "--timeout", "120"])
    train.train_rank(rank, 2, args)
    return seen


def test_fused_dw_takes_bf16_operands(tmp_path):
    """Under compute_dtype bfloat16 the fused dW path hands
    ``ops.matmul_quant`` its bf16 operands as they are (the tensor-core
    kernel's input on a card), and its wire bytes and scales are bit for bit
    those of the same values widened to f32."""
    for seen in run_ranks(_bf16_dw_rank, 2, tmp_path):
        assert seen, "no fused dW ran"
        assert all(rec == (torch.bfloat16, torch.bfloat16, True, True)
                   for rec in seen), seen


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    jax.config.update("jax_default_matmul_precision", "float32")
    from repro.launch.mesh import make_test_mesh
    shape = tuple(int(v) for v in sys.argv[2].split(","))
    reference_run(make_test_mesh(shape=shape, axes=AX), Path(sys.argv[1]),
                  scheme=sys.argv[3], arch=sys.argv[4], seq=int(sys.argv[5]),
                  forced=bool(int(sys.argv[6])))
