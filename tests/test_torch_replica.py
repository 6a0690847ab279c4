"""The replica tier's beyond-paper options in the port against the JAX
package: ``ZeroConfig.cross_replica="reduce_scatter"`` and
``ZeroConfig.quantize_update_gather``.

One reference subprocess (this file under ``__main__``, 4 forced host
devices) and one spawn of 4 port ranks serve every test here.

* ``cross_replica_grad``: the ``reduce_scatter`` flow is bit for bit the
  all-reduce flow on stacked ``(rows, n)`` and flat grads, at R = 2 (the
  mesh (2, 1, 2)) and R = 4 ((4, 1, 1)); it equals the reference's
  ``psum_scatter`` flow within 1e-5, the bound of the reference's own
  scenario (``tests/_scenarios.py``, ``collectives``). The port sums in f32
  in axis order; XLA sums in its own.
* ``update_all_gather`` with ``quantize_update_gather`` on (2, 1, 2) (over
  E + R = ("node", "data"), size 2): the INT8 q and f32 scales the port
  quantizes are bit for bit the reference's ``ops.quantize_int8`` of the
  same bf16 shard, and the gathered, dequantized primaries are bit for bit
  the reference's ``update_all_gather``.
* The zero_topo step of qwen2-0.5b reduced on (2, 1, 2), 3 steps from the
  reference's ``init_state``, with each option, both, and both with
  ``--stream-grads``: the loss within tests/test_torch_train.py's LOSS_RTOL
  (3e-5), the grad norm within GNORM_RTOL (2e-4), and the final fp32
  masters within MASTER_ATOL of the reference's.
* Neither option changes ``scheme_fingerprint`` (the reference's equals the
  port's, with and without them), and a checkpoint written without them
  restores under ``--strict-restore`` with them, bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train import (AX, GNORM_RTOL, LOSS_RTOL, RUN, reference_run,
                              run_ranks)

SHAPE = (2, 1, 2)
N = 4 * 2 * 64          # flat grad length: R x 2 blocks of 64 per slice
ROWS = 3
BLOCK = 64
# the training cases: name -> (ZeroConfig overrides, stream_grads)
CASES = {
    "reduce_scatter": (dict(cross_replica="reduce_scatter"), False),
    "update_int8": (dict(quantize_update_gather=True), False),
    "both": (dict(cross_replica="reduce_scatter",
                  quantize_update_gather=True), False),
    "both-stream": (dict(cross_replica="reduce_scatter",
                         quantize_update_gather=True), True),
}
# the leaves whose final masters are held (one of each kind: a stacked
# MATMUL leaf, the tied embedding, a norm, a bias)
FINAL = ("attn.wq", "embed", "final_norm", "attn.bq")
# The final masters. The PLAIN leaves (norm, bias) agree within
# PLAIN_ATOL (3.2e-7 measured). In the quantized-gradient leaves a float
# difference of summation order flips an INT4 value at a rounding boundary
# now and then, and Adam's update of that element (m / sqrt(v), about +-1
# where its gradient is near 0) then moves it by up to the step's lr: so at
# most FLIP_SHARE of their elements lie beyond PLAIN_ATOL * 10 (0.09 %
# measured, the same elements with and without the options), and every
# element within the farthest two reversed updates can take it, 2 x the
# lr summed over the steps (7.1e-4 measured against 3e-3).
PLAIN_ATOL = 1e-6
FLIP_SHARE = 1e-3
FLIP_ATOL = 2 * (0.0 + 0.5 + 1.0) * RUN["lr"]     # the cosine lr of 3 steps


def _grads(shape, rank: int) -> np.ndarray:
    """Rank ``rank``'s f32 grad of ``shape``: unit normals, seeded by rank."""
    return np.random.default_rng(100 + rank).standard_normal(shape).astype(
        np.float32)


def _shard(rank: int) -> np.ndarray:
    """Rank ``rank``'s (ROWS, N // 2) f32 optimizer shard for the update
    gather: heavy-tailed, so the blocks' scales differ."""
    rng = np.random.default_rng(200 + rank)
    x = rng.standard_normal((ROWS, N // 2)).astype(np.float32)
    return np.where(rng.random(x.shape) < 0.02, 20 * x, x).astype(np.float32)


# -- the reference, on 4 host devices ------------------------------------------

def _reference_main(out_dir: Path) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import collectives as col
    from repro.core.engine import ZeroEngine
    from repro.kernels import ops
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.models.registry import build_model, get_arch

    out = {}
    for shape in (SHAPE, (4, 1, 1)):
        mesh = make_test_mesh(shape=shape, axes=AX)
        cfg = scheme_config("zero_topo", mesh, quant_block=BLOCK,
                            cross_replica="reduce_scatter")
        key = ",".join(map(str, shape))
        for form, gshape in (("flat", (N,)), ("stacked", (ROWS, N))):
            x = np.stack([_grads(gshape, r) for r in range(4)])

            def f(g):
                g = g[0]
                flat = g.reshape(-1, g.shape[-1])
                o = jax.vmap(lambda row: col.cross_replica_grad(row, cfg))(
                    flat)
                return o.reshape(g.shape[:-1] + (-1,))[None]

            sm = shard_map(f, mesh=mesh, in_specs=P(AX), out_specs=P(AX),
                           check_vma=False)
            out[f"rs_{key}_{form}"] = np.asarray(jax.jit(sm)(x))

    mesh = make_test_mesh(shape=SHAPE, axes=AX)
    cfg = scheme_config("zero_topo", mesh, quant_block=BLOCK,
                        quantize_update_gather=True)
    x = np.stack([_shard(r) for r in range(4)])

    def g(m):
        return col.update_all_gather(m[0], cfg, jnp.bfloat16)[None]

    sm = shard_map(g, mesh=mesh, in_specs=P(AX), out_specs=P(AX),
                   check_vma=False)
    out["update"] = np.asarray(jax.jit(sm)(x).astype(jnp.float32))
    # under jit, as the reference's update gather quantizes (XLA folds the
    # scale's division into a product with the reciprocal, as the port does)
    quant = jax.jit(lambda v: ops.quantize_int8(
        v.astype(jnp.bfloat16).reshape(-1), BLOCK))
    for r in range(4):
        q, s = quant(jnp.asarray(x[r]))
        out[f"q_{r}"], out[f"s_{r}"] = np.asarray(q), np.asarray(s)
    np.savez(out_dir / "collectives.npz", **out)

    specs = build_model(get_arch("qwen2-0.5b").reduced()).leaf_specs()
    base = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"])
    fps = {name: ZeroEngine(specs, dataclasses.replace(base, **over), mesh)
           .scheme_fingerprint() for name, (over, _) in CASES.items()}
    fps["none"] = ZeroEngine(specs, base, mesh).scheme_fingerprint()
    (out_dir / "fingerprints.json").write_text(json.dumps(fps))
    for name, (over, stream) in CASES.items():
        (out_dir / name).mkdir()
        reference_run(mesh, out_dir / name, final_leaves=FINAL,
                      stream_grads=stream, **over)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return out


# -- the port, on 4 gloo ranks ---------------------------------------------------

def _collectives(rank: int) -> dict:
    import dataclasses

    from repro_torch.core import collectives as col
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import TEST_AXES, Mesh, config_axis_tuples, \
        scheme_config

    out = {}
    for shape in (SHAPE, (4, 1, 1)):
        mesh = Mesh(shape, TEST_AXES, rank)
        ar = scheme_config("zero_topo", mesh, quant_block=BLOCK)
        rs = dataclasses.replace(ar, cross_replica="reduce_scatter")
        mesh.bind(config_axis_tuples(ar))
        col.bind(mesh)
        key = ",".join(map(str, shape))
        for form, gshape in (("flat", (N,)), ("stacked", (ROWS, N))):
            x = torch.from_numpy(_grads(gshape, rank))
            out[f"rs_{key}_{form}"] = (col.cross_replica_grad(x, rs),
                                       col.cross_replica_grad(x, ar))
    mesh = Mesh(SHAPE, TEST_AXES, rank)
    cfg = scheme_config("zero_topo", mesh, quant_block=BLOCK,
                        quantize_update_gather=True)
    mesh.bind(config_axis_tuples(cfg))
    col.bind(mesh)
    x = torch.from_numpy(_shard(rank))
    out["update"] = col.update_all_gather(x, cfg, torch.bfloat16)
    out["q"], out["s"] = ops.quantize_int8(
        x.to(torch.bfloat16).reshape(-1), BLOCK)
    return out


def _train(rank: int, init: Path, over: dict, stream: bool) -> dict:
    """3 steps of the port's zero_topo step on this rank of SHAPE (f32, as
    ``reference_run``), from ``init``: losses, grad norms, this rank's
    columns of the FINAL masters."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.core.engine import TrainHparams, ZeroEngine
    from repro_torch.data.pipeline import BatchSpec
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.train.trainer import Trainer

    arch = get_arch("qwen2-0.5b").reduced()
    model = build_model(arch)
    mesh = Mesh(SHAPE, TEST_AXES, rank)
    cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                        compute_dtype="float32", **over)
    hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"],
                      warmup_steps=2, stream_grads=stream)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device="cpu")
    tr = Trainer(model, eng, BatchSpec(RUN["batch"], RUN["seq"], arch.vocab))
    state = tr.run(from_jax_state(load_global_state(init), eng), RUN["steps"],
                   log_every=0)
    return dict(losses=tr.log.losses, grad_norms=tr.log.grad_norms,
                master={n: (eng.shard_cols(n, "master"),
                            state["master"][n].clone()) for n in FINAL},
                fingerprint=eng.scheme_fingerprint())


def _checkpoint_crossing(rank: int, init: Path, ckpt: Path) -> dict:
    """One step without the options, saved; restored strictly by an engine
    with both: every restored tensor bit for bit the saved one."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.core.engine import TrainHparams, ZeroEngine
    from repro_torch.data.pipeline import BatchSpec
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer

    arch = get_arch("qwen2-0.5b").reduced()
    model = build_model(arch)
    engines = []
    for over in ({}, CASES["both"][0]):
        mesh = Mesh(SHAPE, TEST_AXES, rank)
        cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                            compute_dtype="float32", **over)
        engines.append(ZeroEngine(model.leaf_specs(), cfg, mesh,
                                  TrainHparams(lr=RUN["lr"]), device="cpu"))
    plain, both = engines
    tr = Trainer(model, plain, BatchSpec(RUN["batch"], RUN["seq"], arch.vocab))
    saved = tr.run(from_jax_state(load_global_state(init), plain), 1,
                   log_every=0, ckpt_dir=str(ckpt), ckpt_every=1)
    got = checkpoint.restore(ckpt, 1, both, both.scheme_fingerprint(),
                             reshard=False)
    return dict(equal=all(torch.equal(got[k][n], saved[k][n])
                          for k in ("primaries", "master", "opt_m", "opt_v")
                          for n in saved[k]),
                step=got["step"])


def _port_main(rank: int, ref_dir: Path, ckpt: Path) -> dict:
    init = ref_dir / "both" / "state.npz"
    out = dict(collectives=_collectives(rank))
    out["train"] = {name: _train(rank, init, over, stream)
                    for name, (over, stream) in CASES.items()}
    out["ckpt"] = _checkpoint_crossing(rank, init, ckpt)
    return out


@pytest.fixture(scope="module")
def port(ref_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    return run_ranks(_port_main, 4, tmp / "ranks", ref_dir, tmp / "ckpt")


def test_init_states_agree(ref_dir):
    """Every reference case starts from the same init_state (the options do
    not change the layout), which the port's cases share."""
    with np.load(ref_dir / "both" / "state.npz") as a:
        for name in CASES:
            with np.load(ref_dir / name / "state.npz") as b:
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("form", ["flat", "stacked"])
@pytest.mark.parametrize("shape", [SHAPE, (4, 1, 1)],
                         ids=["R2", "R4"])
def test_cross_replica_reduce_scatter(ref_dir, port, shape, form):
    key = f"rs_{','.join(map(str, shape))}_{form}"
    with np.load(ref_dir / "collectives.npz") as z:
        want = z[key]
    for rank, r in enumerate(port):
        rs, ar = r["collectives"][key]
        assert rs.dtype == torch.float32
        assert torch.equal(rs.view(torch.int32), ar.view(torch.int32))
        np.testing.assert_allclose(rs.numpy(), want[rank], rtol=0, atol=1e-5)


def test_update_gather_int8(ref_dir, port):
    with np.load(ref_dir / "collectives.npz") as z:
        for rank, r in enumerate(port):
            c = r["collectives"]
            np.testing.assert_array_equal(c["q"].numpy(), z[f"q_{rank}"])
            np.testing.assert_array_equal(c["s"].view(torch.int32).numpy(),
                                          z[f"s_{rank}"].view(np.int32))
            assert c["update"].dtype == torch.bfloat16
            np.testing.assert_array_equal(c["update"].float().numpy(),
                                          z["update"][rank])


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_with_options(ref_dir, port, case):
    ref = json.loads((ref_dir / case / "metrics.json").read_text())
    runs = [r["train"][case] for r in port]
    for r in runs:        # the metrics are global: every rank the same
        assert (r["losses"], r["grad_norms"]) == (runs[0]["losses"],
                                                  runs[0]["grad_norms"])
    np.testing.assert_allclose(runs[0]["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(runs[0]["grad_norms"], ref["grad_norms"],
                               rtol=GNORM_RTOL)
    with np.load(ref_dir / case / "state.npz") as z:
        init = {n: z[f"master/{n}"] for n in FINAL}
    with np.load(ref_dir / case / "final.npz") as z:
        for name in FINAL:
            got = np.concatenate([r["master"][name][1].numpy().ravel()
                                  for r in runs])
            want = np.concatenate([z[name][..., lo:hi].ravel() for lo, hi in
                                   (r["master"][name][0] for r in runs)])
            start = np.concatenate([init[name][..., lo:hi].ravel() for lo, hi
                                    in (r["master"][name][0] for r in runs)])
            assert np.abs(want - start).max() > 1e-4, name     # it moved
            d = np.abs(got - want)
            if name in ("final_norm", "attn.bq"):
                assert d.max() <= PLAIN_ATOL, (name, d.max())
            else:
                assert (d > 10 * PLAIN_ATOL).mean() <= FLIP_SHARE, \
                    (name, (d > 10 * PLAIN_ATOL).sum())
                assert d.max() <= FLIP_ATOL, (name, d.max())


def test_fingerprint_unchanged_by_the_options(ref_dir, port):
    ref = json.loads((ref_dir / "fingerprints.json").read_text())
    assert all(fp == ref["none"] for fp in ref.values())
    for r in port:
        for case in CASES:
            assert r["train"][case]["fingerprint"] == ref["none"]


def test_checkpoint_crosses_the_options_strictly(port):
    for r in port:
        assert r["ckpt"] == dict(equal=True, step=1)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    jax.config.update("jax_default_matmul_precision", "float32")
    _reference_main(Path(sys.argv[1]))
