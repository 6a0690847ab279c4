"""The training step's update in place, as the reference's donated step
(``jax.jit(sm, donate_argnums=(0,))``, ``src/repro/core/engine.py:643``).

* ``optim.adamw.adamw_update_`` against ``_adamw_update``, the same
  step written out of place (the reference's expressions in torch): bit
  for bit on seeded f32 shards, with and without weight decay, at the
  first step and a later one, from f32 and bf16 gradients; and against
  the reference's ``repro.optim.adamw.adamw_update`` run op by op on the
  same shards: m and v bit for bit, the master within 4 ulp.
* ``ZeroEngine.train_step`` on (1, 1, 1): the returned ``master`` /
  ``opt_m`` / ``opt_v`` tensors are the ones passed in (the same storage),
  updated; the primaries are replaced by the update all-gather's result.
* ``convert.from_jax_state`` hands the engine tensors it owns: a step
  leaves the reference's numpy arrays as they were.

Bit for bit across steps and regimes: tests/test_torch_regimes.py
(``test_regimes_bitwise_*``) and the forced four-rank tests of
tests/test_torch_train.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim.adamw import AdamWOut, adamw_update_
from test_torch_train import RUN, one_torch_thread  # noqa: F401

N = 4099            # a shard off every vector width


def _shards(seed: int, grad_dtype):
    rng = np.random.default_rng(seed)
    master = rng.standard_normal(N).astype(np.float32)
    m = (rng.standard_normal(N) * 1e-2).astype(np.float32)
    v = np.abs(rng.standard_normal(N) * 1e-4).astype(np.float32)
    g = rng.standard_normal(N).astype(np.float32)
    g[::97] = 0.0
    g[1::89] *= 1e-6
    return ([torch.from_numpy(a) for a in (master, m, v)],
            torch.from_numpy(g).to(grad_dtype))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _adamw_update(master, m, v, grad, *, step, lr, beta1, beta2, eps,
                  weight_decay) -> AdamWOut:
    """The plain oracle: ``repro.optim.adamw.adamw_update`` (:20) written
    out of place in torch, each expression a new tensor."""
    g = grad.float()
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g.square()
    t = torch.tensor(float(step), dtype=torch.float32)
    mh = m / (1 - torch.pow(beta1, t))
    vh = v / (1 - torch.pow(beta2, t))
    upd = mh / (vh.sqrt() + eps)
    return AdamWOut(master * (1 - lr * weight_decay) - lr * upd, m, v)


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1], ids=["wd0", "wd0.1"])
@pytest.mark.parametrize("step", [1, 5])
def test_adamw_in_place_bitwise(step, weight_decay, grad_dtype):
    """The in-place form writes the out-of-place form's bits into the
    tensors it is given, and returns them."""
    (master, m, v), g = _shards(step, grad_dtype)
    lr = torch.tensor(3e-4, dtype=torch.float32)
    kw = dict(step=step, lr=lr, beta1=0.9, beta2=0.95, eps=1e-8,
              weight_decay=weight_decay)
    start = master.clone()
    want = _adamw_update(master.clone(), m.clone(), v.clone(), g, **kw)
    got = adamw_update_(master, m, v, g, **kw)
    assert got.master is master and got.m is m and got.v is v
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert not torch.equal(master, start)


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1], ids=["wd0", "wd0.1"])
@pytest.mark.parametrize("step", [1, 5])
def test_adamw_in_place_against_reference(step, weight_decay, grad_dtype):
    """The in-place form against the reference's ``adamw_update`` run op
    by op (each jnp expression its own XLA computation, so no multiply and
    add fuse) at an f32 step and lr, as the reference's engine passes
    them: m and v bit for bit; the master within 4 ulp (XLA's f32 divide
    and power on the CPU may round an element differently; measured 2)."""
    import jax.numpy as jnp

    from repro.optim.adamw import adamw_update as jadamw

    (master, m, v), g = _shards(step, grad_dtype)
    lr = np.float32(3e-4)
    jg = jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16 if grad_dtype == torch.bfloat16 else jnp.float32)
    # copies: on the CPU jax may alias a numpy array's memory, and its
    # dispatch is asynchronous, so the in-place update below must neither
    # share the reference's inputs nor overtake its computation
    want = jadamw(*(jnp.asarray(a.numpy().copy()) for a in (master, m, v)),
                  jg, step=jnp.asarray(step, jnp.int32), lr=jnp.asarray(lr),
                  beta1=0.9, beta2=0.95, eps=1e-8,
                  weight_decay=weight_decay)
    want = AdamWOut(*(np.asarray(a) for a in want))
    got = adamw_update_(master, m, v, g, step=step, lr=torch.tensor(lr),
                        beta1=0.9, beta2=0.95, eps=1e-8,
                        weight_decay=weight_decay)
    for name, a, b in zip(("m", "v"), got[1:], want[1:]):
        np.testing.assert_array_equal(_bits(a), np.asarray(b).view(np.uint32),
                                      err_msg=name)
    np.testing.assert_array_max_ulp(got.master.numpy(),
                                    np.asarray(want.master), maxulp=4)


def _engine(compute_dtype: str):
    from repro_torch.core.engine import TrainHparams, ZeroEngine
    from repro_torch.data.pipeline import BatchSpec, SyntheticTokens
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    arch = get_arch("qwen2-0.5b").reduced()
    model = build_model(arch)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                        compute_dtype=compute_dtype)
    hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"], warmup_steps=0)
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device="cpu")
    batch = {k: torch.as_tensor(a).long() for k, a in SyntheticTokens(
        BatchSpec(2, RUN["seq"], arch.vocab), seed=0).batch(0).items()}
    return model, eng, batch


def test_train_step_donates_state():
    """A step at bf16 on (1, 1, 1) returns the state it was given with
    the same master, m and v tensors (the same storage), each moved, and
    new primaries at the updated masters (the old ones replaced, not
    written over)."""
    model, eng, batch = _engine("bfloat16")
    state = eng.init_state(0)
    state["step"] = 1           # step 0 runs at lr 0: take a later one
    before = {k: {n: t.clone() for n, t in state[k].items()}
              for k in ("master", "opt_m", "opt_v", "primaries")}
    ptrs = {k: {n: t.data_ptr() for n, t in state[k].items()}
            for k in ("master", "opt_m", "opt_v")}
    # held here, so the step's new primaries cannot take their storage
    old_primaries = dict(state["primaries"])
    out, metrics = eng.train_step(model.lm.loss, state, batch)
    assert out is state and out["step"] == 2
    assert float(metrics["lr"]) > 0
    for k in ("master", "opt_m", "opt_v"):
        assert set(out[k]) == set(eng.specs)
        for n, t in out[k].items():
            assert t.data_ptr() == ptrs[k][n], (k, n)
    moved = [n for n in eng.specs
             if not torch.equal(out["master"][n], before["master"][n])]
    assert set(moved) == set(eng.specs)
    for n in eng.specs:
        assert bool(out["opt_v"][n].abs().max() > 0), n
        p = out["primaries"][n]
        assert p is not old_primaries[n]
        assert torch.equal(old_primaries[n], before["primaries"][n]), n
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, out["master"][n].to(torch.bfloat16)), n


def test_converted_state_leaves_reference_arrays(tmp_path):
    """``from_jax_state`` on the reference's ``init_state`` (numpy, f32):
    a step through the port leaves every reference array as it was, and
    the port's master moved."""
    import jax

    from repro.core.engine import ZeroEngine as JEngine
    from repro.launch.mesh import make_test_mesh
    from repro.launch.mesh import scheme_config as jscheme
    from repro.models.registry import build_model as jbuild
    from repro.models.registry import get_arch as jget
    from repro_torch.convert import from_jax_state

    jmesh = make_test_mesh(shape=(1, 1, 1), axes=("data", "node", "gcd"))
    jeng = JEngine(jbuild(jget("qwen2-0.5b").reduced()).leaf_specs(),
                   jscheme("zero_topo", jmesh, quant_block=RUN["quant_block"],
                           compute_dtype="float32"), jmesh)
    jstate = jeng.init_state(jax.random.key(0))
    ref = {k: (int(jstate[k]) if k == "step" else
               {n: np.array(a) for n, a in jstate[k].items()})
           for k in ("primaries", "master", "opt_m", "opt_v", "step")}
    kept = {k: {n: a.copy() for n, a in ref[k].items()}
            for k in ("primaries", "master", "opt_m", "opt_v")}
    model, eng, batch = _engine("float32")
    state = from_jax_state(ref, eng)
    state, _ = eng.train_step(model.lm.loss, state, batch)
    state, _ = eng.train_step(model.lm.loss, state, batch)
    for k, arrays in kept.items():
        for n, a in arrays.items():
            np.testing.assert_array_equal(ref[k][n], a, err_msg=f"{k}/{n}")
    assert any(not np.array_equal(state["master"][n].numpy(), kept["master"][n])
               for n in kept["master"])
