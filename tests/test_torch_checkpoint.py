"""The port's checkpoints (train/checkpoint.py), its scheme fingerprint and
its elastic restore, against the JAX package's.

qwen2-0.5b reduced, zero_topo, compute dtype float32, quant block 64, the
training run of tests/test_torch_train.py (lr 1e-3, warmup 2 of 3 steps,
global batch 4 x seq 32 of ``SyntheticTokens`` seed 0). The port writes
first: 4 gloo ranks on (1, 2, 2) train 3 steps from the port's own seeded
state, once with a checkpoint at step 2 and once without. Then one
reference subprocess on 4 forced host devices computes its fingerprints,
trains from its own state with a checkpoint after step 1, and reshards
the port's four-rank checkpoint onto (1, 1, 2) and (1, 1, 1), taking the
next step on each. Every other reference call (its restore and save of
single-device checkpoints, its reshard onto (1, 1, 1)) runs in this
process, where nothing is compiled.

* (a) fingerprints: every scheme on (1, 1, 1), (1, 2, 2), (2, 1, 2), for
  qwen2-0.5b and falcon-mamba-7b reduced, equal after a JSON round trip.
* (b), (c) the one-rank ``global`` format both ways: leaves bit for bit
  (f32 and bf16), ``meta.json`` field by field and the files byte for byte
  equal to what the reference writes for the same state; the port's steps
  2-3 from the reference's checkpoint within LOSS_RTOL / GNORM_RTOL.
* (d) a resume on the writing layout is the uninterrupted run bit for bit.
* (e), (f) the four-rank ``per_process`` format: the reference reassembles
  it (also repacked as 2 files of 2 shards), and both packages reshard it
  onto (1, 1, 2) and (1, 1, 1) to the same bits; the next step from it
  within LOSS_RTOL / GNORM_RTOL of the reference's (one step from the same
  state: about 1e-6, tests/test_torch_train.py).
* (g) the guards raise the reference's error class with its message.
* (h) the CLI's ``--ckpt-dir`` / ``--ckpt-every`` / ``--resume``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_train import (AX, ARCH, GNORM_RTOL, LOSS_RTOL, RUN,
                              _port_setup, _save_reference_state,
                              one_torch_thread, reduced_arch, run_ranks)

assert one_torch_thread     # the autouse fixture, shared with this module

ARCHS = ("qwen2-0.5b", "falcon-mamba-7b")
SCHEMES = ("zero_topo", "zeropp", "zero3", "zero1", "zero2")
SHAPES = ((1, 1, 1), (1, 2, 2), (2, 1, 2))
CKPT_STEP = 2               # the four-rank run saves after its step 2 of 3
GROW_D = 192                # d_model whose norms pad to 192 at block 64, 256 at 128


def _key(arch: str, shape, scheme: str) -> str:
    return f"{arch}|{','.join(map(str, shape))}|{scheme}"


def _bits(x) -> np.ndarray:
    """An array's raw bits (a torch tensor or a numpy / jax array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _leaves(state) -> dict:
    """The state's leaves by flat key (``master/attn.wq``, ...; no step)."""
    return {f"{k}/{n}": v for k in ("primaries", "master", "opt_m", "opt_v")
            for n, v in state[k].items()}


def _assert_same_leaves(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


def _port_fingerprints(shapes, rank: int = 0) -> dict:
    """The port's ``scheme_fingerprint`` of every (arch, shape, scheme);
    on several ranks every rank builds every engine (binding a mesh's
    process groups is collective)."""
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    out = {}
    for shape in shapes:
        mesh = Mesh(shape, TEST_AXES, rank)
        for arch in ARCHS:
            specs = build_model(reduced_arch(get_arch, arch)).leaf_specs()
            for scheme in SCHEMES:
                cfg = scheme_config(scheme, mesh,
                                    quant_block=RUN["quant_block"],
                                    compute_dtype="float32")
                eng = ZeroEngine(specs, cfg, mesh, device="cpu")
                out[_key(arch, shape, scheme)] = json.loads(
                    json.dumps(eng.scheme_fingerprint()))
    return out


def _train_four(rank: int, ckpt_dir: str) -> dict:
    """One of 4 ranks on (1, 2, 2): the fingerprints on both four-rank
    meshes, then 3 steps from the port's seeded state without a checkpoint
    and again with one at CKPT_STEP."""
    from repro_torch.launch.mesh import TEST_AXES, Mesh

    fps = _port_fingerprints(SHAPES[1:], rank)
    mesh = Mesh((1, 2, 2), TEST_AXES, rank)
    out = dict(fingerprints=fps)
    for label, kw in (("plain", {}),
                      ("ckpt", dict(ckpt_dir=ckpt_dir, ckpt_every=CKPT_STEP))):
        _, eng, tr = _port_setup(ARCH, mesh, RUN["seq"])
        state = tr.run(eng.init_state(0), RUN["steps"], log_every=0, **kw)
        out[label] = dict(losses=tr.log.losses, grad_norms=tr.log.grad_norms,
                          saved=sorted(tr.log.ckpt_save_s),
                          master={n: t.clone()
                                  for n, t in state["master"].items()})
    return out


def _resume(rank: int, ckpt_dir: str, shape) -> dict:
    """This rank of ``shape`` restores the latest checkpoint through
    ``Trainer.restore`` (elastic by default) and takes the rest of the
    3-step run; returns the restored shards and the steps' metrics."""
    from repro_torch.launch.mesh import TEST_AXES, Mesh

    _, eng, tr = _port_setup(ARCH, Mesh(shape, TEST_AXES, rank), RUN["seq"])
    state = tr.restore(ckpt_dir)
    out = dict(step=state["step"], restored={
        k: t.clone() for k, t in _leaves(state).items()})
    state = tr.run(state, RUN["steps"] - state["step"], log_every=0)
    out.update(losses=tr.log.losses, grad_norms=tr.log.grad_norms,
               master={n: t.clone() for n, t in state["master"].items()})
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory) -> Path:
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def four(work) -> list[dict]:
    return run_ranks(_train_four, 4, work / "four", str(work / "ckpt4"))


@pytest.fixture(scope="module")
def reference(work, four) -> dict:
    """The reference subprocess (this file under ``__main__``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, __file__, str(work)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads((work / "reference.json").read_text())


def _port_engine(arch=ARCH, quant_block=RUN["quant_block"],
                 dtype="float32", d_model=None):
    """The port's (1, 1, 1) model, engine and trainer."""
    from repro_torch.core.engine import TrainHparams, ZeroEngine
    from repro_torch.data.pipeline import BatchSpec
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.train.trainer import Trainer

    a = reduced_arch(get_arch, arch) if d_model is None else \
        get_arch(arch).reduced(d_model=d_model)
    model = build_model(a)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=quant_block,
                        compute_dtype=dtype)
    hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"],
                      warmup_steps=max(RUN["steps"] // 20, 2))
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device="cpu")
    return model, eng, Trainer(model, eng, BatchSpec(RUN["batch"], RUN["seq"],
                                                     a.vocab), seed=0)


def _ref_engine(mesh, quant_block=RUN["quant_block"], dtype="float32",
                d_model=None):
    from repro.core.engine import ZeroEngine
    from repro.launch.mesh import scheme_config
    from repro.models.registry import build_model, get_arch

    a = get_arch(ARCH).reduced() if d_model is None else \
        get_arch(ARCH).reduced(d_model=d_model)
    return ZeroEngine(build_model(a).leaf_specs(),
                      scheme_config("zero_topo", mesh, quant_block=quant_block,
                                    compute_dtype=dtype), mesh)


def _ref_restore(ckpt, step, eng, **kw):
    from repro.train import checkpoint as jck
    return jck.restore(ckpt, step, eng.state_shardings(),
                       expect_scheme=eng.scheme_fingerprint(), **kw)


# -- (a) fingerprints ----------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_fingerprints_match_reference(four, reference, arch, shape):
    """``ZeroConfig.fingerprint`` + the padded sizes, every scheme."""
    port = four[0]["fingerprints"] if shape != (1, 1, 1) else \
        _port_fingerprints([shape])
    for f in four[1:]:
        assert f["fingerprints"] == four[0]["fingerprints"]
    for scheme in SCHEMES:
        key = _key(arch, shape, scheme)
        assert port[key] == reference["fingerprints"][key], key
        assert port[key]["padded_sizes"] and port[key]["scheme"] == scheme


# -- (b), (c) the one-rank format, both ways ------------------------------------

def test_reference_checkpoint_resumes_in_port(reference, work):
    """The reference's checkpoint after step 1 restores strictly in the
    port, bit for bit ``from_jax_state`` of the same arrays; the port's
    steps 2-3 from it meet the reference's."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.train import checkpoint

    _, eng, tr = _port_engine()
    state = checkpoint.restore(work / "ref_ckpt", 1, eng,
                               eng.scheme_fingerprint())
    assert state["step"] == 1
    want = from_jax_state(load_global_state(work / "ref_state1.npz"), eng)
    _assert_same_leaves(_leaves(state), _leaves(want))
    tr.run(state, 2, log_every=0)
    ref = reference["resume_b"]
    np.testing.assert_allclose(tr.log.losses, ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tr.log.grad_norms, ref["grad_norms"],
                               rtol=GNORM_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_reference(mesh1, tmp_path, dtype):
    """The port's checkpoint after one step restores in the reference with
    ``expect_scheme``: every leaf bit for bit; the reference's save of the
    same state writes the same meta.json, field by field, and the same
    bytes. And the reference's init_state at ``dtype``, saved by the
    reference, restores strictly in the port bit for bit."""
    import jax

    from repro.train import checkpoint as jck
    from repro_torch.convert import from_jax_state
    from repro_torch.train import checkpoint

    _, eng, tr = _port_engine(dtype=dtype)
    state = tr.run(eng.init_state(0), 1, log_every=0)
    port_dir = checkpoint.save(state, tmp_path / "port", state["step"],
                               scheme=eng.scheme_fingerprint(), engine=eng)
    jeng = _ref_engine(mesh1, dtype=dtype)
    restored = _ref_restore(tmp_path / "port", 1, jeng)
    assert int(restored["step"]) == 1
    _assert_same_leaves(_leaves(restored), _leaves(state))
    ref_dir = jck.save(restored, tmp_path / "ref", 1,
                       scheme=jeng.scheme_fingerprint())
    meta = json.loads((Path(port_dir) / "meta.json").read_text())
    want = json.loads((Path(ref_dir) / "meta.json").read_text())
    assert set(meta) == set(want)
    for field in want:
        assert meta[field] == want[field], field
    for f in sorted(os.listdir(ref_dir)):
        assert (Path(port_dir) / f).read_bytes() == \
            (Path(ref_dir) / f).read_bytes(), f

    init = jeng.init_state(jax.random.key(0))
    jck.save(init, tmp_path / "ref_init", 0, scheme=jeng.scheme_fingerprint())
    got = checkpoint.restore(tmp_path / "ref_init", 0, eng,
                             eng.scheme_fingerprint())
    host = {k: {n: np.asarray(a) for n, a in init[k].items()}
            for k in ("primaries", "master", "opt_m", "opt_v")}
    _assert_same_leaves(_leaves(got),
                        _leaves(from_jax_state(dict(host, step=0), eng)))


# -- (d) the same layout ----------------------------------------------------------

@pytest.fixture(scope="module")
def resumed(work, four) -> list[dict]:
    return run_ranks(_resume, 4, work / "resumed", str(work / "ckpt4"),
                     (1, 2, 2))


def test_checkpointing_leaves_the_run_unchanged(four):
    """A run that saves at CKPT_STEP gives the bits of one that does not."""
    for r in four:
        assert r["ckpt"]["saved"] == [CKPT_STEP]
        assert r["ckpt"]["losses"] == r["plain"]["losses"]
        assert r["ckpt"]["grad_norms"] == r["plain"]["grad_norms"]
        _assert_same_leaves(r["ckpt"]["master"], r["plain"]["master"])


def test_same_layout_resume_is_bitwise(four, resumed):
    """A fresh spawn of the four ranks resumes at CKPT_STEP and its step 3
    (loss, grad norm, every final master) is the uninterrupted run's."""
    for r, f in zip(resumed, four):
        assert r["step"] == CKPT_STEP
        assert r["losses"] == f["plain"]["losses"][CKPT_STEP:]
        assert r["grad_norms"] == f["plain"]["grad_norms"][CKPT_STEP:]
        _assert_same_leaves(r["master"], f["plain"]["master"])


# -- (e) the four-rank format read by the reference ------------------------------

def _repack(src: Path, dst: Path) -> Path:
    """The four-rank checkpoint as 2 processes of 2 devices each: files
    p000 (ranks 0, 1) and p001 (ranks 2, 3) of 2 stacked shards."""
    d = dst / f"step_{CKPT_STEP:08d}"
    d.mkdir(parents=True)
    s = src / f"step_{CKPT_STEP:08d}"
    meta = json.loads((s / "meta.json").read_text())
    for base in meta["names"].values():
        for p in (0, 1):
            np.save(d / f"{base}.p{p:03d}.npy", np.concatenate(
                [np.load(s / f"{base}.p{r:03d}.npy") for r in (2 * p, 2 * p + 1)]))
    meta["mesh"].update(process_count=2, local_devices=2)
    meta["device_map"]["process"] = {str(r): r // 2 for r in range(4)}
    (d / "meta.json").write_text(json.dumps(meta))
    return dst


@pytest.mark.parametrize("layout", ["as_written", "repacked"])
def test_reference_reads_four_rank_checkpoint(mesh1, work, four, tmp_path,
                                              layout):
    """The reference restores the port's per_process checkpoint with
    ``reshard=True``: every global leaf bit for bit the port's own reshard
    onto (1, 1, 1) (which holds the global leaves), as written and repacked
    as 2 files of 2 shards with a matching device map."""
    from repro_torch.train import checkpoint

    ckpt = work / "ckpt4"
    if layout == "repacked":
        ckpt = _repack(ckpt, tmp_path)
    jeng = _ref_engine(mesh1)
    ref = _ref_restore(ckpt, CKPT_STEP, jeng, reshard=True)
    _, eng, _ = _port_engine()
    port = checkpoint.restore(ckpt, CKPT_STEP, eng, eng.scheme_fingerprint(),
                              reshard=True)
    assert port["step"] == int(ref["step"]) == CKPT_STEP
    _assert_same_leaves(_leaves(port), _leaves(ref))
    if layout == "repacked":
        written = checkpoint.restore(work / "ckpt4", CKPT_STEP, eng,
                                     eng.scheme_fingerprint(), reshard=True)
        _assert_same_leaves(_leaves(port), _leaves(written))


# -- (f) elastic restore -----------------------------------------------------------

@pytest.fixture(scope="module")
def elastic(work, four) -> dict:
    """The four-rank checkpoint resumed on 2 ranks of (1, 1, 2) and on
    (1, 1, 1) in this process, each with its restored global leaves."""
    two = run_ranks(_resume, 2, work / "elastic", str(work / "ckpt4"),
                    (1, 1, 2))
    # on (1, 1, 2) both categories are sharded over gcd alone: rank order
    glob = {k: torch.cat([r["restored"][k] for r in two], dim=-1)
            for k in two[0]["restored"]}
    one = _resume(0, str(work / "ckpt4"), (1, 1, 1))
    return {"1,1,2": dict(two[0], restored=glob, ranks=two),
            "1,1,1": one}


@pytest.mark.parametrize("shape", ["1,1,2", "1,1,1"])
def test_elastic_restore_matches_reference(elastic, reference, work, shape):
    """The four-rank checkpoint resharded onto ``shape``: the global
    leaves bit for bit the reference's reshard onto the same mesh, and
    the next step within LOSS_RTOL / GNORM_RTOL of the reference's."""
    from repro_torch.convert import load_global_state

    got = elastic[shape]
    assert got["step"] == CKPT_STEP
    want = load_global_state(work / f"reshard_{shape}.npz")
    _assert_same_leaves(got["restored"], _leaves(want))
    for r in got.get("ranks", [got]):
        assert (r["losses"], r["grad_norms"]) == (got["losses"],
                                                  got["grad_norms"])
    ref = reference["elastic"][shape]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                               rtol=GNORM_RTOL)


# -- (g) the guards ----------------------------------------------------------------

def test_strict_cross_layout_restore_raises(work, four):
    """Strict restore of the four-rank checkpoint on one rank: MeshMismatch
    naming both layouts and the reshard=True way out, before any leaf."""
    from repro_torch.train import checkpoint

    _, eng, tr = _port_engine()
    with pytest.raises(checkpoint.MeshMismatch, match="reshard=True") as ei:
        tr.restore(work / "ckpt4", reshard=False)
    assert "checkpoint:" in str(ei.value) and "restoring" in str(ei.value)
    with pytest.raises(FileNotFoundError):
        tr.restore(work / "empty")


def _one_rank_ckpt(path: Path, scheme=True, quant_block=RUN["quant_block"],
                   d_model=None) -> Path:
    from repro_torch.train import checkpoint

    _, eng, _ = _port_engine(quant_block=quant_block, d_model=d_model)
    checkpoint.save(eng.init_state(0), path, 1, engine=eng,
                    scheme=eng.scheme_fingerprint() if scheme else None)
    return path


def _meta_edit(path: Path, **fields) -> Path:
    f = path / "step_00000001" / "meta.json"
    meta = json.loads(f.read_text())
    meta.update(fields)
    f.write_text(json.dumps(meta))
    return path


def _dirty(path: Path) -> Path:
    """A checkpoint at quant block 128 (norms padded 192 -> 256) with a
    nonzero bit in one norm's padding."""
    d = path / "step_00000001"
    meta = json.loads((d / "meta.json").read_text())
    f = d / meta["names"]["master/final_norm"]
    a = np.load(f)
    a[..., -1] = 1.0
    np.save(f, a)
    return path


GUARDS = {
    # case: (make the checkpoint, restoring engine's kwargs, restore kwargs,
    #        error class, what the message names)
    "mesh": (lambda p: _meta_edit(_one_rank_ckpt(p), mesh=dict(
        axes=["data", "node", "gcd"], shape=[1, 1, 1], n_devices=64,
        process_count=1, local_devices=1)), {}, {}, "MeshMismatch",
        "reshard=True"),
    "quant_block": (_one_rank_ckpt, dict(quant_block=128), {},
                    "SchemeMismatch", "quant_block"),
    "no_scheme": (lambda p: _one_rank_ckpt(p, scheme=False), {}, {},
                  "SchemeMismatch", "no scheme metadata"),
    "version": (lambda p: _meta_edit(_one_rank_ckpt(p), version=99), {}, {},
                "ValueError", r"v99.*v1"),
    "dirty_padding": (lambda p: _dirty(_one_rank_ckpt(
        p, quant_block=128, d_model=GROW_D)), dict(d_model=GROW_D),
        dict(reshard=True), "ValueError", "nonzero data"),
    "foreign_model": (_one_rank_ckpt, {}, dict(
        reshard=True, padded_sizes={"not.a.leaf": 64}), "SchemeMismatch",
        "different model"),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_guard_raises_as_the_reference(mesh1, tmp_path, case):
    """Each of the reference's restore guards (tests/test_checkpoint.py),
    on the same files: the port raises the reference's error class with
    the reference's message."""
    from repro.train import checkpoint as jck
    from repro_torch.train import checkpoint

    make, eng_kw, kw, cls, names = GUARDS[case]
    ckpt = make(tmp_path / "ckpt")
    kw = dict(kw)
    pads = kw.pop("padded_sizes", None)
    _, eng, _ = _port_engine(**eng_kw)
    jeng = _ref_engine(mesh1, **eng_kw)
    fps = [eng.scheme_fingerprint(), jeng.scheme_fingerprint()]
    if pads:
        for fp in fps:
            fp["padded_sizes"] = pads
    with pytest.raises(ValueError, match=names) as port:
        checkpoint.restore(ckpt, 1, eng, fps[0], **kw)
    with pytest.raises(ValueError) as ref:
        jck.restore(ckpt, 1, jeng.state_shardings(), expect_scheme=fps[1],
                    **kw)
    assert type(port.value).__name__ == type(ref.value).__name__ == cls
    assert str(port.value) == str(ref.value)


def test_grow_then_shrink_padding_roundtrip(mesh1, tmp_path):
    """Through ``Trainer.restore``'s default reshard: a checkpoint at quant
    block 64 restores into block 128 (norms padded 192 -> 256 with zeros,
    bit for bit the reference's reshard), which saves and restores back
    into block 64 with every leaf bit for bit the original."""
    from repro_torch.train import checkpoint

    _, eng, tr = _port_engine(d_model=GROW_D)
    state = tr.run(eng.init_state(0), 1, log_every=0, ckpt_dir=tmp_path / "a",
                   ckpt_every=1)
    _, eng2, tr2 = _port_engine(quant_block=128, d_model=GROW_D)
    big = tr2.restore(tmp_path / "a")
    assert big["step"] == 1
    t = big["master"]["final_norm"]
    assert t.shape[-1] == 256 and eng._pad["final_norm"] == GROW_D
    assert not t[..., GROW_D:].any()
    ref = _ref_restore(tmp_path / "a", 1,
                       _ref_engine(mesh1, quant_block=128, d_model=GROW_D),
                       reshard=True)
    _assert_same_leaves(_leaves(big), _leaves(ref))
    checkpoint.save(big, tmp_path / "b", 1, scheme=eng2.scheme_fingerprint(),
                    engine=eng2)
    back = tr.restore(tmp_path / "b")
    _assert_same_leaves(_leaves(back), _leaves(state))


# -- (h) the CLI ----------------------------------------------------------------------

def test_resume_requires_ckpt_dir(capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--reduced", "--resume"])
    assert "--resume requires --ckpt-dir" in capsys.readouterr().err


def test_cli_resume_continues_the_data_stream(tmp_path, monkeypatch, capsys):
    """Two steps saving after each, then ``--resume`` for two more: it
    restores step 2 and takes batches 2 and 3 of the stream."""
    from repro_torch.launch import train
    from repro_torch.train.trainer import Trainer

    seen, real = [], Trainer._batch

    def spy(self, step):
        seen.append(step)
        return real(self, step)

    monkeypatch.setattr(Trainer, "_batch", spy)
    argv = ["--device", "cpu", "--reduced", "--devices", "1", "--steps", "2",
            "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path)]
    (first,) = train.main(argv + ["--ckpt-every", "1"])
    assert seen == [0, 1] and sorted(first["ckpt_save_s"]) == [1, 2]
    assert first["resumed_from"] is None
    seen.clear()
    (again,) = train.main(argv + ["--resume"])
    assert seen == [2, 3]
    assert again["resumed_from"] == 2 and again["ckpt_restore_s"] > 0
    assert "resumed from step 2 (elastic restore enabled)" in \
        capsys.readouterr().out


def test_cli_resume_reports_restored_shards(tmp_path):
    """A resumed run reports the sha256 and shape of every shard it
    restored: on one rank, each leaf file's bytes (bf16 primaries as their
    uint16 bits); a run that restored nothing reports None."""
    import hashlib

    from repro_torch.launch import train

    argv = ["--device", "cpu", "--reduced", "--devices", "1", "--steps", "1",
            "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path)]
    (first,) = train.main(argv + ["--ckpt-every", "1"])
    assert first["restored_shards"] is None
    (again,) = train.main(argv + ["--resume"])
    d = tmp_path / "step_00000001"
    meta = json.loads((d / "meta.json").read_text())
    got = again["restored_shards"]
    assert sorted(got) == sorted(k for k in meta["names"] if k != "step")
    assert any(meta["dtypes"][k] == "bfloat16" for k in got)
    for k, entry in got.items():
        a = np.load(d / meta["names"][k])
        assert entry["shape"] == list(a.shape), k
        assert entry["sha256"] == hashlib.sha256(a.tobytes()).hexdigest(), k


def test_cli_strict_restore_refused_before_any_rank(work, four, monkeypatch):
    """``--resume --strict-restore`` of the four-rank checkpoint on 2 ranks
    raises MeshMismatch (naming reshard=True) in the launching process:
    no rendezvous, no rank."""
    from repro_torch.launch import train
    from repro_torch.train import checkpoint

    def never(*a, **k):
        raise AssertionError("a rank or a rendezvous was started")

    monkeypatch.setattr(train, "rendezvous", never)
    monkeypatch.setattr(train, "train_rank", never)
    with pytest.raises(checkpoint.MeshMismatch, match="reshard=True") as ei:
        train.main(["--device", "cpu", "--reduced", "--devices", "2",
                    "--resume", "--strict-restore",
                    "--ckpt-dir", str(work / "ckpt4")])
    assert "{'data': 1, 'node': 2, 'gcd': 2}" in str(ei.value)
    assert "{'data': 1, 'node': 1, 'gcd': 2}" in str(ei.value)


# -- the reference side (this file under __main__) ---------------------------------

def _reference_main(work: Path) -> None:
    """Fingerprints on every mesh; (b): its own run with a checkpoint after
    step 1 and its steps 2-3; (f): the port's four-rank checkpoint
    resharded onto (1, 1, 2) and (1, 1, 1), its global leaves and the next
    step. Everything under ``work``; the metrics in reference.json."""
    import jax

    from repro.core.engine import TrainHparams, ZeroEngine
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.models.config import ShapeConfig
    from repro.models.registry import build_model, get_arch
    from repro.train import checkpoint
    from repro.train.trainer import Trainer

    out = dict(fingerprints={}, elastic={})
    hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"],
                      warmup_steps=max(RUN["steps"] // 20, 2))
    trainers = {}
    for shape in SHAPES + ((1, 1, 2),):
        mesh = make_test_mesh(shape=shape, axes=AX)
        for arch in ARCHS:
            model = build_model(get_arch(arch).reduced())
            for scheme in SCHEMES:
                cfg = scheme_config(scheme, mesh,
                                    quant_block=RUN["quant_block"],
                                    compute_dtype="float32")
                eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp)
                out["fingerprints"][_key(arch, shape, scheme)] = \
                    eng.scheme_fingerprint()
                if arch == ARCH and scheme == "zero_topo":
                    trainers[shape] = (eng, Trainer(
                        model, eng, mesh,
                        ShapeConfig("t", RUN["seq"], RUN["batch"], "train")))

    def step(shape, state, k):
        eng, tr = trainers[shape]
        state, m = tr.step_fn(state, tr._shard_batch(tr.data.batch(k)))
        m = eng.metrics_to_host(m)
        return state, float(m["loss"]), float(m["grad_norm"])

    eng, tr = trainers[(1, 1, 1)]
    state, _, _ = step((1, 1, 1), eng.init_state(jax.random.key(0)), 0)
    checkpoint.save(state, work / "ref_ckpt", 1,
                    scheme=eng.scheme_fingerprint())
    _save_reference_state(work / "ref_state1.npz", state)
    b = dict(losses=[], grad_norms=[])
    for k in (1, 2):
        state, loss, gn = step((1, 1, 1), state, k)
        b["losses"].append(loss)
        b["grad_norms"].append(gn)
    out["resume_b"] = b
    for shape in ((1, 1, 2), (1, 1, 1)):
        eng, tr = trainers[shape]
        state = checkpoint.restore(work / "ckpt4", CKPT_STEP,
                                   eng.state_shardings(),
                                   expect_scheme=eng.scheme_fingerprint(),
                                   reshard=True)
        label = ",".join(map(str, shape))
        _save_reference_state(work / f"reshard_{label}.npz", state)
        _, loss, gn = step(shape, state, CKPT_STEP)
        out["elastic"][label] = dict(losses=[loss], grad_norms=[gn])
    (work / "reference.json").write_text(json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import jax
    jax.config.update("jax_default_matmul_precision", "float32")
    _reference_main(Path(sys.argv[1]))
