"""Serving on a mesh of ranks in the port against the JAX package's.

One reference subprocess (this file under ``__main__``, 4 forced host
devices, ``make_test_mesh(shape=(2, 1, 2))``) and one spawn of 4 port ranks
over gloo serve every test here. The mesh: W = gcd (2), E = node (1), R =
data (2); the decode batch over "data", the full-attention caches along the
sequence over ("node", "gcd"), the residency over the secondary partition
("gcd", "node"), degree 2. Models: qwen2-0.5b, gemma3-1b and
falcon-mamba-7b reduced (``test_torch_train.reduced_arch``), zero_topo,
compute dtype f32, quant block 64, the reference's ``init_state`` carried
across (``convert.from_jax_state``).

* Engine level (``serve.engine.ServeEngine``, the gathered backend; B = 4,
  prompt 16, max length 32): prefill logits, and teacher-forced decode
  logits with each port step started from the reference's f32 caches of
  that step (each rank its rows and its sequence range; in the bf16 caches
  the server keeps, a 1e-6 difference of the new K/V flips the rounding of
  about one element in 2,000 a step, more than the tolerance), within 1e-4
  of the
  reference's ``ServeEngine`` on the same mesh (the matmuls and the
  flash-decode combine sum in another order), and each step's greedy token
  the reference's.
* The degree-2 residency: each rank's q and scales bit for bit the
  reference's shards; the resident backend's prefill and decode logits bit
  for bit the gathered backend's, and its greedy tokens equal.
* ``generate`` on (2, 1, 2) equals ``generate`` on (1, 1, 1) (the
  reference's ``serve_sharded`` scenario), for every model.
* Sequence-parallel prefill within 2e-4 of the plain prefill (the
  reference's ``resident_and_sp`` bound), its sequence chunks held
  against the plain prefill's; a no-op for falcon-mamba (not eligible).
* The qwen2 batcher with both backends, fully provisioned,
  oversubscribed (it preempts) and fully provisioned with the admission
  prefill sequence-parallel: tokens and admission / rejection /
  preemption / retirement counts equal the reference's
  ``ContinuousBatcher`` on (2, 1, 2). gemma is held at the engine level
  only: the reference's batcher cannot serve a sliding-window model.
* The distributed flash-decode against the one-shard version, on the
  ranks; ``sharded_cache_write`` with per-row positions on and off a
  rank's range, in one process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train import AX, reduced_arch, run_ranks

SHAPE = (2, 1, 2)
BLOCK = 64
MODELS = ("qwen2-0.5b", "gemma3-1b", "falcon-mamba-7b")
B, PLEN, MAX_LEN, STEPS = 4, 16, 32, 4
TOL = dict(rtol=1e-4, atol=1e-4)
SP_TOL = dict(rtol=2e-4, atol=2e-4)
GEN = 4
BATCHER_CASES = {
    # fully provisioned: 3 requests recycle 2 slots, one a data rank
    "provisioned": dict(n_slots=2, max_len=32, prompt_len=8, page_size=4,
                        n_pages=0, n_req=3, max_new=5, expect=None),
    # oversubscribed: lazy page growth runs the free list dry mid-decode,
    # the youngest slot is preempted and requeued
    "oversubscribed": dict(n_slots=4, max_len=32, prompt_len=8, page_size=8,
                           n_pages=6, n_req=6, max_new=12,
                           expect="preempted"),
    # the admission prefill sequence-parallel: each rank's prompt chunk
    # gathered over ("node", "gcd") before it is scattered into the pages
    "provisioned-sp": dict(n_slots=2, max_len=32, prompt_len=8, page_size=4,
                           n_pages=0, n_req=3, max_new=5, expect=None,
                           sp=True),
}
BACKENDS = ("gathered", "resident")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _prompts(case: dict, vocab: int) -> list:
    return [_tokens(10 + i, (case["prompt_len"],), vocab)
            for i in range(case["n_req"])]


# -- the reference, on 4 host devices ------------------------------------------

def _reference_model(name: str, out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.core.engine import TrainHparams, ZeroEngine
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.models.config import ShapeConfig
    from repro.models.registry import build_model, get_arch
    from repro.serve.engine import ServeEngine
    from repro.serve.resident import build_resident
    from repro.serve.scheduler import _grow_seq
    from test_torch_train import _save_reference_state

    out.mkdir()
    mesh = make_test_mesh(shape=SHAPE, axes=AX)
    arch = reduced_arch(get_arch, name)
    model = build_model(arch)
    cfg = scheme_config("zero_topo", mesh, quant_block=BLOCK,
                        compute_dtype="float32")
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, TrainHparams())
    state = eng.init_state(jax.random.key(0))
    _save_reference_state(out / "state.npz", state)
    layout, res = build_resident(eng, state, mesh)
    np.savez(out / "residency.npz", **{
        f"{n}/{k}": np.asarray(v) for n, e in res.items()
        if layout.mode(n) == "wire" for k, v in e.items()})

    prim = state["primaries"]
    tokens = _tokens(1, (B, PLEN), arch.vocab)
    pre = ServeEngine(model, eng, mesh,
                      ShapeConfig("p", PLEN, B, "decode")).make_prefill()
    logits, c = pre(prim, {"tokens": jnp.asarray(tokens)})
    dshape = ShapeConfig("d", MAX_LEN, B, "decode")
    # the caches stay f32: a decode step writes its new K/V into them
    # before it attends, and in bf16 a 1e-6 difference of the two
    # packages' f32 K/V flips the rounding of about one element a step
    c = _grow_seq(c, model, MAX_LEN)
    dec = ServeEngine(model, eng, mesh, dshape).make_decode()
    arrays = {"prefill_logits": np.asarray(logits), "tokens": tokens}
    greedy = []
    for i in range(STEPS):
        for k, v in c.items():
            if k != "pos":
                for n, a in v.items():
                    arrays[f"cache{i}/{k}/{n}"] = np.asarray(a)
        tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
        greedy.append(tok)
        logits, c = dec(prim, c, {"token": jnp.asarray(tok)})
        arrays[f"logits{i}"] = np.asarray(logits)
    arrays["greedy"] = np.stack(greedy)
    np.savez(out / "engine.npz", **arrays)


def _reference_batchers(out: Path) -> None:
    import jax

    from repro.core.engine import TrainHparams, ZeroEngine
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.models.registry import build_model, get_arch
    from repro.serve.resident import build_resident
    from repro.serve.scheduler import ContinuousBatcher, Request, ServeSLO

    mesh = make_test_mesh(shape=SHAPE, axes=AX)
    arch = reduced_arch(get_arch, "qwen2-0.5b")
    model = build_model(arch)
    cfg = scheme_config("zero_topo", mesh, quant_block=BLOCK,
                        compute_dtype="float32")
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, TrainHparams())
    state = eng.init_state(jax.random.key(0))
    res = build_resident(eng, state, mesh)[1]
    got = {}
    for case_name, case in BATCHER_CASES.items():
        for backend in BACKENDS:
            cb = ContinuousBatcher(
                model, eng, mesh, n_slots=case["n_slots"],
                max_len=case["max_len"], prompt_len=case["prompt_len"],
                page_size=case["page_size"], n_pages=case["n_pages"],
                slo=ServeSLO(max_queue_steps=50), backend=backend,
                prefill_seq_parallel=case.get("sp", False))
            reqs = [Request(rid=i, prompt=p, max_new=case["max_new"])
                    for i, p in enumerate(_prompts(case, arch.vocab))]
            cb.run(res if backend == "resident" else state["primaries"],
                   reqs)
            got[f"{case_name}/{backend}"] = dict(
                counters=cb.counters, steps=cb.step_count,
                tokens=[[int(t) for t in r.out] for r in reqs],
                rejected=[r.rejected for r in reqs])
    (out / "batchers.json").write_text(json.dumps(got))


def _reference_main(out_dir: Path) -> None:
    for name in MODELS:
        _reference_model(name, out_dir / name)
    _reference_batchers(out_dir)


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

def _engine(name: str, mesh, state_npz):
    """The port's model, ZeroEngine on ``mesh`` and this rank's state from
    the reference's global state."""
    from repro_torch.convert import from_jax_state, load_global_state
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.launch.mesh import scheme_config
    from repro_torch.models.registry import build_model, get_arch

    model = build_model(reduced_arch(get_arch, name))
    cfg = scheme_config("zero_topo", mesh, quant_block=BLOCK,
                        compute_dtype="float32")
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, device="cpu")
    return model, eng, from_jax_state(load_global_state(state_npz), eng)


def _local_caches(z, step: int, serve) -> dict:
    """This rank's caches of the reference's global caches of ``step``:
    its rows, and of the sequence-sharded entries its range."""
    shapes = serve.cache_shapes()
    out = {}
    for kind, entry in shapes.items():
        out[kind] = {}
        for name, (sh, _, seq) in entry.items():
            t = torch.from_numpy(z[f"cache{step}/{kind}/{name}"])
            t = t[:, serve.row0:serve.row0 + serve.b_loc]
            if seq:
                s_loc = sh[2]
                i = serve.mesh.index(serve.sc.seq_axes)
                t = t[:, :, i * s_loc:(i + 1) * s_loc]
            out[kind][name] = t.clone()
    out["pos"] = torch.tensor(PLEN + step, dtype=torch.int32)
    return out


def _serve_model(rank: int, name: str, ref: Path) -> dict:
    from repro_torch.launch.mesh import TEST_AXES, Mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.resident import (ResidentLayout,
                                            ResidentServeEngine,
                                            build_resident)

    mesh = Mesh(SHAPE, TEST_AXES, rank)
    model, eng, state = _engine(name, mesh, ref / name / "state.npz")
    prim = state["primaries"]
    layout = ResidentLayout(eng.specs, eng.cfg, None, mesh)
    res = build_resident(layout, prim.items())
    seeded = eng.init_state(5)["primaries"]
    out = dict(init_primaries_equal=all(
                   torch.equal(t, seeded[n])
                   for n, t in eng.init_primaries(5).items()),
               res_axes=layout.res_axes, res_degree=layout.res_degree,
               res_index=mesh.index(layout.res_axes),
               residency={n: (e["q"], e["s"]) for n, e in res.items()
                          if layout.mode(n) == "wire"},
               memory=layout.memory_report())
    z = np.load(ref / name / "engine.npz")
    tokens = torch.from_numpy(z["tokens"]).long()
    pshape = ShapeConfig("p", PLEN, B, "decode")
    dshape = ShapeConfig("d", MAX_LEN, B, "decode")
    for backend, serve_p, serve_d, params in (
            ("gathered", ServeEngine(model, eng, mesh, pshape),
             ServeEngine(model, eng, mesh, dshape), prim),
            ("resident", ResidentServeEngine(model, layout, pshape, mesh),
             ResidentServeEngine(model, layout, dshape, mesh), res)):
        logits, caches = serve_p.make_prefill()(params, {"tokens": tokens})
        got = dict(prefill=serve_p.gather_rows(logits),
                   prefill_k=caches.get("attn", {}).get("k"), decode=[])
        dec = serve_d.make_decode()
        for i in range(STEPS):
            c = _local_caches(z, i, serve_d)
            tok = torch.from_numpy(z["greedy"][i]).long()
            logits, _ = dec(params, c, {"token": tok})
            got["decode"].append(serve_d.gather_rows(logits))
        got["generate"] = serve_p.generate(params, {"tokens": tokens}, GEN)
        out[backend] = got
    sp = ServeEngine(model, eng, mesh, pshape)
    lp, cp = sp.make_prefill(seq_parallel=False)(prim, {"tokens": tokens})
    ls, cs = sp.make_prefill(seq_parallel=True)(prim, {"tokens": tokens})
    out["sp"] = dict(plain=sp.gather_rows(lp), sp=sp.gather_rows(ls),
                     caches_plain=cp, caches_sp=cs,
                     eligible=model.lm.sp_eligible())
    if model.arch.sliding_window:
        # a prompt past the window: the local layers' masks cut in and
        # their rings, built from the gathered K/V, wrap
        n = 2 * model.arch.sliding_window
        long = torch.from_numpy(_tokens(2, (B, n), model.arch.vocab)).long()
        sp = ServeEngine(model, eng, mesh, ShapeConfig("l", n, B, "decode"))
        lp, cp = sp.make_prefill(seq_parallel=False)(prim, {"tokens": long})
        ls, cs = sp.make_prefill(seq_parallel=True)(prim, {"tokens": long})
        out["sp_long"] = dict(plain=sp.gather_rows(lp), sp=sp.gather_rows(ls),
                              caches_plain=cp, caches_sp=cs, eligible=True)
    return out


def _serve_batchers(rank: int, ref: Path) -> dict:
    from repro_torch.core import collectives as col
    from repro_torch.launch.mesh import TEST_AXES, Mesh
    from repro_torch.serve.resident import build_resident
    from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                             ServeSLO)

    mesh = Mesh(SHAPE, TEST_AXES, rank)
    model, eng, state = _engine("qwen2-0.5b", mesh,
                                ref / "qwen2-0.5b" / "state.npz")
    got = {}
    for case_name, case in BATCHER_CASES.items():
        for backend in BACKENDS:
            cb = ContinuousBatcher(
                model, eng, mesh, n_slots=case["n_slots"],
                max_len=case["max_len"], prompt_len=case["prompt_len"],
                page_size=case["page_size"], n_pages=case["n_pages"],
                slo=ServeSLO(max_queue_steps=50), backend=backend,
                prefill_seq_parallel=case.get("sp", False))
            params = build_resident(cb.layout, state["primaries"].items()) \
                if backend == "resident" else state["primaries"]
            reqs = [Request(rid=i, prompt=p, max_new=case["max_new"])
                    for i, p in enumerate(_prompts(case, model.arch.vocab))]
            col.reset_counters()
            cb.run(params, reqs)
            got[f"{case_name}/{backend}"] = dict(
                seq_gather=col.PAYLOAD.get("seq_gather", 0),
                counters=cb.counters, steps=cb.step_count,
                tokens=[list(r.out) for r in reqs],
                rejected=[r.rejected for r in reqs],
                free=cb.paged.free_pages() == cb.paged.n_pages)
    return got


def _flash_decode_combine(rank: int) -> dict:
    """Each rank's slice of one global (B, 32, Hkv, D) cache through the
    distributed flash-decode, and the whole cache through the one-shard
    version, at per-row positions on both sides of the split."""
    from repro_torch.core import collectives as col
    from repro_torch.launch.mesh import TEST_AXES, Mesh, serve_axis_tuples
    from repro_torch.models import layers

    mesh = Mesh(SHAPE, TEST_AXES, rank)
    mesh.bind(serve_axis_tuples(mesh))
    col.bind(mesh)
    gen = torch.Generator().manual_seed(7)
    q = torch.randn((3, 4, 16), generator=gen)
    k = torch.randn((3, 32, 2, 16), generator=gen)
    v = torch.randn((3, 32, 2, 16), generator=gen)
    pos = torch.tensor([3, 17, 31])
    axes = ("node", "gcd")
    i = mesh.index(axes)
    sizes = dict(mesh.shape)
    off = layers.seq_offset(axes, sizes, 16)
    got = layers.flash_decode(q, k[:, off:off + 16], v[:, off:off + 16], pos,
                              seq_axes=axes, seq_offset=off)
    return dict(index=i, offset=off, got=got,
                want=layers.flash_decode(q, k, v, pos))


def _port_main(rank: int, ref: Path) -> dict:
    out = {name: _serve_model(rank, name, ref) for name in MODELS}
    out["batchers"] = _serve_batchers(rank, ref)
    out["combine"] = _flash_decode_combine(rank)
    return out


@pytest.fixture(scope="module")
def port(ref_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    return run_ranks(_port_main, 4, tmp / "ranks", ref_dir)


# -- the engine level --------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_logits(ref_dir, port, name, backend):
    z = np.load(ref_dir / name / "engine.npz")
    for r in port:       # every rank holds every row after the gather
        got = r[name][backend]
        np.testing.assert_allclose(got["prefill"].numpy(),
                                   z["prefill_logits"], **TOL)
        for i in range(STEPS):
            np.testing.assert_allclose(got["decode"][i].numpy(),
                                       z[f"logits{i}"], **TOL,
                                       err_msg=f"decode step {i}")
            # the greedy token of the next step is the reference's
            if i + 1 < STEPS:
                np.testing.assert_array_equal(
                    got["decode"][i].argmax(dim=-1).numpy(),
                    z["greedy"][i + 1])


@pytest.mark.parametrize("name", MODELS)
def test_residency_shards_bitwise(ref_dir, port, name):
    with np.load(ref_dir / name / "residency.npz") as z:
        wire = {k.split("/")[0] for k in z.files}
        for r in port:
            mine = r[name]
            assert mine["res_axes"] == ("gcd", "node")
            assert mine["res_degree"] == 2
            assert set(mine["residency"]) == wire
            idx = mine["res_index"]
            for n in wire:
                q, s = mine["residency"][n]
                for k, t in (("q", q), ("s", s)):
                    full = z[f"{n}/{k}"]
                    w = full.shape[-1] // 2
                    want = full[..., idx * w:(idx + 1) * w]
                    assert t.dtype == (torch.int8 if k == "q"
                                       else torch.float32)
                    np.testing.assert_array_equal(
                        t.numpy().view(np.int8 if k == "q" else np.int32),
                        want.view(np.int8 if k == "q" else np.int32),
                        err_msg=f"{n}/{k} shard {idx}")
            rep = mine["memory"]
            assert rep["res_degree"] == 2 and rep["wire_bytes"] == sum(
                q.numel() + 4 * s.numel()
                for q, s in mine["residency"].values())


@pytest.mark.parametrize("name", MODELS)
def test_resident_bitwise_the_gathered(port, name):
    """The degree-2 residency (slices re-gathered over ("gcd", "node") per
    product) is bit for bit the gathered backend's logits and tokens."""
    for r in port:
        g, res = r[name]["gathered"], r[name]["resident"]
        assert torch.equal(g["prefill"], res["prefill"])
        for a, b in zip(g["decode"], res["decode"]):
            assert torch.equal(a, b)
        assert torch.equal(g["generate"], res["generate"])


def _one_device_generate(ref_dir, name: str) -> torch.Tensor:
    """The gathered backend's ``generate`` on (1, 1, 1) in this process,
    from the reference's weights re-padded to the one-device layout."""
    from repro_torch.convert import load_global_state
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.serve.engine import ServeEngine

    mesh = Mesh((1, 1, 1), TEST_AXES)
    model = build_model(reduced_arch(get_arch, name))
    eng = ZeroEngine(model.leaf_specs(), scheme_config(
        "zero_topo", mesh, quant_block=BLOCK, compute_dtype="float32"), mesh,
        device="cpu")
    glob = load_global_state(ref_dir / name / "state.npz")["primaries"]
    prim = {}
    for n, spec in eng.specs.items():
        t = glob[n][..., :spec.logical_size]
        prim[n] = torch.nn.functional.pad(
            t, (0, eng._pad[n] - spec.logical_size))
    z = np.load(ref_dir / name / "engine.npz")
    serve = ServeEngine(model, eng, mesh, ShapeConfig("g", PLEN, B, "decode"))
    return serve.generate(prim, {"tokens": torch.from_numpy(z["tokens"])
                                 .long()}, GEN)


@pytest.mark.parametrize("name", MODELS)
def test_mesh_tokens_equal_one_device(ref_dir, port, name):
    """The reference's ``serve_sharded`` scenario: (2, 1, 2) greedy tokens
    equal (1, 1, 1)'s."""
    one = _one_device_generate(ref_dir, name)
    assert one.shape == (B, GEN) and one.dtype == torch.int32
    for r in port:
        assert torch.equal(r[name]["gathered"]["generate"], one)


@pytest.mark.parametrize("name,key", [(n, "sp") for n in MODELS]
                         + [("gemma3-1b", "sp_long")])
def test_seq_parallel_prefill(port, name, key):
    """Sequence-parallel prefill within 2e-4 of the plain prefill (logits
    and this rank's sequence chunk of every full-attention cache, rings
    whole; gemma also at a prompt of twice its window, "sp_long"); for a
    model that is not eligible (falcon-mamba), bit for bit the plain
    prefill."""
    for r in port:
        sp = r[name][key]
        if not sp["eligible"]:
            assert torch.equal(sp["sp"], sp["plain"])
            continue
        np.testing.assert_allclose(sp["sp"].numpy(), sp["plain"].numpy(),
                                   **SP_TOL)
        for kind, entry in sp["caches_plain"].items():
            if kind == "pos":
                assert int(sp["caches_sp"]["pos"]) == int(entry)
                continue
            for n, t in entry.items():
                assert t.shape == sp["caches_sp"][kind][n].shape
                np.testing.assert_allclose(sp["caches_sp"][kind][n].numpy(),
                                           t.numpy(), **SP_TOL)


def test_prefill_cache_is_the_rank_chunk(port):
    """qwen2's prefill keeps this rank's sequence chunk (PLEN / 2) of the
    full-attention cache, the same on both backends."""
    for r in port:
        g = r["qwen2-0.5b"]["gathered"]["prefill_k"]
        assert g.shape[1:3] == (B // 2, PLEN // 2)
        assert torch.equal(g, r["qwen2-0.5b"]["resident"]["prefill_k"])


@pytest.mark.parametrize("name", MODELS)
def test_init_primaries_are_init_states(port, name):
    """Serving's seeded weights (``ZeroEngine.init_primaries``: no master,
    no optimizer state) are ``init_state``'s primaries bit for bit: each
    rank's shards on (2, 1, 2) at f32, and on one device at bf16 (the draw
    rounded once, as ``init_state`` rounds its f32 master)."""
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    assert all(r[name]["init_primaries_equal"] for r in port)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    model = build_model(reduced_arch(get_arch, name))
    eng = ZeroEngine(model.leaf_specs(), scheme_config(
        "zero_topo", mesh, quant_block=BLOCK), mesh, device="cpu")
    want = eng.init_state(3)["primaries"]
    got = eng.init_primaries(3)
    assert got.keys() == want.keys()
    for n, t in got.items():
        assert t.dtype == torch.bfloat16 and t.shape == want[n].shape
        assert torch.equal(t.view(torch.int16), want[n].view(torch.int16)), n


# -- the batcher -----------------------------------------------------------------

@pytest.mark.parametrize("case", list(BATCHER_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_batcher_tokens_and_counters(ref_dir, port, case, backend):
    ref = json.loads((ref_dir / "batchers.json").read_text())[
        f"{case}/{backend}"]
    for r in port:
        got = r["batchers"][f"{case}/{backend}"]
        assert got["counters"] == ref["counters"]
        assert got["steps"] == ref["steps"]
        assert got["tokens"] == ref["tokens"]
        assert got["rejected"] == ref["rejected"]
        assert got["free"]
        # only a sequence-parallel admission gathers its prompt's cache
        assert (got["seq_gather"] > 0) == BATCHER_CASES[case].get("sp", False)
    assert any(ref["tokens"])
    expect = BATCHER_CASES[case]["expect"]
    if expect:
        assert ref["counters"][expect] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_cli_four_ranks(capfd, tmp_path, backend):
    """``launch.serve`` with ``--devices 4 --mesh-shape 2,1,2`` on the CPU:
    four ranks forked from the train launcher's fork server, each with the
    same tokens and counters; rank 0 prints the summary and writes the
    serve schema's metrics lane (its records read back with the schema
    checked)."""
    from repro_torch.launch import serve
    from repro_torch.obs.metrics import SERVE_REQUIRED_FIELDS, read_jsonl

    path = tmp_path / "serve.jsonl"
    results = serve.main(["--device", "cpu", "--reduced", "--devices", "4",
                          "--mesh-shape", "2,1,2", "--backend", backend,
                          "--requests", "3", "--slots", "2", "--prompt-len",
                          "8", "--max-len", "32", "--gen", "4",
                          "--metrics-jsonl", str(path)])
    recs = read_jsonl(path, SERVE_REQUIRED_FIELDS)
    assert len(recs) == results[0]["steps"]
    assert all(r["rank"] == 0 for r in recs)
    assert recs[-1]["retired"] == 3
    out = capfd.readouterr().out
    assert f"metrics: {path} " in out
    assert f"backend={backend} 3 reqs -> 12 tokens" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    for r in results:
        assert r["mesh"] == [2, 1, 2] and r["backend"] == backend
        assert r["tokens"] == results[0]["tokens"]
        assert r["counters"] == results[0]["counters"]
    pay = results[0]["payload_bytes"]
    assert pay["batch_gather"] > 0 and pay["seq_sum"] > 0
    # the admission's prefill cache is whole on every rank: nothing gathered
    assert "seq_gather" not in pay
    key = "residency_gather" if backend == "resident" else "all_gather"
    assert pay[key] > 0
    if backend == "resident":
        # decode re-gathers the residency: nothing is gathered over W
        assert results[0]["memory"]["res_degree"] == 2
        assert "all_gather" not in pay


# -- the layers ------------------------------------------------------------------

def test_flash_decode_combine(port):
    """The partial softmax of each rank's half of the cache, combined over
    ("node", "gcd"), against the whole cache in one shard: rows at
    positions 3 (the second half all masked), 17 and 31."""
    for r in port:
        c = r["combine"]
        assert c["offset"] == 16 * c["index"]
        np.testing.assert_allclose(c["got"].numpy(), c["want"].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("coord", [0, 1])
def test_sharded_cache_write_owner_only(coord):
    """Per-row positions on a mesh whose sequence axis ("gcd") has 2 ranks
    of 8 positions each: a row is written only by the rank that owns its
    position; a scalar position outside the range writes nothing."""
    from repro_torch.core import collectives as col
    from repro_torch.launch.mesh import TEST_AXES, Mesh
    from repro_torch.models import layers

    col.bind(Mesh((1, 1, 2), TEST_AXES, rank=coord))
    try:
        axes, sizes = ("node", "gcd"), {"data": 1, "node": 1, "gcd": 2}
        cache = torch.zeros((3, 8, 1, 2))
        new = torch.arange(1, 4, dtype=torch.float32).reshape(3, 1, 1, 1) \
            .expand(3, 1, 1, 2)
        pos = torch.tensor([2, 9, 15])
        out = layers.sharded_cache_write(cache, new, pos, seq_axes=axes,
                                         axis_sizes=sizes)
        assert out is cache
        want = torch.zeros_like(cache)
        for row, p in enumerate(pos.tolist()):
            if p // 8 == coord:
                want[row, p % 8] = row + 1
        assert torch.equal(cache, want)
        before = cache.clone()
        layers.sharded_cache_write(cache, new, 8 * (1 - coord) + 3,
                                   seq_axes=axes, axis_sizes=sizes)
        assert torch.equal(cache, before)
        layers.sharded_cache_write(cache, new, 8 * coord + 5, seq_axes=axes,
                                   axis_sizes=sizes)
        assert torch.equal(cache[:, 5], new[:, 0])
    finally:
        col.bind(None)


def test_sharded_cache_write_without_axes_as_before():
    """No axes: a per-row write lands at each row's position, a scalar one
    past the cache writes nothing (the one-device serving path)."""
    from repro_torch.models import layers

    cache = torch.zeros((2, 4, 1, 1))
    new = torch.ones((2, 1, 1, 1))
    layers.sharded_cache_write(cache, new, torch.tensor([0, 3]))
    assert cache[0, 0].item() == 1 and cache[1, 3].item() == 1
    assert cache.sum().item() == 2
    layers.sharded_cache_write(cache, new, 4)
    assert cache.sum().item() == 2


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import jax
    jax.config.update("jax_default_matmul_precision", "float32")
    _reference_main(Path(sys.argv[1]))
