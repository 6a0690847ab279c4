"""The port's dry run (``repro_torch.launch.dryrun``), its census
(``launch.census``), the H100 roofline, ``validate`` and ``report``,
against the JAX package's ``launch/`` modules.

One reference subprocess (this file under ``__main__``, 4 forced host
devices) compiles the reference's step of qwen2-0.5b reduced (2 layers,
d_model 256) under zero_topo on (1, 2, 2), block 64, f32, batch 4 x 32, and
returns ``hlo.analyze``'s census of it; one spawn of 4 gloo ranks runs the
port's real step at the same config and returns rank 0's
``collectives.PAYLOAD``. The port's census traces rank 0's step on meta
tensors over a fake 4-rank group. ``test_reduced_census`` holds them
exactly, each difference from the reference named and counted:

* payload: equal label by label (the census records each call's input, as
  ``PAYLOAD`` counts it).
* wire bytes: all-to-all and reduce-scatter equal. All-gather: the
  reference's plus the tied embedding's INT8 shard and scales gathered a
  second time (the port quantizes and gathers them for the lookup and
  again for the head; XLA's CSE shares one gather) and the token count's
  gather (the reference psums the count, an all-reduce of one f32 scalar,
  its only one; the port sums it with ``det_psum``, an all-gather).
* FLOPs: the reference's plus the products the port runs and XLA's
  compiled step does not: ``torch.utils.checkpoint`` recomputes each
  layer's whole forward, its last product (``w_down``) too, whose output
  no backward reads and XLA drops; the checkpointed cross-entropy chunk
  recomputes its logits; the plain attention backward recomputes the score
  product of the remat forward.

The config is f32: XLA's CPU backend widens bf16 reductions and gathers to
f32, which a card's program would not.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from test_torch_train import ARCH, RUN, reduced_arch, run_ranks

MESH_SHAPE = (1, 2, 2)
# would-be launches a rank a step at the card's train phase configuration
# (qwen2-0.5b at published width and 6 layers, batch 8 x 1,024, zero_topo
# on (1, 2, 2), block 128, bf16): chip_smoke.py's per_rank_step_launches
# as measured on one H100 (PERF.md section 6)
CARD_STEP_LAUNCHES = {"quantize_int8": 86, "dequantize_int8": 2,
                      "quantize_int4": 16, "dequantize_int4_sum": 58,
                      "dequant_matmul": 126, "matmul_quant": 42,
                      "flash_attention": 12}
# the reference's record keys (src/repro/launch/dryrun.py:216-230)
RECORD_KEYS = {"arch", "shape", "mesh", "scheme", "serve_mode", "n_chips",
               "n_params", "lower_s", "compile_s", "memory", "cost_analysis",
               "census", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


@pytest.fixture(autouse=True)
def no_group_left():
    """Each test may make this process a rank of a fake group; none is
    left behind for the next test of the worker."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _fake(world: int, rank: int = 0):
    from repro_torch.launch.dryrun import fake_group
    fake_group(world, rank)


def _reduced_engine(rank: int = 0, compute_dtype: str = "float32",
                    arch: str = ARCH, abstract: bool = True):
    """(model, engine) of ``arch`` reduced under zero_topo on (1, 2, 2) at
    ``rank`` of a fake 4-rank group, block 64."""
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    _fake(4, rank)
    mesh = Mesh(MESH_SHAPE, TEST_AXES, rank)
    model = build_model(reduced_arch(get_arch, arch))
    cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                        compute_dtype=compute_dtype)
    if abstract:
        return model, ZeroEngine.abstract(model.leaf_specs(), cfg, mesh)
    return model, ZeroEngine(model.leaf_specs(), cfg, mesh, device="cpu")


# -- the reference's side -------------------------------------------------------

def _reference_main(out: Path) -> None:
    """hlo.analyze's census of the reference's compiled step at the
    reduced config (4 forced host devices)."""
    from repro.core.engine import TrainHparams, ZeroEngine
    from repro.launch import hlo
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.models.config import ShapeConfig
    from repro.models.registry import batch_axes, build_model, get_arch

    model = build_model(reduced_arch(get_arch, ARCH))
    mesh = make_test_mesh(MESH_SHAPE)
    cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                        compute_dtype="float32")
    eng = ZeroEngine(model.leaf_specs(), cfg, mesh, TrainHparams())
    shape = ShapeConfig("t", RUN["seq"], RUN["batch"], "train")
    baxes = batch_axes(mesh, shape.global_batch,
                       candidates=tuple(mesh.axis_names))
    shapes = model.train_batch_shapes(shape)
    step = eng.make_train_step(model.loss_fn(),
                               model.batch_pspecs(shapes, baxes))
    with mesh:
        compiled = step.lower(eng.abstract_state(),
                              model.batch_sds(shapes, mesh, baxes)).compile()
    out.write_text(json.dumps(hlo.analyze(compiled.as_text()).summary()))


@pytest.fixture(scope="module")
def reference_census(tmp_path_factory):
    """Started at first use, read at the end: the reference compiles while
    the port's ranks run."""
    out = tmp_path_factory.mktemp("ref") / "census.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def result() -> dict:
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        return json.loads(out.read_text())
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# -- configs, meshes, the roofline, validate, report ---------------------------

def test_shapes_as_the_reference():
    from repro.models import config as rcfg
    from repro.models.registry import get_arch as rget
    from repro_torch.models import config as pcfg
    from repro_torch.models.registry import get_arch, list_archs

    assert list(pcfg.SHAPES) == list(rcfg.SHAPES)
    for name, shape in pcfg.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            rcfg.SHAPES[name])
    assert pcfg.LONG_CONTEXT_OK == rcfg.LONG_CONTEXT_OK
    for arch in list_archs():
        for name in pcfg.SHAPES:
            assert pcfg.shape_supported(get_arch(arch), pcfg.SHAPES[name]) \
                == rcfg.shape_supported(rget(arch), rcfg.SHAPES[name])


def test_meshes_as_the_reference(monkeypatch):
    """The dry run's meshes have the reference's shapes and axis names
    (its mesh functions read with their device grid stubbed out), and
    ranks row-major as the reference's device ids."""
    from repro.launch import dryrun as rdry
    from repro.launch import mesh as rmesh
    from repro_torch.launch import dryrun

    monkeypatch.setattr(rmesh, "_mk", lambda shape, axes: (shape, axes))
    assert list(dryrun.MESHES) == list(rdry.MESHES)
    for name in dryrun.MESHES:
        shape, axes = rdry.MESHES[name]()
        m = dryrun.MESHES[name]()
        assert (tuple(m.shape.values()), m.axis_names) == (tuple(shape),
                                                           tuple(axes))
        assert m.size in (256, 512) and m.rank == 0
        minor = m.axis_names[-1]
        assert m.members((minor,)) == tuple(range(m.shape[minor]))


def test_model_flops_and_active_params_as_the_reference():
    from repro.launch import roofline as rrl
    from repro.models.registry import build_model as rbuild
    from repro.models.registry import get_arch as rget
    from repro.models.registry import list_archs as rlist
    from repro_torch.launch import roofline
    from repro_torch.models.registry import get_arch, list_archs

    assert list_archs() == rlist()
    for name in list_archs():
        n = rbuild(rget(name)).param_count()
        na = roofline.active_params(get_arch(name), n)
        assert na == rrl.active_params(rget(name), n), name
        for kind in ("train", "prefill", "decode"):
            assert roofline.model_flops(n, na, 4096, kind) \
                == rrl.model_flops(n, na, 4096, kind)


def _reference_target():
    """A Target of the reference's own constants (read here, never
    written into the port)."""
    from repro.launch import roofline as rrl
    from repro_torch.launch.roofline import Target
    return Target(name="reference", peak_flops=rrl.PEAK_FLOPS,
                  peak_flops_f32=rrl.PEAK_FLOPS, hbm_bw=rrl.HBM_BW,
                  link_bw=rrl.ICI_BW, cross_bw=rrl.DCI_BW,
                  hop_lat=rrl.HOP_LAT, node=rrl.POD)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_build_is_the_reference_on_its_constants(kind):
    from repro.launch import roofline as rrl
    from repro.models.registry import get_arch as rget
    from repro_torch.launch import roofline

    census = {"flops": 7.123e14, "hbm_bytes": 2.9e12,
              "total_wire_bytes": 6.1e10,
              "groups": {"all-gather|16|15": [4.2e10, 1253.0],
                         "all-reduce|16|240": [1.3e10, 14.0],
                         "all-to-all|2|256": [6.0e9, 340.0]}}
    n = 41_870_000_000
    na = rrl.active_params(rget("phi3.5-moe-42b-a6.6b"), n)
    for c in (census, {k: v for k, v in census.items() if k != "groups"}):
        kw = dict(n_chips=256, n_params=n, n_active_params=na,
                  tokens=256 * 4096, kind=kind)
        assert roofline.build(c, target=_reference_target(), **kw).summary() \
            == rrl.build(c, **kw).summary()


def test_h100_target():
    """The default target is the H100 SXM5 of the data sheet; f32 products
    are priced at the f32 peak, the rest at the bf16 one."""
    from repro_torch.launch import roofline
    t = roofline.H100_SXM
    assert (t.peak_flops, t.peak_flops_f32, t.hbm_bw) == (989e12, 67e12,
                                                          3.35e12)
    assert (t.link_bw, t.cross_bw, t.node) == (450e9, 50e9, 8)
    c = {"flops": 3.0, "flops_by_dtype": {"bf16": 1.0, "f32": 2.0},
         "hbm_bytes": 0.0, "total_wire_bytes": 0.0,
         "groups": {"all-gather|8|7": [450e9, 1.0],
                    "all-gather|2|8": [50e9, 1.0]}}
    rl = roofline.build(c, n_chips=1, n_params=1, n_active_params=1,
                        tokens=1, kind="train")
    assert rl.compute_s == 1.0 / 989e12 + 2.0 / 67e12
    assert rl.collective_s == 1.0 + 7 * t.hop_lat + 1.0 + t.hop_lat


@pytest.mark.parametrize("scheme", ["zero3", "zeropp", "zero_topo"])
def test_validate_analytic_as_the_reference(scheme):
    """``analytic`` on tests/test_validate.py's stand-in (20 B padded
    parameters, (16, 16) intra model / inter data) equals the reference's,
    and encodes the paper's ratios."""
    from repro.core.partition import preset as rpreset
    from repro.launch.validate import analytic as ranalytic
    from repro_torch.core.partition import preset
    from repro_torch.launch.validate import analytic

    class Eng:
        def padded_param_count(self):
            return 20_000_000_000

    kw = dict(intra_axes=("model",), inter_axes=("data",),
              l0_axes=("model",), axis_sizes={"data": 16, "model": 16})
    got = analytic(Eng(), preset(scheme, **kw))
    assert got == ranalytic(Eng(), rpreset(scheme, **kw))
    v3 = analytic(Eng(), preset("zero3", **kw))
    if scheme == "zeropp":
        assert abs(got["weight_gathers"] / v3["weight_gathers"] - 0.5) < 0.01
        assert abs(got["grad_rs"] / v3["grad_rs"] - 0.125) < 0.01


def test_validate_compare_window(tmp_path):
    """``compare`` reads a record's census and holds it to the analytic
    total of the engine the record's mesh gives: in the window at the
    analytic total, out of it at three times."""
    from repro_torch.launch import validate

    eng = validate.engine_for("qwen2-0.5b", "zeropp", "prod")
    total = validate.analytic(eng, eng.cfg)["total"]
    lines = []
    for factor, ok in ((1.0, True), (3.0, False)):
        rec = tmp_path / f"r{factor}.json"
        rec.write_text(json.dumps({"mesh": "prod", "census": {
            "total_wire_bytes": factor * total}}))
        assert validate.compare("qwen2-0.5b", "zeropp", rec,
                                print_fn=lines.append) is ok
    assert any("ratio 1.00" in ln for ln in lines)


# -- the census ---------------------------------------------------------------

def test_synthetic_census():
    """Known products and one collective of each kind over a fake 4-rank
    group: the exact FLOPs (``2 * prod(out) * K``), the ring wire bytes,
    the counts, the ``op|d|span`` groups and the payload by label, the
    counterpart of tests/test_hlo.py's synthetic module; a kernel billed
    once at its inputs and outputs, its launch counted where the card
    would make it and not under ``impl="plain"``; ``trips``."""
    from repro_torch.core import collectives as col
    from repro_torch.kernels import ops
    from repro_torch.launch.census import Census
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config

    _fake(4)
    mesh = Mesh(MESH_SHAPE, TEST_AXES, 0)
    mesh.bind([("node", "gcd"), ("gcd",), ("node",)])
    col.bind(mesh)
    cfg = scheme_config("zero_topo", mesh, quant_block=64)
    meta = torch.device("meta")
    a = torch.empty(32, 64, device=meta)
    b = torch.empty(64, 16, device=meta)
    x = torch.empty(3, 8, 16, device=meta, dtype=torch.bfloat16)
    y = torch.empty(3, 16, 4, device=meta, dtype=torch.bfloat16)
    w = torch.empty(100, device=meta, dtype=torch.bfloat16)     # 200 bytes
    v = torch.empty(64, device=meta)                            # 256 bytes
    launched = ops.launches()
    with Census() as c:
        a @ b
        torch.bmm(x, y)
        with c.trips(5):
            a @ b
        col.all_gather_flat(w, ("node", "gcd"), cfg)
        col.all_gather_flat(w, ("gcd",), cfg)
        col.psum_scatter(v, ("node", "gcd"), cfg)
        col.seq_sum(v, ("node",))
        col._all_to_all(v.reshape(4, 16), ("node", "gcd"), "all_to_all")
        ops.quantize_int8(torch.empty(256, device=meta), 64, impl="plain")
    s = c.summary()
    mm, bmm = 2 * 32 * 16 * 64, 2 * 3 * 8 * 4 * 16
    assert s["flops"] == 6 * mm + bmm
    assert s["flops_by_dtype"] == {"bf16": bmm, "f32": 6 * mm}
    assert s["wire_bytes"] == {"all-gather": 800 * 3 / 4 + 400 / 2,
                               "reduce-scatter": 64 * 3,
                               "all-reduce": 2 * 256 / 2,
                               "all-to-all": 256 * 3 / 4}
    assert s["total_wire_bytes"] == 600 + 200 + 192 + 256 + 192
    assert s["collective_counts"] == {"all-gather": 2, "reduce-scatter": 1,
                                      "all-reduce": 1, "all-to-all": 1}
    assert s["groups"] == {"all-gather|4|3": [600, 1],
                           "all-gather|2|1": [200, 1],
                           "reduce-scatter|4|3": [192, 1],
                           "all-reduce|2|2": [256, 1],
                           "all-to-all|4|3": [192, 1]}
    assert s["payload"] == {"all_gather": 400, "all_to_all": 256,
                            "psum_scatter": 256, "seq_sum": 256}
    assert [(r.op, r.label, r.d, r.span, r.out_bytes) for r in c.records] \
        == [("all-gather", "all_gather", 4, 3, 800),
            ("all-gather", "all_gather", 2, 1, 400),
            ("reduce-scatter", "psum_scatter", 4, 3, 64),
            ("all-reduce", "seq_sum", 2, 2, 256),
            ("all-to-all", "all_to_all", 4, 3, 256)]
    assert s["unknown_loops"] == 0
    assert not any(s["launches"].values())
    # a gather's HBM bytes are those the card moves: the transport reads
    # the 200-byte operand and writes 4 copies, the stack that orders them
    # reads and writes 800, and the tiling concatenation 800 again
    with Census() as g:
        col.all_gather_flat(w, ("node", "gcd"), cfg)
    assert g.hbm_bytes == 200 + 4 * 200 + 2 * 800 + 2 * 800
    # one kernel call, billed at its input (256 f32) and outputs (256 int8,
    # 4 f32 scales), its launch counted; LAUNCHES untouched
    with Census() as k:
        q, sc = ops.quantize_int8(torch.empty(256, device=meta), 64)
    assert (q.shape, sc.shape, q.dtype) == ((256,), (4,), torch.int8)
    assert k.hbm_bytes == 256 * 4 + 256 + 4 * 4
    assert k.summary()["kernel_bytes"] == {"quantize_int8": k.hbm_bytes}
    assert k.summary()["kernel_flops"] == {"quantize_int8": 0}
    assert k.summary()["launches"] == dict.fromkeys(ops.KERNELS, 0) | {
        "quantize_int8": 1}
    assert ops.launches() == launched


def test_meta_route_is_the_cards():
    """On meta a wrapper counts the launch the card would make and runs
    the plain version; the dispatch on the CPU is untouched, and no other
    device has a route."""
    from repro_torch.kernels import ops

    before = dict(ops.WOULD_LAUNCH)
    q, s = ops.quantize_int4(torch.empty(128, device="meta"), 64)
    assert q.shape == (64,) and q.is_meta
    assert ops.WOULD_LAUNCH["quantize_int4"] == before["quantize_int4"] + 1
    ops.quantize_int4(torch.empty(128, device="meta"), 64, impl="plain")
    ops.quantize_int4(torch.zeros(128), 64)
    assert ops.WOULD_LAUNCH == dict(before, quantize_int4=before[
        "quantize_int4"] + 1)
    assert not ops._kernel(torch.zeros(1), None, "quantize_int4")
    with pytest.raises(ValueError, match="impl"):
        ops._kernel(torch.zeros(1), "pallas", "quantize_int4")


def test_meta_is_no_entry_points_device():
    """``device.resolve`` and the engine refuse meta: only
    ``ZeroEngine.abstract`` (the dry run's construction) builds on it."""
    from repro_torch.core.engine import ZeroEngine
    from repro_torch.device import resolve
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    with pytest.raises(ValueError, match="unsupported device"):
        resolve("meta")
    mesh = Mesh((1, 1, 1), TEST_AXES)
    model = build_model(reduced_arch(get_arch))
    cfg = scheme_config("zero_topo", mesh, quant_block=64)
    with pytest.raises(ValueError, match="unsupported device"):
        ZeroEngine(model.leaf_specs(), cfg, mesh, device="meta")
    assert ZeroEngine.abstract(model.leaf_specs(), cfg, mesh).device.type \
        == "meta"


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return tree


@pytest.mark.parametrize("rank,dtype", [(0, "float32"), (3, "bfloat16")])
def test_abstract_state_is_the_seeded_inits(rank, dtype):
    """``abstract_state`` / ``abstract_primaries`` have the shapes and
    dtypes of ``init_state`` / ``init_primaries``, leaf by leaf, at a rank
    of (1, 2, 2)."""
    from repro_torch.core.engine import ZeroEngine

    model, real = _reduced_engine(rank, dtype, abstract=False)
    abstract = ZeroEngine.abstract(model.leaf_specs(), real.cfg, real.mesh)
    st = abstract.abstract_state()
    assert all(t.is_meta for k in ("primaries", "master", "opt_m", "opt_v")
               for t in st[k].values())
    assert _layout(st) == _layout(real.init_state(0))
    assert _layout(abstract.abstract_primaries()) \
        == _layout(real.init_primaries(0))


@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_abstract_residency_and_serving_inputs(arch):
    """``ResidentServeEngine.abstract_params`` has ``build_resident``'s
    shapes and dtypes; ``prefill_inputs`` the prefill batch's; and
    ``decode_inputs``' caches those of a real prefill of a full-length
    prompt (bf16, the caches' dtype), on one device."""
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.serve.resident import (ResidentLayout,
                                            ResidentServeEngine,
                                            build_resident, iter_primaries)

    torch.manual_seed(0)
    model = build_model(reduced_arch(get_arch, arch))
    cfg = scheme_config("zero_topo", Mesh((1, 1, 1), TEST_AXES),
                        quant_block=64)
    layout = ResidentLayout(model.leaf_specs(), cfg)
    shape = ShapeConfig("d", 16, 2, "decode")
    se = ResidentServeEngine(model, layout, shape)
    res = build_resident(layout, iter_primaries(layout, 0, "cpu"))
    assert _layout(se.abstract_params("meta")) == _layout(res)
    batch = se.prefill_inputs("meta")
    assert _layout(batch) == {k: (sh, dt) for k, (sh, dt) in
                              model.prefill_batch_shapes(shape).items()}
    tokens = torch.randint(0, model.arch.vocab, (2, 16))
    _, caches = se.make_prefill()(res, {"tokens": tokens})
    want, _ = se.decode_inputs("meta")
    assert want["pos"].device.type == "cpu" and int(want["pos"]) == 15
    del want["pos"], caches["pos"]
    assert _layout(want) == _layout(caches)


def _payload_rank(rank: int, metrics: str) -> dict:
    """The port's real step on this gloo rank of (1, 2, 2) at the reduced
    config: its collective payload by label. Then one traced step and its
    probes, whose phase times go to the ``metrics`` JSONL lanes."""
    from repro_torch.core import collectives as col
    from repro_torch.launch.mesh import TEST_AXES, Mesh
    from repro_torch.obs.spans import TraceConfig
    from test_torch_train import _port_setup

    model, eng, tr = _port_setup(ARCH, Mesh(MESH_SHAPE, TEST_AXES, rank),
                                 RUN["seq"])
    state = eng.init_state(0)
    col.reset_counters()
    state, _ = eng.train_step(model.lm.loss, state, tr._batch(0))
    payload = dict(col.PAYLOAD)
    tr.trace = TraceConfig(metrics_path=metrics, probe_every=1)
    tr.run(state, 1, log_every=0)
    return payload


def test_reduced_census(tmp_path, reference_census):
    """Rank 0's census of the reduced step against the real step's payload
    (4 gloo ranks) and the reference's HLO census (the module docstring
    names each difference)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    metrics = tmp_path / "m.jsonl"
    ranks = run_ranks(_payload_rank, 4, tmp_path / "ranks", str(metrics))
    model, eng = _reduced_engine(0)
    shape = ShapeConfig("t", RUN["seq"], RUN["batch"], "train")
    tr = dryrun.trace_step(model, eng, shape)
    got = tr["census"].summary()
    assert got["payload"] == ranks[0]
    ref = reference_census()
    wire, rwire = got["wire_bytes"], ref["wire_bytes"]
    for op in ("all-to-all", "reduce-scatter"):
        assert wire[op] == rwire[op], op
    # the embedding's second gather over W = gcd (2): q (pad int8) and
    # scales (pad / block f32), each V_out * (d - 1) / d; the token count's
    # gather over 4: 4 f32 bytes each, V_out 16, wire 12
    pad, block = eng._pad["embed"], RUN["quant_block"]
    embed = (pad + 4 * pad // block) / 2
    assert wire["all-gather"] == rwire["all-gather"] + embed + 12
    assert "all-reduce" not in wire and rwire["all-reduce"] == 2 * 4 * 3 / 4
    a = model.arch
    tokens = RUN["batch"] * RUN["seq"] // 4
    w_down = a.n_layers * 2 * tokens * a.d_ff * a.d_model
    logits = 2 * tokens * a.d_model * a.vocab
    scores = a.n_layers * a.n_heads * 2 * RUN["seq"] ** 2 * a.hdim
    assert got["flops"] == ref["flops"] + w_down + logits + scores
    assert got["unknown_loops"] == ref["unknown_loops"] == 0
    assert tr["census"].temp_bytes > 0 and tr["argument_bytes"] > 0
    _compare_phases_as_the_reference(model, eng, shape, metrics)


def _compare_phases_as_the_reference(model, eng, shape, metrics):
    """``compare_phases`` on the traced 4-rank run's metrics lanes prints
    the reference's table for the same config (its mesh stood in by
    tests/test_topo.py's): the predicted column at its printed precision,
    and every in-loop phase measured."""
    from test_topo import _FakeMesh

    from repro.launch import dryrun as rdry
    from repro.launch.mesh import scheme_config as rscheme_config
    from repro.models.registry import build_model as rbuild
    from repro.models.registry import get_arch as rget
    from repro_torch.launch import dryrun

    rarch = reduced_arch(rget, ARCH)
    rmesh = _FakeMesh(dict(data=1, node=2, gcd=2), n_processes=1)
    rmesh.size = 4                  # a jax Mesh's device count
    reng = SimpleNamespace(
        hp=eng.hp, cfg=rscheme_config("zero_topo", rmesh,
                                      quant_block=RUN["quant_block"]),
        param_count=rbuild(rarch).param_count)
    rows, table = dryrun.compare_phases(eng, model.arch, shape, eng.mesh,
                                        str(metrics))
    _, want = rdry.compare_phases(reng, rarch, shape, rmesh, str(metrics))
    assert table == want
    for ph in ("fwd_allgather", "bwd_allgather", "grad_rs_w", "grad_rs_e"):
        assert rows[ph]["measured_ms"] > 0 and rows[ph]["predicted_ms"] > 0


def test_compare_serve_phases_as_the_reference(tmp_path):
    """``compare_serve_phases`` of qwen2-0.5b's decode_32k on the production
    mesh, resident, on a serve record: the reference's table (its mesh
    stood in by tests/test_topo.py's)."""
    from test_topo import _FakeMesh

    from repro.launch import dryrun as rdry
    from repro.launch.mesh import scheme_config as rscheme_config
    from repro.models.registry import get_arch as rget
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import scheme_config
    from repro_torch.models.config import SHAPES
    from repro_torch.models.registry import get_arch
    from repro_torch.obs.metrics import SERVE_REQUIRED_FIELDS

    path = tmp_path / "serve.jsonl"
    rec = dict.fromkeys(SERVE_REQUIRED_FIELDS, 0) | {
        "phase_ms": {"serve_decode": 3.25, "serve_admit": 0.5}}
    path.write_text(json.dumps(rec) + "\n")
    shape = SHAPES["decode_32k"]
    mesh = dryrun.MESHES["prod"]()
    eng = SimpleNamespace(cfg=scheme_config("zero_topo", mesh,
                                            quant_block=128))
    rmesh = _FakeMesh(dict(mesh.shape), n_processes=1)
    reng = SimpleNamespace(cfg=rscheme_config("zero_topo", rmesh,
                                              quant_block=128))
    rows, table = dryrun.compare_serve_phases(
        eng, get_arch("qwen2-0.5b"), shape, mesh, str(path))
    _, want = rdry.compare_serve_phases(reng, rget("qwen2-0.5b"), shape,
                                        rmesh, str(path))
    assert table == want
    assert rows["serve_decode"]["measured_ms"] == 3.25
    assert rows["serve_decode"]["predicted_ms"] > 0


def test_card_train_config_launches():
    """At the card's train phase configuration the census's would-be
    launches are those the H100 made a step a rank (CARD_STEP_LAUNCHES)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    eng, arch, shape, tr = dryrun.trace_combo(
        "qwen2-0.5b", "train_4k", "1,2,2", "zero_topo", quant_block=128,
        layers=6, batch=8, seq=1024)
    assert (arch.n_layers, arch.d_model, shape.global_batch, shape.seq_len) \
        == (6, 896, 8, 1024)
    want = dict.fromkeys(ops.KERNELS, 0) | CARD_STEP_LAUNCHES
    assert tr["census"].summary()["launches"] == want


def test_cli_writes_the_reference_record(tmp_path, capsys):
    """One decode combo through the CLI on the production mesh: a record
    with the reference's keys (and the H100 target), the
    census' keys those of ``HLOAnalysis.summary()`` and more, the
    roofline's the reference's; ``report.dryrun_table`` is the
    reference's on it; XLA's flags, and ``--compare`` at a cut depth, are
    refused."""
    from repro.launch import hlo as rhlo
    from repro.launch import report as rreport
    from repro.launch import roofline as rrl
    from repro_torch.launch import dryrun, report

    dryrun.main(["--arch", "qwen2-0.5b", "--layers", "2", "--shape",
                 "decode_32k", "--seq", "1024", "--mesh", "prod",
                 "--serve-mode", "resident", "--quant-block", "128",
                 "--out", str(tmp_path)])
    assert "OK  qwen2-0.5b@L2__decode_32k@b128s1024__prod__zero_topo__" \
        "resident" in capsys.readouterr().out
    [path] = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert RECORD_KEYS | {"target"} == set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rhlo.HLOAnalysis().summary()) < set(rec["census"])
    assert set(rec["roofline"]) == set(rrl.Roofline(1, 1, 1, 1, 1).summary())
    assert rec["n_chips"] == 256 and "H100" in rec["target"]
    assert rec["census"]["launches"]["dequant_matmul"] > 0
    recs = report.load(tmp_path)
    assert report.dryrun_table(recs) == rreport.dryrun_table(recs)
    md = tmp_path / "report.md"
    report.main(["--dir", str(tmp_path), "--out", str(md)])
    assert "## Roofline (one pod, a GPU; NVIDIA H100 80GB HBM3 (SXM5, " \
        "700 W): 989 TFLOP/s bf16" in md.read_text()
    for bad in (["--save-hlo"], ["--kernel-impl", "pallas"],
                ["--layers", "2", "--compare", str(md)]):
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "qwen2-0.5b", "--out", str(tmp_path)]
                        + bad)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    _reference_main(Path(sys.argv[1]))
