"""The port's topology planner and cost model (``repro_torch.topo``) and
``scheme_config("auto")`` against the reference's (``repro.topo``).

Pure Python on both sides: the same inputs go through each package and
the results must be *equal*, not close. The planner sorts by predicted
step time with a stable sort, and on (1, 2, 2) its first two plans tie
exactly (``data`` has size 1), so which one ``--scheme auto`` trains rests
on the candidates' order and on every float operation of the cost model.

The reference's meshes for ``Topology.from_mesh`` and ``scheme_config``
are ``make_test_mesh`` meshes on forced host devices, built in one
subprocess (this file under ``__main__``); the host-boundary cases use the
reference's own duck-typed fake-process mesh (``test_topo._FakeMesh``)
against the port's ``Mesh`` with the same rank -> host map.
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from repro.models.registry import list_archs as ref_archs
from repro.obs import calibrate as rcal
from repro.topo import cost as rcost
from repro.topo import model as rmodel
from repro.topo import planner as rplanner
from repro_torch.obs import calibrate as pcal
from repro_torch.topo import cost as pcost
from repro_torch.topo import model as pmodel
from repro_torch.topo import planner as pplanner

AX = ("data", "node", "gcd")
MESH_SHAPES = [(1, 1, 1), (1, 2, 2), (2, 1, 2), (2, 2, 2)]
# scheme_config("auto", mesh, **kw): the default workload, a model's,
# a budget, the streaming regime, overrides applied to the choice
AUTO_VARIANTS = {
    "default": {},
    "qwen2": dict(psi=494_032_768, n_layers=24),
    "budget": dict(psi=225_609_856, n_layers=6, memory_budget=80e9),
    "tight": dict(memory_budget=16e9),
    "stream": dict(stream_grads=True),
    "over": dict(quant_block=64, overlap=True, compute_dtype="float32",
                 cross_replica="reduce_scatter"),
}
PRESET_TOPOS = ("frontier", "gpu_pod", "tpu")
ARCHS = ref_archs()
SRC = str(Path(__file__).resolve().parents[1] / "src")
SCHEMES = ("zero3", "zeropp", "zero_topo", "zero1", "zero2", "auto")


def _json(x):
    return json.loads(json.dumps(x))


def _cfg(cfg) -> dict:
    """A ZeroConfig as plain data: every field, and its fingerprint."""
    return _json(dict(fields=dataclasses.asdict(cfg),
                      fingerprint=cfg.fingerprint()))


def random_topology(mod, seed: int):
    """tests/test_topo.py's random topology, built from ``mod``'s classes."""
    rng = random.Random(seed)
    k = rng.randint(1, 4)
    tiers = ["l0", "intra", "inter"]
    links = []
    bw = rng.uniform(100e9, 400e9)
    for i in range(k):
        links.append(mod.Link(f"ax{i}", rng.choice([1, 2, 3, 4]), bw,
                              rng.uniform(1e-6, 20e-6),
                              tiers[min(i, 2)] if rng.random() < 0.8
                              else rng.choice(tiers)))
        bw /= rng.uniform(1.5, 16.0)
    return mod.Topology(f"rand{rng.random():.6f}", tuple(links),
                        flops_per_device=rng.uniform(50e12, 400e12),
                        hbm_bytes=rng.choice([16e9, 64e9, 1e15]))


def _topos(spec):
    if isinstance(spec, int):
        return random_topology(rmodel, spec), random_topology(pmodel, spec)
    return rmodel.load_topology(spec), pmodel.load_topology(spec)


def _plans(plans):
    return [(p.label, p.step_s, p.cost.fits, p.cost.memory_total)
            for p in plans]


@pytest.mark.parametrize("quantize", [None, True, False])
@pytest.mark.parametrize("spec", list(range(8)) + list(PRESET_TOPOS))
def test_enumerate_candidates_same_order(spec, quantize):
    ref, port = _topos(spec)
    assert port.to_dict() == ref.to_dict()
    want = [_cfg(c) for c in rplanner.enumerate_candidates(ref,
                                                           quantize=quantize)]
    got = [_cfg(c) for c in pplanner.enumerate_candidates(port,
                                                          quantize=quantize)]
    assert got == want


def test_list_archs_and_param_count():
    from repro.models.registry import build_model as rbuild
    from repro.models.registry import get_arch as rget
    from repro.models.registry import list_archs as rlist
    from repro_torch.models.registry import build_model, get_arch, list_archs
    assert list_archs() == rlist()
    for name in list_archs():
        assert build_model(get_arch(name)).param_count() \
            == rbuild(rget(name)).param_count(), name


@pytest.mark.parametrize("topo", PRESET_TOPOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches(arch, topo):
    """Every registered model's workload on every preset, at budgets None /
    64 GB / 16 GB, seed and streaming regime: the same plans in the same
    order with equal step_s, fits and memory_total."""
    ref, port = _topos(topo)
    for stream in (False, True):
        rwl = rplanner.model_workload(arch, stream_grads=stream)
        pwl = pplanner.model_workload(arch, stream_grads=stream)
        assert dataclasses.asdict(pwl) == dataclasses.asdict(rwl)
        for budget in (None, 64e9, 16e9):
            assert _plans(pplanner.plan(port, pwl, memory_budget=budget)) \
                == _plans(rplanner.plan(ref, rwl, memory_budget=budget)), \
                (stream, budget)


def _scheme_cfg(mod_planner, topo, scheme, wl):
    if scheme == "auto":
        return mod_planner.plan(topo, wl)[0].cfg
    return mod_planner.preset_on_topology(scheme, topo)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("topo", PRESET_TOPOS)
def test_cost_model_equal(topo, scheme):
    """phase_volumes, phase_axes, phase_breakdown, step_cost (fused and
    not, seed and streaming), memory_bytes and tflops_per_device: equal
    floats for the five presets and the planner's choice."""
    ref, port = _topos(topo)
    for kw in (dict(psi=20e9, n_layers=44),
               dict(psi=494_032_768, n_layers=24, fused_kernels=False),
               dict(psi=1e9, n_layers=16, stream_grads=True,
                    n_microbatch=2, tokens_per_device_mb=33)):
        rwl, pwl = rcost.Workload(**kw), pcost.Workload(**kw)
        rc = _scheme_cfg(rplanner, ref, scheme, rwl)
        pc = _scheme_cfg(pplanner, port, scheme, pwl)
        assert _cfg(pc) == _cfg(rc)
        assert pcost.phase_volumes(pc, pwl.psi) \
            == rcost.phase_volumes(rc, rwl.psi)
        assert pcost.phase_axes(pc) == rcost.phase_axes(rc)
        assert pcost.phase_breakdown(pc, port, pwl) \
            == rcost.phase_breakdown(rc, ref, rwl)
        for budget in (None, 16e9):
            r = rcost.step_cost(rc, ref, rwl, memory_budget=budget)
            p = pcost.step_cost(pc, port, pwl, memory_budget=budget)
            assert dataclasses.asdict(p) == dataclasses.asdict(r)
            assert p.step_s(pwl.hidden_fraction) \
                == r.step_s(rwl.hidden_fraction)
        for streaming in (None, False, True):
            assert pcost.memory_bytes(pc, pwl.psi, streaming=streaming) \
                == rcost.memory_bytes(rc, rwl.psi, streaming=streaming)
        assert pcost.tflops_per_device(pc, port, pwl) \
            == rcost.tflops_per_device(rc, ref, rwl)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_workload_and_plan(arch):
    """The exact all-layer KV bytes a token (torch dtypes' element_size
    here, numpy itemsize there) and the serving plans."""
    rwl = rplanner.serve_workload_for_model(arch)
    pwl = pplanner.serve_workload_for_model(arch, n_slots=8)
    assert dataclasses.asdict(pwl) == dataclasses.asdict(rwl)
    for topo in ("frontier", "gpu_pod"):
        ref, port = _topos(topo)
        for budget in (None, 8e9):
            r = rplanner.plan_serve(ref, rwl, memory_budget=budget)
            p = pplanner.plan_serve(port, pwl, memory_budget=budget)
            assert [(x.label, x.tok_s, x.cost.fits, x.cost.memory_total,
                     x.cost.step_s(), x.cost.arithmetic_intensity())
                    for x in p] == \
                [(x.label, x.tok_s, x.cost.fits, x.cost.memory_total,
                  x.cost.step_s(), x.cost.arithmetic_intensity()) for x in r]


def _crossload_cases():
    return ["frontier", "gpu_pod", "tpu", "calibrated", "scaled"]


@pytest.mark.parametrize("case", _crossload_cases())
def test_topology_json_crossloads(tmp_path, case):
    """Each package loads the other's Topology file; to_dict is equal."""
    def make(mod):
        if case == "calibrated":
            return mod.calibrated(mod.frontier(4), {"node": 55e9, "gcd": 0.0})
        if case == "scaled":
            return mod.scaled(mod.gpu_pod(), "data", 7)
        return mod.load_topology(case)
    ref, port = make(rmodel), make(pmodel)
    assert port.to_dict() == ref.to_dict()
    port.save(tmp_path / "p.json")
    ref.save(tmp_path / "r.json")
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()
    assert rmodel.load_topology(str(tmp_path / "p.json")).to_dict() \
        == ref.to_dict()
    assert pmodel.load_topology(str(tmp_path / "r.json")).to_dict() \
        == ref.to_dict()


# -- live meshes: the reference's make_test_mesh in a subprocess ---------------

def reference_meshes(out: Path) -> None:
    """The reference's Topology.from_mesh and scheme_config("auto") on
    make_test_mesh for every MESH_SHAPES x AUTO_VARIANTS, into ``out``."""
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.topo.model import Topology
    res = {}
    for shape in MESH_SHAPES:
        mesh = make_test_mesh(shape=shape, axes=AX)
        key = ",".join(map(str, shape))
        res[key] = dict(
            topology=Topology.from_mesh(mesh).to_dict(),
            auto={name: _cfg(scheme_config("auto", mesh, **kw))
                  for name, kw in AUTO_VARIANTS.items()})
    out.write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ref_meshes(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshes") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(out.read_text())


@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=lambda s: ",".join(map(str, s)))
def test_from_mesh_as_the_reference(ref_meshes, shape):
    from repro_torch.launch.mesh import Mesh
    topo = pmodel.Topology.from_mesh(Mesh(shape, AX))
    assert _json(topo.to_dict()) == \
        ref_meshes[",".join(map(str, shape))]["topology"]


@pytest.mark.parametrize("variant", list(AUTO_VARIANTS))
@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=lambda s: ",".join(map(str, s)))
def test_scheme_config_auto_as_the_reference(ref_meshes, shape, variant):
    """Field by field, fingerprint too."""
    from repro_torch.launch.mesh import Mesh, scheme_config
    cfg = scheme_config("auto", Mesh(shape, AX), **AUTO_VARIANTS[variant])
    assert _cfg(cfg) == ref_meshes[",".join(map(str, shape))]["auto"][variant]
    if shape == (1, 2, 2) and variant in ("default", "qwen2", "budget"):
        a = cfg.axes    # the planner's pick for the port's auto path
        assert (a.weight, a.extra_grad, a.secondary) \
            == (("gcd", "node"), (), ("gcd",))


# -- host boundaries (the reference's fake-process cases) ----------------------

HOST_CASES = [  # (mesh shape, processes)
    (dict(data=2, node=2, gcd=2), 2),
    (dict(data=4, node=2, gcd=1), 4),
    (dict(data=2, node=2, gcd=2), 4),
    (dict(data=2, node=2, gcd=2), 1),
]


@pytest.mark.parametrize("shape,n_proc", HOST_CASES,
                         ids=["2proc", "4proc_data", "4proc_node", "1proc"])
def test_process_axes_and_boundary_as_the_reference(shape, n_proc):
    """tests/test_topo.py's fake-process meshes (devices process-major)
    against the port's Mesh with the same rank -> host map: the spanning
    axes, the boundary check's ValueError and Topology.from_mesh."""
    from test_topo import _FakeMesh

    from repro.launch.mesh import process_axes as rprocess_axes
    from repro.launch.mesh import zero_tiers as rzero_tiers
    from repro_torch.launch.mesh import Mesh, process_axes, zero_tiers

    ref = _FakeMesh(shape, n_processes=n_proc)
    n = 1
    for v in shape.values():
        n *= v
    hosts = [r // (n // n_proc) for r in range(n)]
    port = Mesh(tuple(shape.values()), tuple(shape), hosts=hosts)
    assert process_axes(port) == rprocess_axes(ref)
    # a mesh without a map is one host
    assert process_axes(Mesh(tuple(shape.values()), tuple(shape))) == ()
    try:
        want = rzero_tiers(ref)
    except ValueError as e:
        with pytest.raises(ValueError, match="process boundary") as got:
            zero_tiers(port)
        assert str(got.value) == str(e)
        with pytest.raises(ValueError, match="process boundary"):
            pmodel.Topology.from_mesh(port)
        return
    assert zero_tiers(port) == want
    assert pmodel.Topology.from_mesh(port).to_dict() \
        == rmodel.Topology.from_mesh(ref).to_dict()


@pytest.mark.parametrize("names,want,spanning", [
    (["a", "a", "b", "b"], (0, 0, 1, 1), ("node",)),
    (["b", "a", "b", "a"], (0, 1, 0, 1), ("gcd",)),
    (["a"] * 4, (0, 0, 0, 0), ()),
], ids=["block", "cyclic", "one_host"])
def test_launch_host_map(names, want, spanning):
    """The train launcher's rank -> host map: the ranks' host names
    numbered in order of first appearance, whatever the placement. On
    (1, 2, 2) two hosts put a boundary on an intra axis (node in blocks,
    gcd cyclic), which the boundary check refuses. Without a group, no map
    (one host)."""
    from repro_torch.launch import distributed
    from repro_torch.launch.mesh import Mesh, process_axes, zero_tiers
    assert distributed.number_hosts(names) == want
    assert distributed.host_map() is None
    mesh = Mesh((1, 2, 2), AX, hosts=want)
    assert process_axes(mesh) == spanning
    if spanning:
        with pytest.raises(ValueError, match="process boundary"):
            zero_tiers(mesh)
    else:
        assert zero_tiers(mesh)["intra"] == ("node", "gcd")


# -- the planner CLI -------------------------------------------------------------

@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A v1 checkpoint the port saved (reduced qwen2-0.5b, one CPU rank,
    after step 1)."""
    import torch

    from repro_torch.launch import train
    d = tmp_path_factory.mktemp("ckpt")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.run(train.build_parser().parse_args([
            "--device", "cpu", "--reduced", "--devices", "1", "--steps", "1",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(d),
            "--ckpt-every", "1"]))
    finally:
        torch.set_num_threads(threads)
    return d


PLANNER_CASES = {
    "default": [],
    "no_quant": ["--no-quant"],
    "stream": ["--stream-grads"],
    "budget": ["--topology", "gpu_pod", "--budget-gb", "16", "--top", "12"],
    "tpu_qwen2": ["--topology", "tpu", "--model", "qwen2-0.5b", "--top", "4"],
    "serve": ["--serve"],
    "serve_qwen2": ["--serve", "--model", "qwen2-0.5b", "--slots", "4",
                    "--context", "512"],
    "save": ["--save-topology", "{tmp}/t.json"],
    "replan": ["--replan-from", "{ckpt}", "--topology", "frontier"],
}


@pytest.mark.parametrize("case", list(PLANNER_CASES))
def test_planner_main_prints_the_reference(case, capsys, tmp_path, port_ckpt):
    argv = [a.format(tmp=tmp_path, ckpt=port_ckpt)
            for a in PLANNER_CASES[case]]
    assert rplanner.main(argv) == 0
    want = capsys.readouterr().out
    saved = (tmp_path / "t.json").read_text() if case == "save" else None
    assert pplanner.main(argv) == 0
    assert capsys.readouterr().out == want
    if saved is not None:
        assert (tmp_path / "t.json").read_text() == saved
    assert want


def test_planner_unknown_model_exits_as_the_reference():
    with pytest.raises(SystemExit) as ref:
        rplanner.main(["--model", "no-such-model"])
    with pytest.raises(SystemExit) as port:
        pplanner.main(["--model", "no-such-model"])
    assert str(port.value) == str(ref.value)


def test_planner_runs_as_a_module():
    """``python -m repro_torch.topo.planner`` (no torch needed to rank)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.topo.planner",
                          "--top", "3"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "planner choice is" in res.stdout
    assert "RuntimeWarning" not in res.stderr


# -- calibration math (tests/test_obs.py's identities) --------------------------

def test_solve_bandwidths_inverts_the_cost_model():
    topo = pmodel.frontier(8)
    cfg = pplanner.preset_on_topology("zero_topo", topo)
    pred = pcost.phase_breakdown(cfg, topo, pcost.Workload(psi=1e9,
                                                           n_layers=16))
    measured = {ph: rec["seconds"] for ph, rec in pred.items()}
    solved = pcal.solve_bandwidths(pred, measured)
    assert solved
    for ax, bw in solved.items():
        assert bw == pytest.approx(topo.link(ax).bandwidth, rel=1e-9), ax
    fast = pcal.solve_bandwidths(
        pred, {ph: pred[ph]["latency_s"] + (s - pred[ph]["latency_s"]) / 2
               for ph, s in measured.items()})
    for ax in solved:
        assert fast[ax] == pytest.approx(2 * solved[ax], rel=1e-9), ax
    # and the reference's back-solve of the reference's prediction: equal
    rtopo = rmodel.frontier(8)
    rpred = rcost.phase_breakdown(
        rplanner.preset_on_topology("zero_topo", rtopo), rtopo,
        rcost.Workload(psi=1e9, n_layers=16))
    assert rpred == pred
    skew = {ph: 1.7 * s + 1e-4 for ph, s in measured.items()}
    assert pcal.solve_bandwidths(pred, skew) \
        == rcal.solve_bandwidths(rpred, skew)


def test_calibrated_topology_round_trip(tmp_path):
    topo = pmodel.frontier(4)
    cal = pmodel.calibrated(topo, {"node": 55e9, "bogus": 1.0, "gcd": 0.0})
    assert cal.link("node").bandwidth == 55e9
    assert cal.link("gcd").bandwidth == topo.link("gcd").bandwidth
    assert cal.link("data").bandwidth == topo.link("data").bandwidth
    assert cal.name == "frontier:calibrated"
    assert cal.link("node").latency == topo.link("node").latency
    assert cal.to_dict() == rmodel.calibrated(
        rmodel.frontier(4), {"node": 55e9, "bogus": 1.0, "gcd": 0.0}).to_dict()
    path = tmp_path / "topo_calibrated.json"
    cal.save(path)
    loaded = pmodel.load_topology(str(path))
    assert loaded.link("node").bandwidth == 55e9
    assert [l.name for l in loaded.links] == [l.name for l in topo.links]
    pplanner.preset_on_topology("zero_topo", loaded).validate_dependency_rule()


def test_partition_memory_formulas_as_the_reference():
    """The Table IV-VI formulas the cost model prices, on every preset
    of (1, 2, 2) and (2, 2, 2)."""
    from repro.core import partition as rpart
    from repro_torch.core import partition as ppart
    for sizes in (dict(data=1, node=2, gcd=2), dict(data=2, node=2, gcd=2)):
        for scheme in SCHEMES[:-1]:
            kw = dict(intra_axes=("node", "gcd"), inter_axes=("data",),
                      l0_axes=("gcd",), axis_sizes=sizes)
            r, p = rpart.preset(scheme, **kw), ppart.preset(scheme, **kw)
            for psi in (1_313_024, 494_032_768):
                assert ppart.sharding_factor_table(p) \
                    == rpart.sharding_factor_table(r)
                assert ppart.weight_memory_bytes(p, psi) \
                    == rpart.weight_memory_bytes(r, psi)
                assert ppart.optimizer_memory_bytes(p, psi) \
                    == rpart.optimizer_memory_bytes(r, psi)
                for gb in (2, 4):
                    assert ppart.grad_memory_bytes(p, psi, grad_bytes=gb) \
                        == rpart.grad_memory_bytes(r, psi, grad_bytes=gb)
                    for streaming in (None, True):
                        assert ppart.grad_buffer_bytes(
                            p, psi, streaming=streaming, grad_bytes=gb) \
                            == rpart.grad_buffer_bytes(
                                r, psi, streaming=streaming, grad_bytes=gb)


if __name__ == "__main__":
    reference_meshes(Path(sys.argv[1]))
