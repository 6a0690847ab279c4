"""Rules of the PyTorch port: it imports neither jax, nor ml_dtypes, nor
the JAX package, and its serving and training entry points run on the card
unless asked for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve, train

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_port_files_found():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 20
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if p.name != "chip_smoke.py"}
    # the import rule covers obs/ and the multi-process launcher
    assert {"obs/__init__.py", "obs/spans.py", "obs/metrics.py",
            "obs/heartbeat.py", "obs/phased.py", "obs/calibrate.py",
            "topo/__init__.py", "topo/model.py", "topo/cost.py",
            "topo/planner.py", "launch/distributed.py", "launch/census.py",
            "launch/dryrun.py", "launch/roofline.py", "launch/validate.py",
            "launch/report.py", "launch/cli_reference.py"} <= names


def test_topo_imports_no_torch():
    """The planner and cost model are pure Python: importing them (and
    ranking on a preset) loads no torch."""
    import subprocess
    import sys
    code = ("import sys; from repro_torch.topo import planner; "
            "planner.plan(planner.load_topology('frontier'), "
            "planner.Workload(psi=2e10)); "
            "assert 'torch' not in sys.modules, 'torch imported'")
    res = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_serve_cli_without_device_raises_here():
    """Without --device cpu the CLI asks for the card; on a host with no
    card it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the CLI would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])


def test_serve_cli_on_cpu_prints_tokens(capsys):
    serve.main(["--device", "cpu", "--reduced", "--requests", "3", "--slots",
                "2", "--prompt-len", "8", "--max-len", "24", "--gen", "4"])
    out = capsys.readouterr().out
    assert "3 reqs -> 12 tokens" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    assert "sample: [" in out
    assert "backend=gathered" in out


def test_serve_cli_one_device_resident_prints_tokens(capsys):
    """``--backend resident --devices 1``: the one-device residency built
    from the seeded init one leaf at a time (``setup`` /
    ``iter_primaries``), degree 1, served as before."""
    results = serve.main(["--device", "cpu", "--reduced", "--backend",
                          "resident", "--devices", "1", "--requests", "3",
                          "--slots", "2", "--prompt-len", "8", "--max-len",
                          "24", "--gen", "4"])
    out = capsys.readouterr().out
    assert "degree=1 wire=" in out
    assert "backend=resident 3 reqs -> 12 tokens" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out
    [r] = results
    assert r["mesh"] is None and r["memory"]["res_degree"] == 1
    assert all(len(t) == 4 for t in r["tokens"])
    assert not r["payload_bytes"]          # one device: no collective


def test_serve_cli_four_ranks_without_device_raises_here():
    """``--devices 4`` without --device cpu raises on a host with no card,
    before it starts any rank; no rank serves on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the CLI would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1", "--devices", "4",
                    "--mesh-shape", "2,1,2", "--max-len", "32"])


def test_serve_cli_backends_all_held():
    """Every backend the serve CLI offers (``--backend``'s choices) is held
    against the reference on the (2, 1, 2) mesh
    (tests/test_torch_serve_mesh.py: the engine and the batcher, each
    backend), and no other."""
    from test_torch_serve_mesh import BACKENDS

    choices = next(a.choices for a in serve.build_parser()._actions
                   if a.dest == "backend")
    assert sorted(choices) == sorted(BACKENDS)
    default = serve.build_parser().parse_args([]).backend
    assert default == "gathered"


def test_train_cli_without_device_raises_here():
    """Without --device cpu the training CLI asks for the card and raises
    on a host with no card, before it starts any rank."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the CLI would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--devices", "4", "--steps", "1"])


def test_train_cli_on_cpu_prints_losses(capsys):
    train.main(["--device", "cpu", "--reduced", "--devices", "1", "--steps",
                "2", "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(steps) == 2 and all(" loss " in s and " gnorm " in s
                                   for s in steps)
    assert "final loss: " in out


def test_train_cli_schemes_all_held():
    """Every scheme the train CLI offers (``--scheme``'s choices) is held
    against the reference on four ranks (tests/test_torch_train.py), and
    no other: a scheme offered and not held fails here."""
    from test_torch_train import FOUR_RANK_CASES

    choices = next(a.choices for a in train.build_parser()._actions
                   if a.dest == "scheme")
    held = [scheme for _, scheme in FOUR_RANK_CASES]
    assert sorted(choices) == sorted(set(held))


def test_train_cli_checkpoint_flags_as_the_reference():
    """``--ckpt-dir``, ``--ckpt-every``, ``--resume`` and
    ``--strict-restore`` exist with the reference launcher's names,
    defaults, types and help texts."""
    from repro.launch import train as ref_train

    def flags(ap):
        return {a.dest: (a.option_strings, a.default, a.type, a.help)
                for a in ap._actions
                if a.dest in ("ckpt_dir", "ckpt_every", "resume",
                              "strict_restore")}

    port = flags(train.build_parser())
    assert len(port) == 4
    assert port == flags(ref_train.build_parser())


def test_train_cli_budget_flag_as_the_reference():
    """``--budget-gb`` (``--scheme auto``'s memory bound) exists with the
    reference launcher's name, default, type and help text, and
    ``--scheme`` offers ``auto``."""
    from repro.launch import train as ref_train

    def flag(ap):
        return [(a.option_strings, a.default, a.type, a.help)
                for a in ap._actions if a.dest == "budget_gb"]

    assert len(flag(train.build_parser())) == 1
    assert flag(train.build_parser()) == flag(ref_train.build_parser())
    assert train.build_parser().parse_args(["--scheme", "auto"]).scheme \
        == "auto"


OBS_AND_DIST_FLAGS = ("trace", "metrics_jsonl", "chrome_trace", "heartbeat_dir",
                      "probe_every", "coordinator", "num_processes",
                      "process_id")


def test_train_cli_trace_and_distributed_flags_as_the_reference():
    """``--trace --metrics-jsonl --chrome-trace --heartbeat-dir
    --probe-every`` (the observability group) and ``--coordinator
    --num-processes --process-id`` (the distributed group) exist with the
    reference launcher's names, defaults, types and help texts, in groups
    of the same titles."""
    from repro.launch import train as ref_train

    def flags(ap):
        out = {a.dest: (a.option_strings, a.default, a.type, a.help)
               for a in ap._actions if a.dest in OBS_AND_DIST_FLAGS}
        groups = {a.dest: g.title for g in ap._action_groups
                  for a in g._group_actions if a.dest in OBS_AND_DIST_FLAGS}
        return out, groups

    port = flags(train.build_parser())
    assert len(port[0]) == len(OBS_AND_DIST_FLAGS)
    assert port == flags(ref_train.build_parser())


def _engine_args():
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch

    mesh = Mesh((1, 1, 1), TEST_AXES)
    return (build_model(get_arch("qwen2-0.5b").reduced()).leaf_specs(),
            scheme_config("zero_topo", mesh, quant_block=64), mesh)


def test_engine_without_device_raises_here():
    """``ZeroEngine`` without ``device`` asks for the card; on a host with
    no card it raises instead of building its state on the CPU."""
    from repro_torch.core.engine import ZeroEngine

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the engine would build on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZeroEngine(*_engine_args())


def test_engine_on_cpu_when_asked():
    from repro_torch.core.engine import ZeroEngine

    eng = ZeroEngine(*_engine_args(), device="cpu")
    assert eng.device == torch.device("cpu")


def _carried(j):
    """The reference's ArchConfig ``j`` carried field by field into the
    port's."""
    import dataclasses

    from repro_torch.models import config as tconfig

    sub = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    sub["moe"] = tconfig.MoEConfig(**dataclasses.asdict(j.moe))
    sub["ssm"] = tconfig.SSMConfig(**dataclasses.asdict(j.ssm))
    sub["mla"] = None if j.mla is None else \
        tconfig.MLAConfig(**dataclasses.asdict(j.mla))
    return tconfig.ArchConfig(**sub)


PORTED = ("qwen2-0.5b", "falcon-mamba-7b", "gpt-neox-20b", "gpt-neox-10b",
          "gemma3-1b", "deepseek-7b", "internvl2-1b", "phi3.5-moe-42b-a6.6b",
          "mixtral-8x7b", "minicpm3-4b", "whisper-medium", "jamba-v0.1-52b")


@pytest.mark.parametrize("name", ["jamba-v0.1-52b"])
def test_unported_configs_raise(name):
    """No config of the reference is left unported: each of them, carried
    field by field into the port's ArchConfig, builds the same leaves
    (names, shapes, kinds, stacks, inits, in order) as the port's own
    config; ``name``, the last one ported (the mamba / attention hybrid),
    among them."""
    from repro.models.registry import ARCHS as JARCHS
    from repro.models.registry import get_arch as jget

    from repro_torch.models.registry import get_arch
    from repro_torch.models.transformer import LM

    jget("qwen2-0.5b")
    assert name in JARCHS and set(JARCHS) == set(PORTED)

    def leaves(arch):
        return [(n, s.shape, s.kind, s.stack, s.init, s.init_scale)
                for n, s in LM(arch).leaf_specs().items()]

    for ported in JARCHS:
        assert leaves(_carried(jget(ported))) == leaves(get_arch(ported)), \
            ported


@pytest.mark.parametrize("name", PORTED)
def test_ported_configs_are_the_reference_ones(name):
    """Every config the port registers equals the reference's field by
    field (the MoE, SSM and MLA sub-configs too), at published size and
    reduced; they are all of the reference's configs."""
    from repro.models.registry import ARCHS as JARCHS
    from repro.models.registry import get_arch as jget

    from repro_torch.models.registry import ARCHS, get_arch

    jget(name)
    get_arch(name)
    assert set(ARCHS) == set(PORTED)
    assert set(JARCHS) == set(PORTED)
    assert get_arch(name) == _carried(jget(name))
    assert get_arch(name).reduced() == _carried(jget(name).reduced())
