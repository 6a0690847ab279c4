"""The port's CLI reference (``repro_torch.launch.cli_reference``):
``docs/CLI_torch.md`` is what the port's parsers render, it lists the five
port CLIs, and every listed parser imports without touching
``torch.distributed``, a card or ``os.environ``."""
import subprocess
import sys
from pathlib import Path

from repro_torch.launch import cli_reference

ROOT = Path(__file__).resolve().parents[1]


def test_cli_reference_up_to_date():
    path = ROOT / "docs" / "CLI_torch.md"
    assert path.read_text() == cli_reference.generate(), \
        "docs/CLI_torch.md is stale: run python -m " \
        "repro_torch.launch.cli_reference --write"
    assert cli_reference.main(["--check"]) == 0


def test_lists_the_port_clis():
    assert cli_reference.TOOLS == (
        "repro_torch.launch.train", "repro_torch.launch.dryrun",
        "repro_torch.launch.serve", "repro_torch.topo.planner",
        "repro_torch.obs.calibrate")
    text = (ROOT / "docs" / "CLI_torch.md").read_text()
    for module in cli_reference.TOOLS:
        assert f"## `python -m {module}`" in text
    # the reference's file is its own
    assert "repro_torch" not in (ROOT / "docs" / "CLI.md").read_text()


def test_parsers_import_without_side_effects():
    """In a fresh process: importing each tool and building its parser
    starts no process group, initialises no card and leaves os.environ as
    it was."""
    code = (
        "import os, importlib\n"
        "env = dict(os.environ)\n"
        "from repro_torch.launch import cli_reference as c\n"
        "for m in c.TOOLS:\n"
        "    importlib.import_module(m).build_parser()\n"
        "import torch, torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'process group'\n"
        "assert not torch.cuda.is_initialized(), 'cuda'\n"
        "assert dict(os.environ) == env, 'os.environ'\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
