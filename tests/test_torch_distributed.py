"""The port's multi-process launch (``repro_torch.launch.distributed``)
against the JAX package's.

* ``detect`` gives the reference's ``DistConfig`` fields under the same
  environment and flags, in each case of tests/test_launch_distributed.py:
  explicit flags over SLURM, a partial set refused, SLURM (with its node
  list and with ``REPRO_COORDINATOR``), OpenMPI (only with a coordinator),
  the ``REPRO_*`` variables and the single-process default, the
  configurations ``DistConfig`` refuses, the CLI flags' round trip. After
  the reference's sources the port reads torchrun's variables.
* Two CPU processes of ``python -m repro_torch.launch.train`` started by
  ``REPRO_*`` variables, and two started by ``SLURM_*`` variables (their
  coordinator through ``REPRO_COORDINATOR``), each train qwen2-0.5b reduced
  for 3 steps on (1, 1, 2): rank 0's losses and grad norms are bit for bit
  the launcher's own 2-rank spawn, and the heartbeat report reads every
  rank ok at step 3.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import distributed as ref
from repro_torch.launch import distributed as port

ROOT = Path(__file__).resolve().parents[1]
RUN = ["--device", "cpu", "--reduced", "--steps", "3", "--seq", "16",
       "--batch", "2", "--quant-block", "64", "--timeout", "120"]
LAUNCH_VARS = ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_NODELIST",
               "SLURM_STEP_NODELIST", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "REPRO_COORDINATOR",
               "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID", "RANK",
               "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)


def _fields(d):
    return (d.coordinator, d.num_processes, d.process_id, d.source,
            d.is_distributed)


def _same(*args):
    got, want = port.detect(*args), ref.detect(*args)
    assert _fields(got) == _fields(want)
    return got


def test_explicit_flags_win(monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert _fields(_same("host:1234", 2, 1))[:4] == \
        ("host:1234", 2, 1, "flags")


@pytest.mark.parametrize("partial", [("host:1234", None, None),
                                     (None, 2, None), (None, None, 0)])
def test_partial_flags_refused(partial):
    for mod in (port, ref):
        with pytest.raises(ValueError, match="together"):
            mod.detect(*partial)


def test_slurm_autodetect(monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_NODELIST", "frontier[00123-00170]")
    assert _same().coordinator == "frontier00123:12621"
    monkeypatch.setenv("SLURM_STEP_NODELIST", "node7,node8")
    assert _same().coordinator == "node7:12621"
    monkeypatch.setenv("REPRO_COORDINATOR", "login1:9000")
    assert _same().source == "slurm"
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert _same().source == "single"


def test_ompi_needs_coordinator(monkeypatch):
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    assert _same().source == "single"
    monkeypatch.setenv("REPRO_COORDINATOR", "c:9")
    assert _fields(_same())[:4] == ("c:9", 2, 1, "ompi")


def test_env_vars_and_single_default(monkeypatch):
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
    monkeypatch.setenv("REPRO_PROCESS_ID", "1")
    monkeypatch.setenv("REPRO_COORDINATOR", "c:9")
    assert _same().source == "env"
    for k in ("REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID", "REPRO_COORDINATOR"):
        monkeypatch.delenv(k)
    assert not _same().is_distributed


@pytest.mark.parametrize("args", [(None, 2, 0), ("c:9", 2, 2), ("c:9", 0, 0)])
def test_invalid_configs_refused(args):
    for mod in (port, ref):
        with pytest.raises(AssertionError):
            mod.DistConfig(*args)


def test_cli_args_roundtrip():
    for mod in (port, ref):
        ap = argparse.ArgumentParser()
        mod.add_cli_args(ap)
        args = ap.parse_args(["--coordinator", "h:1", "--num-processes", "2",
                              "--process-id", "1"])
        assert mod.from_args(args) == mod.DistConfig("h:1", 2, 1, "flags")
        assert not mod.from_args(ap.parse_args([])).is_distributed


def test_torchrun_after_the_reference_sources(monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    assert _fields(port.detect())[:4] == ("10.0.0.1:29511", 4, 1, "torchrun")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
    monkeypatch.setenv("REPRO_COORDINATOR", "c:9")
    assert port.detect().source == "env"


def test_devices_must_match_the_processes(monkeypatch, capsys):
    from repro_torch.launch import train
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
    monkeypatch.setenv("REPRO_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(SystemExit):
        train.main(RUN + ["--devices", "4"])
    assert "2 processes (env)" in capsys.readouterr().err


# -- two processes started from outside ------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp: Path, env_of) -> dict:
    """Two launcher processes with the environments ``env_of(rank, addr)``;
    rank 0's TrainLog and stdout. The coordinator's port is free when it is
    chosen, but another process may bind it before rank 0 does: the launch
    is made again, once, on a new port if rank 0 found it taken."""
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    base["PYTHONPATH"] = str(ROOT / "src")
    for attempt in range(2):
        addr = f"127.0.0.1:{_free_port()}"
        run_dir = tmp / f"launch{attempt}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *RUN,
             "--heartbeat-dir", str(run_dir / "hb"), "--log-json",
             str(run_dir / "log.json")],
            env=dict(base, **env_of(r, addr)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        for i, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=240 if i == 0 else 30)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
        taken = "EADDRINUSE" in outs[0] or "ddress already in use" in outs[0]
        if not (taken and procs[0].returncode != 0 and attempt == 0):
            break
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    return dict(log=json.loads((run_dir / "log.json").read_text()),
                out=outs[0])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    from repro_torch.launch import train
    args = train.build_parser().parse_args(RUN + ["--devices", "2"])
    return train.run(args)[0]


@pytest.mark.parametrize("source", ["env", "slurm"])
def test_two_processes_from_outside(tmp_path, spawned, source):
    def env_of(rank, addr):
        if source == "env":
            return dict(REPRO_COORDINATOR=addr, REPRO_NUM_PROCESSES="2",
                        REPRO_PROCESS_ID=str(rank))
        return dict(SLURM_PROCID=str(rank), SLURM_NTASKS="2",
                    SLURM_NODELIST="localhost", REPRO_COORDINATOR=addr)

    got = _launch(tmp_path, env_of)
    assert got["log"]["losses"] == spawned["losses"]
    assert got["log"]["grad_norms"] == spawned["grad_norms"]
    assert "heartbeat: all ranks ok at step 3" in got["out"]
    assert "model-TFLOPS/GPU (per rank of 2)" in got["out"]
