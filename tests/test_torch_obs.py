"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``).

* The metrics stream: the writer's round trip, its schema checked at write
  and at read, the per-rank lanes; each package's ``read_lanes`` reads the
  other's files, train and serve records alike.
* ``tflops_per_gpu`` and ``model_flops_per_token`` are the reference's
  formula; ``TrainLog.aggregates`` leaves the first step out of
  ``tflops_per_gpu_mean`` as the reference's does.
* Spans: dead by default; a ``SpanRecorder``'s Chrome events carry the
  reference's keys and values.
* The heartbeat: the same stamps classify the same way (ok, behind,
  stalled, dead) in both packages, each reading the stamps the other
  wrote.
* Trace mode's step (``ZeroEngine.train_step`` with a ``SpanRecorder``,
  probes every step) is bit for bit the untraced step, losses, grad norms
  and masters, over 3 steps of qwen2-0.5b reduced at (1, 1, 1) in this
  process and on four gloo ranks (``CASES``): (1, 2, 2) and (2, 1, 2) as
  they are, (1, 2, 2) with ``--overlap`` and with ``--stream-grads``, and
  (2, 1, 2) with the cross-replica reduce-scatter and the INT8 update
  gather, alone and streamed (the reference's traced step is only
  float-close to its fused one; the port's step is eager, so its segments
  compute the same bits); ``PhasedStep.probe_inventory`` at (1, 2, 2)
  equals the reference's (a subprocess on 4 forced host devices).
* The train CLI in trace mode writes the metrics lanes, the Chrome trace
  and the heartbeat, and prints the report and the throughput line.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro.obs import heartbeat as ref_hb
from repro.obs import metrics as ref_om
from repro.obs import spans as ref_spans
from repro_torch.obs import heartbeat as hb
from repro_torch.obs import metrics as om
from repro_torch.obs import spans
from test_torch_train import RUN, run_ranks

# the four-rank traced cases: id -> (mesh shape, ZeroConfig overrides)
OPTIONS = dict(cross_replica="reduce_scatter", quantize_update_gather=True)
CASES = {
    "1,2,2": ((1, 2, 2), {}),
    "2,1,2": ((2, 1, 2), {}),
    "1,2,2-overlap": ((1, 2, 2), dict(overlap=True)),
    "1,2,2-stream": ((1, 2, 2), dict(stream_grads=True)),
    "2,1,2-options": ((2, 1, 2), OPTIONS),
    "2,1,2-options-stream": ((2, 1, 2), dict(OPTIONS, stream_grads=True)),
}


def _rec(step, rank=0, **over):
    rec = dict(step=step, rank=rank, loss=2.0 - 0.1 * step, grad_norm=1.0,
               lr=1e-3, tokens=1024.0, dt_s=0.5 if step else 10.0,
               tokens_per_s=2048.0 if step else 102.4,
               tflops_per_gpu=0.5 if step else 0.025,
               phase_ms={"fwd_allgather": 1.5, "compute": 40.0},
               overlap_efficiency=0.6, memory_hw_bytes=0,
               memory_pred_bytes=123456)
    rec.update(over)
    return rec


def _serve_rec(step):
    return dict(step=step, tokens=4, dt_s=0.01, tokens_per_s=400.0,
                queue_depth=2, active_slots=4, admitted=step, rejected=0,
                preempted=0, retired=0, free_pages=10, p50_ms=1.0,
                p99_ms=2.0, phase_ms={"serve_admit": 0.5})


def test_schema_fields_as_the_reference():
    assert om.REQUIRED_FIELDS == ref_om.REQUIRED_FIELDS
    assert om.SERVE_REQUIRED_FIELDS == ref_om.SERVE_REQUIRED_FIELDS
    assert spans.SEGMENTS == ref_spans.SEGMENTS
    assert spans.PROBES == ref_spans.PROBES
    assert [f.name for f in spans.TraceConfig.__dataclass_fields__.values()] \
        == [f.name for f in ref_spans.TraceConfig.__dataclass_fields__.values()]
    assert spans.TraceConfig() == spans.TraceConfig(
        **vars(ref_spans.TraceConfig()))


def test_metrics_roundtrip_and_schema(tmp_path):
    path = tmp_path / "metrics.jsonl"
    w = om.MetricsWriter(path)
    written = [w.write(_rec(i)) for i in range(3)]
    w.close()
    assert om.read_jsonl(path) == written
    assert om.read_lanes(path) == written
    bad = _rec(0)
    del bad["tflops_per_gpu"]
    w = om.MetricsWriter(tmp_path / "m.jsonl")
    with pytest.raises(ValueError, match="tflops_per_gpu"):
        w.write(bad)
    w.close()
    (tmp_path / "broken.jsonl").write_text(json.dumps({"step": 0}) + "\n")
    with pytest.raises(ValueError, match="missing fields"):
        om.read_jsonl(tmp_path / "broken.jsonl")


@pytest.mark.parametrize("writer,reader", [(om, ref_om), (ref_om, om)],
                         ids=["port-writes", "reference-writes"])
def test_lanes_read_across_packages(tmp_path, writer, reader):
    """Four rank lanes (train) and a serve lane written by one package are
    read by the other, merged by (step, rank)."""
    stem = tmp_path / "metrics.jsonl"
    assert writer.lane_path(stem, 2, 4) == reader.lane_path(stem, 2, 4)
    for rank in (3, 1, 0, 2):
        w = writer.MetricsWriter(stem, rank=rank, n_ranks=4)
        for i in range(2):
            w.write(_rec(i, rank=rank))
        w.close()
    merged = reader.read_lanes(stem)
    assert [(r["step"], r["rank"]) for r in merged] == \
        [(i, r) for i in range(2) for r in range(4)]
    assert reader.aggregates(merged) == writer.aggregates(merged)
    serve = tmp_path / "serve.jsonl"
    w = writer.MetricsWriter(serve, fields=writer.SERVE_REQUIRED_FIELDS)
    recs = [w.write(_serve_rec(i)) for i in range(3)]
    w.close()
    assert reader.read_lanes(serve) == recs
    assert reader.serve_aggregates(recs) == writer.serve_aggregates(recs)


def test_serve_cli_metrics_schema(tmp_path, capsys):
    """The serving CLI's records hold every serve field (checked as they
    are written) and the reference reads them; the CLI's summary of its
    lane is the reference's ``serve_aggregates``."""
    from repro_torch.launch import serve
    path = tmp_path / "serve.jsonl"
    serve.main(["--device", "cpu", "--reduced", "--requests", "2", "--slots",
                "2", "--prompt-len", "8", "--max-len", "16", "--gen", "2",
                "--metrics-jsonl", str(path)])
    recs = ref_om.read_jsonl(path, ref_om.SERVE_REQUIRED_FIELDS)
    assert recs and all(r["rank"] == 0 for r in recs)
    line = next(x for x in capsys.readouterr().out.splitlines()
                if x.startswith(f"metrics: {path} "))
    assert json.loads(line.split(" ", 2)[2]) == ref_om.serve_aggregates(recs)


@pytest.mark.parametrize("params,tokens,dt,n_dev",
                         [(494_032_768, 8192.0, 6.49, 4), (1, 1.0, 0.0, 8),
                          (7, 3.0, 0.5, 0), (20_554_567_680, 1e6, 11.2, 64)])
def test_tflops_formula_as_the_reference(params, tokens, dt, n_dev):
    assert om.model_flops_per_token(params) == \
        ref_om.model_flops_per_token(params)
    assert om.tflops_per_gpu(params, tokens, dt, n_dev) == \
        ref_om.tflops_per_gpu(params, tokens, dt, n_dev)


def test_trainlog_tflops_aggregate():
    from repro.train.trainer import TrainLog as RefLog
    from repro_torch.train.trainer import TrainLog
    port, ref = TrainLog(), RefLog()
    for i, dt in enumerate([10.0, 0.5, 0.25]):
        m = dict(loss=2.0, grad_norm=1.0, lr=1e-3, tokens=512.0)
        port.record(i, m, dt, tflops_per_gpu=1.0 / dt)
        ref.record(i, m, dt, tokens_per_s=512.0 / dt, tflops_per_gpu=1.0 / dt)
    assert port.aggregates() == ref.aggregates()
    assert port.aggregates()["tflops_per_gpu_mean"] == 3.0


def test_spans_dead_by_default_and_chrome_keys(tmp_path):
    import contextlib
    assert not spans.enabled()
    assert isinstance(spans.scope("gather/issue"), contextlib.nullcontext)
    with spans.tracing():
        assert spans.enabled()
        with spans.tracing():
            assert spans.enabled()
        assert spans.enabled()
    assert not spans.enabled()
    port, ref = spans.SpanRecorder(), ref_spans.SpanRecorder()
    for rec in (port, ref):
        rec.step = 0
        assert rec.fenced("fwd_bwd", lambda a, b: a + b, 1, 2) == 3
        rec.fenced("fwd_allgather", time.sleep, 0.01)
        rec.step = 1
        rec.fenced("update", time.sleep, 0.01)
    pe, re_ = port.chrome_events(rank=3), ref.chrome_events(rank=3)
    assert [sorted(e) for e in pe] == [sorted(e) for e in re_]
    for a, b in zip(pe, re_):
        assert {k: a[k] for k in ("name", "ph", "pid", "tid", "args")} == \
            {k: b[k] for k in ("name", "ph", "pid", "tid", "args")}
    assert set(port.step_seconds(0)) == set(ref.step_seconds(0))
    doc = json.loads(Path(spans.write_chrome_trace(
        pe, tmp_path / "trace.json")).read_text())
    assert sorted(doc) == ["displayTimeUnit", "traceEvents"]
    assert doc["traceEvents"] == pe


@pytest.mark.parametrize("writer,reader", [(hb, ref_hb), (ref_hb, hb)],
                         ids=["port-stamps", "reference-stamps"])
def test_heartbeat_across_packages(tmp_path, writer, reader):
    """ok / behind / dead, then stalled, from one package's stamps: both
    packages classify them the same way and format the same report."""
    writer.stamp(tmp_path, 0, 5)
    writer.stamp(tmp_path, 1, 3)
    writer.stamp(tmp_path, 3, 5)
    assert writer.stamp_path(tmp_path, 1) == reader.stamp_path(tmp_path, 1)
    now = time.time()
    for kw in (dict(now=now), dict(now=now + 120)):
        rep = reader.straggler_report(tmp_path, 4, stall_s=60.0, **kw)
        assert rep == writer.straggler_report(tmp_path, 4, stall_s=60.0, **kw)
        assert reader.format_report(rep) == writer.format_report(rep)
    rep = reader.straggler_report(tmp_path, 4, stall_s=60.0, now=now)
    assert [rep["ranks"][r]["status"] for r in range(4)] == \
        ["ok", "behind", "dead", "ok"]
    stale = reader.straggler_report(tmp_path, 2, stall_s=60.0, now=now + 120)
    assert all(v["status"] == "stalled" for v in stale["ranks"].values())
    ok = reader.straggler_report(tmp_path, 1, stall_s=60.0, now=now)
    assert ok["ok"] and "all ranks ok at step 5" in reader.format_report(ok)


# -- the phased step, bit for bit the untraced one ------------------------------

def _traced_pair(rank, shape, over=None) -> dict:
    """3 steps of qwen2-0.5b reduced (bf16, the port's seed-0 init) on this
    rank of ``shape`` with the ZeroConfig overrides ``over``, untraced and
    traced with probes every step: their losses, grad norms and final
    masters, and the probe inventory."""
    from repro_torch.core.engine import TrainHparams, ZeroEngine
    from repro_torch.data.pipeline import BatchSpec
    from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
    from repro_torch.models.registry import build_model, get_arch
    from repro_torch.obs.spans import TraceConfig
    from repro_torch.train.trainer import Trainer

    arch = get_arch("qwen2-0.5b").reduced()
    model = build_model(arch)
    over = over or {}
    out = {}
    for traced in (False, True):
        mesh = Mesh(shape, TEST_AXES, rank)
        cfg = scheme_config("zero_topo", mesh, quant_block=RUN["quant_block"],
                            **over)
        hp = TrainHparams(lr=RUN["lr"], total_steps=RUN["steps"],
                          warmup_steps=2, overlap=cfg.overlap,
                          stream_grads=cfg.stream_grads)
        eng = ZeroEngine(model.leaf_specs(), cfg, mesh, hp, device="cpu")
        tr = Trainer(model, eng, BatchSpec(RUN["batch"], RUN["seq"],
                                           arch.vocab),
                     trace=TraceConfig(probe_every=1) if traced else None)
        state = tr.run(eng.init_state(0), RUN["steps"], log_every=0)
        out[traced] = dict(
            losses=tr.log.losses, grad_norms=tr.log.grad_norms,
            master={n: t.clone() for n, t in state["master"].items()},
            inventory=tr.phased.probe_inventory() if traced else None,
            segments=[tr.recorder.step_seconds(i) for i in range(RUN["steps"])]
            if traced else None)
    return out


def _assert_bitwise(pair):
    plain, traced = pair[False], pair[True]
    assert traced["losses"] == plain["losses"]
    assert traced["grad_norms"] == plain["grad_norms"]
    for n, t in plain["master"].items():
        assert torch.equal(traced["master"][n], t), n
    for seg in traced["segments"]:
        assert set(spans.SEGMENTS) <= set(seg)
        assert set(spans.PROBES) <= set(seg)


def test_phased_step_bitwise_one_device():
    torch.set_num_threads(1)
    _assert_bitwise(_traced_pair(0, (1, 1, 1)))


def _four_rank(rank) -> dict:
    return {case: _traced_pair(rank, shape, over)
            for case, (shape, over) in CASES.items()}


@pytest.fixture(scope="module")
def four_rank_pairs(tmp_path_factory):
    return run_ranks(_four_rank, 4, tmp_path_factory.mktemp("traced"))


@pytest.mark.parametrize("case", list(CASES))
def test_phased_step_bitwise_four_ranks(four_rank_pairs, case):
    for r in four_rank_pairs:
        _assert_bitwise(r[case])
        assert r[case][True]["losses"] == four_rank_pairs[0][case][True][
            "losses"]


def _reference_inventory(out: Path) -> None:
    from repro.launch.mesh import make_test_mesh, scheme_config
    from repro.core.engine import ZeroEngine
    from repro.models.config import ShapeConfig
    from repro.models.registry import build_model, get_arch
    from repro.obs.phased import PhasedStep
    from repro.train.trainer import Trainer

    mesh = make_test_mesh(shape=(1, 2, 2), axes=("data", "node", "gcd"))
    model = build_model(get_arch("qwen2-0.5b").reduced())
    eng = ZeroEngine(model.leaf_specs(), scheme_config(
        "zero_topo", mesh, quant_block=RUN["quant_block"]), mesh)
    tr = Trainer(model, eng, mesh, ShapeConfig("t", RUN["seq"], RUN["batch"],
                                              "train"))
    out.write_text(json.dumps(
        PhasedStep(eng, model.loss_fn(), tr.bspecs).probe_inventory()))


def test_probe_inventory_as_the_reference(four_rank_pairs, tmp_path):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    path = tmp_path / "inventory.json"
    res = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    want = json.loads(path.read_text())
    for r in four_rank_pairs:
        assert r["1,2,2"][True]["inventory"] == want


def test_train_cli_trace_outputs(tmp_path, capfd):
    """``--trace --metrics-jsonl --chrome-trace --heartbeat-dir`` on 2
    ranks: a metrics lane a rank with a record a step, a Chrome trace a
    rank holding every span, the heartbeat report and the throughput line
    (per rank) from rank 0."""
    from repro_torch.launch import train
    d = tmp_path
    res = train.main(["--device", "cpu", "--reduced", "--devices", "2",
                      "--steps", "3", "--seq", "16", "--batch", "2",
                      "--metrics-jsonl", str(d / "m.jsonl"), "--chrome-trace",
                      str(d / "t.json"), "--heartbeat-dir", str(d / "hb"),
                      "--probe-every", "2", "--timeout", "120"])
    out = capfd.readouterr().out
    assert "heartbeat: all ranks ok at step 3" in out
    assert "model-TFLOPS/GPU (per rank of 2)" in out
    recs = ref_om.read_lanes(d / "m.jsonl")
    assert [(x["step"], x["rank"]) for x in recs] == \
        [(s, r) for s in (1, 2, 3) for r in (0, 1)]
    for r in res:
        evs = json.loads((d / f"t.rank{r['rank']}.json").read_text())[
            "traceEvents"]
        # five segments a step, five probes at steps 0 and 2
        assert len(evs) == r["trace"]["chrome_events"] == 3 * 5 + 2 * 5
    assert [x["loss"] for x in recs if x["rank"] == 0] == res[0]["losses"]


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    _reference_inventory(Path(sys.argv[1]))
