"""The port's calibration loop (``repro_torch.obs.calibrate``) end to end on
4 gloo ranks on the CPU: the traced step and probes on (1, 2, 2), rank 0's
spans priced by ``topo.cost.phase_breakdown``, the back-solved bandwidths
written as a Topology that the reference's ``load_topology`` reads and
that the port's planner plans from."""
import dataclasses
import json

import pytest
import torch

from repro.topo.model import load_topology as ref_load_topology


def reference_prediction(*, seq, n_microbatch, n_layers, d_model, vocab):
    """What the reference prices for ``obs.calibrate``'s default config on
    (1, 2, 2): its config, topology and workload, and the predicted_ms
    column (the compute row included) as the port's CLI prints it."""
    from test_topo import _FakeMesh

    from repro.launch.mesh import scheme_config
    from repro.models.registry import build_model, get_arch
    from repro.topo import cost as rcost
    from repro.topo.model import Topology

    mesh = _FakeMesh(dict(data=1, node=2, gcd=2), n_processes=1)
    cfg = scheme_config("zero_topo", mesh, quant_block=64, overlap=False,
                        stream_grads=False)
    topo = Topology.from_mesh(mesh)
    arch = get_arch("qwen2-0.5b").reduced(n_layers=n_layers,
                                          d_model=d_model, vocab=vocab)
    wl = rcost.Workload(psi=float(build_model(arch).param_count()),
                        n_layers=arch.n_layers, tokens_per_device_mb=seq,
                        n_microbatch=n_microbatch,
                        stream_grads=cfg.stream_grads)
    pred = rcost.phase_breakdown(cfg, topo, wl)
    out = {ph: f"{pred[ph]['seconds'] * 1e3:>14.3f}" for ph in rcost.PHASES}
    comp = 6.0 * wl.psi * wl.n_microbatch * wl.tokens_per_device_mb \
        / topo.flops_per_device
    out["compute"] = f"{comp * 1e3:>14.3f}"
    return cfg, topo, wl, out


def test_calibrate_quick_on_four_ranks(tmp_path, capsys, monkeypatch):
    from repro_torch.obs import calibrate
    from repro_torch.topo import cost, planner

    priced = []
    breakdown = cost.phase_breakdown

    def spy(cfg, topo, wl):
        priced.append((cfg, topo, wl))
        return breakdown(cfg, topo, wl)

    monkeypatch.setattr(cost, "phase_breakdown", spy)

    out = tmp_path / "topo_calibrated.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert calibrate.main(["--device", "cpu", "--mesh", "1,2,2",
                               "--quick", "--out-topology", str(out)]) == 0
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    lines = text.splitlines()
    assert lines[0].startswith(
        "calibrate: qwen2-0.5b-reduced/zero_topo on mesh:{'data': 1, "
        "'node': 2, 'gcd': 2} (2 measured steps, n_mb=2)"), text
    cov = next(x for x in lines if x.startswith("span/wall coverage"))
    assert 0.9 <= float(cov.split()[-1]) <= 1.1, cov
    # fixed columns: phase (16), measured ms (12), predicted ms (14), error
    rows = {x[:16].strip(): (x[16:28], x[28:42]) for x in lines
            if x[:16].strip() in cost.PHASES + ("compute",)}
    assert set(rows) == set(cost.PHASES) | {"compute"}
    # the in-loop phases and the stage-2 RS run over axes of size 2: each
    # was measured and predicted
    for ph in ("fwd_allgather", "bwd_allgather", "grad_rs_w", "grad_rs_e",
               "update_gather"):
        assert float(rows[ph][0]) > 0 and float(rows[ph][1]) > 0, rows[ph]
    # the price is the reference's for the same run: its config on the
    # mesh, the reduced model's logical parameter count, one row of --seq
    # tokens a device a microbatch; the predicted column prints it
    rcfg, rtopo, rwl, want = reference_prediction(
        seq=33, n_microbatch=2, n_layers=2, d_model=128, vocab=256)
    ((pcfg, ptopo, pwl),) = priced
    assert json.loads(json.dumps(pcfg.fingerprint())) \
        == json.loads(json.dumps(rcfg.fingerprint()))
    assert ptopo.to_dict() == rtopo.to_dict()
    assert dataclasses.asdict(pwl) == dataclasses.asdict(rwl)
    assert {ph: rows[ph][1] for ph in rows} == want
    assert "effective bandwidth[gcd]" in text
    assert "effective bandwidth[node]" in text
    topo = ref_load_topology(str(out))
    assert sorted(topo.axis_sizes) == [("data", 1), ("gcd", 2), ("node", 2)]
    assert topo.name.endswith(":calibrated")
    assert {l.tier for l in topo.links} == {"l0", "intra", "inter"}
    assert calibrate.build_parser().parse_args([]).device == "cuda"
    # the planner plans from the file
    assert planner.main(["--topology", str(out), "--model", "qwen2-0.5b",
                         "--top", "3"]) == 0
    assert "planner choice is" in capsys.readouterr().out


def test_calibrate_without_device_raises_here():
    """Without --device cpu the CLI asks for the card and raises on a host
    with no card, before it starts any rank."""
    from repro_torch.obs import calibrate
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the CLI would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.main(["--mesh", "1,2,2", "--quick"])


def test_calibrate_refuses_emit_bench():
    from repro_torch.obs import calibrate
    with pytest.raises(SystemExit):
        calibrate.main(["--device", "cpu", "--emit-bench"])
