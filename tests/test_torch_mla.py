"""minicpm3-4b (Multi-head Latent Attention) in the port against the JAX
package.

minicpm3-4b (hf:openbmb/MiniCPM3-4B): 62 uniform ``mla`` layers, d_model
2,560, 40 heads, q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head
64, SiLU-GLU, RMSNorm, untied vocab 73,448. On ``reduced()`` (2 layers,
d_model 256, 4 heads, q_lora 128, kv_lora 64, nope 32, rope 16, v_head 32,
vocab 512), with the reference set up as its serving tests set it up
(zero_topo, quant_block 64, f32; ``test_torch_serve._pair``). The value
width (32) is not the key width (48), so every prefill and training
attention takes the chunked plain path (``mla_dv_mismatch``) in both
packages; ``w_dkv`` (256 x 80) is not whole quant blocks a row, so it is
dequantized whole and multiplied dense (its gradient on the unfused INT4
path); decode absorbs ``w_ukv`` into the query over the latent cache.

Tolerances and their causes:

- the residency bit for bit (the INT8 q and f32 scales of every WIRE leaf);
- the chunked attention at dv != d, causal, at q_offset 0 and at a host-int
  offset, over several query and key chunks: output and the three
  gradients within 1e-5 of max|ref| (f32 einsums in another order than
  XLA's);
- prefill logits and the latent cache within 1e-4 (rtol and atol): f32
  matmuls in another order; teacher-forced decode logits within 1e-4 a
  step, each port step from the reference's bf16 latent of that step (a
  1e-6 difference of a step's new latent can move its bf16 rounding by one
  ulp, 2**-8 relative), the latent held to one bf16 rounding (rtol 2**-7,
  atol 1e-5); greedy tokens equal;
- the batcher's tokens and admission / rejection / preemption / retirement
  counts equal the reference's ``ContinuousBatcher``, provisioned and
  oversubscribed (its latent pages preempted and re-admitted);
- on the mesh (2, 1, 2) (one reference subprocess on 4 forced host
  devices, one spawn of 4 port ranks): the engine's prefill and
  teacher-forced decode logits within 1e-4 of the reference's
  ``ServeEngine`` on the same mesh (f32 caches, the latent sharded along
  the sequence over ("node", "gcd")); the degree-2 residency bit for bit
  the gathered backend; the sequence-parallel prefill, which gathers the
  latent under its own payload label (``lat_gather``), within 2e-4 of the
  plain one (the reference's ``resident_and_sp`` bound);
- the zero_topo step at (1, 1, 1) and forced on four ranks at (1, 2, 2):
  loss within 3e-5 and grad norm within 2e-4 relative (slice 2's
  tolerances; tests/test_torch_train.py says why), the free-running
  (1, 2, 2) trajectory within TRAJECTORY_GNORM_RTOL; the unfused ``w_dkv``
  gradient's INT4 wire bytes (packed q and f32 scales) bit for bit the
  reference's ``quantize_int4`` of the same gradient.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.scheduler import _grow_seq

from repro_torch.core.engine import TrainHparams, ZeroEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
from repro_torch.models import layers
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident)
import test_torch_serve as ts
import test_torch_serve_mesh as tsm
import test_torch_train as tt
from test_torch_train import (AX, RUN, TRAJECTORY_GNORM_RTOL,  # noqa: F401
                              _check, one_torch_thread, port_run,
                              reference_run, run_ranks)

ARCH = "minicpm3-4b"
TOL = dict(rtol=1e-4, atol=1e-4)
WIRE = ["embed", "lm_head", "mla.w_down", "mla.w_dkv", "mla.w_dq",
        "mla.w_gate", "mla.w_ukv", "mla.w_up", "mla.w_uq", "mla.wo"]
FALLBACK = "attention/fallback/mla_dv_mismatch"


def test_config_is_the_reference_one():
    a, j = get_arch(ARCH), jget(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "hdim", "d_ff",
              "vocab", "rope_theta", "norm", "act", "qkv_bias",
              "tie_embeddings", "pattern", "family", "source"):
        assert getattr(a, f) == getattr(j, f), f
    for f in ("q_lora", "kv_lora", "qk_nope", "qk_rope", "v_head"):
        assert getattr(a.mla, f) == getattr(j.mla, f), f
        assert getattr(a.reduced().mla, f) == getattr(j.reduced().mla, f), f
    assert (a.n_layers, a.d_model, a.n_heads, a.vocab) == (62, 2560, 40,
                                                           73_448)


def test_cache_shapes_are_the_latent():
    """The ``mla`` kind caches its latent alone, sequence-indexed as K/V
    are (the paged pool pages it, a mesh shards it), as the reference's
    ``cache_shapes`` says."""
    from repro.models.registry import build_model as jbuild
    from repro_torch.models.registry import build_model

    shape = ShapeConfig("d", 256, 4, "decode")
    got = build_model(get_arch(ARCH)).cache_shapes(shape)
    want = jbuild(jget(ARCH)).cache_shapes(JShape("d", 256, 4, "decode"))
    assert got == {"mla": {"lat": ((62, 4, 256, 288), torch.bfloat16, True)}}
    assert want["mla"]["lat"][0] == got["mla"]["lat"][0]
    assert want["mla"]["lat"][2] is True


# ---------------------------------------------------------------------------
# the chunked attention at dv != d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,q_offset", [(40, 40, 0), (16, 48, 32)],
                         ids=["prefill", "q_offset"])
def test_chunked_attention_dv_mismatch(sq, sk, q_offset):
    """q, k (B, S, H, 48) and v (B, Sk, H, 32) through both packages'
    ``flash_attention`` (8-row query and 16-row key chunks): the
    ``mla_dv_mismatch`` fallback on both sides, the output and the
    gradients of q, k and v within 1e-5 of max|ref|."""
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((2, s, 4, 48)).astype(np.float32)
            for s in (sq, sk))
    v = rng.standard_normal((2, sk, 4, 32)).astype(np.float32)
    r = rng.standard_normal((2, sq, 4, 32)).astype(np.float32)
    kw = dict(causal=True, q_chunk=8, kv_chunk=16, q_offset=q_offset)

    def jf(q, k, v):
        return jnp.sum(jlayers.flash_attention(q, k, v, **kw) * r)

    jo = np.asarray(jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), **kw))
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    assert jops.dispatch_counters().get(FALLBACK, 0) > 0
    ops.reset_dispatch_counters()
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = layers.flash_attention(tq, tk, tv, **kw)
    assert ops.dispatch_counters() == {FALLBACK: 1}
    (to * torch.from_numpy(r)).sum().backward()
    assert to.shape == (2, sq, 4, 32)
    np.testing.assert_allclose(to.detach().numpy(), jo, rtol=0,
                               atol=1e-5 * np.abs(jo).max())
    for t, g in zip((tq, tk, tv), jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


# ---------------------------------------------------------------------------
# serving on one device
# ---------------------------------------------------------------------------

def test_residency_bitwise():
    ref, port = ts._pair(ARCH)
    ts.hold_convert(ref, port)
    ts.hold_residency(ref, port, WIRE)


def test_prefill_logits_and_latent():
    """Logits and the latent cache within 1e-4; one ``mla_dv_mismatch``
    fallback a layer, nothing else."""
    ref, port = ts._pair(ARCH)
    ops.reset_dispatch_counters()
    tokens = ts._tokens(0, (2, 16), port["arch"].vocab)
    (jl, jc), (tl, tc) = ts._prefill_both(ref, port, tokens)
    assert ops.dispatch_counters() == {FALLBACK: port["arch"].n_layers}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["mla"]["lat"].shape == (2, 2, 16, 80)
    np.testing.assert_allclose(tc["mla"]["lat"].numpy(),
                               np.asarray(jc["mla"]["lat"]), **TOL)
    assert set(tc["mla"]) == {"lat"}
    assert int(tc["pos"]) == int(jc["pos"]) == 16


def test_decode_teacher_forced():
    """The absorbed decode over the bf16 latent at a shared position, each
    port step from the reference's latent of that step (the module
    docstring's tolerances)."""
    ref, port = ts._pair(ARCH)
    plen, max_len, steps = 8, 16, 6
    vocab = port["arch"].vocab
    tokens = ts._tokens(1, (2, plen), vocab)
    forced = ts._tokens(2, (steps, 2), vocab)
    (_, jc), _ = ts._prefill_both(ref, port, tokens)
    jc = _grow_seq(jc, ref["model"], max_len)
    jc = {k: (v if k == "pos" else
              {n: a.astype(jnp.bfloat16) for n, a in v.items()})
          for k, v in jc.items()}
    jdec = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("d", max_len, 2, "decode")).make_decode()
    dec = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("d", max_len, 2, "decode")
                              ).make_decode()
    for i in range(steps):
        tc = {"mla": {"lat": ts._bf16_torch(jc["mla"]["lat"])},
              "pos": torch.tensor(int(jc["pos"]), dtype=torch.int32)}
        lat = tc["mla"]["lat"]
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1
        assert tc["mla"]["lat"] is lat            # written in place
        np.testing.assert_allclose(
            tc["mla"]["lat"].float().numpy(),
            np.asarray(jc["mla"]["lat"]).astype(np.float32),
            rtol=2 ** -7, atol=1e-5, err_msg=f"latent, step {i}")


def test_latent_write_per_row_in_place():
    """Per-row positions: each row's latent lands at its own position, in
    place, with index tensors alone; on two sequence ranks of 8 only the
    owner of a row's position writes it."""
    from repro_torch.core import collectives as col

    lat = torch.zeros((3, 16, 5))
    new = torch.arange(1, 4, dtype=torch.float32).reshape(3, 1, 1) \
        .expand(3, 1, 5)
    out = layers.sharded_cache_write(lat, new, torch.tensor([0, 7, 15]))
    assert out is lat and lat.sum().item() == 5 * (1 + 2 + 3)
    assert lat[1, 7, 0].item() == 2 and lat[2, 15, 0].item() == 3
    for coord in (0, 1):
        col.bind(Mesh((1, 1, 2), TEST_AXES, rank=coord))
        try:
            shard = torch.zeros((3, 8, 5))
            layers.sharded_cache_write(
                shard, new, torch.tensor([2, 9, 15]), seq_axes=("gcd",),
                axis_sizes={"data": 1, "node": 1, "gcd": 2})
            want = torch.zeros_like(shard)
            for row, p in enumerate((2, 9, 15)):
                if p // 8 == coord:
                    want[row, p % 8] = row + 1
            assert torch.equal(shard, want)
        finally:
            col.bind(None)


def test_generate_greedy_tokens():
    ts.hold_generate(*ts._pair(ARCH))


@pytest.mark.parametrize("case", ts.BATCHER_CASES[:2], ids=ts.BATCHER_IDS[:2])
def test_batcher_tokens_and_counters(case):
    """The paged pool holds the 4-D latent through admission, assemble,
    writeback and preemption: tokens and counters the reference's."""
    ts.hold_batcher(*ts._pair(ARCH), case)


def test_resident_is_gathered_bitwise():
    """Prefill and 3 decode steps: the gathered backend's logits bit for bit
    the resident one's."""
    _, port = ts._pair(ARCH)
    mesh = Mesh((1, 1, 1), TEST_AXES)
    cfg = scheme_config("zero_topo", mesh, quant_block=64,
                        compute_dtype="float32")
    eng = ZeroEngine(port["model"].leaf_specs(), cfg, mesh, TrainHparams(),
                     device="cpu")
    layout = ResidentLayout(eng.specs, cfg)
    res = build_resident(layout, port["prim"].items())
    shape = ShapeConfig("t", 19, 2, "decode")
    tokens = torch.as_tensor(ts._tokens(6, (2, 16), 512)).long()
    outs = []
    for se, params in ((ServeEngine(port["model"], eng, mesh, shape),
                        port["prim"]),
                       (ResidentServeEngine(port["model"], layout, shape),
                        res)):
        logits, caches = se.make_prefill()(params, {"tokens": tokens})
        caches["mla"]["lat"] = torch.nn.functional.pad(caches["mla"]["lat"],
                                                       (0, 0, 0, 3))
        got = [logits]
        for i in range(3):
            logits, caches = se.make_decode()(
                params, caches, {"token": torch.full((2,), 5 + i,
                                                     dtype=torch.long)})
            got.append(logits)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_serve_cli_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--requests", "3", "--slots", "2", "--prompt-len", "8",
                    "--max-len", "24", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out


# ---------------------------------------------------------------------------
# the reference on 4 host devices, and the port on 4 gloo ranks
# ---------------------------------------------------------------------------

def _reference_main(out: Path) -> None:
    """(1, 2, 2): the reference's training run with its state before every
    step (``train/``); (2, 1, 2): its ``ServeEngine`` prefill and decode
    (``test_torch_serve_mesh._reference_model``, ``ARCH/``)."""
    from repro.launch.mesh import make_test_mesh

    (out / "train").mkdir()
    reference_run(make_test_mesh(shape=(1, 2, 2), axes=AX), out / "train",
                  arch=ARCH, forced=True)
    tsm._reference_model(ARCH, out / ARCH)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    here = Path(__file__).resolve().parent
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(here.parent / "src"), str(here)]))
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return out


def _port_main(rank: int, ref: Path) -> dict:
    """This rank's forced training steps on (1, 2, 2), then its serving on
    (2, 1, 2) (``test_torch_serve_mesh._serve_model``) and one
    sequence-parallel prefill's payload bytes by label."""
    from repro_torch.core import collectives as col

    out = dict(forced=tt.port_forced_rank(rank, (1, 2, 2), ARCH, RUN["seq"],
                                          ref / "train"))
    out["serve"] = tsm._serve_model(rank, ARCH, ref)
    mesh = Mesh(tsm.SHAPE, TEST_AXES, rank)
    model, eng, state = tsm._engine(ARCH, mesh, ref / ARCH / "state.npz")
    se = ServeEngine(model, eng, mesh,
                     ShapeConfig("p", tsm.PLEN, tsm.B, "decode"))
    tokens = torch.from_numpy(np.load(ref / ARCH / "engine.npz")["tokens"])
    for sp in (False, True):
        col.reset_counters()
        se.make_prefill(seq_parallel=sp)(state["primaries"],
                                         {"tokens": tokens.long()})
        out[f"payload_sp{int(sp)}"] = dict(col.PAYLOAD)
    return out


@pytest.fixture(scope="module")
def port(ref_dir, tmp_path_factory):
    return run_ranks(_port_main, 4, tmp_path_factory.mktemp("port"), ref_dir)


@pytest.mark.parametrize("backend", tsm.BACKENDS)
def test_mesh_prefill_and_decode_logits(ref_dir, port, backend):
    """(2, 1, 2): the latent sharded over ("node", "gcd"), decode's
    partial softmax combined over them; logits within 1e-4 of the
    reference's ``ServeEngine``, each greedy token equal."""
    z = np.load(ref_dir / ARCH / "engine.npz")
    for r in port:
        got = r["serve"][backend]
        np.testing.assert_allclose(got["prefill"].numpy(),
                                   z["prefill_logits"], **TOL)
        for i in range(tsm.STEPS):
            np.testing.assert_allclose(got["decode"][i].numpy(),
                                       z[f"logits{i}"], **TOL,
                                       err_msg=f"decode step {i}")
            if i + 1 < tsm.STEPS:
                np.testing.assert_array_equal(
                    got["decode"][i].argmax(dim=-1).numpy(),
                    z["greedy"][i + 1])


def test_mesh_resident_bitwise_the_gathered(port):
    for r in port:
        g, res = r["serve"]["gathered"], r["serve"]["resident"]
        assert torch.equal(g["prefill"], res["prefill"])
        for a, b in zip(g["decode"], res["decode"]):
            assert torch.equal(a, b)
        assert torch.equal(g["generate"], res["generate"])


def test_mesh_seq_parallel_prefill(port):
    """Sequence-parallel prefill within 2e-4 of the plain one, logits and
    this rank's chunk of the latent; it gathers the latent (B, S / 2, lora
    + rope) once a layer under ``lat_gather``, and no K or V."""
    arch = tt.reduced_arch(get_arch, ARCH)
    ml = arch.mla
    for r in port:
        sp = r["serve"]["sp"]
        assert sp["eligible"]
        np.testing.assert_allclose(sp["sp"].numpy(), sp["plain"].numpy(),
                                   **tsm.SP_TOL)
        a, b = sp["caches_sp"]["mla"]["lat"], sp["caches_plain"]["mla"]["lat"]
        assert a.shape == b.shape == (arch.n_layers, tsm.B // 2,
                                      tsm.PLEN // 2, ml.kv_lora + ml.qk_rope)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tsm.SP_TOL)
        assert "lat_gather" not in r["payload_sp0"]
        # 4 bytes an f32 value; each rank gathers the other half of its rows
        assert r["payload_sp1"]["lat_gather"] == arch.n_layers * 4 * (
            tsm.B // 2) * (tsm.PLEN // 2) * (ml.kv_lora + ml.qk_rope)
        assert "seq_gather" not in r["payload_sp1"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_one_device(mesh1, tmp_path):
    """(1, 1, 1): each step from the reference's state before it, then the
    free-running run; two fallbacks a layer a step (the forward and its
    checkpointed recompute)."""
    ref = reference_run(mesh1, tmp_path, arch=ARCH, forced=True)
    forced = tt.port_forced_rank(0, (1, 1, 1), ARCH, RUN["seq"], tmp_path)
    (free,) = port_run(tmp_path, (1, 1, 1), arch=ARCH)
    _check(ref, forced)
    _check(ref, free)
    n = get_arch(ARCH).reduced().n_layers
    assert free["fallbacks"] == {FALLBACK: 2 * n * RUN["steps"]}


def test_train_step_four_ranks(ref_dir, port):
    """(1, 2, 2): each step from the reference's state before it within
    slice 2's tolerances, the same global loss and grad norm on every
    rank."""
    ref = json.loads((ref_dir / "train" / "metrics.json").read_text())
    for r in port:
        assert r["forced"] == port[0]["forced"]
    _check(ref, port[0]["forced"])


def _dw_rank(rank: int) -> dict:
    """One f32 step of the reduced minicpm3 on (1, 1, 2), W = 2, with
    ``ops.matmul_quant`` (the fused dW) and ``ops.quantize_int4`` (stage 1
    of a dense dW) wrapped: the (K, N) of each fused dW, the length of each
    quantized gradient, and the first ``w_dkv``-sized one's input and wire
    output."""
    from repro_torch.core.partition import padded_flat_size
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model

    fused, quantized, wire = [], [], {}
    mq, q4 = ops.matmul_quant, ops.quantize_int4
    spec = build_model(get_arch(ARCH).reduced()).leaf_specs()["mla.w_dkv"]
    n_dkv = padded_flat_size(spec.logical_size, scheme_config(
        "zero_topo", Mesh((1, 1, 2), TEST_AXES, rank),
        quant_block=RUN["quant_block"]))

    def spy_mq(x2, g2, block, **kw):
        fused.append((x2.shape[1], g2.shape[1]))
        return mq(x2, g2, block, **kw)

    def spy_q4(x, block, **kw):
        quantized.append(x.numel())
        q, s = q4(x, block, **kw)
        if x.numel() == n_dkv and not wire:
            wire.update(x=x.clone(), q=q.clone(), s=s.clone(), block=block)
        return q, s

    ops.matmul_quant, ops.quantize_int4 = spy_mq, spy_q4
    args = train.build_parser().parse_args([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--devices", "2",
        "--steps", "1", "--batch", str(RUN["batch"]), "--seq",
        str(RUN["seq"]), "--quant-block", str(RUN["quant_block"]),
        "--compute-dtype", "float32"])
    res = train.train_rank(rank, 2, args)
    return dict(fused=fused, quantized=quantized, wire=wire,
                losses=res["losses"])


def test_dw_paths_and_int4_wire(tmp_path):
    """With W = 2: every MLA matmul leaf whose rows are whole quant blocks
    takes the fused ``matmul_quant`` dW once a layer; ``w_dkv`` (80
    columns) takes the dense product and ``quantize_int4`` of its padded
    flat gradient once a layer, as do the embedding and the untied head
    (read whole). The first ``w_dkv`` gradient's packed INT4 bytes and f32
    scales are bit for bit the reference's ``quantize_int4`` of it."""
    from repro_torch.core.partition import padded_flat_size
    from repro_torch.models.registry import build_model

    arch = get_arch(ARCH).reduced()
    specs = build_model(arch).leaf_specs()
    cfg = scheme_config("zero_topo", Mesh((1, 1, 2), TEST_AXES, 0),
                        quant_block=RUN["quant_block"])
    fusable = sorted([specs[f"mla.{w}"].shape for w in
                      ("w_dq", "w_uq", "w_ukv", "wo", "w_gate", "w_up",
                       "w_down")] * arch.n_layers)
    pad = {n: padded_flat_size(specs[n].logical_size, cfg)
           for n in ("mla.w_dkv", "embed", "lm_head")}
    assert specs["mla.w_dkv"].shape[-1] % RUN["quant_block"]
    for r in run_ranks(_dw_rank, 2, tmp_path):
        assert all(np.isfinite(r["losses"]))
        assert sorted(r["fused"]) == fusable
        assert sorted(r["quantized"]) == sorted(
            [pad["mla.w_dkv"]] * arch.n_layers + [pad["embed"],
                                                  pad["lm_head"]])
        w = r["wire"]
        jq, js = jax.jit(lambda v: jops.quantize_int4(v, w["block"],
                                                      impl="jnp"))(
            jnp.asarray(w["x"].numpy()))
        np.testing.assert_array_equal(w["q"].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(w["s"].numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))


def test_train_cli_cpu(capfd):
    from repro_torch.launch import train as train_cli
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--devices", "4", "--steps", "2", "--seq", "32",
                    "--batch", "4"])
    out = capfd.readouterr().out
    assert f"arch={ARCH}-reduced" in out
    steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "final loss: " in out


if __name__ == "__main__":
    jax.config.update("jax_default_matmul_precision", "float32")
    _reference_main(Path(sys.argv[1]))
