"""jamba-v0.1-52b (the mamba / attention hybrid) in the port against the JAX
package.

jamba-v0.1-52b (arXiv:2403.19887): 32 layers, d_model 4,096, a mamba mixer
(d_inner 8,192, d_state 16) in every layer but 4, 12, 20 and 28
(attention, 32 heads over 8 KV heads of 128, no RoPE), an FFN behind every
mixer: the MoE FFN (16 SiLU-GLU experts of 14,336, top 2) in the odd
layers, a SiLU-GLU MLP of 14,336 in the even ones; RMSNorm, untied vocab
65,536. So three block kinds with three leaf sets: 12 ``mamba_mlp``, 16
``mamba_moe``, 4 ``attn_mlp``. On ``reduced()`` (3 layers, one of each
kind; d_model 256, 4 heads of 64, d_inner 512, 4 experts of 512, token
chunk 256, vocab 512) with the reference set up as its serving tests set
it up (zero_topo, quant_block 64, f32; ``test_torch_serve._pair``).

Tolerances and their causes:

- the leaves (names, shapes, kinds, stacks, inits, order) and the
  residency bit for bit;
- prefill logits and the mamba states within 1e-4 (rtol and atol: f32
  products in another order); the attention layer's K/V follows the MoE
  before it, whose slots are bf16 in an f32 run too, so where a slot
  element sits at a bf16 rounding boundary f32 noise moves it by one bf16
  ulp: held within 2**-7 of max|ref| (tests/test_torch_moe.py's bound);
- teacher-forced decode logits within 1e-4 a step, each port step from the
  reference's caches of that step (the K/V bf16 as the pool keeps them,
  the mamba states f32): measured 2.2e-5 at most on the port's own slots;
- the batcher's tokens and counters equal the reference's
  ``ContinuousBatcher``, provisioned and oversubscribed (a slot preempted
  and its request re-admitted into another slot's row);
- the zero_topo step at (1, 1, 1) over 3 steps: each step from the
  reference's state before it within slice 2's tolerances (loss 3e-5,
  grad norm 2e-4; tests/test_torch_train.py); on four ranks at (1, 2, 2)
  the forced steps
  within LOSS_RTOL and MOE_INT4_GNORM_RTOL (the bf16 slots' flips cross
  INT4 roundings, tests/test_torch_moe.py); the INT4 wire bytes of the
  unfused gradients (``w_xproj``, the expert stacks) bit for bit the
  reference's ``quantize_int4`` of the same gradient;
- on the mesh (2, 1, 2) (one reference subprocess on 4 forced host
  devices, one spawn of 4 port ranks): the engine's prefill and
  teacher-forced decode logits within 1e-4 of the reference's
  ``ServeEngine`` on the same mesh (f32 caches; each decode step given the
  reference's MoE slots, as tests/test_torch_moe.py's one-device decode,
  and within 4e-3 on its own), greedy tokens equal, the
  attention layer's K/V sharded along the sequence, the mamba states
  whole, ``sp_eligible()`` false in both packages.
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
from repro.models.config import ShapeConfig as JShape
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_arch as jget
from repro.serve.resident import ResidentServeEngine as JEngine
from repro.serve.scheduler import _grow_seq

from repro_torch.core.engine import TrainHparams, ZeroEngine
from repro_torch.core.partition import padded_flat_size, single_device_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import TEST_AXES, Mesh, scheme_config
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model, get_arch
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.resident import (ResidentLayout, ResidentServeEngine,
                                        build_resident, init_primaries,
                                        iter_primaries)
from repro_torch.serve.scheduler import ContinuousBatcher, Request
import test_torch_serve as ts
import test_torch_serve_mesh as tsm
import test_torch_train as tt
from test_torch_moe import MOE_INT4_GNORM_RTOL
from test_torch_train import (AX, RUN, _check,  # noqa: F401
                              one_torch_thread, reference_run, run_ranks)

ARCH = "jamba-v0.1-52b"
KINDS = ("mamba_mlp", "mamba_moe", "attn_mlp")
TOL = dict(rtol=1e-4, atol=1e-4)
MAMBA = ("w_in", "w_xproj", "w_dt", "w_out")
WIRE = sorted(["embed", "lm_head"]
              + [f"{k}.{n}" for k in ("mamba_mlp", "mamba_moe")
                 for n in MAMBA + ("w_gate", "w_up", "w_down")]
              + [f"attn_mlp.{n}" for n in ("wq", "wk", "wv", "wo", "w_gate",
                                           "w_up", "w_down")])
# the gradients stage 1 quantizes unfused (not whole quant blocks a row, or
# an expert stack read whole)
UNFUSED = ("mamba_moe.w_xproj", "mamba_moe.w_gate")


def test_config_is_the_reference_one():
    """Field by field (the MoE and SSM sub-configs too), published and
    reduced; the pattern's kinds and counts."""
    a, j = get_arch(ARCH), jget(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "kv_heads", "hdim", "d_ff",
              "vocab", "norm", "act", "tie_embeddings", "pattern", "family",
              "d_inner", "dt_rank", "source"):
        assert getattr(a, f) == getattr(j, f), f
        assert getattr(a.reduced(), f) == getattr(j.reduced(), f), f
    for f in ("n_experts", "top_k", "d_ff", "capacity_factor", "aux_coef",
              "token_chunk"):
        assert getattr(a.moe, f) == getattr(j.moe, f), f
    for f in ("d_state", "d_conv", "expand", "chunk"):
        assert getattr(a.ssm, f) == getattr(j.ssm, f), f
    assert a.kind_counts() == {"mamba_mlp": 12, "mamba_moe": 16,
                               "attn_mlp": 4}
    assert [i for i, k in enumerate(a.pattern) if k == "attn_mlp"] \
        == [4, 12, 20, 28]
    r = a.reduced()
    assert r.pattern == KINDS
    assert (r.d_model, r.moe.n_experts, r.moe.d_ff, r.d_inner) \
        == (256, 4, 512, 512)


@pytest.mark.parametrize("size", ["published", "reduced"])
def test_leaves_are_the_reference_ones(size):
    """Names, shapes, kinds, stacks and inits in the reference's order:
    each mamba kind's mixer leaves, then ``ln2`` and its FFN's; 51.57 G
    parameters at published size."""
    from repro.models.transformer import LM as JLM

    a, j = get_arch(ARCH), jget(ARCH)
    if size == "reduced":
        a, j = a.reduced(), j.reduced()
    got, want = LM(a).leaf_specs(), JLM(j).leaf_specs()
    assert list(got) == list(want)
    for n, sp in got.items():
        w = want[n]
        assert (sp.shape, sp.kind, sp.stack, sp.init, sp.init_scale) \
            == (w.shape, w.kind, w.stack, w.init, w.init_scale), n
    if size == "published":
        n_params = sum(s.logical_size * (s.stack or 1) for s in got.values())
        assert n_params == 51_570_315_264
        assert got["mamba_moe.w_gate"].shape == (16, 4096, 14336)
        assert got["mamba_moe.w_in"].stack == 16


def test_cache_shapes():
    """The attention kind's K/V sequence-indexed (L = 4, S positions, 8 KV
    heads of 128), the mamba kinds' f32 states not (stacks of 12 and 16),
    as the reference's ``cache_shapes`` says: the paged pool pages the
    first and keeps the others per slot."""
    got = build_model(get_arch(ARCH)).cache_shapes(
        ShapeConfig("d", 256, 4, "decode"))
    want = jbuild(jget(ARCH)).cache_shapes(JShape("d", 256, 4, "decode"))
    assert got["attn_mlp"]["k"] == ((4, 4, 256, 8, 128), torch.bfloat16, True)
    assert got["attn_mlp"]["v"] == got["attn_mlp"]["k"]
    for kind, n in (("mamba_mlp", 12), ("mamba_moe", 16)):
        assert got[kind] == {
            "h": ((n, 4, 8192, 16), torch.float32, False),
            "conv": ((n, 4, 3, 8192), torch.float32, False)}
    assert set(got) == set(want)
    for kind, entry in got.items():
        assert set(entry) == set(want[kind])
        for name, (shape, _, seq) in entry.items():
            assert want[kind][name][0] == shape and want[kind][name][2] == seq


# ---------------------------------------------------------------------------
# serving on one device
# ---------------------------------------------------------------------------

def test_residency_bitwise():
    ref, port = ts._pair(ARCH)
    ts.hold_convert(ref, port)
    ts.hold_residency(ref, port, WIRE)


def test_residency_rows_and_size():
    """Built one stack row at a time (``iter_primaries``), the residency
    equals the one quantized from whole stacks; the ``ssm_a`` rows are
    log(1..N) in both mamba stacks. At published size the layout's report
    is the INT8 bytes and f32 scales of 51.57 G parameters at block 128,
    53.18 GB, with no leaf left dense but the norms, ``conv``, ``dt_bias``,
    ``A_log``, ``D`` and the routers."""
    layout = ts._pair(ARCH)[1]["layout"]
    whole = build_resident(layout, init_primaries(layout, 0, "cpu").items())
    by_row = build_resident(layout, iter_primaries(layout, 0, "cpu"))
    for name, entry in by_row.items():
        if isinstance(entry, dict):
            for k in ("q", "s"):
                assert torch.equal(entry[k], whole[name][k]), name
        else:
            assert torch.equal(entry, whole[name]), name
    n = layout.specs["mamba_moe.A_log"].shape[1]
    for kind in ("mamba_mlp", "mamba_moe"):
        a = by_row[f"{kind}.A_log"]
        assert torch.equal(a, torch.log(torch.arange(1, n + 1).float())
                           .expand_as(a))

    big = get_arch(ARCH)
    specs = LM(big).leaf_specs()
    lay = ResidentLayout(specs, single_device_config("zero_topo",
                                                     quant_block=128))
    rep = lay.memory_report()
    cfg = lay.cfg
    wire = sum((s.stack or 1) * padded_flat_size(s.logical_size, cfg)
               * (1 + 4 / 128) for n, s in specs.items()
               if lay.mode(n) == "wire")
    assert rep["wire_bytes"] == wire and 53.17e9 < wire < 53.19e9
    dense = {n.split(".")[-1] for n in specs if lay.mode(n) != "wire"}
    assert dense == {"ln1", "ln2", "final_norm", "conv_w", "conv_b",
                     "dt_bias", "A_log", "D", "router"}


def _port_caches(jc):
    """The port's caches from the reference's: K/V bf16 as the pool keeps
    them, the mamba states f32."""
    out = {k: {n: ts._bf16_torch(a) if n in ("k", "v")
               else torch.from_numpy(np.array(a)) for n, a in v.items()}
           for k, v in jc.items() if k != "pos"}
    out["pos"] = torch.tensor(int(jc["pos"]), dtype=torch.int32)
    return out


def _hold_states(tc, jc, what):
    for kind in ("mamba_mlp", "mamba_moe"):
        for name in ("h", "conv"):
            np.testing.assert_allclose(tc[kind][name].numpy(),
                                       np.asarray(jc[kind][name]), **TOL,
                                       err_msg=f"{kind}.{name} {what}")


def test_prefill_logits_and_caches():
    """Logits and the mamba states within 1e-4; the attention layer's K/V
    (behind the MoE) within 2**-7 of max|ref|; no attention fallback."""
    ref, port = ts._pair(ARCH)
    ops.reset_dispatch_counters()
    tokens = ts._tokens(0, (2, 16), port["arch"].vocab)
    (jl, jc), (tl, tc) = ts._prefill_both(ref, port, tokens)
    assert ops.dispatch_counters() == {}
    assert tl.shape == (2, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["mamba_moe"]["h"].shape == (1, 2, 512, 16)
    assert tc["attn_mlp"]["k"].shape == (1, 2, 16, 4, 64)
    _hold_states(tc, jc, "after prefill")
    for n in ("k", "v"):
        want = np.asarray(jc["attn_mlp"][n])
        np.testing.assert_allclose(tc["attn_mlp"][n].numpy(), want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max())
    assert int(tc["pos"]) == int(jc["pos"]) == 16


def test_decode_teacher_forced():
    """A fixed token sequence decoded at a shared position, each port step
    from the reference's caches of that step: logits within 1e-4, the
    states written back in place within 1e-4, the step's new K/V (behind
    the MoE, as in prefill) within 2**-7 of max|ref| (measured: one
    element of 8,192 at step 5 2.7e-5 off, a near-zero value whose bf16
    rounding followed a flipped slot)."""
    ref, port = ts._pair(ARCH)
    plen, max_len, steps = 8, 16, 6
    vocab = port["arch"].vocab
    tokens = ts._tokens(1, (2, plen), vocab)
    forced = ts._tokens(2, (steps, 2), vocab)
    (_, jc), _ = ts._prefill_both(ref, port, tokens)
    jc = _grow_seq(jc, ref["model"], max_len)
    jc = {k: v if k == "pos" else
          {n: a.astype(jnp.bfloat16) if n in ("k", "v") else a
           for n, a in v.items()} for k, v in jc.items()}
    jdec = JEngine(ref["model"], ref["eng"], ref["mesh"],
                   JShape("d", max_len, 2, "decode")).make_decode()
    dec = ResidentServeEngine(port["model"], port["layout"],
                              ShapeConfig("d", max_len, 2, "decode")
                              ).make_decode()
    for i in range(steps):
        tc = _port_caches(jc)
        h = tc["mamba_moe"]["h"]
        tl, tc = dec(port["res"], tc,
                     {"token": torch.as_tensor(forced[i]).long()})
        jl, jc = jdec(ref["res"], jc, {"token": jnp.asarray(forced[i])})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
        assert int(tc["pos"]) == int(jc["pos"]) == plen + i + 1
        assert tc["mamba_moe"]["h"] is h             # written in place
        _hold_states(tc, jc, f"after decode step {i}")
        for n in ("k", "v"):
            want = np.asarray(jc["attn_mlp"][n]).astype(np.float32)
            np.testing.assert_allclose(
                tc["attn_mlp"][n].float().numpy(), want, rtol=0,
                atol=2 ** -7 * np.abs(want).max(),
                err_msg=f"cache {n}, step {i}")


def test_resident_is_gathered_bitwise():
    """The gathered backend (the engine's primaries through ``ParamView``,
    the experts through its ``expert_ffn`` under the ``mamba_moe.``
    prefix) and the resident one give the same logits bit for bit,
    prefill and 3 decode steps over the three kinds' caches."""
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
        caches["attn_mlp"] = {n: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, 3)) for n, t in caches["attn_mlp"].items()}
        got = [logits]
        for i in range(3):
            logits, caches = se.make_decode()(
                params, caches, {"token": torch.full((2,), 5 + i,
                                                     dtype=torch.long)})
            got.append(logits)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_generate_greedy_tokens():
    ts.hold_generate(*ts._pair(ARCH))


@pytest.mark.parametrize("case", ts.BATCHER_CASES[:2], ids=ts.BATCHER_IDS[:2])
def test_batcher_tokens_and_counters(case):
    """The pool holds the attention layer's K/V in pages and both mamba
    kinds' states per slot: tokens and counters the reference's, a slot
    preempted and re-admitted when oversubscribed."""
    ts.hold_batcher(*ts._pair(ARCH), case)


def test_pool_mamba_rows():
    """The oversubscribed batcher, every decode step watched: an
    admission writes the prompt's whole prefill state into the slot's row
    (bit for bit a B = 1 prefill of that prompt; a preempted request's
    re-admission overwrites what another request left there); a step
    changes the state of each active row and leaves every inactive row's
    as it was."""
    _, port = ts._pair(ARCH)
    case = ts.BATCHER_CASES[1]
    cb = ContinuousBatcher(port["model"], port["layout"], device="cpu",
                           n_slots=case["n_slots"], max_len=case["max_len"],
                           prompt_len=case["prompt_len"],
                           page_size=case["page_size"],
                           n_pages=case["n_pages"])
    pre = ResidentServeEngine(port["model"], port["layout"], ShapeConfig(
        "p", case["prompt_len"], 1, "decode")).make_prefill()
    prompts = [ts._tokens(10 + i, (case["prompt_len"],), 512)
               for i in range(case["n_req"])]
    states = {}
    for i, p in enumerate(prompts):
        _, c = pre(port["res"], {"tokens": torch.as_tensor(p[None]).long()})
        states[i] = {(k, n): c[k][n][:, 0] for k in ("mamba_mlp", "mamba_moe")
                     for n in ("h", "conv")}

    def rows():
        return {key: cb.pool[key[0]][key[1]].clone() for key in states[0]}

    steps, own = [], cb._paged_step

    def watched(params, table, token, row_pos, active):
        before = rows()
        out = own(params, table, token, row_pos, active)
        steps.append((before, rows(), active.clone(),
                      [r.rid if r is not None else None for r in cb.slots]))
        return out

    cb._paged_step = watched
    cb.run(port["res"], [Request(rid=i, prompt=p, max_new=case["max_new"])
                         for i, p in enumerate(prompts)])
    assert cb.counters["preempted"] > 0 and cb.counters["retired"] == 4
    readmitted = 0
    after_prev, rids_prev = None, [None] * case["n_slots"]
    for before, after, active, rids in steps:
        for slot, rid in enumerate(rids):
            if rid is not None and rid != rids_prev[slot]:
                for key, want in states[rid].items():
                    assert torch.equal(before[key][:, slot], want), key
                    if after_prev is not None:
                        assert not torch.equal(after_prev[key][:, slot],
                                               want), key
                readmitted += after_prev is not None
            for key in before:
                same = torch.equal(after[key][:, slot], before[key][:, slot])
                assert same != bool(active[slot]), (key, slot)
        after_prev, rids_prev = after, rids
    assert readmitted >= 2


def test_serve_cli_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                    "--backend", "resident", "--devices", "1",
                    "--requests", "3", "--slots", "2", "--prompt-len", "8",
                    "--max-len", "24", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced backend=resident" in out
    assert "admitted 3 rejected 0 preempted 0 retired 3" in out


# ---------------------------------------------------------------------------
# the reference on 4 host devices, and the port on 4 gloo ranks
# ---------------------------------------------------------------------------

def _reference_main(out: Path) -> None:
    """(1, 2, 2): the reference's training run with its state before every
    step (``train/``); (2, 1, 2): its ``ServeEngine`` prefill and decode
    (``test_torch_serve_mesh._reference_model``, ``ARCH/``) with the MoE
    slots each decode step formed on each data rank (``slots.npz``:
    recorded from its dispatch einsum, the same on both sequence ranks of
    a row group), and its ``sp_eligible``."""
    from jax import lax

    from repro.launch.mesh import make_test_mesh

    (out / "train").mkdir()
    reference_run(make_test_mesh(shape=(1, 2, 2), axes=AX), out / "train",
                  arch=ARCH, forced=True)
    seen, own = {0: [], 1: []}, jnp.einsum

    def record(eq, *operands, **kw):
        if eq == "tec,td->ecd":
            jax.debug.callback(
                lambda i, a: seen[int(i)].append(np.asarray(a)),
                lax.axis_index("data"), operands[1].astype(jnp.float32))
        return own(eq, *operands, **kw)

    jnp.einsum = record
    try:
        tsm._reference_model(ARCH, out / ARCH)
        jax.effects_barrier()
    finally:
        jnp.einsum = own
    slots = {}
    for data, arrays in seen.items():
        # a prefill's slots are its rows' 16 tokens; a decode step's one
        # token a row, recorded by the two sequence ranks in turn
        steps = [a for a in arrays if a.shape[0] == tsm.B // 2]
        assert len(steps) == 2 * tsm.STEPS
        for i in range(tsm.STEPS):
            assert np.array_equal(steps[2 * i], steps[2 * i + 1])
            slots[f"{data}/{i}"] = steps[2 * i]
    np.savez(out / ARCH / "slots.npz", **slots)
    (out / "sp_eligible.json").write_text(json.dumps(
        jbuild(tt.reduced_arch(jget, ARCH)).lm.sp_eligible()))


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


def _serve_mesh(rank: int, ref: Path) -> dict:
    """This rank of (2, 1, 2), both backends: the prefill's logits (and the
    gathered one's caches), each decode step from the reference's caches
    of that step with the reference's slots for this rank's rows handed to
    ``moe._slots`` and with its own, greedy generation; the
    sequence-parallel prefill's logits beside the plain one's."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine

    mesh = Mesh(tsm.SHAPE, TEST_AXES, rank)
    model, eng, state = tsm._engine(ARCH, mesh, ref / ARCH / "state.npz")
    prim = state["primaries"]
    layout = ResidentLayout(eng.specs, eng.cfg, None, mesh)
    res = build_resident(layout, prim.items())
    z = np.load(ref / ARCH / "engine.npz")
    slots = np.load(ref / ARCH / "slots.npz")
    data = mesh.index(("data",))
    tokens = torch.from_numpy(z["tokens"]).long()
    pshape = ShapeConfig("p", tsm.PLEN, tsm.B, "decode")
    dshape = ShapeConfig("d", tsm.MAX_LEN, tsm.B, "decode")
    handed, own_slots = [], moe._slots

    def hand(xc):
        return torch.from_numpy(handed.pop()).to(torch.bfloat16) \
            if handed else own_slots(xc)

    moe._slots = hand
    out = dict(coords=(data, mesh.index(("node", "gcd"))))
    try:
        for backend, serve_p, serve_d, params in (
                ("gathered", ServeEngine(model, eng, mesh, pshape),
                 ServeEngine(model, eng, mesh, dshape), prim),
                ("resident", ResidentServeEngine(model, layout, pshape, mesh),
                 ResidentServeEngine(model, layout, dshape, mesh), res)):
            logits, caches = serve_p.make_prefill()(params,
                                                    {"tokens": tokens})
            got = dict(prefill=serve_p.gather_rows(logits), caches=caches,
                       decode=[], decode_own=[])
            dec = serve_d.make_decode()
            for i in range(tsm.STEPS):
                tok = torch.from_numpy(z["greedy"][i]).long()
                for key, given in (("decode", True), ("decode_own", False)):
                    handed[:] = [slots[f"{data}/{i}"]] if given else []
                    logits, _ = dec(params, tsm._local_caches(z, i, serve_d),
                                    {"token": tok})
                    assert not handed
                    got[key].append(serve_d.gather_rows(logits))
            got["generate"] = serve_p.generate(params, {"tokens": tokens},
                                               tsm.GEN)
            out[backend] = got
    finally:
        moe._slots = own_slots
    se = ServeEngine(model, eng, mesh, pshape)
    out["sp"] = dict(eligible=model.lm.sp_eligible(), sp=se.gather_rows(
        se.make_prefill(seq_parallel=True)(prim, {"tokens": tokens})[0]))
    return out


def _port_main(rank: int, ref: Path) -> dict:
    """This rank's forced training steps on (1, 2, 2), the first inputs and
    INT4 wire outputs of ``ops.quantize_int4`` at the UNFUSED leaves'
    padded sizes (W = 2), then its serving on (2, 1, 2) (``_serve_mesh``)."""
    from repro_torch.models.registry import build_model as tbuild

    specs = tbuild(get_arch(ARCH).reduced()).leaf_specs()
    cfg = scheme_config("zero_topo", Mesh((1, 2, 2), TEST_AXES, rank),
                        quant_block=RUN["quant_block"])
    sizes = {padded_flat_size(specs[n].logical_size, cfg): n for n in UNFUSED}
    wire, q4 = {}, ops.quantize_int4

    def spy(x, block, **kw):
        q, s = q4(x, block, **kw)
        name = sizes.get(x.numel())
        if name is not None and name not in wire:
            wire[name] = dict(x=x.clone(), q=q.clone(), s=s.clone(),
                              block=block)
        return q, s

    ops.quantize_int4 = spy
    try:
        out = dict(forced=tt.port_forced_rank(rank, (1, 2, 2), ARCH,
                                              RUN["seq"], ref / "train"))
    finally:
        ops.quantize_int4 = q4
    out["wire"] = wire
    out["serve"] = _serve_mesh(rank, ref)
    return out


@pytest.fixture(scope="module")
def port(ref_dir, tmp_path_factory):
    return run_ranks(_port_main, 4, tmp_path_factory.mktemp("port"), ref_dir)


@pytest.mark.parametrize("backend", tsm.BACKENDS)
def test_mesh_prefill_and_decode_logits(ref_dir, port, backend):
    """(2, 1, 2): the prefill's logits within 1e-4 of the reference's
    ``ServeEngine``; each decode step (from the reference's caches of that
    step) within 1e-4 given the reference's slots, within 4e-3 on the
    port's own (tests/test_torch_moe.py: a slot element at a bf16 rounding
    boundary moves by one ulp on f32 noise; here 21 of 2,048 logits of one
    step 1.5e-4 apart); the greedy tokens of both the reference's; the
    resident backend bit for bit the gathered one (``generate`` too)."""
    z = np.load(ref_dir / ARCH / "engine.npz")
    for r in port:
        got = r["serve"][backend]
        np.testing.assert_allclose(got["prefill"].numpy(),
                                   z["prefill_logits"], **TOL)
        for i in range(tsm.STEPS):
            want = z[f"logits{i}"]
            for key, tol in (("decode", TOL), ("decode_own",
                                               dict(rtol=0, atol=4e-3))):
                np.testing.assert_allclose(got[key][i].numpy(), want, **tol,
                                           err_msg=f"{key} step {i}")
                if i + 1 < tsm.STEPS:
                    np.testing.assert_array_equal(
                        got[key][i].argmax(dim=-1).numpy(),
                        z["greedy"][i + 1])
        g = r["serve"]["gathered"]
        for key in ("prefill", "generate"):
            assert torch.equal(g[key], got[key])
        for a, b in zip(g["decode_own"], got["decode_own"]):
            assert torch.equal(a, b)


def test_mesh_caches_and_sp(ref_dir, port):
    """A rank's prefill caches: the attention layer's K/V its rows and its
    half of the sequence, each mamba state its rows whole, as the
    reference's global caches cut the same way; neither package runs a
    hybrid's prefill sequence-parallel (the scan's cross-chunk
    dependency): the port's ``seq_parallel`` prefill is its plain one."""
    assert json.loads((ref_dir / "sp_eligible.json").read_text()) is False
    arch = tt.reduced_arch(get_arch, ARCH)
    z = np.load(ref_dir / ARCH / "engine.npz")
    half, s_loc = tsm.B // 2, tsm.PLEN // 2
    for r in port:
        sp = r["serve"]["sp"]
        assert sp["eligible"] is False
        assert torch.equal(sp["sp"], r["serve"]["gathered"]["prefill"])
        c = r["serve"]["gathered"]["caches"]
        data, seq = r["serve"]["coords"]
        rows = slice(data * half, (data + 1) * half)
        k = c["attn_mlp"]["k"]
        assert k.shape == (1, half, s_loc, arch.kv_heads, arch.hdim)
        want = z["cache0/attn_mlp/k"][:, rows, seq * s_loc:(seq + 1) * s_loc]
        np.testing.assert_allclose(k.numpy(), want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max())
        for kind in ("mamba_mlp", "mamba_moe"):
            for name in ("h", "conv"):
                t = c[kind][name]
                assert t.shape[:2] == (1, half)
                np.testing.assert_allclose(
                    t.numpy(), z[f"cache0/{kind}/{name}"][:, rows], **TOL)
            assert c[kind]["h"].shape[2:] == (arch.d_inner, arch.ssm.d_state)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_one_device(mesh1, tmp_path):
    """(1, 1, 1): each of 3 steps from the reference's state before it;
    no attention fallback."""
    ref = reference_run(mesh1, tmp_path, arch=ARCH, forced=True)
    ops.reset_dispatch_counters()
    forced = tt.port_forced_rank(0, (1, 1, 1), ARCH, RUN["seq"], tmp_path)
    assert ops.dispatch_counters() == {}
    _check(ref, forced)


def test_train_step_four_ranks(ref_dir, port):
    """(1, 2, 2): each step from the reference's state before it, the same
    global loss and grad norm on every rank."""
    ref = json.loads((ref_dir / "train" / "metrics.json").read_text())
    for r in port:
        assert r["forced"] == port[0]["forced"]
    _check(ref, port[0]["forced"], gnorm_rtol=MOE_INT4_GNORM_RTOL)


def test_int4_wire_bytes(port):
    """W = 2: the first unfused stage-1 gradient of ``w_xproj`` (48 columns,
    not whole blocks of 64) and of an expert stack on every rank: its
    packed INT4 bytes and f32 scales bit for bit the reference's
    ``quantize_int4`` of the same gradient."""
    quant = jax.jit(lambda v, b: jops.quantize_int4(v, b, impl="jnp"),
                    static_argnums=1)
    for r in port:
        assert set(r["wire"]) == set(UNFUSED)
        for name, w in r["wire"].items():
            assert torch.count_nonzero(w["x"]) > 0, name
            jq, js = quant(jnp.asarray(w["x"].numpy()), w["block"])
            np.testing.assert_array_equal(w["q"].numpy(), np.asarray(jq),
                                          err_msg=name)
            np.testing.assert_array_equal(w["s"].numpy().view(np.uint32),
                                          np.asarray(js).view(np.uint32),
                                          err_msg=name)


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
