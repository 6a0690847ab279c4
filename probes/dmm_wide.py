#!/usr/bin/env python3
"""Card probe of the flat dequant-matmul's wide decode kernel (row 8e,
``dmm_dec_tn_wide_kernel`` in src/repro_torch/csrc/dequant_matmul.cu) at
the NeoX LM heads: gpt-neox-20b's (50,432 x 6,144).T and gpt-neox-10b's
(50,432 x 5,120).T at M = 1, 4 and 8.

    python3 probes/dmm_wide.py

Needs one CUDA card and nvcc. For each head and M it prints the device ms
of the call on its own path (through ``ops.dequant_matmul``), on the SIMT
kernel (forced) and of bf16 cuBLAS on the dequantized weight, beside the
bytes bound; then of forms of the kernel built from the same source with
its ring constants replaced (columns a stage, stages a ring, CTAs an SM),
with the int8 widened by a bf16x2 subtract instead of through exact f32,
and with the products left out (``ring only``: the same copies and waits,
what the ring alone streams), each twice in turns, with the largest
difference from the plain version for those that compute. Writes the rows
to chiprun_out/dmm_wide.json.
"""
import ctypes
import json
import multiprocessing as mp
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "csrc"

# name -> (DW_COLS, DW_STAGES, DW_MIN_CTAS, products, widening)
FORMS = {"256 x 2": (256, 2, 4, True, "f32"), "128 x 4": (128, 4, 4, True, "f32"),
         "128 x 3": (128, 3, 4, True, "f32"),
         "256 x 2 bf16x2 widening": (256, 2, 4, True, "bf16x2"),
         "256 x 2 ring only": (256, 2, 4, False, "f32"),
         "128 x 4 ring only": (128, 4, 4, False, "f32")}
PRODUCTS = "    for (int p = 0; p < DW_SLICES / 2; ++p) {"
# the kernel's widening (i8x4_to_bf16x4: each int8 exact in f32, a bf16x2
# pack a pair), and a form with fewer instructions a pair: the bytes spread
# to the low bytes of two halves, 0x4300 | (b & 0x7F) and 0x4300 | (b &
# 0x80) are the bf16 128 + (b & 0x7F) and 128 + (b & 0x80), whose
# difference is the int8 b
WIDEN = ("        i8x4_to_bf16x4(r[2 * h], a[0], a[2]);\n"
         "        i8x4_to_bf16x4(r[2 * h + 1], a[1], a[3]);\n")
BF16X2_WIDEN = ("        a[0] = sub_pair<0>(r[2 * h]), a[2] = sub_pair<2>(r[2 * h]);\n"
                "        a[1] = sub_pair<0>(r[2 * h + 1]), a[3] = sub_pair<2>(r[2 * h + 1]);\n")
KERNEL_NOTE = "// out (M, K) = x (M, N) @ dequant(q (K, N)).T, bf16 x and out, N % 16 == 0,"
SUB_PAIR = """template <int I>
__device__ __forceinline__ uint32_t sub_pair(uint32_t w) {
  const uint32_t v = __byte_perm(w, 0u, 0x4140 + I * 0x0101);
  const uint32_t hi = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t lo = (v & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                   *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&d);
}

"""


def build(name, cols, stages, min_ctas, products, widening):
    """dequant_matmul.cu with the form's constants, as its own library;
    returns its dequant_matmul_on_path."""
    from repro_torch.kernels import cuda

    src = (CSRC / "dequant_matmul.cu").read_text()
    for key, val in (("DW_COLS", cols), ("DW_STAGES", stages),
                     ("DW_MIN_CTAS", min_ctas)):
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {val};", src)
        assert n == 1, key
    if widening == "bf16x2":
        assert src.count(WIDEN) == 1 and src.count(KERNEL_NOTE) == 1
        src = src.replace(WIDEN, BF16X2_WIDEN).replace(
            KERNEL_NOTE, SUB_PAIR + KERNEL_NOTE)
    if not products:
        assert src.count(PRODUCTS) == 1
        src = src.replace(PRODUCTS, "    for (int p = 0; p < 0; ++p) {")
    out = ROOT / "build" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", name)
    cu, so = out / f"{stem}.cu", out / f"lib{stem}.so"
    cu.write_text(src)
    r = subprocess.run([cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", "-I", str(CSRC), "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    log = (r.stdout + r.stderr).splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "dmm_dec_tn_wide" in line:
            regs = next(l for l in log[i:] if "registers" in l)
            spill = next(l for l in log[i:] if "spill" in l)
            nt = re.search(r"ILi(\d)E", line).group(1)
            print(f"  {name}, M <= {8 * int(nt)}: {regs.split(':')[-1].strip()}; "
                  f"{spill.strip()}")
    f = ctypes.CDLL(str(so)).dequant_matmul_on_path
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return f


def work():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import PATHS

    if not torch.cuda.is_available():
        raise SystemExit("dmm_wide: no CUDA device")
    print(cs.nvidia_smi())
    forms = {name: build(name, *v) for name, v in FORMS.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for n in (cs.NEOX_D, cs.NEOX10B_D):
        k = cs.NEOX_V
        w = torch.randn(k * n, generator=gen, device=dev) * 0.05
        q, s = ops.quantize_int8(w, 128)
        del w
        dense = cs.dense_weights([(None, q, s, (k, n), 128, True)])
        for m in (1, 4, 8):
            x = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
            call = (x, q, s, (k, n), 128, True)
            bound = cs.bound_ms(*cs.matmul_work([call]), "bf16")[0]
            ref = ops.dequant_matmul(x, q, s, (k, n), 128, transpose=True,
                                     dtype=torch.bfloat16, impl="plain")
            row = dict(K=k, N=n, M=m, bound_ms=bound, path=cs.call_path(call),
                       own_ms=cs.device_ms(cs.run_matmuls([call])),
                       simt_ms=cs.device_ms(cs.run_on_path([call], PATHS.index("simt"))),
                       cublas_ms=cs.device_ms(cs.run_dense([call], dense)))
            print(f"({k}, {n}).T M={m} {row['path']}: {row['own_ms']:.5f} ms, "
                  f"SIMT {row['simt_ms']:.5f}, bf16 cuBLAS {row['cublas_ms']:.5f}, "
                  f"bound {bound:.5f}")
            for turn in (0, 1):
                for name, f in forms.items():
                    y = torch.empty((m, k), dtype=torch.bfloat16, device=dev)

                    def fn():
                        rc = f(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                               None, 1, m, k, n, 128, 1, PATHS.index("decode"),
                               torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"{name}: launch failed with {rc}")
                    ms = cs.device_ms(fn)
                    err = float((y.float() - ref.float()).abs().max()) \
                        if FORMS[name][3] else None
                    row.setdefault("forms", {}).setdefault(name, []).append(ms)
                    print(f"  {name}: {ms:.5f} ms ({bound / ms:.0%} of bound)"
                          + ("" if err is None else f", max|d| {err:.3e}"))
            rows.append(row)
        del q, s, dense
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "dmm_wide.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    p = mp.get_context("spawn").Process(target=work)
    p.start()
    p.join(900)
    if p.is_alive():
        p.kill()
        sys.exit("dmm_wide: timed out")
    sys.exit(p.exitcode)
