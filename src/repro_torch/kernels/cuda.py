"""Builds the CUDA kernels of ``csrc/`` and binds them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<hash>/lib<name>.so`` at the
repository root (a directory .gitignore lists), compiled by ``nvcc`` for
``sm_90a`` with a plain C interface. ``<hash>`` covers every source, header
and flag, so an edited kernel is rebuilt and an unchanged one is reused. The
build runs at first use, one ``nvcc`` per source, all started together;
importing this module compiles nothing. No ``--use_fast_math``: the
quantize needs IEEE division and ``rintf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# must match csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}
_BOUND: set[str] = set()
BUILD_LOG: dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return str(path)


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (or reuse) every kernel library and load it. Raises with the
    compiler's output if any source fails to build."""
    if _LIBS:
        return _LIBS
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _digest(sources + sorted(CSRC.glob("*.cuh")))
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for src in sources:
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, lib)
    failed, logs = [], {}
    for stem, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {stem}.cu:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_LOG.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                     built=sorted(jobs), ptxas=logs)
    for src in sources:
        _LIBS[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
    return _LIBS


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` with ``argtypes``/``restype`` set from
    ``signatures`` ({function: (restype, [argtypes])})."""
    lib = build_all()[name]
    if name not in _BOUND:
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = restype, argtypes
        _BOUND.add(name)
    return lib


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, name: str, dtypes) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
