"""Build the CUDA kernels in `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` holds kernels with a plain C entry point (no PyTorch
headers), so one `nvcc` run takes seconds. It is compiled for `sm_90a` on
first use into `build/tpu_diffusion_torch/` at the repository root; the file
name carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. A build failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_diffusion_torch"
SOURCES = ("attention_fused", "groupnorm_silu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source that is not built yet, one `nvcc` each, all at
    once. Returns {name: {"seconds": s, "cached": bool, "ptxas": text}}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent build loads either
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "ptxas": out}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built `csrc/<name>.cu`, building it first if needed."""
    target = _target(name)
    if not target.exists():
        build_all((name,))
    return ctypes.CDLL(str(target))
