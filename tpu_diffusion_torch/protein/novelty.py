"""Python bindings for the native novelty scan (ctypes).

Counterpart of `tpu_diffusion/protein/novelty.py`, with API parity with the
reference's `src/evaluation/novelty/`: `kabsch_alignment`, `rmsd`,
`tm_score`, `gdt_score`, `find_closest_structure`. The scan runs in host
C++ (`tpu_diffusion_torch/native/novelty.cpp`, a copy of the JAX package's
source), compiled with g++ at first use into `build/tpu_diffusion_torch/`
at the repository root under a name that carries a hash of the source, the
flags and the compiler's version, as `kernels/build.py` builds the CUDA
kernels. A failed build raises: nothing falls back to numpy. The numpy
functions below are the plain versions the tests hold the scan to; nothing
else calls them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np

from tpu_diffusion_torch.kernels.build import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "native" / "novelty.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _target() -> Path:
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256((" ".join(GXX_FLAGS) + version).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"novelty-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `native/novelty.cpp` unless it is built; raises on failure."""
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SRC}:\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build loads either
    return target


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    dptr = ctypes.POINTER(ctypes.c_double)
    lptr = ctypes.POINTER(ctypes.c_int64)
    lib.nov_kabsch_align.argtypes = [dptr, dptr, ctypes.c_int64, dptr]
    lib.nov_kabsch_align.restype = None
    lib.nov_rmsd.argtypes = [dptr, dptr, ctypes.c_int64]
    lib.nov_rmsd.restype = ctypes.c_double
    lib.nov_kabsch_rmsd.argtypes = [dptr, dptr, ctypes.c_int64, dptr]
    lib.nov_kabsch_rmsd.restype = ctypes.c_double
    lib.nov_tm_score.argtypes = [dptr, dptr, ctypes.c_int64]
    lib.nov_tm_score.restype = ctypes.c_double
    lib.nov_gdt_score.argtypes = [dptr, dptr, ctypes.c_int64]
    lib.nov_gdt_score.restype = ctypes.c_double
    lib.nov_find_closest.argtypes = [dptr, ctypes.c_int64, dptr, lptr,
                                     ctypes.c_int64, dptr, dptr, lptr]
    lib.nov_find_closest.restype = None
    return lib


def _c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _prep(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"expected [N, 3] coordinates, got {x.shape}")
    return x


def _pair(p, q):
    p, q = _prep(p), _prep(q)
    if len(p) != len(q):
        raise ValueError(f"{len(p)} and {len(q)} residues")
    return p, q


# ---------------------------------------------------------------------------
# plain numpy versions (the semantic reference for the C++ scan)
# ---------------------------------------------------------------------------


def _np_kabsch_alignment(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    cp, cq = p.mean(0), q.mean(0)
    pc, qc = p - cp, q - cq
    c = pc.T @ qc
    v, s, w = np.linalg.svd(c)
    if np.linalg.det(v) * np.linalg.det(w) < 0:
        v[:, -1] = -v[:, -1]
    return pc @ (v @ w) + cq


def _np_tm_score(p: np.ndarray, q: np.ndarray) -> float:
    # Zhang & Skolnick d0, clamped at 0.5 like standard TM-score
    # implementations: the raw formula is <= 0 for L <= 18
    d0 = max(1.24 * np.cbrt(len(p) - 15) - 1.8, 0.5)
    d = np.sqrt(np.sum((p - q) ** 2, axis=1))
    return float(np.mean(1.0 / (1.0 + (d / d0) ** 2)))


def _np_gdt_score(p: np.ndarray, q: np.ndarray) -> float:
    diff = p[:, None, :] - q[None, :, :]
    dist = np.sqrt(np.sum(diff**2, axis=-1))
    return float(np.mean([(dist < t).max(axis=1).mean()
                          for t in (1.0, 2.0, 4.0, 8.0)]))


def _np_find_closest(p1, keys, arrays) -> Dict:
    out = {"rmsd": np.inf, "tm_score": -np.inf, "gdt_score": -np.inf,
           "rmsd_match": None, "tm_score_match": None,
           "gdt_score_match": None}
    for key, sample in zip(keys, arrays):
        n1, ns = len(p1), len(sample)
        windows = 1 if n1 == ns else abs(ns - n1)
        for w in range(windows):
            pw = p1 if n1 <= ns else p1[w:w + ns]
            qw = sample if ns <= n1 else sample[w:w + n1]
            aligned = _np_kabsch_alignment(pw, qw)
            tag = key if n1 == ns else (
                f"{key}_{w}" if n1 < ns else f"{key}^{w}")
            r = float(np.sqrt(np.mean((aligned - qw) ** 2)))
            if r < out["rmsd"]:
                out["rmsd"], out["rmsd_match"] = r, tag
            tm = _np_tm_score(aligned, qw)
            if tm > out["tm_score"]:
                out["tm_score"], out["tm_score_match"] = tm, tag
            g = _np_gdt_score(aligned, qw)
            if g > out["gdt_score"]:
                out["gdt_score"], out["gdt_score_match"] = g, tag
    return out


# ---------------------------------------------------------------------------
# the native scan
# ---------------------------------------------------------------------------


def kabsch_alignment(p, q) -> np.ndarray:
    p, q = _pair(p, q)
    out = np.empty_like(p)
    _lib().nov_kabsch_align(_c(p), _c(q), len(p), _c(out))
    return out


def rmsd(p, q) -> float:
    p, q = _pair(p, q)
    return float(_lib().nov_rmsd(_c(p), _c(q), len(p)))


def tm_score(p, q) -> float:
    p, q = _pair(p, q)
    return float(_lib().nov_tm_score(_c(p), _c(q), len(p)))


def gdt_score(p, q) -> float:
    p, q = _pair(p, q)
    return float(_lib().nov_gdt_score(_c(p), _c(q), len(p)))


def find_closest_structure(p1, samples: Dict[str, np.ndarray]) -> Dict:
    """Closest training structure under RMSD / TM / GDT with the reference's
    sliding-window rule for unequal lengths (novelty_calculation.py:43-120)."""
    p1 = _prep(p1)
    keys = list(samples.keys())
    arrays = [_prep(samples[k]) for k in keys]
    offsets = np.zeros(len(arrays) + 1, np.int64)
    offsets[1:] = np.cumsum([len(a) for a in arrays])
    flat = np.ascontiguousarray(np.concatenate(arrays) if arrays
                                else np.zeros((0, 3), np.float64))
    scratch = np.empty_like(p1)
    metrics = np.empty(3, np.float64)
    match = np.empty(3, np.int64)
    _lib().nov_find_closest(
        _c(p1), len(p1), _c(flat),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(arrays), _c(scratch), _c(metrics),
        match.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))

    def decode(code: int):
        if code < 0:
            return None
        idx, wdw = divmod(int(code), 100000)
        key = keys[idx]
        if len(arrays[idx]) == len(p1):
            return key
        sep = "_" if len(p1) < len(arrays[idx]) else "^"
        return f"{key}{sep}{wdw}"

    return {
        "rmsd_match": decode(match[0]),
        "tm_score_match": decode(match[1]),
        "gdt_score_match": decode(match[2]),
        "rmsd": float(metrics[0]),
        "tm_score": float(metrics[1]),
        "gdt_score": float(metrics[2]),
    }
