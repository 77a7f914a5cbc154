"""Protein C-alpha datasets as padded dense batches.

The port's own copy of `tpu_diffusion/protein/data.py` (numpy only; the
port imports nothing of the JAX package).

Rebuilds `src/utils/data_utils.py` (SCOPe/CATH .npy coordinate datasets) and
`src/utils/torch_utils.py:67-90` (positions_to_graph: scale 1/15, COM
center, fully-connected edges, chain-order feature). A
deterministic synthetic ensemble of helix-bundle-like chains stands in when
no .npy directory is present — realistic C-alpha spacing (3.8 A) so the
geometry losses and evaluators have true structure to measure.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

COORD_SCALE = 1.0 / 15.0  # reference torch_utils.py:73


@dataclass
class ProteinDataset:
    """positions [Num, N, 3] (scaled + centered), lengths [Num]."""

    positions: np.ndarray
    lengths: np.ndarray
    max_len: int
    synthetic: bool = False

    def __len__(self):
        return len(self.positions)


def _center_pad(coords: np.ndarray, max_len: int) -> np.ndarray:
    """Scale 1/15, remove COM, zero-pad to max_len."""
    coords = coords * COORD_SCALE
    coords = coords - coords.mean(axis=0, keepdims=True)
    out = np.zeros((max_len, 3), np.float32)
    out[:len(coords)] = coords
    return out


def synthetic_ca_chains(n: int, max_len: int = 112, min_len: int = 60,
                        seed: int = 0) -> ProteinDataset:
    """Helix-like self-avoiding chains with 3.8 A consecutive spacing."""
    rng = np.random.default_rng(seed)
    min_len = min(min_len, max(max_len - 1, 1))
    lengths = rng.integers(min_len, max_len + 1, size=n)
    positions = np.zeros((n, max_len, 3), np.float32)
    # ideal alpha-helix local geometry: rise 1.5 A, radius 2.3 A, 100 deg
    for k in range(n):
        L = lengths[k]
        phase = rng.uniform(0, 2 * np.pi)
        # random piecewise helix: occasional direction changes (loops)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        coords = np.zeros((L, 3))
        u = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else \
            np.array([0, 1.0, 0])
        e1 = np.cross(axis, u)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis, e1)
        origin = np.zeros(3)
        t_axis = 0.0
        for i in range(L):
            if i and rng.random() < 0.04:  # start a new segment (loop)
                origin = coords[i - 1]
                axis = rng.normal(size=3)
                axis /= np.linalg.norm(axis)
                e1 = np.cross(axis, u if abs(axis @ u) < 0.9
                              else np.array([0, 0, 1.0]))
                e1 /= np.linalg.norm(e1)
                e2 = np.cross(axis, e1)
                t_axis = 0.0
                phase = rng.uniform(0, 2 * np.pi)
            ang = phase + 1.745 * t_axis  # ~100 deg per residue
            coords[i] = (origin + axis * 1.5 * t_axis
                         + 2.3 * (np.cos(ang) * e1 + np.sin(ang) * e2))
            t_axis += 1.0
        positions[k] = _center_pad(coords, max_len)
    return ProteinDataset(positions, lengths.astype(np.int32), max_len,
                          synthetic=True)


def load_npy_dir(root: str, max_len: int = 112) -> Optional[ProteinDataset]:
    """Load a directory of per-protein [L, 3] C-alpha .npy files."""
    if not os.path.isdir(root):
        return None
    files = sorted(f for f in os.listdir(root) if f.endswith(".npy"))
    if not files:
        return None
    pos_list, lens = [], []
    for f in files:
        coords = np.load(os.path.join(root, f)).astype(np.float32)
        if coords.ndim != 2 or coords.shape[1] != 3:
            continue
        coords = coords[:max_len]
        lens.append(len(coords))
        pos_list.append(_center_pad(coords, max_len))
    if not pos_list:
        return None
    return ProteinDataset(np.stack(pos_list), np.asarray(lens, np.int32),
                          max_len)


def get_protein_data(root: str = "data/scope", max_len: int = 112,
                     n_synthetic: int = 2048, seed: int = 0
                     ) -> ProteinDataset:
    ds = load_npy_dir(root, max_len)
    if ds is not None:
        return ds
    return synthetic_ca_chains(n_synthetic, max_len=max_len, seed=seed)


def protein_batches(ds: ProteinDataset, batch_size: int, seed: int = 0
                    ) -> Iterator[dict]:
    """Infinite shuffled (pos, mask) numpy batches."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    col = np.arange(ds.max_len)
    if batch_size > n:
        raise ValueError(
            f"batch_size={batch_size} exceeds dataset size {n} — the "
            f"epoch loop would yield nothing and spin forever")
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            idx = perm[s:s + batch_size]
            yield {
                "pos": ds.positions[idx],
                "mask": col[None, :] < ds.lengths[idx][:, None],
            }
