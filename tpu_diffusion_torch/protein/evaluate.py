"""Protein sample evaluation pipeline.

The port's own copy of `tpu_diffusion/protein/evaluate.py`: numpy at
module level; scipy, the novelty scan, the datasets and the
self-consistency stage are imported where they are used. Run it as
`python -m tpu_diffusion_torch.protein.evaluate` with the JAX CLI's flags
plus `--device`, where `--self_consistency` runs the CA-ProteinMPNN (the
CUDA card unless `--device cpu`).

Rebuilds `amortised diffusion/src/evaluation/evaluation_pipeline.py`: a
staged pipeline over sampled structures producing per-sample statistics
(`sample_stats.csv` equivalent):

  * BackboneSanityCheck   — NaN / stuck-canvas detection (:322-338)
  * BackboneCAEvaluator   — consecutive C-alpha distances (:211-246)
  * BackboneCAAngleEvaluator — bond/dihedral angles (:249-287)
  * BackboneCASSEEvaluator — helix/sheet/coil fractions via a dependency-
                            free P-SEA classifier (:290-319 uses biotite)
  * RadiusOfGyration      — (:341-359)
  * VolumeEvaluator       — convex hull volume (:370-385)
  * NoveltyEvaluator      — closest train structure RMSD/TM/GDT via the
                            native C++ kernel (novelty/)

Parallel `eval_many(n_jobs=...)` (reference :104-130), training-set
statistics with CSV caching (`eval_training_set`, reference :633-694), and
sample-vs-training distribution comparison (`compare_to_training`).

The ProteinMPNN + ColabFold self-consistency stages of the reference call
external model servers that do not exist in this environment; the pipeline
exposes the same stage interface so they can be plugged in where available.

Stages are numpy (post-hoc analysis on the host); the heavy novelty
scan is C++.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class EvaluationStage:
    """Named stage computing statistics for one [L, 3] structure."""

    name: str
    fn: Callable[[np.ndarray], Dict[str, float]]

    def __call__(self, coords: np.ndarray) -> Dict[str, float]:
        return self.fn(coords)


def sanity_check(coords: np.ndarray,
                 canvas_size: float = 21.0) -> Dict[str, float]:
    """NaN / canvas checks (reference :320-337: has_nan, exceeds_canvas
    with |pos| > canvas_size=21), plus a degenerate-collapse flag."""
    finite = bool(np.isfinite(coords).all())
    spread = float(np.std(coords)) if finite else 0.0
    exceeds = bool(finite and (np.abs(coords) > canvas_size).any())
    return {"finite": float(finite),
            "has_nan": float(not finite),
            "exceeds_canvas": float(exceeds),
            "degenerate": float(finite and spread < 1e-3)}


def ca_distances(coords: np.ndarray) -> Dict[str, float]:
    """Consecutive C-alpha distances; key names match the reference's
    `ca_distance_<stat>` / `n_ca_atoms` CSV columns (:225-246)."""
    d = np.linalg.norm(np.diff(coords, axis=0), axis=-1)
    return {"n_ca_atoms": float(len(coords)),
            "ca_distance_mean": float(d.mean()),
            "ca_distance_std": float(d.std()),
            "ca_distance_median": float(np.median(d)),
            "ca_distance_min": float(d.min()),
            "ca_distance_max": float(d.max()),
            # fraction within 15% of the ideal 3.8 A pseudo-bond
            "ca_distance_valid_frac": float(
                np.mean(np.abs(d - 3.8) < 0.15 * 3.8))}


def ca_angles(coords: np.ndarray) -> Dict[str, float]:
    v1 = coords[1:-1] - coords[:-2]
    v2 = coords[2:] - coords[1:-1]
    cos = np.sum(v1 * v2, -1) / (np.linalg.norm(v1, axis=-1)
                                 * np.linalg.norm(v2, axis=-1) + 1e-9)
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    out = {"ca_angle_mean": float(ang.mean()),
           "ca_angle_std": float(ang.std()),
           "ca_angle_median": float(np.median(ang))}
    if len(coords) >= 4:
        b1, b2, b3 = (coords[1:-2] - coords[:-3], coords[2:-1]
                      - coords[1:-2], coords[3:] - coords[2:-1])
        n1 = np.cross(b1, b2)
        n2 = np.cross(b2, b3)
        m1 = np.cross(n1, b2 / (np.linalg.norm(b2, axis=-1, keepdims=True)
                                + 1e-9))
        x = np.sum(n1 * n2, -1)
        y = np.sum(m1 * n2, -1)
        dih = np.degrees(np.arctan2(y, x))
        out["ca_dihedral_abs_mean"] = float(np.abs(dih).mean())
    return out


def radius_of_gyration(coords: np.ndarray) -> Dict[str, float]:
    centered = coords - coords.mean(0, keepdims=True)
    return {"radius_of_gyration": float(
        np.sqrt(np.mean(np.sum(centered**2, -1))))}


def hull_volume(coords: np.ndarray) -> Dict[str, float]:
    """Convex-hull volume + sphericity statistics (reference :368-407:
    sphere_volume from the mean centroid distance, shpericality [sic] =
    hull/sphere volume ratio, frac_of_bounding_sphere from the max
    distance). The reference's misspelled key is kept for CSV parity."""
    out = {"hull_volume": float("nan"), "hull_area": float("nan"),
           "sphere_volume": float("nan"), "shpericality": float("nan"),
           "frac_of_bounding_sphere": float("nan")}
    try:
        from scipy.spatial import ConvexHull
        hull = ConvexHull(coords)
        dist = np.linalg.norm(coords - coords.mean(0, keepdims=True),
                              axis=-1)
        sphere = (4.0 / 3.0) * np.pi * float(np.mean(dist)) ** 3
        bounding = (4.0 / 3.0) * np.pi * float(np.max(dist)) ** 3
        out.update(hull_volume=float(hull.volume),
                   hull_area=float(hull.area),
                   sphere_volume=sphere,
                   shpericality=float(hull.volume) / max(sphere, 1e-12),
                   frac_of_bounding_sphere=float(hull.volume)
                   / max(bounding, 1e-12))
    except Exception:
        pass
    return out


# P-SEA geometric windows (Labesse et al. 1997), the algorithm behind
# biotite's annotate_sse that the reference's BackboneCASSEEvaluator calls
# (evaluation_pipeline.py:290-319). All thresholds in Angstrom / degrees.
_HELIX_D3 = (4.8, 5.6)
_HELIX_D4 = (4.9, 7.0)
_HELIX_TAU = (89.0, 115.0)
_HELIX_ALPHA = (43.0, 78.0)
_STRAND_D2 = (6.4, 7.4)
_STRAND_D3 = (9.9, 11.3)
_STRAND_D4 = (12.3, 14.6)
_STRAND_TAU = (120.0, 145.0)


def _in(x: np.ndarray, lo_hi) -> np.ndarray:
    lo, hi = lo_hi
    return (x >= lo) & (x <= hi)


def _mark_runs(cand: np.ndarray, min_len: int) -> np.ndarray:
    """True where `cand` holds over a run of at least `min_len`."""
    out = np.zeros(len(cand), bool)
    i = 0
    while i < len(cand):
        if cand[i]:
            j = i
            while j < len(cand) and cand[j]:
                j += 1
            if j - i >= min_len:
                out[i:j] = True
            i = j
        else:
            i += 1
    return out


def secondary_structure(coords: np.ndarray) -> np.ndarray:
    """P-SEA-style SSE from C-alpha geometry: 'a' helix / 'b' strand / 'c' coil.

    Dependency-free stand-in for biotite's `annotate_sse` (same algorithm
    family and thresholds; the reference calls biotite at
    evaluation_pipeline.py:305-319). Feature window for residue i starts at
    i-1: d2=|CA(i-1)-CA(i+1)|, d3=|CA(i-1)-CA(i+2)|, d4=|CA(i-1)-CA(i+3)|,
    tau=angle(i-1,i,i+1), alpha=dihedral(i-1,i,i+1,i+2). Candidates become
    assignments over minimum run lengths (5 for helix, 3 for strand).
    """
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    sse = np.full(n, "c", dtype="<U1")
    if n < 5:
        return sse

    d = np.full((3, n), np.nan)  # d2, d3, d4
    for k, span in enumerate((2, 3, 4)):
        v = np.linalg.norm(coords[span:] - coords[:-span], axis=-1)
        d[k, 1:n - span + 1] = v
    tau = np.full(n, np.nan)
    v1 = coords[:-2] - coords[1:-1]
    v2 = coords[2:] - coords[1:-1]
    cos = (np.sum(v1 * v2, -1)
           / (np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1)
              + 1e-9))
    tau[1:n - 1] = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    alpha = np.full(n, np.nan)
    if n >= 4:
        b1 = coords[1:-2] - coords[:-3]
        b2 = coords[2:-1] - coords[1:-2]
        b3 = coords[3:] - coords[2:-1]
        n1 = np.cross(b1, b2)
        n2 = np.cross(b2, b3)
        m1 = np.cross(n1, b2 / (np.linalg.norm(b2, axis=-1, keepdims=True)
                                + 1e-9))
        alpha[1:n - 2] = np.degrees(np.arctan2(np.sum(m1 * n2, -1),
                                               np.sum(n1 * n2, -1)))

    with np.errstate(invalid="ignore"):
        helix_cand = ((_in(d[1], _HELIX_D3) & _in(d[2], _HELIX_D4))
                      | (_in(tau, _HELIX_TAU) & _in(alpha, _HELIX_ALPHA)))
        strand_cand = ((_in(d[0], _STRAND_D2) & _in(d[1], _STRAND_D3)
                        & _in(d[2], _STRAND_D4))
                       | (_in(tau, _STRAND_TAU)
                          & ((alpha <= -125.0) | (alpha >= 145.0))))
    helix = _mark_runs(np.nan_to_num(helix_cand).astype(bool), 5)
    strand = _mark_runs(np.nan_to_num(strand_cand).astype(bool), 3)
    sse[strand] = "b"
    sse[helix] = "a"  # helix wins ties, as in P-SEA
    return sse


def sse_proportions(coords: np.ndarray) -> Dict[str, float]:
    """helix/sheet/coil fractions — the reference's headline SSE statistics
    (evaluation_pipeline.py:305-319 keys)."""
    sse = secondary_structure(coords)
    n = max(len(sse), 1)
    return {"helix_proportion": float(np.sum(sse == "a") / n),
            "sheet_proportion": float(np.sum(sse == "b") / n),
            "coil_proportion": float(np.sum(sse == "c") / n)}


@dataclass
class _NoveltyFn:
    """Module-level callable (not a closure) so novelty stages pickle into
    process workers."""

    train: Dict[str, np.ndarray]

    def __call__(self, coords: np.ndarray) -> Dict[str, float]:
        from tpu_diffusion_torch.protein.novelty import (
            find_closest_structure)
        out = find_closest_structure(coords, self.train)
        return {"novelty_rmsd": out["rmsd"],
                "novelty_tm_score": out["tm_score"],
                "novelty_gdt_score": out["gdt_score"]}


def make_novelty_stage(train: Dict[str, np.ndarray]) -> EvaluationStage:
    return EvaluationStage("novelty", _NoveltyFn(train))


DEFAULT_STAGES = [
    EvaluationStage("sanity", sanity_check),
    EvaluationStage("ca_dist", ca_distances),
    EvaluationStage("ca_angle", ca_angles),
    EvaluationStage("sse", sse_proportions),
    EvaluationStage("rg", radius_of_gyration),
    EvaluationStage("hull", hull_volume),
]


@dataclass
class EvaluationPipeline:
    """eval_single / eval_many / eval_dir (reference :86-175)."""

    stages: Sequence[EvaluationStage] = field(
        default_factory=lambda: list(DEFAULT_STAGES))

    def eval_single(self, coords: np.ndarray,
                    sample_id: str = "") -> Dict[str, float]:
        row: Dict[str, float] = {"id": sample_id,
                                 "length": int(len(coords))}
        for stage in self.stages:
            try:
                row.update(stage(coords))
            except Exception as e:  # a failing stage must not kill the run
                row[f"{stage.name}_error"] = str(e)
        return row

    def eval_many(self, structures: Dict[str, np.ndarray],
                  n_jobs: Optional[int] = None,
                  backend: str = "auto") -> List[Dict]:
        """Evaluate many structures, optionally in parallel.

        `backend="process"` matches the reference's joblib *process* pool
        (evaluation_pipeline.py:104-130): the numpy-heavy angle/SSE stages
        hold the GIL for long stretches, so threads cannot scale them on
        multi-core eval hosts (measured in scripts/eval_many_bench.py).
        All default stages and the novelty stage are picklable; a stage
        that fails to pickle falls back to the thread pool with a note.
        `backend="thread"` forces the thread pool; `"auto"` picks
        processes on multi-core hosts and threads on a single core (where
        spawned workers are pure interpreter-startup overhead).
        """
        items = list(structures.items())
        if n_jobs in (None, 1) or len(items) <= 1:
            return [self.eval_single(c, sid) for sid, c in items]
        workers = os.cpu_count() if n_jobs < 0 else n_jobs
        if backend == "auto":
            backend = "process" if (os.cpu_count() or 1) > 1 else "thread"
        if backend == "process":
            # Unpicklable custom stages are detected UP FRONT (not via a
            # blanket except around the map, which would misattribute a
            # genuine worker failure, discard completed work, and silently
            # redo the whole evaluation on threads). Per-structure stage
            # errors never propagate here — eval_single records them in
            # the row — so only pool-level failures remain.
            import pickle
            try:
                pickle.dumps(self.stages)
            except Exception as e:
                import logging
                logging.getLogger(__name__).warning(
                    "stages not picklable (%s); using threads", e)
                backend = "thread"
        if backend == "process":
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool
            try:
                # spawn, not fork: the parent may hold a CUDA context and
                # live threads (forking those can deadlock); workers only
                # need numpy.
                with ProcessPoolExecutor(
                        max_workers=workers,
                        mp_context=multiprocessing.get_context(
                            "spawn")) as pool:
                    return list(pool.map(
                        _eval_one,
                        [(self.stages, sid, c) for sid, c in items],
                        chunksize=max(1, len(items) // (4 * workers))))
            except BrokenProcessPool as e:  # worker hard-crash (OOM, ...)
                import logging
                logging.getLogger(__name__).warning(
                    "process pool broke (%s); falling back to threads", e)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(
                lambda sc: self.eval_single(sc[1], sc[0]), items))

    def eval_dir(self, sample_dir: str, out_csv: Optional[str] = None,
                 n_jobs: Optional[int] = None) -> List[Dict]:
        structures = load_structures(sample_dir)
        rows = self.eval_many(structures, n_jobs=n_jobs)
        if out_csv is None:
            out_csv = os.path.join(sample_dir, "sample_stats.csv")
        _write_csv(rows, out_csv)
        return rows

    def eval_training_set(self, train: Dict[str, np.ndarray],
                          cache_csv: str,
                          n_jobs: Optional[int] = None) -> List[Dict]:
        """Training-set statistics with CSV caching (reference :633-694:
        `<dataset>_stats.csv` is computed once and reloaded thereafter).
        Structures are COM-centered before evaluation, as the reference's
        `_load_npz_to_data` does."""
        if os.path.exists(cache_csv):
            return _read_csv(cache_csv)
        centered = {k: v - v.mean(0, keepdims=True)
                    for k, v in train.items()}
        rows = self.eval_many(centered, n_jobs=n_jobs)
        _write_csv(rows, cache_csv)
        return rows


def _eval_one(args) -> Dict[str, float]:
    """Process-pool worker: (stages, sample_id, coords) -> stats row."""
    stages, sample_id, coords = args
    return EvaluationPipeline(stages).eval_single(coords, sample_id)


def load_structures(sample_dir: str) -> Dict[str, np.ndarray]:
    """sample*.npy files -> {id: [L, 3]} in sorted order (the reference
    loads sample*.pt the same way, evaluation_pipeline.py:132-151)."""
    structures = {}
    for f in sorted(os.listdir(sample_dir)):
        if f.endswith(".npy") and f.startswith("sample"):
            structures[f[:-4]] = np.load(os.path.join(sample_dir, f))
    return structures


def _write_csv(rows: List[Dict], path: str):
    import csv
    if not rows:
        return
    cols: List[str] = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, restval="")
        w.writeheader()
        w.writerows(rows)


def _read_csv(path: str) -> List[Dict]:
    import csv
    rows: List[Dict] = []
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            row: Dict = {}
            for k, v in r.items():
                try:
                    row[k] = float(v)
                except (TypeError, ValueError):
                    row[k] = v
            rows.append(row)
    return rows


def _numeric_column(rows: List[Dict], k: str) -> np.ndarray:
    return np.asarray([r[k] for r in rows
                       if isinstance(r.get(k), (int, float))
                       and np.isfinite(r[k])])


def summarize(rows: List[Dict]) -> Dict[str, float]:
    """Mean/std/median of every numeric column (the plot pipeline's input)."""
    out = {}
    if not rows:
        return out
    for k in rows[0]:
        vals = _numeric_column(rows, k)
        if len(vals):
            out[f"{k}_mean"] = float(np.mean(vals))
            out[f"{k}_std"] = float(np.std(vals))
            out[f"{k}_median"] = float(np.median(vals))
    return out


def compare_to_training(sample_rows: List[Dict],
                        train_rows: List[Dict]) -> Dict[str, float]:
    """Distribution distances between sample and training statistics.

    The reference's plot pipeline overlays sample vs training histograms
    per statistic (evaluation_pipeline.py:697-732 feeding run_plot_pipeline);
    this reduces each overlay to a scalar 1-Wasserstein distance (computed
    from sorted empirical quantiles — no scipy needed) for results.json.
    """
    out: Dict[str, float] = {}
    if not sample_rows or not train_rows:
        return out
    for k in sample_rows[0]:
        a = _numeric_column(sample_rows, k)
        b = _numeric_column(train_rows, k)
        if len(a) < 2 or len(b) < 2:
            continue
        q = np.linspace(0.0, 1.0, 101)
        qa = np.quantile(a, q)
        qb = np.quantile(b, q)
        out[f"{k}_w1_vs_train"] = float(np.mean(np.abs(qa - qb)))
    return out


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--sample_dir", required=True)
    p.add_argument("--train_root", default="data/scope",
                   help="training set for the novelty + comparison stages")
    p.add_argument("--novelty", action="store_true")
    p.add_argument("--compare_train", action="store_true",
                   help="evaluate the training set too (cached to "
                        "<train_root>_stats.csv) and report per-statistic "
                        "Wasserstein distances (reference :633-732)")
    p.add_argument("--max_train", type=int, default=200)
    p.add_argument("--n_jobs", type=int, default=None,
                   help="parallel sample evaluation (-1 = all cores)")
    p.add_argument("--self_consistency", action="store_true",
                   help="ProteinMPNN design/scoring + ColabFold refolding "
                        "(reference :695-726); each tool is used only if "
                        "available, the rest of the stage still runs")
    p.add_argument("--n_seq", type=int, default=3,
                   help="designed sequences scored per sample (:703)")
    p.add_argument("--colabfold", default="colabfold_batch",
                   help="refolding executable (:711)")
    p.add_argument("--device", default="cuda",
                   help="where --self_consistency runs the ProteinMPNN: cuda "
                        "(default) or cpu")
    args = p.parse_args(argv)

    stages = list(DEFAULT_STAGES)
    train = None
    if args.novelty or args.compare_train:
        from tpu_diffusion_torch.protein.data import get_protein_data
        ds = get_protein_data(args.train_root)
        train = {f"train_{i}":
                 ds.positions[i][:ds.lengths[i]] / (1.0 / 15.0)
                 for i in range(min(len(ds), args.max_train))}
    if args.novelty:
        stages.append(make_novelty_stage(train))

    pipeline = EvaluationPipeline(stages)
    rows = pipeline.eval_dir(args.sample_dir, n_jobs=args.n_jobs)
    if args.self_consistency:
        from tpu_diffusion_torch.protein.self_consistency import (
            load_proteinmpnn_scorer, self_consistency_eval)
        sc_rows = self_consistency_eval(
            load_structures(args.sample_dir), args.sample_dir,
            scorer=load_proteinmpnn_scorer(device=args.device),
            n_seq=args.n_seq, colabfold_executable=args.colabfold)
        for row, sc in zip(rows, sc_rows):
            row.update(sc)
        _write_csv(rows, os.path.join(args.sample_dir, "sample_stats.csv"))
    summary = summarize(rows)
    if args.compare_train:
        cache = args.train_root.rstrip("/").rstrip(os.sep) + "_stats.csv"
        train_rows = EvaluationPipeline(list(DEFAULT_STAGES)) \
            .eval_training_set(train, cache, n_jobs=args.n_jobs)
        summary.update(compare_to_training(rows, train_rows))
    with open(os.path.join(args.sample_dir, "summary_stats.json"),
              "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
