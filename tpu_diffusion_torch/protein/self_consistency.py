"""ProteinMPNN + ColabFold self-consistency evaluation stages.

The port's own copy of `tpu_diffusion/protein/self_consistency.py` (numpy
only; the scorer, `protein/mpnn.py`, is loaded lazily and runs on the
device it is given, `cuda` unless the caller asks for the CPU).

Rebuilds the reference's inverse-folding / refolding stage logic
(`amortised diffusion/src/evaluation/evaluation_pipeline.py`):

  * sequence design + NLL scoring with a CA-only ProteinMPNN
    (`calculate_proteinmpnn_scores` / `run_proteinmpnn_eval`, :453-513):
    per backbone, sample one designed sequence, then re-score it `n_seq`
    times with different seeds; score = exp(-NLL) over masked positions;
  * `protein_mpnn_seqs.csv` with `sample{i}_{j}` ids for ColabFold
    (`write_protein_mpnn_seqs_file`, :515-527);
  * the `colabfold_batch --templates --amber <csv> <out_dir>` subprocess
    (:705-712) and extraction of mean pLDDT / max PAE / pTM from the
    `*_scores_rank_001*.json` outputs (`process_af2_output`, :529-573);
  * the self-consistency geometry the reference documents but left
    unfinished (scTM / scRMSD between the sampled backbone and the AF2
    prediction, :545-551 docstring + commented block :556-567) — completed
    here with the native novelty kernel.

Neither external tool exists in this environment, so each sits behind an
explicit seam: `ProteinMPNNScorer` is a small protocol (a `sample` +
`log_probs` pair) — filled by the real CA-ProteinMPNN architecture in
`protein/mpnn.py` (random-init or converted public weights) or a test
stub — and the ColabFold runner takes the executable name so tests can
point it at a fake. Everything else (CSV plumbing, NLL math, JSON/PDB
parsing, scTM/scRMSD) is real code exercised by the test suite.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# The 20 canonical amino acids + X, ProteinMPNN's alphabet order.
ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"


def untokenise(tokens: np.ndarray) -> str:
    """Token ids -> one-letter sequence (reference `untokenise_sequence`)."""
    return "".join(ALPHABET[int(t) % len(ALPHABET)] for t in tokens)


def nll_score(tokens: np.ndarray, log_probs: np.ndarray,
              mask: Optional[np.ndarray] = None) -> float:
    """Mean negative log-likelihood of `tokens` under `log_probs`.

    `log_probs` is [L, |alphabet|] (log-softmax rows); `mask` selects the
    designable positions (1 = scored), as in the reference's `nll_score`
    over `inpt["mask"]` (evaluation_pipeline.py:476-477).
    """
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    lp = np.asarray(log_probs, np.float64)
    picked = lp[np.arange(len(tokens)), tokens]
    if mask is None:
        mask = np.ones(len(tokens))
    mask = np.asarray(mask, np.float64).reshape(-1)
    return float(-(picked * mask).sum() / max(mask.sum(), 1e-9))


class ProteinMPNNScorer:
    """Interface to a CA-only inverse-folding model.

    A real backend wraps the ProteinMPNN `ca_model_weights` checkpoint;
    tests use `StubScorer`. Methods:

      sample(coords, seed)     -> [L] int tokens (a designed sequence)
      log_probs(coords, tokens, seed) -> [L, 21] log-softmax rows
    """

    def sample(self, coords: np.ndarray, seed: int = 0,
               fixed_tokens: Optional[np.ndarray] = None,
               fixed_mask: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError

    def log_probs(self, coords: np.ndarray, tokens: np.ndarray,
                  seed: int = 0) -> np.ndarray:
        raise NotImplementedError


def load_proteinmpnn_scorer(weights_npz: Optional[str] = None,
                            allow_random_init: bool = False,
                            device="cuda") -> Optional[ProteinMPNNScorer]:
    """Load the CA ProteinMPNN scorer (reference
    `load_protein_mpnn_model(model_type="ca")`).

    The architecture is implemented in `protein/mpnn.py` and runs on
    `device`; what gates the stage is WEIGHTS, which the repository does
    not hold. Priority:

      1. `weights_npz` (or `$TPU_DIFFUSION_MPNN_WEIGHTS`): a converted
         public checkpoint, the same flat npz the JAX package reads
         (`mpnn.load_mpnn_scorer`) -> real scores;
      2. `allow_random_init=True`: the real architecture at random init —
         deterministic and structure-dependent but NOT the published
         model (self-consistent scores only, like eval/fid.py's
         random-feature FID);
      3. otherwise None -> the stage is skipped, as the reference does
         without the proteinmpnn package.
    """
    if weights_npz is None:
        weights_npz = os.environ.get("TPU_DIFFUSION_MPNN_WEIGHTS")
    if weights_npz:
        from tpu_diffusion_torch.protein.mpnn import load_mpnn_scorer
        return load_mpnn_scorer(npz_path=weights_npz, device=device)
    if allow_random_init:
        from tpu_diffusion_torch.protein.mpnn import load_mpnn_scorer
        return load_mpnn_scorer(device=device)
    return None


@dataclass
class StubScorer(ProteinMPNNScorer):
    """Deterministic geometry-dependent fake model for stage testing: logits
    are a fixed random projection of local backbone geometry, so scores are
    reproducible, structure-dependent, and in (0, 1] like the real thing."""

    seed: int = 0

    def _logits(self, coords: np.ndarray, seed: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1000003 + seed)
        d = np.linalg.norm(np.diff(coords, axis=0, prepend=coords[:1]),
                           axis=-1, keepdims=True)
        feats = np.concatenate([coords, d], -1)
        w = rng.normal(0, 0.5, (feats.shape[-1], len(ALPHABET)))
        logits = feats @ w
        # stabilized log-softmax: raw coordinates can push |logits| past
        # exp's overflow for long extended chains
        logits = logits - logits.max(-1, keepdims=True)
        return logits - np.log(np.sum(np.exp(logits), -1, keepdims=True))

    def sample(self, coords: np.ndarray, seed: int = 0,
               fixed_tokens: Optional[np.ndarray] = None,
               fixed_mask: Optional[np.ndarray] = None) -> np.ndarray:
        tokens = np.argmax(self._logits(coords, seed), -1)
        if fixed_mask is not None and fixed_tokens is not None:
            tokens = np.where(np.asarray(fixed_mask) > 0,
                              np.asarray(fixed_tokens), tokens)
        return tokens

    def log_probs(self, coords: np.ndarray, tokens: np.ndarray,
                  seed: int = 0) -> np.ndarray:
        del tokens
        return self._logits(coords, seed)


def proteinmpnn_scores(coords: np.ndarray, scorer: ProteinMPNNScorer,
                       n_seq: int = 8,
                       design_mask: Optional[np.ndarray] = None,
                       motif_inds: Optional[Sequence[int]] = None,
                       motif_res: Optional[str] = None
                       ) -> Tuple[np.ndarray, List[str]]:
    """Design + score one backbone (reference
    `calculate_proteinmpnn_scores`, :453-482): sample a sequence once, then
    re-score it under `n_seq` seeds; per-seed score = exp(-NLL) = the mean
    per-residue probability the model assigns its own design.

    With a motif (`motif_inds` positions, `motif_res` one-letter codes),
    those residues are FIXED to their native identities during design
    (reference `create_backbone` res_mask semantics, :434-449) but still
    INCLUDED in the NLL: the reference scores with `mask=inpt["mask"]`
    (:476), the BackboneSample VALIDITY mask — all residues — while
    res_mask only gates which positions are designable. `design_mask`
    therefore stays as passed (None = score every residue)."""
    fixed_tokens = fixed_mask = None
    if motif_inds:
        if motif_res is None or len(motif_res) != len(motif_inds):
            raise ValueError(
                f"motif_inds ({len(motif_inds)} positions) requires "
                f"motif_res of equal length, got "
                f"{None if motif_res is None else len(motif_res)}")
        fixed_tokens = np.zeros(len(coords), np.int32)
        fixed_mask = np.zeros(len(coords), np.float32)
        for idx, res in zip(motif_inds, motif_res):
            fixed_tokens[idx] = ALPHABET.index(res)
            fixed_mask[idx] = 1.0
    tokens = scorer.sample(coords, seed=0, fixed_tokens=fixed_tokens,
                           fixed_mask=fixed_mask)
    scores = np.zeros(n_seq)
    seqs: List[str] = []
    for i in range(n_seq):
        lp = scorer.log_probs(coords, tokens, seed=i)
        scores[i] = float(np.exp(-nll_score(tokens, lp, design_mask)))
        seqs.append(untokenise(tokens))
    return scores, seqs


def run_proteinmpnn_eval(structures: Dict[str, np.ndarray],
                         scorer: ProteinMPNNScorer, n_seq: int = 8,
                         motif_inds: Optional[Sequence[int]] = None,
                         motif_res: Optional[str] = None
                         ) -> Tuple[List[np.ndarray], List[List[str]]]:
    """Per-sample design scores + sequences (reference :484-513, incl.
    its motif_inds/motif_res pass-through)."""
    scores, seqs = [], []
    for _, coords in structures.items():
        s, q = proteinmpnn_scores(np.asarray(coords, np.float64), scorer,
                                  n_seq=n_seq, motif_inds=motif_inds,
                                  motif_res=motif_res)
        scores.append(s)
        seqs.append(q)
    return scores, seqs


def write_seqs_csv(seqs_by_sample: Sequence[Sequence[str]],
                   path: str) -> None:
    """`protein_mpnn_seqs.csv` with `sample{i}_{j}` ids — the exact format
    `colabfold_batch` consumes (reference :515-527)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "sequence"])
        for i, seqs in enumerate(seqs_by_sample):
            for j, seq in enumerate(seqs):
                w.writerow([f"sample{i}_{j}", seq])


def colabfold_available(executable: str = "colabfold_batch") -> bool:
    return shutil.which(executable) is not None


def run_colabfold(seqs_csv: str, out_dir: str,
                  executable: str = "colabfold_batch",
                  templates: bool = True, amber: bool = True) -> None:
    """The refolding subprocess (reference :705-712:
    `colabfold_batch --templates --amber <csv> <out_dir>`)."""
    if not colabfold_available(executable):
        raise FileNotFoundError(
            f"{executable!r} not on PATH — install ColabFold or pass the "
            f"stage a stub executable")
    os.makedirs(out_dir, exist_ok=True)
    cmd = [executable]
    if templates:
        cmd.append("--templates")
    if amber:
        cmd.append("--amber")
    cmd += [seqs_csv, out_dir]
    subprocess.run(cmd, check=True)


def _af2_ca_trace(pdb_path: str) -> np.ndarray:
    from tpu_diffusion_torch.protein.pdb import parse_pdb
    return parse_pdb(pdb_path).ca_trace()


def process_af2_output(af2_dir: str, structures: Dict[str, np.ndarray],
                       n_seq: int = 8) -> Dict[str, List]:
    """Extract pLDDT / max-PAE / pTM from ColabFold's rank-1 score JSONs and
    compute the self-consistency geometry vs the rank-1 predicted PDBs.

    Reference `process_af2_output` (:529-573) reads
    `sample{i}_{j}_scores_rank_001*.json` -> mean(plddt), max_pae, ptm; its
    docstring also specifies scTM (max TM score vs predictions) and scRMSD
    (min RMSD), which the reference never finished (:556-567 commented) —
    implemented here with the novelty kernel's Kabsch/TM routines.
    """
    from tpu_diffusion_torch.protein.novelty import (kabsch_alignment,
                                                     rmsd, tm_score)

    out: Dict[str, List] = {"plddt": [], "max_pae": [], "pTM": [],
                            "scTM": [], "scRMSD": []}
    for i, (_, coords) in enumerate(structures.items()):
        plddt_s, pae_s, ptm_s, tm_s, rmsd_s = [], [], [], [], []
        for j in range(n_seq + 1):
            for path in sorted(glob.glob(os.path.join(
                    af2_dir, f"sample{i}_{j}_scores_rank_001*.json"))):
                with open(path) as f:
                    data = json.load(f)
                plddt_s.append(float(np.mean(data["plddt"])))
                pae_s.append(float(data["max_pae"]))
                ptm_s.append(float(data["ptm"]))
                break  # rank-1 only, as in the reference
            for path in sorted(glob.glob(os.path.join(
                    af2_dir, f"sample{i}_{j}_*rank_001*.pdb"))):
                pred = _af2_ca_trace(path)
                if len(pred) == len(coords) and len(pred) >= 3:
                    aligned = kabsch_alignment(pred, coords)
                    tm_s.append(float(tm_score(aligned, coords)))
                    rmsd_s.append(float(rmsd(aligned, coords)))
                break
        out["plddt"].append(plddt_s)
        out["max_pae"].append(pae_s)
        out["pTM"].append(ptm_s)
        # docstring spec (:545-551): scTM = max TM, scRMSD = min RMSD
        out["scTM"].append(max(tm_s) if tm_s else float("nan"))
        out["scRMSD"].append(min(rmsd_s) if rmsd_s else float("nan"))
    return out


def self_consistency_eval(structures: Dict[str, np.ndarray],
                          sample_dir: str,
                          scorer: Optional[ProteinMPNNScorer] = None,
                          n_seq: int = 3,
                          colabfold_executable: str = "colabfold_batch",
                          run_fold: Optional[bool] = None,
                          motif_inds: Optional[Sequence[int]] = None,
                          motif_res: Optional[str] = None
                          ) -> List[Dict[str, object]]:
    """Full self-consistency stage over evaluated structures: design ->
    score -> (optionally) refold -> extract, returning one row per sample
    to merge into `sample_stats.csv` (reference main :695-726: columns
    protein_mpnn_scores/protein_mpnn_seqs/plddt/max_pae/pTM).

    Skips cleanly: with no scorer and no ColabFold on PATH the result is an
    empty-column row list (the geometric pipeline is unaffected).
    """
    rows: List[Dict[str, object]] = [{} for _ in structures]
    if scorer is None:
        scorer = load_proteinmpnn_scorer()
    if scorer is None:
        return rows
    scores, seqs = run_proteinmpnn_eval(structures, scorer, n_seq=n_seq,
                                        motif_inds=motif_inds,
                                        motif_res=motif_res)
    for row, s, q in zip(rows, scores, seqs):
        row["protein_mpnn_scores"] = s.tolist()
        row["protein_mpnn_seqs"] = q
    seqs_csv = os.path.join(sample_dir, "protein_mpnn_seqs.csv")
    write_seqs_csv(seqs, seqs_csv)

    if run_fold is None:
        run_fold = colabfold_available(colabfold_executable)
    if not run_fold:
        return rows
    af2_dir = os.path.join(sample_dir, "af2_output")
    run_colabfold(seqs_csv, af2_dir, executable=colabfold_executable)
    af2 = process_af2_output(af2_dir, structures, n_seq=n_seq)
    for i, row in enumerate(rows):
        row["plddt"] = af2["plddt"][i]
        row["max_pae"] = af2["max_pae"][i]
        row["pTM"] = af2["pTM"][i]
        row["scTM"] = af2["scTM"][i]
        row["scRMSD"] = af2["scRMSD"][i]
    return rows
