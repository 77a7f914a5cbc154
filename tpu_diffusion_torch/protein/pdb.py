"""PDB file utilities (dependency-free).

The port's own copy of `tpu_diffusion/protein/pdb.py` (numpy only; the
port imports nothing of the JAX package).

Rebuilds the local-file parts of `amortised diffusion/src/utils/
{biotite_utils,pdb_clean,pdb_utils,pypdb_utils}.py` without biotite /
biopython / openmm: fixed-column PDB parsing, C-alpha trace
+ sequence extraction, simple structure cleaning (altloc/insertion/HETATM
filtering, chain selection), and PDB writing for generated backbones.
Network-dependent functions of the reference (RCSB fetch, PDBFlex API,
obsolete-ID remap) are gated: the package downloads nothing, so they
raise with a clear message unless given local files.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}
ONE_TO_THREE = {v: k for k, v in THREE_TO_ONE.items()}


@dataclass
class Atom:
    name: str
    res_name: str
    chain: str
    res_seq: int
    icode: str
    altloc: str
    xyz: np.ndarray
    element: str
    hetero: bool


@dataclass
class Structure:
    atoms: List[Atom] = field(default_factory=list)

    def chains(self) -> List[str]:
        seen = []
        for a in self.atoms:
            if a.chain not in seen:
                seen.append(a.chain)
        return seen

    def select_chain(self, chain: str) -> "Structure":
        return Structure([a for a in self.atoms if a.chain == chain])

    def clean(self, keep_altloc: str = "A",
              drop_insertions: bool = True) -> "Structure":
        """pdb_clean.py-style filtering: drop HETATM, non-primary altlocs,
        and insertion-code residues."""
        out = []
        for a in self.atoms:
            if a.hetero:
                continue
            if a.altloc not in ("", " ", keep_altloc):
                continue
            if drop_insertions and a.icode.strip():
                continue
            out.append(a)
        return Structure(out)

    def ca_trace(self, chain: Optional[str] = None) -> np.ndarray:
        """[L, 3] C-alpha coordinates in residue order."""
        coords = []
        seen = set()
        for a in self.atoms:
            if a.name != "CA" or (chain and a.chain != chain):
                continue
            key = (a.chain, a.res_seq, a.icode)
            if key in seen:
                continue
            seen.add(key)
            coords.append(a.xyz)
        return np.asarray(coords, np.float32).reshape(-1, 3)

    def sequence(self, chain: Optional[str] = None) -> str:
        seq = []
        seen = set()
        for a in self.atoms:
            if a.name != "CA" or (chain and a.chain != chain):
                continue
            key = (a.chain, a.res_seq, a.icode)
            if key in seen:
                continue
            seen.add(key)
            seq.append(THREE_TO_ONE.get(a.res_name, "X"))
        return "".join(seq)


def parse_pdb(path: str) -> Structure:
    """Fixed-column PDB parser (ATOM/HETATM records)."""
    opener = gzip.open if path.endswith(".gz") else open
    atoms: List[Atom] = []
    with opener(path, "rt") as f:
        for line in f:
            rec = line[:6]
            if rec not in ("ATOM  ", "HETATM"):
                if rec == "ENDMDL":  # first model only
                    break
                continue
            atoms.append(Atom(
                name=line[12:16].strip(),
                altloc=line[16].strip(),
                res_name=line[17:20].strip(),
                chain=line[21].strip(),
                res_seq=int(line[22:26]),
                icode=line[26].strip(),
                xyz=np.array([float(line[30:38]), float(line[38:46]),
                              float(line[46:54])], np.float32),
                element=line[76:78].strip() if len(line) > 77 else "",
                hetero=rec == "HETATM",
            ))
    return Structure(atoms)


def write_ca_pdb(coords: np.ndarray, path: str, chain: str = "A",
                 res_name: str = "GLY"):
    """Write a C-alpha-only PDB for generated backbones (used by the
    evaluation/visualization flow; sample.py saves tensors in the
    reference, PDB output makes samples viewable in standard tools)."""
    with open(path, "w") as f:
        for i, (x, y, z) in enumerate(np.asarray(coords, float), start=1):
            f.write(f"ATOM  {i:5d}  CA  {res_name} {chain}{i:4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C\n")
        f.write("END\n")


def load_ca_from_pdb_dir(root: str, max_len: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
    """All C-alpha traces from .pdb(.gz) files under a directory."""
    out = {}
    if not os.path.isdir(root):
        return out
    for fn in sorted(os.listdir(root)):
        if not fn.endswith((".pdb", ".pdb.gz", ".ent", ".ent.gz")):
            continue
        trace = parse_pdb(os.path.join(root, fn)).clean().ca_trace()
        if max_len:
            trace = trace[:max_len]
        if len(trace):
            out[fn.split(".")[0]] = trace
    return out


def fetch_pdb(pdb_id: str, out_dir: str = "data/pdb") -> str:
    """RCSB fetch (pdb_utils.py / pypdb_utils.py): network-gated."""
    path = os.path.join(out_dir, f"{pdb_id.lower()}.pdb")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        f"fetch_pdb({pdb_id!r}): the package downloads nothing; "
        f"place the file at {path} manually")
