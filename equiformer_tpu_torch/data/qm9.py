"""QM9 from its raw files (numpy only).

Counterpart of ``equiformer_tpu.data.qm9``: parses the gdb9 SDF, the targets
CSV and ``uncharacterized.txt`` under ``root/raw``, rotates the CSV's
columns (A, B, C to the end), converts units, subtracts the atomrefs and
makes the torchmd-net split (110k / 10k / rest of ``default_rng(1)``'s
permutation).  The parsed molecules are cached as
``root/processed_tpu/qm9.npz`` in the JAX package's format (pos, species,
counts, y), so either package reads the other's cache.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Tuple

import numpy as np

HAR2EV = 27.211386246
KCALMOL2EV = 0.04336414

# unit conversion per target, after the column rotation
CONVERSION = np.array(
    [1.0, 1.0, HAR2EV, HAR2EV, HAR2EV, 1.0, HAR2EV, HAR2EV, HAR2EV, HAR2EV,
     HAR2EV, 1.0, KCALMOL2EV, KCALMOL2EV, KCALMOL2EV, KCALMOL2EV, 1.0, 1.0, 1.0]
)

TARGETS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U0", "U", "H",
           "G", "Cv", "U0_atom", "U_atom", "H_atom", "G_atom", "A", "B", "C"]

# per-type atom reference energies of targets 7-10 (U0, U, H, G)
ATOMREFS = {
    7: [-13.61312172, -1029.86312267, -1485.30251237, -2042.61123593, -2713.48485589],
    8: [-13.5745904, -1029.82456413, -1485.26398105, -2042.5727046, -2713.44632457],
    9: [-13.54887564, -1029.79887659, -1485.2382935, -2042.54701705, -2713.42063702],
    10: [-13.90303183, -1030.25891228, -1485.71166277, -2043.01812778, -2713.88796536],
}

SYMBOL_TO_TYPE = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}
# atomic number -> compact type id
Z_TO_TYPE = {1: 0, 6: 1, 7: 2, 8: 3, 9: 4}

N_TRAIN, N_VALID = 110000, 10000


def _atomref_matrix() -> np.ndarray:
    """[5 types, 19 targets] atomref table."""
    m = np.zeros((5, 19))
    for col, refs in ATOMREFS.items():
        m[:, col] = refs
    return m


def _parse_sdf(path: str):
    """Yield (symbols, positions) per molecule of a (gzipped) SDF file."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        text = f.read()
    for block in text.split("$$$$\n"):
        lines = block.split("\n")
        if len(lines) < 4:
            continue
        try:
            n_atoms = int(lines[3].split()[0])
        except (ValueError, IndexError):
            continue
        syms, pos = [], []
        for line in lines[4 : 4 + n_atoms]:
            parts = line.split()
            pos.append([float(parts[0]), float(parts[1]), float(parts[2])])
            syms.append(parts[3])
        yield syms, np.asarray(pos, np.float32)


def _parse_raw(root: str, cache: str):
    """(pos, species, counts, y) of every characterized molecule, written to
    ``cache``."""
    sdf = None
    for cand in ("gdb9.sdf", "gdb9.sdf.gz"):
        p = os.path.join(root, "raw", cand)
        if os.path.exists(p):
            sdf = p
            break
    if sdf is None:
        raise FileNotFoundError(
            f"QM9 raw data not found under {root}/raw "
            "(place gdb9.sdf + gdb9.sdf.csv + uncharacterized.txt there)"
        )
    with open(os.path.join(root, "raw", "gdb9.sdf.csv")) as f:
        rows = f.read().strip().split("\n")[1:]
    target_rows = np.array(
        [[float(x) for x in line.split(",")[1:20]] for line in rows], np.float64
    )
    target_rows = np.concatenate([target_rows[:, 3:], target_rows[:, :3]], axis=1)
    target_rows = target_rows * CONVERSION[None, :]

    with open(os.path.join(root, "raw", "uncharacterized.txt")) as f:
        skip = {int(x.split()[0]) - 1 for x in f.read().split("\n")[9:-2]}

    pos_list, species_list, counts_l, ys_l = [], [], [], []
    for i, (syms, pos) in enumerate(_parse_sdf(sdf)):
        if i in skip:
            continue
        pos_list.append(pos)
        species_list.append(np.array([SYMBOL_TO_TYPE[s] for s in syms], np.int32))
        counts_l.append(len(syms))
        ys_l.append(target_rows[i])
    all_pos = np.concatenate(pos_list, axis=0)
    all_species = np.concatenate(species_list, axis=0)
    counts = np.asarray(counts_l, np.int64)
    ys = np.asarray(ys_l, np.float64)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.savez(cache, pos=all_pos, species=all_species, counts=counts, y=ys)
    return all_pos, all_species, counts, ys


def load_qm9(root: str, split: str = "train", target: int = 1,
             subtract_atomref: bool = True) -> Tuple[List[Dict], float, float]:
    """(graphs, mean, std) of ``split`` ('train', 'valid' or 'test') for
    target index ``target``.  Graph dicts: 'pos', 'species' (compact type
    0..4) and 'y' (the converted target, atomref-subtracted by default);
    mean and std are taken over the train split."""
    cache = os.path.join(root, "processed_tpu", "qm9.npz")
    if os.path.exists(cache):
        data = np.load(cache, allow_pickle=False)
        all_pos, all_species = data["pos"], data["species"]
        counts, ys = data["counts"], data["y"]
    else:
        all_pos, all_species, counts, ys = _parse_raw(root, cache)

    perm = np.random.default_rng(1).permutation(len(counts))
    idx = {
        "train": perm[:N_TRAIN],
        "valid": perm[N_TRAIN : N_TRAIN + N_VALID],
        "test": perm[N_TRAIN + N_VALID :],
    }
    offsets = np.concatenate([[0], np.cumsum(counts)])
    atomref = _atomref_matrix()

    def build(indices):
        graphs = []
        for i in indices:
            s, e = offsets[i], offsets[i + 1]
            species = all_species[s:e]
            y = ys[i, target]
            if subtract_atomref:
                y = y - atomref[species, target].sum()
            graphs.append({"pos": all_pos[s:e], "species": species, "y": np.float32(y)})
        return graphs

    train_graphs = build(idx["train"])
    train_y = np.array([g["y"] for g in train_graphs], np.float64)
    mean, std = float(train_y.mean()), float(train_y.std())
    if split == "train":
        return train_graphs, mean, std
    return build(idx[split]), mean, std
