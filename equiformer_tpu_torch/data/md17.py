"""MD17 molecular-dynamics datasets (numpy only).

Counterpart of ``equiformer_tpu.data.md17``: reads ``md17_<molecule>.npz``
(keys z / R / E / F) and makes the torchmd-net style split (950 / 50 / rest
from a seeded permutation), cached beside the data as ``splits_*.npz``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

MOLECULES = (
    "aspirin", "benzene", "ethanol", "malonaldehyde",
    "naphthalene", "salicylic", "toluene", "uracil",
)

_FILE_NAMES = {
    "aspirin": "md17_aspirin.npz",
    "benzene": "md17_benzene2017.npz",
    "ethanol": "md17_ethanol.npz",
    "malonaldehyde": "md17_malonaldehyde.npz",
    "naphthalene": "md17_naphthalene.npz",
    "salicylic": "md17_salicylic.npz",
    "toluene": "md17_toluene.npz",
    "uracil": "md17_uracil.npz",
}


def train_val_test_split(n: int, n_train: int, n_val: int, seed: int):
    """(train, valid, test) indices from ``default_rng(seed).permutation(n)``."""
    perm = np.random.default_rng(seed).permutation(n)
    return perm[:n_train], perm[n_train : n_train + n_val], perm[n_train + n_val :]


def load_md17(root: str, molecule: str = "aspirin", split: str = "train", n_train: int = 950,
              n_val: int = 50, seed: int = 1) -> Tuple[List[Dict], float, float]:
    """(graphs, energy_mean, energy_std), the statistics over the train
    split.  Graph dicts: pos, species (raw atomic numbers: the MD17 models
    take 64 atom types), y (energy) and forces.  The file is looked up under
    ``root/raw`` and then ``root``."""
    fname = _FILE_NAMES.get(molecule, f"md17_{molecule}.npz")
    path = os.path.join(root, "raw", fname)
    if not os.path.exists(path):
        path = os.path.join(root, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(f"MD17 file {fname} not found under {root}")
    data = np.load(path)
    z = data["z"].astype(np.int64)
    R = data["R"].astype(np.float32)
    E = data["E"].reshape(-1).astype(np.float64)
    F = data["F"].astype(np.float32)

    split_file = os.path.join(root, f"splits_{molecule}_{n_train}_{n_val}_{seed}.npz")
    if os.path.exists(split_file):
        s = np.load(split_file)
        idx = {"train": s["idx_train"], "valid": s["idx_valid"], "test": s["idx_test"]}
    else:
        tr, va, te = train_val_test_split(len(R), n_train, n_val, seed)
        idx = {"train": tr, "valid": va, "test": te}
        try:
            np.savez(split_file, idx_train=tr, idx_valid=va, idx_test=te)
        except OSError:
            pass  # a read-only data directory: the split is recomputed next time

    train_E = E[idx["train"]]
    graphs = [{"pos": R[i], "species": z, "y": np.float32(E[i]), "forces": F[i]}
              for i in idx[split]]
    return graphs, float(train_E.mean()), float(train_E.std())
