"""Synthetic molecular graphs with QM9-like statistics (numpy only).

Same generator and draw order as ``equiformer_tpu.data.synthetic``, so a seed
gives the same molecules in both packages: atoms placed by a short random
walk with ~1.5 A steps, which gives radius-5 graphs with an average degree
close to QM9's 15.6.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def random_molecule(
    rng: np.random.Generator, num_atoms: int, num_species: int = 5, step: float = 1.5
) -> Dict[str, np.ndarray]:
    steps = rng.normal(size=(num_atoms, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    pos = np.cumsum(steps * step, axis=0)
    pos += rng.normal(scale=0.1, size=pos.shape)
    return {
        "pos": pos.astype(np.float32),
        "species": rng.integers(0, num_species, size=num_atoms),
        "y": np.float32(rng.normal()),
    }


def qm9_like_dataset(
    n: int, seed: int = 0, min_atoms: int = 8, max_atoms: int = 29
) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [
        random_molecule(rng, int(rng.integers(min_atoms, max_atoms + 1)))
        for _ in range(n)
    ]
