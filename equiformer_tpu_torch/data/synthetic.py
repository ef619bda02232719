"""Synthetic molecular graphs with QM9- and MD17-like statistics (numpy only).

Same generators and draw order as ``equiformer_tpu.data.synthetic``, so a
seed gives the same molecules in both packages: atoms placed by a short
random walk with ~1.5 A steps, which gives radius-5 graphs with an average
degree close to QM9's 15.6.
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


def md17_like_dataset(n: int, num_atoms: int = 21, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Frames of one fixed-topology molecule, like an MD17 trajectory (aspirin
    has 21 atoms): 0.05 A jitter of one random-walk geometry, random energy
    and force targets."""
    rng = np.random.default_rng(seed)
    base = random_molecule(rng, num_atoms, num_species=4)
    out = []
    for _ in range(n):
        g = dict(base)
        g["pos"] = base["pos"] + rng.normal(scale=0.05, size=base["pos"].shape).astype(
            np.float32)
        g["y"] = np.float32(rng.normal())
        g["forces"] = rng.normal(size=(num_atoms, 3)).astype(np.float32)
        out.append(g)
    return out
