from .loader import GraphLoader
from .synthetic import qm9_like_dataset, random_molecule
