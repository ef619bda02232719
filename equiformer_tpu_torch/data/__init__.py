from .loader import GraphLoader, prefetch
from .md17 import load_md17, train_val_test_split
from .stats import compute_stats
from .synthetic import md17_like_dataset, qm9_like_dataset, random_molecule
