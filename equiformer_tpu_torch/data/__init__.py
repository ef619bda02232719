from .loader import GraphLoader
from .md17 import load_md17, train_val_test_split
from .synthetic import md17_like_dataset, qm9_like_dataset, random_molecule
