"""Dataset statistics: average nodes, edges and degree of the radius graph.

Counterpart of ``equiformer_tpu.cli.compute_stats``; the native
``radius_stats`` when no ``--max-neighbors`` is given, else numpy's
``compute_stats``.  OC20 is not ported.

  python -m equiformer_tpu_torch.cli.compute_stats --dataset qm9 --radius 5
  python -m equiformer_tpu_torch.cli.compute_stats --synthetic --radius 5
"""

from __future__ import annotations

import argparse
import json

from .. import native
from ..data import compute_stats, md17_like_dataset, qm9_like_dataset


def get_args(argv=None):
    p = argparse.ArgumentParser("dataset statistics")
    p.add_argument("--dataset", choices=["qm9", "md17", "oc20"], default="qm9")
    p.add_argument("--data-path", type=str, default="datasets")
    p.add_argument("--molecule", type=str, default="aspirin")
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--max-neighbors", type=int, default=None)
    p.add_argument("--limit", type=int, default=2000)
    p.add_argument("--synthetic", action="store_true")
    return p.parse_args(argv)


def main(args=None):
    """Prints and returns the statistics (rounded to 6 digits)."""
    args = args if args is not None else get_args()
    if args.dataset == "oc20":
        raise NotImplementedError("OC20 (M11) is not ported")
    if args.synthetic:
        graphs = (qm9_like_dataset if args.dataset == "qm9" else md17_like_dataset)(args.limit)
    elif args.dataset == "qm9":
        from ..data.qm9 import load_qm9

        graphs = load_qm9(args.data_path, "train")[0][: args.limit]
    else:
        from ..data.md17 import load_md17

        graphs = load_md17(args.data_path, args.molecule, "train")[0][: args.limit]

    if native.HAVE_NATIVE and args.max_neighbors is None:
        stats = native.GraphArena(graphs).radius_stats(args.radius)
        stats.pop("edges_per_graph")
    else:
        stats = compute_stats(graphs, args.radius, args.max_neighbors)
    out = {k: round(float(v), 6) for k, v in stats.items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
