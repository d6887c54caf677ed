#!/usr/bin/env python
"""Write the two real offline datasets, karate and digits, in the
reference's 4-file text format plus split masks, through the port's
writers (counterpart of tools/make_real_datasets.py: the same graphs, the
same files byte for byte in the same environment).

  karate — Zachary's karate club (networkx.karate_club_graph): 34 nodes,
      156 directed edges, 2 classes (the club each member joined), one-hot
      node identity as features.
  digits — sklearn.datasets.load_digits: 1,797 8x8 images (64 features
      scaled to [0, 1]), 10 classes; a symmetrised 8-nearest-neighbour
      graph in feature space with self-loops. Its ties resolve differently
      across sklearn versions, so the edge list depends on the installed
      sklearn (the committed data/digits came from one such version).

Both get deterministic train/val/test masks (data/splits.random_splits,
seed 0). A host-side tool that needs networkx and sklearn (the chip
machine has neither). It refuses to overwrite an existing dataset
directory unless --force is given: the default --out data holds the
committed datasets.

Usage: python tools/torch_make_real_datasets.py --out DIR [--force]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from gatv2_tpu_torch.data.graph import Graph, edges_to_csr  # noqa: E402
from gatv2_tpu_torch.data.io import save_dataset  # noqa: E402
from gatv2_tpu_torch.data.splits import (  # noqa: E402
    random_splits,
    save_split_files,
)


def _import(module: str):
    try:
        return __import__(module, fromlist=["_"])
    except ImportError as e:
        raise ImportError(
            f"tools/torch_make_real_datasets.py needs {module.split('.')[0]} "
            f"(a host-side tool: run it where networkx and scikit-learn are "
            f"installed): {e}") from e


def _csr_from_edges(src, dst, n):
    """Deduplicated dst-CSR (data/graph.edges_to_csr)."""
    row_ptr, col_idx = edges_to_csr(src, dst, n, dedup=True)
    return row_ptr.astype(np.int32), col_idx.astype(np.int32)


def make_karate() -> Graph:
    nx = _import("networkx")
    g = nx.karate_club_graph()
    n = g.number_of_nodes()
    labels = np.array(
        [0 if g.nodes[i]["club"] == "Mr. Hi" else 1 for i in range(n)],
        np.int32)
    und = np.array(g.edges(), np.int64)
    src = np.concatenate([und[:, 0], und[:, 1]])
    dst = np.concatenate([und[:, 1], und[:, 0]])
    row_ptr, col_idx = _csr_from_edges(src, dst, n)
    return Graph(features=np.eye(n, dtype=np.float32), row_ptr=row_ptr,
                 col_idx=col_idx, labels=labels)


def make_digits(k: int = 8) -> Graph:
    datasets = _import("sklearn.datasets")
    neighbors = _import("sklearn.neighbors")
    ds = datasets.load_digits()
    x = (ds.data / 16.0).astype(np.float32)  # pixel counts 0..16 -> [0, 1]
    labels = ds.target.astype(np.int32)
    n = x.shape[0]
    knn = neighbors.kneighbors_graph(x, k, mode="connectivity",
                                     include_self=False).tocoo()
    # symmetrise (i->j implies j->i) and add self-loops
    src = np.concatenate([knn.row, knn.col, np.arange(n)])
    dst = np.concatenate([knn.col, knn.row, np.arange(n)])
    row_ptr, col_idx = _csr_from_edges(src.astype(np.int64),
                                       dst.astype(np.int64), n)
    return Graph(features=x, row_ptr=row_ptr, col_idx=col_idx, labels=labels)


DATASETS = (
    ("karate", make_karate, (0.4, 0.2, 0.4)),
    ("digits", make_digits, (0.6, 0.2, 0.2)),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data")
    ap.add_argument("--force", action="store_true",
                    help="overwrite dataset directories that exist")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)

    there = [str(out / name) for name, _, _ in DATASETS
             if (out / name).exists()]
    if there and not args.force:
        print(f"refusing to overwrite {', '.join(there)} (pass --force, or "
              f"another --out)", file=sys.stderr)
        return 2
    for name, make, fractions in DATASETS:
        g = make()
        d = out / name
        save_dataset(g, d)
        splits = random_splits(g.num_nodes, fractions, seed=0)
        save_split_files(splits, d)
        print(f"{name}: N={g.num_nodes} E={g.num_edges} F={g.feature_dim} "
              f"C={g.num_classes} splits={splits.counts} -> {d}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
