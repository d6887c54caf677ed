#!/usr/bin/env python
"""Convert an OGB node-property-prediction dataset (ogbn-arxiv,
ogbn-products, ...) to the reference's 4-file text format (features.txt /
row_ptr.txt / col_idx.txt / labels.txt) plus the split mask files
(train_mask.txt / val_mask.txt / test_mask.txt), through the port's
writers (counterpart of tools/convert_ogb.py; the same files byte for
byte).

Two input modes (no network access at convert time):
  1. --ogb-root pointing at an existing OGB download (imports the `ogb`
     package, only in this mode);
  2. --raw-dir pointing at an OGB raw/ directory (edge.csv.gz,
     node-feat.csv.gz, node-label.csv.gz and
     split/<name>/{train,valid,test}.csv.gz) — parsed with numpy only.

Edges are directed src->dst and stored CSR-by-destination (in-neighbour
lists), the reference's convention. --make-undirected adds the reverse
edges (standard for arxiv/products). A host-side tool: it needs no card.
"""

from __future__ import annotations

import argparse
import gzip
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from gatv2_tpu_torch.data.graph import Graph, edges_to_csr  # noqa: E402
from gatv2_tpu_torch.data.io import save_dataset  # noqa: E402
from gatv2_tpu_torch.data.splits import Splits, save_split_files  # noqa: E402


def _read_csv_gz(path: pathlib.Path, dtype) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def load_from_raw(raw_dir: pathlib.Path, split_name: str = "sales_ranking"):
    edges = _read_csv_gz(raw_dir / "edge.csv.gz", np.int64)  # [E, 2] src,dst
    feats = _read_csv_gz(raw_dir / "node-feat.csv.gz", np.float32)
    labels = _read_csv_gz(raw_dir / "node-label.csv.gz", np.int64).reshape(-1)
    split_dir = raw_dir / "split"
    splits = None
    if split_dir.exists():
        candidates = (
            [split_dir / split_name] if (split_dir / split_name).exists()
            else sorted(p for p in split_dir.iterdir() if p.is_dir())
        )
        if candidates:
            sd = candidates[0]
            n = feats.shape[0]
            masks = {}
            for part, fname in (("train", "train.csv.gz"),
                                ("val", "valid.csv.gz"),
                                ("test", "test.csv.gz")):
                idx = _read_csv_gz(sd / fname, np.int64).reshape(-1)
                m = np.zeros(n, bool)
                m[idx] = True
                masks[part] = m
            splits = Splits(**masks)
    return edges, feats, labels, splits


def load_from_ogb(name: str, ogb_root: pathlib.Path):
    from ogb.nodeproppred import NodePropPredDataset

    ds = NodePropPredDataset(name=name, root=str(ogb_root))
    graph, labels = ds[0]
    edges = graph["edge_index"].T.astype(np.int64)  # [E, 2]
    feats = graph["node_feat"].astype(np.float32)
    labels = labels.reshape(-1).astype(np.int64)
    idx = ds.get_idx_split()
    n = feats.shape[0]

    def mask(key):
        m = np.zeros(n, bool)
        m[idx[key]] = True
        return m

    splits = Splits(train=mask("train"), val=mask("valid"), test=mask("test"))
    return edges, feats, labels, splits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="ogbn-arxiv",
                    help="OGB dataset name (for --ogb-root mode)")
    ap.add_argument("--ogb-root", type=pathlib.Path, default=None,
                    help="root of an existing OGB download")
    ap.add_argument("--raw-dir", type=pathlib.Path, default=None,
                    help="an OGB raw/ directory (csv.gz files)")
    ap.add_argument("--out", type=pathlib.Path, required=True,
                    help="output dataset directory")
    ap.add_argument("--make-undirected", action="store_true")
    args = ap.parse_args(argv)

    if args.raw_dir:
        edges, feats, labels, splits = load_from_raw(args.raw_dir)
    elif args.ogb_root:
        edges, feats, labels, splits = load_from_ogb(args.name, args.ogb_root)
    else:
        ap.error("one of --raw-dir / --ogb-root is required")

    n = feats.shape[0]
    row_ptr, col_idx = edges_to_csr(edges[:, 0], edges[:, 1], n,
                                    make_undirected=args.make_undirected)
    g = Graph(features=feats, row_ptr=row_ptr, col_idx=col_idx,
              labels=labels.astype(np.int32))
    save_dataset(g, args.out)
    if splits is not None:
        save_split_files(splits, args.out)
    print(
        f"wrote {args.out}: {g.num_nodes} nodes, {g.num_edges} edges, "
        f"{g.feature_dim} features, {int(labels.max()) + 1} classes"
        + (", with split masks" if splits is not None else "")
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
