"""Inference entry point: load trained weights, write per-node predictions
(port of the root predict.py).

Runs one full-graph forward (on CUDA through K1 with --impl sell, the
default, or K5 with --impl pallas) and writes `predictions.txt` (one
predicted label per node; with --loss bce one line of C 0/1 task
predictions per node) and, with --save-probs, `probs.txt` (softmax rows;
per-task sigmoids with --loss bce), from a text weight dump (--load-weights) or the newest checkpoint of
a training run (--checkpoint-dir; either package's).

Example:
    python -m gatv2_tpu_torch.predict --dataset citeseer --load-weights w/ \\
        --num-layers 2 --heads 1,1 --outdims 16,16 --out preds/
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import torch

from gatv2_tpu_torch import cli
from gatv2_tpu_torch.data.io import load_dataset
from gatv2_tpu_torch.device import resolve_device
from gatv2_tpu_torch.models.gatv2 import GATv2, model_forward
from gatv2_tpu_torch.models.params_io import load_params_txt
from gatv2_tpu_torch.ops.pallas_attention import setup_full_graph
from gatv2_tpu_torch.ops.pallas_fwd import pallas_fwd
from gatv2_tpu_torch.ops.sell_attention import setup_full_graph_sell
from gatv2_tpu_torch.ops.sell_fwd import sell_fwd
from gatv2_tpu_torch.train import checkpoint as ckpt


def main(argv: list[str] | None = None) -> int:
    p = cli.build_parser()
    p.add_argument("--out", type=str, default="predictions",
                   help="output directory")
    p.add_argument("--save-probs", action="store_true",
                   help="also write softmax probabilities (N x C floats)")
    model_config, train_config, args = cli.parse_args_from(p, argv)
    device = resolve_device(args.device)

    graph = load_dataset(train_config.dataset, train_config.data_root)
    model_config = dataclasses.replace(
        model_config, num_classes=graph.num_classes, in_dim=graph.feature_dim,
        edge_dim=graph.edge_dim if args.edge_features else 0,
    )
    edge_features = graph.edge_features if args.edge_features else None

    if args.load_weights:
        params = load_params_txt(args.load_weights, model_config)
    elif args.checkpoint_dir:
        path = ckpt.latest_path(args.checkpoint_dir)
        if path is None:
            raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
        # shapes can coincide while semantics differ (edge vs node variant
        # have identical params): compare the stored model fingerprint
        stored = ckpt.read_meta(path)
        if "model_config" in stored:
            diffs = ckpt.config_diffs(stored, ckpt.run_meta(model_config),
                                      groups=("model_config",))
            if diffs:
                raise SystemExit(
                    "Error: checkpoint was trained with a different model "
                    "configuration:\n  " + "\n  ".join(diffs)
                )
        params = GATv2(model_config)
        epoch = ckpt.restore(path, params)
        print(f"Loaded checkpoint at epoch {epoch}")
    else:
        raise SystemExit("one of --load-weights / --checkpoint-dir is required")

    num_nodes = graph.num_nodes
    edge_tiles, src, dst = None, None, None
    feats = graph.features
    setup = {"sell": setup_full_graph_sell, "pallas": setup_full_graph}
    edge_kw = {}
    if edge_features is not None:
        if train_config.impl == "sell":
            edge_kw = dict(edge_features=edge_features)
        elif train_config.impl != "torch":
            raise SystemExit(
                f"Error: --edge-features runs on --impl torch or sell, not "
                f"{train_config.impl}.")
    if train_config.impl in setup:
        edge_tiles, feats, _, _ = setup[train_config.impl](
            graph, model_config.heads, model_config.out_dims, device=device,
            **edge_kw)
    else:
        src, dst = graph.src, graph.dst

    kernel = {"sell": ("K1", sell_fwd), "pallas": ("K5", pallas_fwd)}.get(
        train_config.impl)
    launches0 = kernel[1].launches if kernel else 0
    # inference: BatchNorm (--norm batch) normalises by its running
    # statistics
    with torch.inference_mode():
        logits = model_forward(
            params, feats, src, dst, model_config, impl=train_config.impl,
            edge_tiles=edge_tiles, device=device,
            edge_feat=edge_features if train_config.impl == "torch" else None,
        )[:num_nodes]
        if model_config.loss == "bce":
            preds = (logits > 0).cpu().numpy().astype(np.int64)
            probs = torch.sigmoid(logits).cpu().numpy()
        else:
            preds = logits.argmax(dim=-1).cpu().numpy().astype(np.int64)
            probs = torch.softmax(logits, dim=-1).cpu().numpy()
    if kernel:
        tag, k = kernel
        print(f"{tag} {k.__name__} launches: {k.launches - launches0}")

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "predictions.txt", "w") as f:
        if preds.ndim == 2:
            f.write("\n".join(" ".join(map(str, row)) for row in preds))
        else:
            f.write(" ".join(map(str, preds)))
    if args.save_probs:
        np.savetxt(out / "probs.txt", probs, fmt="%.6g")
    acc = float((preds == graph.labels).mean())
    print(
        f"Wrote {out}/predictions.txt ({num_nodes} nodes); "
        f"accuracy vs labels: {acc * 100:.2f}%"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
