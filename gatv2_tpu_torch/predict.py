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
from gatv2_tpu_torch.ops.attention import full_graph_inputs
from gatv2_tpu_torch.ops.pallas_fwd import pallas_fwd
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
    inputs = full_graph_inputs(graph, model_config, train_config.impl,
                               device=device)

    kernel = {"sell": ("K1", sell_fwd), "pallas": ("K5", pallas_fwd)}.get(
        train_config.impl)
    launches0 = kernel[1].launches if kernel else 0
    # inference: BatchNorm (--norm batch) normalises by its running
    # statistics
    with torch.inference_mode():
        logits = model_forward(
            params, inputs.features, inputs.src, inputs.dst, model_config,
            impl=train_config.impl, edge_tiles=inputs.layout, device=device,
            edge_feat=inputs.edge_feat,
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
