#!/usr/bin/env python
"""Gradient error of a lower numeric tier against exact fp32 at full scale
(counterpart of tools/grad_error_at_scale.py): one JSON line with, for each
gradient, the max, 99.99th and 99th percentile of |g_tier - g_exact|
relative to max |g_exact|, the loss's relative error and the tier.

Two tiers, measured where each acts in the port:

  --streams bf16 (sell only): the op's own tier. zs and zd rounded once to
      bf16 inside sell_attention (streams='bf16') against streams='f32';
      loss = sum(sin(sell_attention(zs, zd, a))), gradients for zs, zd, a
      (the JAX tool's measurement, with its inputs from the same seed).
  --precision high|default: the dense projections' tier. The port's
      kernels (K1-K8) compute in fp32 at every --precision tier, which
      acts only in models/gatv2.dense (TF32 for 'high', bf16-rounded
      inputs for 'default'); measured inside the op it would be an exact
      0 and mean nothing. So the loss is sum(sin(op(dense(x, W_s),
      dense(x, W_d), a))) with x [N, 128] (arxiv's in-dim), and the
      gradients are those of W_s, W_d and a, each tier against
      'highest' (IEEE fp32). TF32 exists only on the card: on the CPU
      'high' equals 'highest' and reports 0.

The graph is random_graph(nodes, edges, 8, 4, seed); inputs come from
numpy's default_rng(seed + 7). Runs on the card unless --device cpu.

Usage: python tools/torch_grad_error_at_scale.py [--nodes 169343
           --edges 1166243] [--impl sell|pallas] [--streams bf16 |
           --precision high|default] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

IN_DIM = 128  # ogbn-arxiv's feature width
KERNELS = {"sell": ("sell_fwd", "sell_bwd_dst", "sell_segsum", "sell_bwd_src"),
           "pallas": ("pallas_fwd", "pallas_bwd_dst", "pallas_segsum",
                      "pallas_bwd_src")}


def launch_counts(impl: str) -> dict:
    """The launch counters of the impl's kernel wrappers."""
    return {n: getattr(importlib.import_module(f"gatv2_tpu_torch.ops.{n}"),
                       n).launches for n in KERNELS[impl]}


def rel_stats(got: np.ndarray, exact: np.ndarray) -> dict:
    rel = np.abs(got - exact) / (np.abs(exact).max() + 1e-12)
    return {"rel_max": float(rel.max()),
            "rel_p9999": float(np.percentile(rel, 99.99)),
            "rel_p99": float(np.percentile(rel, 99))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=169343)
    ap.add_argument("--edges", type=int, default=1166243)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--impl", default="sell", choices=["sell", "pallas"])
    ap.add_argument("--streams", default=None, choices=["bf16"],
                    help="measure the bf16-stream tier of the op (sell "
                         "only): streams='bf16' against 'f32'")
    ap.add_argument("--precision", default="high",
                    choices=["high", "default"],
                    help="the dense projections' tier measured against "
                         "'highest' (ignored with --streams)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.bench import device_fields
    from gatv2_tpu_torch.data.synthetic import random_graph
    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.models.gatv2 import dense

    dev = resolve_device(args.device)
    if args.streams == "bf16" and args.impl != "sell":
        raise SystemExit("--streams bf16 is a sell-only tier")
    g = random_graph(args.nodes, args.edges, 8, 4, seed=args.seed)
    n, h, d = g.num_nodes, args.heads, args.dim
    rng = np.random.default_rng(args.seed + 7)

    if args.impl == "sell":
        from gatv2_tpu_torch.ops.sell_attention import (
            prepare_sell_tiles,
            sell_attention,
        )

        tiles = prepare_sell_tiles(g.row_ptr, g.col_idx, n).to(dev)

        def op(zs, zd, a, streams="f32"):
            return sell_attention(zs, zd, a, n, negative_slope=0.2,
                                  sell_tiles=tiles, streams=streams)
    else:
        from gatv2_tpu_torch.ops.pallas_attention import (
            edge_attention_pallas,
            prepare_edge_tiles,
        )

        tiles = prepare_edge_tiles(g.row_ptr, g.col_idx, n).to(dev)

        def op(zs, zd, a):
            return edge_attention_pallas(zs, zd, a, n, negative_slope=0.2,
                                         edge_tiles=tiles)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    out = {"impl": args.impl, "nodes": n, "edges": int(g.num_edges),
           "heads": h, "dim": d}
    if args.streams == "bf16":
        out["tier"] = "streams_bf16_vs_f32"
        names = ("d_zs", "d_zd", "d_a")
        inputs = [t(rng.standard_normal((n, h, d))),
                  t(rng.standard_normal((n, h, d))),
                  t(rng.standard_normal((h, d)))]

        def loss_at(key, zs, zd, a):
            return torch.sin(op(zs, zd, a, streams="bf16" if key == "high"
                                else "f32")).sum()
    else:
        tier = args.precision
        out["tier"] = f"precision_{tier}_vs_highest"
        names = ("d_w_src", "d_w_dst", "d_a")
        x = t(rng.standard_normal((n, IN_DIM)))
        scale = 1.0 / np.sqrt(IN_DIM)  # unit-variance projections
        inputs = [t(rng.standard_normal((h * d, IN_DIM)) * scale),
                  t(rng.standard_normal((h * d, IN_DIM)) * scale),
                  t(rng.standard_normal((h, d)))]

        def loss_at(key, w_s, w_d, a):
            p = tier if key == "high" else "highest"
            zs = dense(x, w_s, p).reshape(n, h, d)
            zd = dense(x, w_d, p).reshape(n, h, d)
            return torch.sin(op(zs, zd, a)).sum()

    before = launch_counts(args.impl)
    grads = {}
    for key in ("highest", "high"):
        leaves = [v.clone().requires_grad_(True) for v in inputs]
        loss = loss_at(key, *leaves)
        grads[key] = [gr.detach().cpu().numpy().astype(np.float64)
                      for gr in torch.autograd.grad(loss, leaves)]
        out[f"loss_{key}"] = float(loss.detach())
    after = launch_counts(args.impl)
    for name, ge, gx in zip(names, grads["high"], grads["highest"]):
        out[name] = rel_stats(ge, gx)
    out["loss_rel_err"] = abs(out["loss_high"] - out["loss_highest"]) / (
        abs(out["loss_highest"]) + 1e-12)
    out["launches"] = {k: after[k] - before[k] for k in after}
    out.update(device_fields(dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
