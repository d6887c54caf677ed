#!/usr/bin/env python
"""Time the port's fused attention op alone (no projections, no optimizer),
forward or forward + backward, on one bench config (port of
tools/bench_kernels.py).

    python tools/torch_bench_kernels.py [--config arxiv] [--impl sell]
        [--mode fwd|fwdbwd] [--heads 4] [--dim 64] [--device cuda|cpu]

The op is sell_attention (K1 forward; K2 with K3, or K4 on a chunked
layout, backward) or edge_attention_pallas (K5; K6 with K7, or K8) on the
config's graph, laid out and chunked as the trainer lays it out, with
random zs, zd and a from a seeded torch.Generator. The time per call is
gatv2_tpu_torch.bench's differenced timing: calls of k_small and k_large
back to back, (t(k_large) - t(k_small)) / (k_large - k_small), CUDA events
on the card (host clock with --device cpu, where the op runs the kernels'
plain twins). The FLOP count is the op's algorithmic one, the bench's
per-edge term for one layer: e * H * (6D + 10) forward, three times that
forward + backward. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from gatv2_tpu_torch.bench import (  # noqa: E402
    CONFIGS,
    PEAK_TFLOPS,
    bench_graph,
    device_fields,
    differenced_ms,
    timing_fields,
)


def layout(g, impl, heads, dim, dev, tile_e=None):
    """The op's layout of graph g on dev: the trainer's own set-up
    (setup_full_graph_sell / setup_full_graph) for one layer of `heads` x
    `dim`, chunked by its default budget."""
    if impl == "sell":
        from gatv2_tpu_torch.ops.sell_attention import setup_full_graph_sell

        et = setup_full_graph_sell(g, (heads,), (dim,), device=dev)[0]
    else:
        from gatv2_tpu_torch.ops.pallas_attention import setup_full_graph

        et = setup_full_graph(g, (heads,), (dim,), device=dev,
                              tile_e=tile_e)[0]
    return et.to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="arxiv", choices=list(CONFIGS))
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--mode", default="fwdbwd", choices=["fwd", "fwdbwd"])
    ap.add_argument("--impl", default="sell", choices=["pallas", "sell"])
    ap.add_argument("--tile-e", type=int, default=None)
    ap.add_argument("--k", type=int, default=None,
                    help="calls of the larger run (default by scale)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.ops.pallas_attention import edge_attention_pallas
    from gatv2_tpu_torch.ops.sell_attention import sell_attention

    dev = resolve_device(args.device)
    n, e, f, c, _, _, _ = CONFIGS[args.config]
    h, d = args.heads, args.dim
    g = bench_graph(args.config, n, e, f, c, seed=0)
    et = layout(g, args.impl, h, d, dev, args.tile_e)
    n_pad = et.padded_num_nodes
    gen = torch.Generator().manual_seed(0)
    zs, zd = (torch.randn(n_pad, h * d, generator=gen).to(dev)
              .requires_grad_(args.mode == "fwdbwd") for _ in range(2))
    a = (torch.randn(h, d, generator=gen) * 0.1).to(dev).requires_grad_(
        args.mode == "fwdbwd")

    def op():
        if args.impl == "sell":
            return sell_attention(zs, zd, a, n_pad, negative_slope=0.2,
                                  sell_tiles=et)
        return edge_attention_pallas(zs, zd, a, n_pad, negative_slope=0.2,
                                     edge_tiles=et)

    def call():
        if args.mode == "fwd":
            with torch.no_grad():
                op()
            return
        torch.autograd.grad(torch.sin(op()).sum(), (zs, zd, a))

    def run_k(k):
        for _ in range(k):
            call()

    k_small = 2
    k_large = args.k or (6 if e >= 4_000_000 else 22)
    diffs = differenced_ms({"op": run_k}, (k_small, k_large, args.reps),
                           dev)["op"]
    t = timing_fields(diffs)
    ms = t["epoch_ms"]
    gflop = e * h * (6.0 * d + 10.0) * (1 if args.mode == "fwd" else 3) / 1e9
    on_card = dev.type == "cuda"
    print(json.dumps({
        "config": args.config, "mode": args.mode, "impl": args.impl,
        "heads": h, "dim": d, "tile_e": getattr(et, "tile_e", None),
        "num_chunks": et.num_chunks,
        "ms_per_call": round(ms, 4), "ms_min": round(t["epoch_ms_min"], 4),
        "ms_q1": round(t["epoch_ms_q1"], 4),
        "ms_q3": round(t["epoch_ms_q3"], 4), "samples": t["samples"],
        "k_small": k_small, "k_large": k_large,
        "edges_per_s": round(e / (ms / 1e3)),
        "gflop": round(gflop, 4),
        "achieved_tflops": round(gflop / ms, 4) if on_card else None,
        "pct_of_fp32_peak": (round(gflop / ms / PEAK_TFLOPS["highest"][0]
                                   * 100, 3) if on_card else None),
        **device_fields(dev),
    }))
    return 0 if np.isfinite(ms) else 1


if __name__ == "__main__":
    sys.exit(main())
