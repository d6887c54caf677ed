#!/usr/bin/env python
"""One-process probe of the SELL op at one scale (counterpart of
tools/bisect_sell_high.py): one forward, or forward + backward, of
sell_attention at --nodes/--edges/--heads/--dim, printing the layout line,
`OK fwd+bwd loss=... gmax=[...]` and which kernels ran (their launch
counters). Run it in a subprocess under `timeout`, one scale per process,
so that a kernel fault at some scale kills only the probe.

The op's only numeric tier in the port is --streams (bf16 rounds zs and zd
once inside the op); K1-K4 compute in fp32 whatever --precision says, so
--precision is accepted for the JAX tool's command lines and passed to
nothing. --chunks N > 1 builds a chunked layout, whose backward runs K4
in place of K3.

Usage:
    timeout 300 python tools/torch_bisect_sell_high.py --nodes 20000 \\
        --edges 140000 [--heads 4 --dim 64] [--powerlaw] [--fwd-only] \\
        [--streams bf16] [--chunks 3] [--device cpu]
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

KERNELS = ("sell_fwd", "sell_bwd_dst", "sell_segsum", "sell_bwd_src")


def launch_counts() -> dict:
    return {n: getattr(importlib.import_module(f"gatv2_tpu_torch.ops.{n}"),
                       n).launches for n in KERNELS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, required=True)
    ap.add_argument("--edges", type=int, required=True)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--precision", default="high",
                    choices=["highest", "high", "default"],
                    help="accepted and passed to nothing: the SELL kernels "
                         "compute in fp32 at every tier (the tier acts in "
                         "the dense projections, outside this op)")
    ap.add_argument("--streams", default="f32", choices=["f32", "bf16"],
                    help="the op's stream tier")
    ap.add_argument("--chunks", type=int, default=1,
                    help="chunks of the layout (> 1: the backward runs K4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--powerlaw", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.ops.sell_attention import (
        prepare_sell_tiles,
        sell_attention,
    )

    dev = resolve_device(args.device)
    gen = powerlaw_graph if args.powerlaw else random_graph
    kw = {"alpha": 1.2} if args.powerlaw else {}
    g = gen(args.nodes, args.edges, 8, 4, seed=args.seed, **kw)
    n, h, d = g.num_nodes, args.heads, args.dim
    rng = np.random.default_rng(args.seed + 7)
    zs, zd = (torch.as_tensor(rng.standard_normal((n, h, d)), device=dev,
                              dtype=torch.float32).requires_grad_(True)
              for _ in range(2))
    a = torch.as_tensor(rng.standard_normal((h, d)), device=dev,
                        dtype=torch.float32).requires_grad_(True)
    st = prepare_sell_tiles(g.row_ptr, g.col_idx, n,
                            num_chunks=args.chunks).to(dev)
    print(f"layout: e_ell={st.e_ell} e2_ell={st.e2_ell} "
          f"dst_tiles={st.num_dst_tiles} chunks={st.num_chunks}", flush=True)

    def loss():
        return torch.sin(sell_attention(
            zs, zd, a, n, negative_slope=0.2, sell_tiles=st,
            streams=args.streams)).sum()

    before = launch_counts()
    if args.fwd_only:
        with torch.no_grad():
            v = loss()
        print(f"OK fwd loss={float(v):.6f}", flush=True)
    else:
        v = loss()
        grads = torch.autograd.grad(v, (zs, zd, a))
        gn = [float(x.abs().max()) for x in grads]
        print(f"OK fwd+bwd loss={float(v.detach()):.6f} gmax={gn}",
              flush=True)
    after = launch_counts()
    ran = {k: after[k] - before[k] for k in KERNELS}
    print(f"kernels: {json.dumps(ran)} on {dev}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
