#!/usr/bin/env python
"""Measure the products-full-4h sharding plan at real scale on the host
(counterpart of tools/plan_products_4h.py), with the port's own per-shard
memory table.

Builds a community-structured graph at ogbn-products scale (N=2,449,029,
E=61,859,140; communities as contiguous id blocks, like a clustered real
ordering; --p-local is the intra-community edge probability), runs the
port's partitioner and halo planner (gatv2_tpu_torch/parallel/partition.py)
and prints, per shard count:

  - edge balance across shards;
  - halo rows per shard and phi = exchanged rows / N;
  - per layer of the 4-head model (heads 4,1,1, outdims 64,32,16), the
    boundary exchange's bytes against an all_gather's;
  - the per-shard live set on the card of the widest layer (layer 0, H*D =
    256) in the sell path: the features, the SELL layout's int32 arrays
    (both sides' slots at this shard's degree profile, unchunked), zs and
    zd, the gather space of exchanged rows, out, the softmax stats, and the
    chunk budget of the edge-space temporaries (a quarter of the card, the
    port's default), totalled against the card's memory.

The card's memory comes from torch.cuda.get_device_properties, or from
--card-gib with --device cpu. Everything else is numpy on the host: the
full scale needs about 8 GB of host memory; --scale shrinks N and E.

Usage: python tools/torch_plan_products_4h.py [--shards 1 2 4]
           [--p-local 0.9] [--scale 1.0] [--device cpu --card-gib 80]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

N_FULL = 2_449_029
E_FULL = 61_859_140
F_IN = 100
HEADS = (4, 1, 1)
OUTDIMS = (64, 32, 16)
COMMUNITIES = 16


def build_graph(n: int, e: int, p_local: float, seed: int = 0):
    """dst-CSR community graph (tools/plan_products_4h.py build_graph): node
    ids are contiguous per community, the clustered ordering a preprocessed
    real Products graph would have."""
    from gatv2_tpu_torch.data.graph import Graph

    rng = np.random.default_rng(seed)
    comm_lo = np.arange(COMMUNITIES) * n // COMMUNITIES
    comm_hi = np.arange(1, COMMUNITIES + 1) * n // COMMUNITIES

    dst = np.sort(rng.integers(0, n, e).astype(np.int64), kind="stable")
    local = rng.random(e) < p_local
    c = dst * COMMUNITIES // n
    span = (comm_hi - comm_lo)[c]
    src_local = comm_lo[c] + (rng.random(e) * span).astype(np.int64)
    src_global = rng.integers(0, n, e)
    src = np.where(local, src_local, src_global).astype(np.int64)

    counts = np.bincount(dst, minlength=n)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(
        features=np.zeros((n, 1), np.float32),  # sizes are analytic
        row_ptr=row_ptr,
        col_idx=src.astype(np.int32),
        labels=np.zeros(n, np.int32),
    )


def sell_slots(pg, plan, shard: int) -> tuple[int, int, int]:
    """(dst-side slots e_ell, src-side slots e2_ell, virtual rows of both
    sides) of shard's unchunked SELL layout, from its degree profile."""
    from gatv2_tpu_torch.ops.sell_attention import (
        DEFAULT_SPLIT_CAP,
        TILE_N,
        _side_geometry,
    )

    nps = pg.nodes_per_shard
    dst = pg.dst_local[pg.shard_edges(shard)]
    real = dst < nps
    if plan is not None:
        src, space = plan.src_halo[shard], plan.space_size
    else:
        src, space = pg.src[pg.shard_edges(shard)], pg.padded_num_nodes
    deg_d = np.bincount(dst[real], minlength=nps)
    deg_s = np.bincount(src[real], minlength=space)
    t_d, _, e_ell, _ = _side_geometry(deg_d, 1, split_cap=DEFAULT_SPLIT_CAP)
    t_s, _, e2_ell, _ = _side_geometry(deg_s, 1, split_cap=DEFAULT_SPLIT_CAP)
    return e_ell, e2_ell, (t_d + t_s) * TILE_N


def memory_table(pg, plan, n: int, card_bytes: int) -> dict:
    """The widest shard's live set of layer 0 on the card, in bytes."""
    s, nps = pg.num_shards, pg.nodes_per_shard
    hd0 = HEADS[0] * OUTDIMS[0]
    if s == 1:
        gather_rows, where = 0, "none: one shard"
    elif plan is None:
        gather_rows, where = n - nps, "(S-1)/S * N, all_gather"
    else:
        gather_rows, where = plan.halo_size, "phi * N"
    e_ell, e2_ell, rows = max(sell_slots(pg, plan, k) for k in range(s))
    return {
        f"features [nps, {F_IN}] f32": nps * F_IN * 4,
        "SELL layout int32 (slots both sides, ell_perm, row ids)":
            4 * (e_ell + 2 * e2_ell) + 4 * 4 * rows,
        f"zs + zd [nps, {hd0}] x2": nps * hd0 * 4 * 2,
        f"gather space [{where}, {hd0}]": gather_rows * hd0 * 4,
        f"out [nps, {hd0}]": nps * hd0 * 4,
        f"softmax stats sigma, r [nps, {HEADS[0]}] x2": nps * HEADS[0] * 4 * 2,
        "chunk budget (a quarter of the card)": card_bytes // 4,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--p-local", type=float, default=0.9)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--card-gib", type=float, default=None,
                    help="the card's memory in GiB (needed with --device "
                         "cpu; default: the card's own)")
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.parallel.partition import (
        halo_exchange_plan,
        partition_graph,
    )

    dev = resolve_device(args.device)
    if args.card_gib is not None:
        card_bytes, card = int(args.card_gib * 2**30), f"{args.card_gib} GiB"
    elif dev.type == "cuda":
        import torch

        props = torch.cuda.get_device_properties(dev)
        card_bytes = props.total_memory
        card = f"{props.name}, {card_bytes / 2**30:.2f} GiB"
    else:
        ap.error("--device cpu needs --card-gib")

    n = int(N_FULL * args.scale)
    e = int(E_FULL * args.scale)
    print(f"building community graph: N={n:,} E={e:,} "
          f"p_local={args.p_local} communities={COMMUNITIES}",
          file=sys.stderr, flush=True)
    g = build_graph(n, e, args.p_local, args.seed)

    for s in args.shards:
        pg = partition_graph(g, s)
        print(f"\n== {s} shards ==")
        print(f"balance: {pg.balance_report()}")
        plan = None
        if s > 1:
            plan = halo_exchange_plan(pg)
            disabled = plan.halo_size >= pg.padded_num_nodes
            phi = plan.halo_size / n
            print(f"halo rows/shard: {plan.halo_size:,} (m_per_pair "
                  f"{plan.m_per_pair:,}) -> phi = {phi:.4f}"
                  + ("  [>= all_gather; dense fallback]" if disabled
                     else ""))
            if disabled:
                plan = None
        else:
            print("halo rows/shard: 0 (one shard: nothing is exchanged)")
        rows_ag = pg.padded_num_nodes - pg.nodes_per_shard
        m = plan.m_per_pair if plan is not None else 0
        for layer, (h, d) in enumerate(zip(HEADS, OUTDIMS)):
            hd = h * d
            ag_mb = rows_ag * hd * 4 / 1e6
            halo_mb = (s - 1) * m * hd * 4 / 1e6
            print(f"layer {layer}: all_gather {ag_mb:,.1f} MB/chip vs "
                  f"boundary {halo_mb:,.1f} MB/chip "
                  f"({halo_mb / max(ag_mb, 1e-9):.2%})")
        total = 0
        print("per-shard device memory (4-head config, layer 0, sell):")
        for k, v in memory_table(pg, plan, n, card_bytes).items():
            total += v
            print(f"  {k:<56} {v / 2**30:7.3f} GiB")
        print(f"  {'TOTAL (one layer live, per-layer remat)':<56} "
              f"{total / 2**30:7.3f} GiB  (card: {card}; "
              f"{total / card_bytes:.1%} of it)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
