#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gatv2_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases (any failure exits non-zero):
  1. the device: name, count, torch/CUDA versions, nvidia-smi name and
     power limit; no CUDA device is a failure;
  2. build every CUDA kernel from gatv2_tpu_torch/csrc (one nvcc per
     source, all at once), with nvcc's register / shared-memory report;
  3. chunked full-graph training, the fourth main path, first while the
     card's memory is free: bench.py's products-full (2,449,029 nodes,
     61,859,140 edges, heads 2,1,1, outdims 64,32,16, random weights from a
     seeded torch.Generator) through Trainer(impl='sell') on the chunk
     count its default budget picks (more than 1), 3 epochs of Adam with
     clipping; the K1/K2/K3/K4 counters zeroed just before and read just
     after (K4 launched, K3 not); epoch time, peak memory, a profiler
     table, one remat epoch with the same first loss and K1 launched as
     often as in an epoch without remat; then K4 against its
     twin and float64, K2 without packets against K2 with them, and K1
     against its twin, at each layer's shapes on one chunk, with K1's, K2's
     and K4's times beside their bounds, per-edge gather floors and twins;
     then the multi-epoch runner on its chunks (as in 8b: K1, K2, K4);
  4. full-width inference, the first main path: the headline model (3
     layers, heads 4,1,1, outdims 64,32,16, random weights from a seeded
     torch.Generator) at ogbn-arxiv scale on a uniform graph ('arxiv') and
     a Zipf(1.2) graph ('arxiv-pl'), through model_forward(impl='sell');
     K1's launch counter is zeroed just before and read just after. The
     logits must be finite and match impl='torch';
  5. full-width training, the second main path: the port's Trainer
     (impl='sell', Adam, lr 0.01, clipping, 3 epochs) on both graphs from
     the same weights, K1/K2/K3 counters zeroed just before and read just
     after; the losses must be finite and match a Trainer on impl='torch';
  6. one step's gradients: sell and the fp32 torch path, each against the
     torch path in float64;
  7. every kernel against its plain PyTorch twin on the card, at the main
     paths' per-layer shapes and on extra layouts (chunked, 20 heads, bf16
     streams, isolated nodes, no edges), with each layer's kernel time
     beside its bound, the twin's time and, for K3, index_add_'s;
  8. forward and epoch times, peak memory, profiler tables;
  8b. the multi-epoch runners (make_multi_epoch_runner) at arxiv full width
     on impl='sell' (K1-K3) and impl='pallas' (K5-K7): the waits for the
     device of one Trainer.step listed (set_sync_debug_mode 'warn'); 3
     runner epochs under set_sync_debug_mode('error'), which fails the
     phase at any wait, with the counters zeroed just before and read just
     after, each kernel launched 3 times as often as by one Trainer.step;
     their losses against 3 Trainer.step calls from the same start; the
     runner's epoch ms by differencing runs of 8 and 40 epochs (5 reps,
     bench.py's _differenced_timing) beside Trainer.step's, timed the same
     way in turns with it; and whether torch.tensor(x, device=cuda) from a
     Python scalar waits;
  9. the entry points end to end, as subprocesses: predict on data/digits;
     train on data/karate with a checkpoint, then predict from it;
 10. sampled-minibatch training, the third main path: the headline model at
     full width on bench.py's products-sub graph (500k nodes, 8M edges,
     batch 1024, fanouts 10,10,10, native sampler, device-resident
     features, Adam lr 0.01 with clipping, weights from a seeded
     torch.Generator) through MinibatchTrainer(impl='pallas'); the K5/K6/K7
     counters are zeroed just before 3 warm-up and 30 timed batches and
     read just after; then one exact full-graph evaluation (K5 per chunk);
 11. its correctness on the card: the first sampled batches through
     impl='pallas' and impl='torch' from the same weights (losses), one
     batch's gradients against float64, K5/K6/K7 against their twins at
     every layer's shapes (padding packets poisoned with NaN before K7) and
     on extra layouts (20 heads, a hub beside isolated nodes, a batch with
     empty node tiles, no edges), and full-graph Trainer(impl='pallas') on
     'arxiv' and 'arxiv-pl' against the torch path, with a profile of one
     step of each (on 'arxiv-pl', its hub rows' share by kernel); then K7
     at each layer of that unchunked 'arxiv-pl' step (its 226,772-edge
     source hub split over segment blocks) against its twin and float64,
     padding packets poisoned with NaN, with its time beside its bound,
     its twin's and index_add_'s;
 11b. the same products-sub minibatch path on per-batch SELL layouts:
     MinibatchTrainer(impl='sell') from the same start weights (budget
     500,096 nodes / 1,136,640 edges, fixed geometry 9,136 columns and
     3,942 slices a side, both sides split), the K1/K2/K3 counters zeroed
     just before 3 warm-up and 30 timed batches and read just after; the
     first 5 losses against the torch path's, one batch's gradients
     against float64, K1-K3 against their twins at every layer's shapes
     (padding packets poisoned with NaN before K3), each kernel's time
     beside its bound (real edges only), its twin and, for K3,
     index_add_, the plain-PyTorch row merges, device step / host sample +
     layout / pipelined times beside the pallas run's in the same call, a
     profile, and one exact evaluation through setup_full_graph_sell;
 12. chunk invariance: 'arxiv' and 'arxiv-pl' on a forced 3-chunk layout,
     sell (K1, K2, K4) and pallas (K5, K6, K8) Trainers against the torch
     path's losses, their epoch times and a profile of the 'arxiv-pl'
     pallas step, one step's gradients against float64; both ops''
     gradients on chunked extra layouts (20 heads, split hubs beside
     isolated nodes, chunks without an edge, no edges, bf16 streams)
     against the twins and float64; then the edge-conditioned block
     (phase_edge_features): the edge-feature variants of K1, K2 and K4 on
     one chunk of a layout at ogbn-proteins' in-degree (~600 edges a row,
     6 x 80 heads, 8-dim edge features) against their twins and float64,
     out / m / l, dzd / da / the summed dW_e partials and dzs; then 2
     layers of that block (residual, BatchNorm, multi-label loss) on a
     forced 3-chunk layout with remat, sell (K1, K2, K4 with the edge
     term) against the torch path's losses, K1 launched once per layer,
     chunk and epoch;
 13. its times: device step, host sample + tile, the pipeline ratio of
     tools/bench_minibatch.py, each kernel beside its bound (K5 and K6:
     and per-edge gather floor), its twin and, for K7, index_add_; a profiler table; peak memory; and the minibatch
     entry point (train --batch-size on karate, then predict --impl pallas
     from its checkpoint; train --impl sell --batch-size with --profile
     and --debug-nans, its trace file checked);
 14. products-sub full-graph Trainer(impl='pallas') on the chunk count its
     default budget picks, the K5-K8 counters zeroed just before and read
     just after (K8 launched, K7 not), against a sell Trainer from the same
     weights; then K8 against its twin and float64, and K6 without packets
     against K6 with them, at each layer's shapes on one chunk, with K8's
     time beside its bound and per-edge gather floor; then the runner on
     the pallas Trainer's chunks (as in 8b: K5, K6, K8);
 15. multi-GPU on the one card: a pool of 2 ranks sharing cuda:0 over
     gloo (the Transport: line; each collective the port calls run once on
     CUDA tensors), which is no measure of multi-GPU speed. Sharded arxiv
     training at full width (ShardedTrainer, 3 epochs from phase 5's
     weights) on sell, pallas and torch with and without --overlap on a
     2-rank 'graph' mesh, and sell on a 1x2 'head' mesh; sell with
     --overlap on arxiv-pl, whose hubs hand it to the single pass: each
     rank's counters zeroed just before and read just after, K1-K3 or
     K5-K7 launched on every rank of their routes and K1 / K5 with
     normalize=False on the merge routes, the losses against phase 5's
     single-process sell Trainer; on the sell and pallas --overlap routes
     the host order of every layer on both ranks (forward: exchange
     started, local pass launched, wait, halo pass; backward: halo pass,
     reverse exchange started, local pass launched, wait), which fails the
     phase otherwise; one more epoch under torch.profiler of sell, sell
     --overlap and pallas --overlap (wall, device busy, the gloo rows'
     host time and, on the overlap routes, the local passes' device ms and
     the host's waits for the exchange); the sell and pallas epochs, single
     pass and --overlap, timed in turns; one sharded step's gradients on
     every arxiv route against float64; every kernel launch of the sharded
     layer's ops on shard 0's layouts (each route's per-shard bipartite
     tiles and overlap pair, arxiv-pl's split single pass), layer by
     layer: K1 / K5 with normalize=False per pass and K2 + K3 / K6 + K7
     against the merged stats on the merge routes, each against its twin
     on the arguments the op gave it, with its time beside its bound; K5
     with normalize=False on a split hub beside rows without an edge;
     data-parallel products-sub minibatch training
     (pallas, then sell, 5 super-steps) against a single-process oracle
     of seed-weighted group steps; the sharded multi-epoch runner on the
     arxiv sell route against ShardedTrainer's losses, with its
     differenced epoch ms; and `train --mesh 2` on karate;
 16. the bench (gatv2_tpu_torch/bench.py) and its tools: bench_config on
     arxiv for sell and pallas (their epoch ms within 25% of 8b's runner
     epoch, the two timed in turns),
     a 2-rank --mesh 2 arxiv sell line (k1=1, k2=3, 3 reps), the minibatch
     tool on products-sub for 5 batches and one profile tool summary on
     arxiv; each line must hold its fields, no NaN and no correct: false;
 17. the remaining tools (tools/torch_*.py, the JAX tools' counterparts):
     the sweep tool on the cora and cora-sell legs (one bench subprocess
     each) and its report, both legs `correct`, naming the card and in the
     A/B table; the gradient error at arxiv scale of bf16 streams and of
     TF32 projections, in this process, with the K1-K3 counters zeroed just
     before and read just after (each launched); the SELL probe at arxiv
     scale in a subprocess; the multi-host smoke's sell mode as 2 processes
     sharing the card over gloo, their losses equal;
 18. the total seconds, one JSON line listing every kernel, the
     nvidia-smi line, then the result line
     {"ok": true, "device": {...}}.

Every time is measured with CUDA events and printed with the card's name
and power limit.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from gatv2_tpu_torch import bench
from gatv2_tpu_torch.bench import differenced_ms, timing_line
from gatv2_tpu_torch.config import ModelConfig, TrainConfig
from gatv2_tpu_torch.data.graph import Graph
from gatv2_tpu_torch.data.io import load_dataset
from gatv2_tpu_torch.data.sampling import prefetch
from gatv2_tpu_torch.data.splits import random_splits
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models.gatv2 import init_params, loss_fn, model_forward
from gatv2_tpu_torch.models.params_io import save_params_txt
from gatv2_tpu_torch.ops import build
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops.attention import edge_attention
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.pallas_bwd_dst import (
    pallas_bwd_dst,
    pallas_bwd_dst_plain,
)
from gatv2_tpu_torch.ops.pallas_bwd_src import (
    pallas_bwd_src,
    pallas_bwd_src_plain,
)
from gatv2_tpu_torch.ops.pallas_fwd import (
    NEG_INF,
    pallas_fwd,
    pallas_fwd_plain,
    real_edges,
)
from gatv2_tpu_torch.ops.pallas_segsum import pallas_segsum, pallas_segsum_plain
from gatv2_tpu_torch.ops.sell_attention import (
    TILE_N,
    prepare_sell_tiles,
    sell_attention,
    sell_forward,
    setup_full_graph_sell,
)
from gatv2_tpu_torch.ops.sell_bwd_dst import sell_bwd_dst, sell_bwd_dst_plain
from gatv2_tpu_torch.ops.sell_bwd_src import sell_bwd_src, sell_bwd_src_plain
from gatv2_tpu_torch.ops.sell_fwd import sell_fwd, sell_fwd_plain
from gatv2_tpu_torch.ops.sell_segsum import sell_segsum, sell_segsum_plain
from gatv2_tpu_torch.train import optim
from gatv2_tpu_torch.train.loop import Trainer, make_multi_epoch_runner
from gatv2_tpu_torch.parallel import multihost, sharded
from gatv2_tpu_torch.train.minibatch import (
    DataParallelMinibatchTrainer,
    MinibatchTrainer,
    gather_rows_clip,
)
from gatv2_tpu_torch.utils import native_loader

ROOT = pathlib.Path(__file__).resolve().parent

# the repo's headline model (bench.py configs citeseer3 / arxiv) at
# ogbn-arxiv scale (bench.py 'arxiv' and 'arxiv-pl')
HEADS, OUTDIMS = (4, 1, 1), (64, 32, 16)
ARXIV = dict(num_nodes=169_343, num_edges=1_166_243, feature_dim=128,
             num_classes=40, seed=0)
SLOPE = 0.01  # ModelConfig.negative_slope

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 outside the
# tensor cores, which is where K1's arithmetic runs
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations per feature per real edge: add zd, LeakyReLU (compare +
# multiply), multiply by a, the head sum's add, and acc = c*acc + p*z (a
# multiply and a multiply-add); the per-head softmax update (two exp) is
# D times rarer and not counted
K1_OPS_PER_FEATURE = 8
# K2, per feature per real edge: add zd, LeakyReLU (compare + multiply),
# multiply by a and the score sum's add, g*zs and the dalpha sum's add, ds
# (two multiplies), dzd's add, d_a's multiply-add with s_act (two), and
# c1 = alpha*g + ds (two); the per-head exp and de are D times rarer
K2_OPS_PER_FEATURE = 15
# K3: one add per feature per real edge
K3_OPS_PER_FEATURE = 1

# Kernel vs twin, both fp32: the kernel sums each head's D terms in lane
# groups and shuffles where the twin uses torch's reduction, and expf vs
# torch.exp may differ in the last ulp, so results differ by rounding only.
K1_RTOL, K1_ATOL = 1e-5, 1e-5
# Logits of impl='sell' vs impl='torch', relative to the largest logit: the
# torch path sums a node's in-edges with index_add_ (atomics, any order)
# after a two-pass softmax, the SELL path online per row, over three layers
# and hub rows of up to ~2e5 edges (arxiv-pl); fp32 rounding in different
# orders. Both are also held against the torch path in float64.
LOGIT_TOL = 1e-3
# K2's c1 is per edge, like K1's output, and is held to K1's tolerance
# against the twin. dzd, d_a (and the op's d_zd) are sums of terms
# de = alpha * (dalpha - r) that cancel: over a node's edges sum(de) = 0
# per head in exact arithmetic, so their fp32 rounding can be large against
# the result itself. They, K3's dzs and the op's gradients are held against
# a float64 evaluation instead: the kernel's max abs error may be at most
# F64_FACTOR times the fp32 twin's, or F64_FLOOR x the largest |value|.
F64_FACTOR, F64_FLOOR = 10.0, 1e-6
# Training losses of impl='sell' vs impl='torch' from the same weights,
# relative: both fp32 in different summation orders, and Adam's early steps
# move each weight by about lr times its gradient's sign, so a weight whose
# gradient is near 0 can move differently on the two paths.
LOSS_RTOL = 1e-4
# One step's gradients against the float64 torch path, relative to each
# parameter's largest |gradient|: sell may be at most GRAD_FACTOR times
# further from it than the fp32 torch path, or GRAD_FLOOR, if larger.
GRAD_FACTOR, GRAD_FLOOR = 10.0, 1e-5
TRAIN_EPOCHS = 3

# bench.py's 'products-sub' graph (random_graph(500000, 8000000, 100, 47)),
# trained by sampled minibatch at tools/bench_minibatch.py's batch and
# fanouts, with the headline model
PRODUCTS_SUB = dict(num_nodes=500_000, num_edges=8_000_000, feature_dim=100,
                    num_classes=47, seed=0)
MB_BATCH, MB_FANOUTS = 1024, (10, 10, 10)
# the static budget the sampler must derive: the analytic worst case capped
# at the graph's node count, padded to the 128-node tile grid
MB_MAX_NODES, MB_MAX_EDGES = 500_096, 1_136_640
MB_WARMUP, MB_TIMED = 3, 30
# the first sampled batches, replayed through impl='pallas' and 'torch' from
# the same weights; Adam moves a weight whose gradient is rounding noise by
# about lr either way, so the two paths drift apart step by step
MB_CHECK = 5
# K5, K6 and K7 do K1's, K2's and K3's arithmetic per real edge
K5_OPS_PER_FEATURE = K1_OPS_PER_FEATURE
K6_OPS_PER_FEATURE = K2_OPS_PER_FEATURE
K7_OPS_PER_FEATURE = K3_OPS_PER_FEATURE
SELL_KERNELS = ("sell_fwd", "sell_bwd_dst", "sell_segsum")
# the per-batch SELL geometry (sell_minibatch_geometry) of that budget:
# ceil(1,136,640 / 128) + 256 columns and ceil((500,096 + 1,136,640 // 256)
# / 128) row slices a side
MB_SELL_COLS, MB_SELL_TILES = 9_136, 3_942
PALLAS_KERNELS = ("pallas_fwd", "pallas_bwd_dst", "pallas_segsum")

# bench.py's 'products-full' config: random_graph(2449029, 61859140, 100, 47)
# with heads 2,1,1 and outdims 64,32,16, trained full-graph; the default
# chunk budget (a quarter of free device memory) chunks its layout
PRODUCTS_FULL = dict(num_nodes=2_449_029, num_edges=61_859_140,
                     feature_dim=100, num_classes=47, seed=0)
PF_HEADS, PF_OUTDIMS = (2, 1, 1), (64, 32, 16)
# the chunked backward's kernels: K2 per dst chunk without packets, K4 per
# src chunk (SELL); K6 and K8 (edge tiles)
CHUNKED_SELL_KERNELS = ("sell_fwd", "sell_bwd_dst", "sell_bwd_src")
CHUNKED_PALLAS_KERNELS = ("pallas_fwd", "pallas_bwd_dst", "pallas_bwd_src")
# the chunk count the chunk-invariance phase forces on arxiv / arxiv-pl
FORCED_CHUNKS = 3
# K4 and K8, per feature per real edge: add zd, LeakyReLU (compare +
# multiply), multiply by a and the score sum's add, g*zs and the dalpha
# sum's add, ds (two multiplies), c1 = alpha*g + ds (a multiply and an add)
# and dzs's add; the per-head exp and de are D times rarer and not counted
K4_OPS_PER_FEATURE = 12
K8_OPS_PER_FEATURE = K4_OPS_PER_FEATURE
# a remat epoch's loss against the same epoch without remat: the forward is
# the same computation, so only a different GEMM or reduction order could
# move it
REMAT_RTOL = 1e-6
# the multi-epoch runners: RUNNER_EPOCHS epochs checked against as many
# Trainer.step calls (the same epoch body on the same card: bit-equal, held
# to RUNNER_ATOL) with no wait for the device; then the per-epoch ms by
# differencing runs of k1 and k2 epochs, reps times (bench.py's
# _differenced_timing), with (k1, k2, reps) from bench.py's _rep_plan tier
# of the graph's edge count: >= 500 k, >= 4 M, >= 30 M
RUNNER_EPOCHS = TRAIN_EPOCHS
RUNNER_ATOL = 1e-6
RUNNER_PLANS = {"arxiv": (8, 40, 5), "products-sub": (1, 3, 5),
                "products-full": (1, 2, 3)}
# the sharded runner on 2 gloo ranks sharing the card: an epoch takes ~25x
# a single process's there, and the arxiv tier would cost ~70 s
SHARDED_RUNNER_PLAN = (2, 6, 3)

KERNELS = {
    "sell_fwd": dict(
        fn=sell_fwd, route="cuda", source="gatv2_tpu_torch/csrc/sell_fwd.cu",
        replaces="gatv2_tpu/ops/sell_attention.py:802",
    ),
    "sell_bwd_dst": dict(
        fn=sell_bwd_dst, route="cuda",
        source="gatv2_tpu_torch/csrc/sell_bwd_dst.cu",
        replaces="gatv2_tpu/ops/sell_attention.py:968",
    ),
    "sell_segsum": dict(
        fn=sell_segsum, route="cuda",
        source="gatv2_tpu_torch/csrc/sell_segsum.cu",
        replaces="gatv2_tpu/ops/sell_attention.py:1334",
    ),
    "pallas_fwd": dict(
        fn=pallas_fwd, route="cuda",
        source="gatv2_tpu_torch/csrc/pallas_fwd.cu",
        replaces="gatv2_tpu/ops/pallas_attention.py:680",
    ),
    "pallas_bwd_dst": dict(
        fn=pallas_bwd_dst, route="cuda",
        source="gatv2_tpu_torch/csrc/pallas_bwd_dst.cu",
        replaces="gatv2_tpu/ops/pallas_attention.py:942",
    ),
    "pallas_segsum": dict(
        fn=pallas_segsum, route="cuda",
        source="gatv2_tpu_torch/csrc/pallas_segsum.cu",
        replaces="gatv2_tpu/ops/pallas_attention.py:1150",
    ),
    "sell_bwd_src": dict(
        fn=sell_bwd_src, route="cuda",
        source="gatv2_tpu_torch/csrc/sell_bwd_src.cu",
        replaces="gatv2_tpu/ops/sell_attention.py:1173",
    ),
    "pallas_bwd_src": dict(
        fn=pallas_bwd_src, route="cuda",
        source="gatv2_tpu_torch/csrc/pallas_bwd_src.cu",
        replaces="gatv2_tpu/ops/pallas_attention.py:1254",
    ),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over reps runs, timed with CUDA events
    after warmup runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, rtol, atol) -> float:
    """Max abs error of got vs want [rows, cols]; fails unless every
    element is within atol + rtol * (the largest |want| in its row). A
    row's sums carry rounding relative to the size of their terms, not of
    their result, which cancellation can make small (the raw accumulator
    of normalize=False sums up to 256 weighted rows)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    row_scale = want.abs().amax(dim=-1, keepdim=True)
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / (row_scale + atol)).max()) if err.numel() else 0.0
    ok = bool(torch.all(err <= atol + rtol * row_scale))
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(of the row's largest value; rtol={rtol:g}, atol={atol:g}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees beyond rtol={rtol:g}, atol={atol:g}")
    return max_abs


def compare_f64(name, got, twin, ref64) -> float:
    """got (a kernel's fp32 result) and twin (its fp32 plain version)
    against ref64 (the plain version in float64); fails if got's max abs
    error exceeds F64_FACTOR x the twin's, or F64_FLOOR x max |ref64|.
    Returns got's max abs difference from the twin."""
    if not got.numel():
        return 0.0
    e_got = float((got.double() - ref64).abs().max())
    e_twin = float((twin.double() - ref64).abs().max())
    scale = float(ref64.abs().max())
    ok = e_got <= max(F64_FACTOR * e_twin, F64_FLOOR * scale)
    print(f"  {name}: max_abs_err vs float64 {e_got:.3e} (fp32 twin "
          f"{e_twin:.3e}; largest |value| {scale:.3e}; allowed "
          f"{F64_FACTOR:g}x the twin's or {F64_FLOOR:g}x the largest) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} is further from float64 than allowed")
    return float((got - twin).abs().max())


def k1_inputs(zs, zd, a, st):
    """K1's inputs for an unchunked layout on the card."""
    side = st.dst
    return (zs, zd, a, side.perm, side.ids_grp[0], side.cnt_grp[0],
            side.rel_off[0])


def chunk_rows(side, spc, chunk):
    """The perm rows of one chunk of a SELL side."""
    return side.perm[chunk * spc * TILE_N: (chunk + 1) * spc * TILE_N]


def sell_counts(perm, ids, cnt, rel):
    """What one K1 or K2 launch on a SELL side's rows must touch, from the
    launch's own perm rows, gather ids, column counts and slice offsets:
    its real edges, the distinct sources they read, the distinct nodes of
    its rows with an edge, and its rows, columns and slice offsets."""
    cnt, rel = cnt.long(), rel.long()
    real = real_slots(cnt)
    widths = rel[1:] - rel[:-1]
    first = cnt[rel[:-1].clamp(max=max(cnt.numel() - 1, 0))]
    row_used = (torch.where(widths > 0, first, 0)[:, None]
                > torch.arange(TILE_N, device=cnt.device)).reshape(-1)
    return dict(
        e=int(real.sum()), n_src=int(torch.unique(ids[real]).numel()),
        n_dst=int(torch.unique(perm[row_used]).numel()),
        rows=perm.numel(), cols=int(rel[-1]), offsets=rel.numel())


def dst_chunk_counts(st, chunk):
    """sell_counts of one K1 or K2 launch on dst chunk `chunk` of the SELL
    layout st (on the card; chunk 0 of an unchunked layout is all of
    it)."""
    side = st.dst
    return sell_counts(chunk_rows(side, st.spc_dst, chunk),
                       side.ids_grp[chunk], side.cnt_grp[chunk],
                       side.rel_off[chunk])


def k1_k2_bounds(c, hd, heads, packets):
    """{kernel: (bound_ms, bound_by, floor_ms)} of one K1 and one K2 launch
    with the counts c of dst_chunk_counts. The bound: each input read once
    (zs rows an edge reads, zd rows, and for K2 g rows, sigma and r, of
    nodes with an in-edge; the perm rows, the ids of real slots, the column
    counts and offsets, a), each output written once (K1: out, m, l per
    row; K2: dzd rows, d_a and, with packets, one c1 row per real edge).
    The per-edge gather floor: the same with one zs row per real edge in
    32-byte sectors in place of each used zs row once (no source reuse on a
    random graph whose zs table outgrows the L2)."""
    layout = c["e"] + c["rows"] + c["cols"] + c["offsets"]
    zs_once = c["n_src"] * hd
    zs_per_edge = c["e"] * (-(-hd * 4 // 32) * 8)  # in floats
    k1 = c["n_dst"] * hd + layout + hd + c["rows"] * (hd + 2 * heads)
    k2 = (2 * c["n_dst"] * hd + 2 * c["n_dst"] * heads + layout + 2 * hd
          + c["rows"] * hd + (c["e"] * hd if packets else 0))
    out = {}
    for name, rest, per_feature in (("sell_fwd", k1, K1_OPS_PER_FEATURE),
                                    ("sell_bwd_dst", k2, K2_OPS_PER_FEATURE)):
        bound, by = _bound(4 * (zs_once + rest),
                           c["e"] * hd * per_feature)
        floor, _ = _bound(4 * (zs_per_edge + rest), 0)
        out[name] = (bound, by, floor)
    return out


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_bound_ms(st_host, hd):
    """(bound_ms, bound_by) of one K3 launch: one c1 row and one ell_perm
    entry per real edge and the src layout's real columns read, dzs rows
    written (a fixed layout's tail columns and its num_edges of -1 do not
    count)."""
    rows = st_host.num_src_tiles * TILE_N
    e = int(st_host.srcs.cnt.sum())
    cols = int(st_host.srcs.col_off[-1])
    nbytes = 4 * (e * hd + e + cols + st_host.num_src_tiles + 1 + rows * hd)
    return _bound(nbytes, e * hd * K3_OPS_PER_FEATURE)


def k3_library_index(st_host):
    """[e_ell] int64: the src row whose sum K3 adds each dst-ELL slot into
    (padding slots -> a spare last row), so that one index_add_ computes
    K3's function: the library call K3 is timed against."""
    s = st_host.srcs
    rows = st_host.num_src_tiles * TILE_N
    slot = np.arange(s.cnt.shape[0] * TILE_N)
    col, r = slot // TILE_N, slot % TILE_N
    real = r < s.cnt[col]
    row = (np.searchsorted(s.col_off, col, side="right") - 1) * TILE_N + r
    idx = np.full(st_host.e_ell, rows, np.int64)
    idx[st_host.ell_perm[real]] = row[real]
    return idx


def real_slots(cnt):
    """[Ec] bool on cnt's device: the ELL slots that hold an edge."""
    lane = torch.arange(TILE_N, device=cnt.device)
    return (lane[None, :] < cnt[:, None].long()).reshape(-1)


def zero_counters():
    for k in KERNELS.values():
        k["fn"].launches = 0
    # K1's and K5's launches with normalize=False (the merged-softmax ops)
    sell_fwd.raw_launches = pallas_fwd.raw_launches = 0
    # head groups whose forward a remat recompute took from the first call
    tsa.sell_attention.reused = tpa.edge_attention_pallas.reused = 0


def read_counters():
    return {n: k["fn"].launches for n, k in KERNELS.items()}


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: not available"
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(f"nvidia-smi: {smi_line}")
    return smi_line


def phase_build():
    """Every CUDA source (one nvcc each) and the native sampler library
    (g++), all started together."""
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as ex:
        native = ex.submit(native_loader.build)
        libs = dict(zip(names, ex.map(build.build, names)))
        native_so = native.result()
    print(f"built {', '.join(names)} and {native_so.name} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(build.NVCC_FLAGS)}; g++ "
          f"{' '.join(native_loader.CXX_FLAGS)})")
    for name, so in libs.items():
        log = so.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if re.search(r"registers|spill|smem", line):
                print(f"  {name}: {line.strip()}")
    missing = set(KERNELS) - set(names)
    if missing:
        fail(f"no source for kernels {sorted(missing)}")


def make_graph(name):
    gen = powerlaw_graph if name.endswith("-pl") else random_graph
    kw = dict(alpha=1.2) if name.endswith("-pl") else {}
    return gen(**ARXIV, **kw)


def phase_main_path(dev):
    """Set up both graphs, then drive the main path once with the launch
    counters zeroed just before and read just after."""
    config = ModelConfig(
        num_layers=3, heads=HEADS, out_dims=OUTDIMS,
        num_classes=ARXIV["num_classes"], in_dim=ARXIV["feature_dim"],
    )
    model = init_params(config, torch.Generator().manual_seed(0)).to(dev)
    runs = {}
    for name in ("arxiv", "arxiv-pl"):
        t0 = time.perf_counter()
        g = make_graph(name)
        t1 = time.perf_counter()
        st, feats, labels, num_valid = setup_full_graph_sell(
            g, HEADS, OUTDIMS, device=dev
        )
        t2 = time.perf_counter()
        print(f"{name}: N={g.num_nodes} E={g.num_edges} "
              f"dst slices={st.num_dst_tiles} e_ell={st.e_ell} "
              f"pad={st.pad_overhead:.4f} split={st.dst.split} "
              f"chunks={st.num_chunks}; graph {t1 - t0:.2f} s, "
              f"layout {t2 - t1:.2f} s")
        runs[name] = dict(
            graph=g, st_host=st, st=st.to(dev),
            feats=torch.as_tensor(feats, device=dev),
            labels=torch.as_tensor(labels, device=dev), num_valid=num_valid,
            src=torch.as_tensor(g.src, device=dev),
            dst=torch.as_tensor(g.dst, device=dev),
        )

    zero_counters()
    with torch.inference_mode():
        for name, r in runs.items():
            before = sell_fwd.launches
            r["logits"] = model_forward(
                model, r["feats"], None, None, config, impl="sell",
                edge_tiles=r["st"], device=dev,
            )[: r["graph"].num_nodes]
            torch.cuda.synchronize()
            r["launches"] = sell_fwd.launches - before
    launches = read_counters()
    print(f"inference main path launches: {launches}")
    if launches["sell_fwd"] == 0:
        fail("kernel sell_fwd was not launched on the inference main path")

    model64 = copy.deepcopy(model).double()
    with torch.inference_mode():
        for name, r in runs.items():
            if r["launches"] < config.num_layers:
                fail(f"{name}: {r['launches']} K1 launches for "
                     f"{config.num_layers} layers")
            lg = r["logits"]
            if lg.shape != (r["graph"].num_nodes, config.num_classes) or \
                    not bool(torch.isfinite(lg).all()):
                fail(f"{name}: logits {tuple(lg.shape)} not finite/shaped")
            n = r["graph"].num_nodes
            ref = model_forward(
                model, r["feats"][:n], r["src"], r["dst"], config,
                impl="torch", device=dev,
            )
            ref64 = model_forward(
                model64, r["feats"][:n].double(), r["src"], r["dst"],
                config, impl="torch", device=dev,
            )
            scale = float(ref64.abs().max())
            errs = {k: float((v.double() - ref64).abs().max())
                    for k, v in (("sell", lg), ("torch", ref))}
            sell_vs_torch = float((lg - ref).abs().max())
            print(f"{name}: logits {tuple(lg.shape)} finite, "
                  f"{r['launches']} K1 launches; max |logit| {scale:.4f}; "
                  f"max abs err vs torch-float64: sell {errs['sell']:.3e}, "
                  f"torch {errs['torch']:.3e}; sell vs torch "
                  f"{sell_vs_torch:.3e} (tolerance {LOGIT_TOL:g} x max "
                  f"|logit|)")
            if sell_vs_torch > LOGIT_TOL * scale:
                fail(f"{name}: sell logits disagree with the torch path")
    return model, config, runs, launches


def phase_kernels_at_main_path(model, config, runs, card):
    """K1 vs its twin, and their times, at each main-path layer's shapes."""
    max_err = 0.0
    totals = {}
    with torch.inference_mode():
        for name, r in runs.items():
            st, g = r["st"], r["graph"]
            n = g.num_nodes
            deg = np.diff(g.row_ptr)
            counts = dst_chunk_counts(st, 0)
            x = r["feats"]
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                       floor_ms=0.0)
            for l, layer in enumerate(model.layers):
                zs, zd = layer.project(x, config.precision)
                a = layer.a.detach().contiguous()
                args = k1_inputs(zs, zd, a, st)
                norm = not st.dst.split
                kw = dict(negative_slope=SLOPE, normalize=norm)
                got = sell_fwd(*args, **kw)
                want = sell_fwd_plain(*args, **kw)
                for part, gv, wv in zip(("out", "m", "l"), got, want):
                    max_err = max(max_err, compare(
                        f"{name} layer {l} K1 {part} [{tuple(gv.shape)}, "
                        f"normalize={norm}]", gv, wv, K1_RTOL, K1_ATOL))
                ms = cuda_ms(lambda: sell_fwd(*args, **kw))
                plain_ms = cuda_ms(lambda: sell_fwd_plain(*args, **kw))
                hd = zs.shape[1]
                bound, by, floor = k1_k2_bounds(
                    counts, hd, a.shape[0], packets=True)["sell_fwd"]
                print(f"  {name} layer {l} H*D={hd}: K1 {ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by}), per-edge gather floor "
                      f"{floor:.4f} ms, twin {plain_ms:.3f} ms [{card}]")
                tot["ms"] += ms
                tot["floor_ms"] += floor
                tot["plain_ms"] += plain_ms
                tot["bound_ms"] += bound
                tot["bytes_ms"] += bound if by == "bytes" else 0.0
                if l == 0:
                    # isolated nodes: their outputs must be exactly 0
                    out, _ = sell_forward(
                        zs, zd, a, n, negative_slope=SLOPE, sell_tiles=st)
                    iso = torch.as_tensor(deg == 0, device=out.device)
                    print(f"  {name}: {int(iso.sum())} isolated nodes, "
                          f"outputs exactly 0: "
                          f"{bool((out[iso] == 0).all())}")
                    if int(iso.sum()) == 0 or not bool((out[iso] == 0).all()):
                        fail(f"{name}: isolated-node outputs are not 0")
                x = layer(x, None, None, is_last=l == len(model.layers) - 1,
                          config=config, impl="sell", edge_tiles=st)
            totals[name] = tot
            print(f"  {name} K1 per forward: {tot['ms']:.4f} ms, bound "
                  f"{tot['bound_ms']:.4f} ms, per-edge gather floor "
                  f"{tot['floor_ms']:.4f} ms, twin {tot['plain_ms']:.3f} ms "
                  f"[{card}]")
    return max_err, totals


def phase_kernel_cases(dev):
    """Layouts the main path does not reach at full size: chunked, 20 heads
    (head groups), bf16 streams. The op on the card (K1) against the op on
    the CPU (the twin), same inputs."""
    max_err = 0.0
    g = random_graph(20_000, 150_000, 8, 3, seed=5)
    gp = powerlaw_graph(20_000, 150_000, 8, 3, seed=6, alpha=1.2)
    rng = np.random.default_rng(0)
    cases = [
        ("uniform, num_chunks=3", g, 3, 4, 64, "f32"),
        ("power-law split, num_chunks=3", gp, 3, 2, 16, "f32"),
        ("H=20 (head groups), D=32", g, 1, 20, 32, "f32"),
        ("streams=bf16", gp, 1, 4, 64, "bf16"),
    ]
    for label, gr, chunks, h, d, streams in cases:
        n = gr.num_nodes
        st = prepare_sell_tiles(gr.row_ptr, gr.col_idx, n, num_chunks=chunks)
        zs, zd = (rng.standard_normal((n, h * d), dtype=np.float32)
                  for _ in range(2))
        a = (rng.standard_normal((h, d), dtype=np.float32)
             / np.sqrt(d)).astype(np.float32)
        kernel, twin = (
            sell_forward(
                *(torch.as_tensor(x, device=where) for x in (zs, zd, a)), n,
                negative_slope=SLOPE, sell_tiles=st.to(where),
                streams=streams,
            )
            for where in (dev, torch.device("cpu"))
        )
        print(f"case {label} (split={st.dst.split}, chunks={st.num_chunks}):")
        for part, i in (("out", 0), ("sigma", 1)):
            max_err = max(max_err, compare(
                f"{label} {part}", kernel[i].cpu(), twin[i],
                K1_RTOL, K1_ATOL))
    return max_err


def phase_forward_times(model, config, runs, dev, card):
    with torch.inference_mode():
        for name, r in runs.items():
            n = r["graph"].num_nodes
            torch.cuda.reset_peak_memory_stats(dev)
            sell_ms = cuda_ms(lambda: model_forward(
                model, r["feats"], None, None, config, impl="sell",
                edge_tiles=r["st"], device=dev))
            peak = torch.cuda.max_memory_allocated(dev)
            torch_ms = cuda_ms(lambda: model_forward(
                model, r["feats"][:n], r["src"], r["dst"], config,
                impl="torch", device=dev))
            print(f"{name} forward: sell {sell_ms:.3f} ms (peak memory "
                  f"{peak / 2**30:.2f} GiB), torch path {torch_ms:.3f} ms "
                  f"[{card}]")
            profile_fn(lambda: model_forward(
                model, r["feats"], None, None, config, impl="sell",
                edge_tiles=r["st"], device=dev), f"{name} sell forward",
                sell_ms, card)


def kernel_rows(fn, reps):
    """[(ms per call, launches per call, kernel name)] of fn's device
    kernels over reps calls (torch.profiler). The profiler can miss the
    kernels launched in its first milliseconds, so each kernel's time per
    call is its mean per captured launch times its launches per call
    (captured launches / reps, rounded up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device kernels only: a host op's self device time repeats theirs,
        # and so does a program span's device row (its user annotation)
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t > 0 and ev.count and \
                str(getattr(ev, "device_type", "")).endswith("CUDA") and \
                not getattr(ev, "is_user_annotation", False):
            per_call = -(-ev.count // reps)
            rows.append((t / 1e3 / ev.count * per_call, per_call, ev.key))
    return rows


def profile_fn(fn, what, wall_ms, card, reps=5):
    """Device time per call of fn by kernel (torch.profiler), and the share
    of the CUDA-event wall time the device was busy."""
    rows = kernel_rows(fn, reps)
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{what}, device time by kernel (torch.profiler, {reps} calls) "
          f"[{card}]: busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy / wall_ms:.0f}%)")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.4f} ms  x{count:<3d} {key[:90]}")


def device_ms(fn, kernels, reps=10):
    """Device time per call of fn spent in the kernels whose names contain
    one of `kernels` (kernel_rows): the kernels' own time, without the
    wrapper's host work, which cuda_ms also sees when a launch is short;
    nan if the profiler captured none of them."""
    ms = [t for t, _, key in kernel_rows(fn, reps)
          if any(k in key for k in kernels)]
    return sum(ms) if ms else float("nan")


# the device kernels of each wrapper, by name (K6, K7 and K8 also launch
# the merge of their hub segments)
DEVICE_KERNELS = {
    "sell_fwd": ("sell_fwd_kernel",),
    "sell_bwd_dst": ("sell_bwd_dst_kernel",),
    "sell_segsum": ("sell_segsum_kernel",),
    "pallas_fwd": ("pallas_fwd_kernel",),
    "pallas_bwd_dst": ("pallas_bwd_dst_kernel", "merge_segments"),
    "pallas_segsum": ("pallas_segsum_kernel", "merge_segments"),
    "pallas_bwd_src": ("pallas_bwd_src_kernel", "merge_segments"),
}


class LossSink:
    """A Trainer metrics sink that keeps each epoch's loss."""

    def __init__(self):
        self.losses = []

    def write(self, record):
        self.losses.append(record["loss"])


def make_trainer(graph, config, impl, model, dev):
    """A Trainer on `dev` from `model`'s weights (Adam, lr 0.01, clipping),
    printing nothing; its metrics sink keeps the losses."""
    tc = TrainConfig(epochs=TRAIN_EPOCHS, optimizer="adam", lr=0.01,
                     clip=True, seed=0, impl=impl)
    tr = Trainer(graph, config, tc, log_fn=lambda _: None,
                 metrics_sink=LossSink(), device=dev)
    tr.params = copy.deepcopy(model)
    return tr


def phase_train_main_path(model, config, runs, dev):
    """Drive the training main path: a sell Trainer per graph, TRAIN_EPOCHS
    epochs each, with every launch counter zeroed just before and read just
    after; then the torch path's Trainers from the same weights."""
    trainers = {name: make_trainer(r["graph"], config, "sell", model, dev)
                for name, r in runs.items()}
    torch.cuda.synchronize()
    zero_counters()
    for tr in trainers.values():
        tr.run()
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"training main path launches ({TRAIN_EPOCHS} epochs x "
          f"{len(trainers)} graphs): {launches}")
    for name in SELL_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the training main path")
    for name, r in runs.items():
        ref = make_trainer(r["graph"], config, "torch", model, dev)
        ref.run()
        got, want = trainers[name].metrics_sink.losses, ref.metrics_sink.losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"{name} training losses: sell {got}, torch {want}; max "
              f"relative difference {rel:.3e} (tolerance {LOSS_RTOL:g})")
        if not all(np.isfinite(got)) or rel > LOSS_RTOL:
            fail(f"{name}: sell training losses disagree with the torch path")
        r["trainer"], r["torch_trainer"] = trainers[name], ref
    return launches


def phase_gradients(model, config, runs, dev, paths=None, given=None):
    """One step's gradients of the loss: each path (by default sell, K1-K3;
    paths(r) maps a label to (impl, tiles, features, labels, num_valid);
    `given` adds {label: gradients} computed elsewhere) and the fp32 torch
    path, each against the torch path in float64, per parameter."""
    model64 = copy.deepcopy(model).double()
    names = optim.param_names(model)
    if paths is None:
        def paths(r):
            return {"sell": ("sell", r["st"], r["feats"], r["labels"],
                             r["num_valid"])}

    def grads(m, feats, src, dst, labels, impl, st=None, num_valid=None):
        loss, _ = loss_fn(m, feats, src, dst, labels, config, impl=impl,
                          edge_tiles=st, num_valid=num_valid)
        return torch.autograd.grad(loss, optim.param_leaves(m))

    for name, r in runs.items():
        n = r["graph"].num_nodes
        labels = r["labels"][:n]
        got = {label: grads(model, feats, None, None, lab, impl, tiles, nv)
               for label, (impl, tiles, feats, lab, nv) in paths(r).items()}
        got.update(given or {})
        g_torch = grads(model, r["feats"][:n], r["src"], r["dst"], labels,
                        "torch")
        g64 = grads(model64, r["feats"][:n].double(), r["src"], r["dst"],
                    labels, "torch")
        print(f"{name} gradients, max |error| vs the float64 torch path / "
              f"the parameter's largest |gradient|:")
        for i, pname in enumerate(names):
            scale = float(g64[i].abs().max()) or 1.0
            e_torch = float((g_torch[i].double() - g64[i]).abs().max()) / scale
            errs = {label: float((g[i].double() - g64[i]).abs().max()) / scale
                    for label, g in got.items()}
            ok = all(e <= max(GRAD_FACTOR * e_torch, GRAD_FLOOR)
                     for e in errs.values())
            print(f"  {pname:12s} " + "  ".join(
                f"{label} {e:.3e}" for label, e in errs.items())
                + f"  torch {e_torch:.3e}  {'ok' if ok else 'TOO FAR'}")
            if not ok:
                fail(f"{name}: a gradient of {pname} ({errs}) is more than "
                     f"{GRAD_FACTOR:g}x the torch path's distance (or "
                     f"{GRAD_FLOOR:g}) from float64")


def phase_bwd_kernels_at_main_path(model, config, runs, card):
    """K2 and K3 against their twins, and their times, at each main-path
    layer's shapes: the layer's projections, sigma from its forward, and a
    seeded random upstream gradient."""
    max_err = {"sell_bwd_dst": 0.0, "sell_segsum": 0.0}
    totals = {}
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for name, r in runs.items():
            st, sth = r["st"], r["st_host"]
            counts = dst_chunk_counts(st, 0)
            real = real_slots(st.dst.cnt)
            lib_idx = torch.as_tensor(k3_library_index(sth),
                                      device=real.device)
            rows_src = sth.num_src_tiles * TILE_N
            x = r["feats"]
            tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                           library_ms=0.0, floor_ms=0.0) for k in max_err}
            for l, layer in enumerate(model.layers):
                zs, zd = layer.project(x, config.precision)
                a = layer.a.detach().contiguous()
                heads, hd = a.shape[0], zs.shape[1]
                out, sigma = sell_forward(zs, zd, a, x.shape[0],
                                          negative_slope=SLOPE, sell_tiles=st)
                gout = torch.as_tensor(rng.standard_normal(
                    (x.shape[0], hd), dtype=np.float32), device=x.device)
                rr = (gout * out).view(-1, heads, hd // heads).sum(-1)
                args = (zs, zd, gout, sigma, rr, a, st.dst.perm,
                        st.dst.gather_ids, st.dst.cnt, st.dst.col_off)
                kw = dict(negative_slope=SLOPE)
                dzd, da, c1 = sell_bwd_dst(*args, **kw)
                w_dzd, w_da, w_c1 = sell_bwd_dst_plain(*args, **kw)
                w64 = sell_bwd_dst_plain(
                    *(t.double() for t in args[:6]), *args[6:], **kw)
                tag = f"{name} layer {l} K2"
                e = max(
                    compare(f"{tag} c1 real slots [{int(real.sum())}, {hd}]",
                            c1[real], w_c1[real], K1_RTOL, K1_ATOL),
                    compare_f64(f"{tag} dzd [{tuple(dzd.shape)}]", dzd,
                                w_dzd, w64[0]),
                    compare_f64(f"{tag} d_a [{tuple(da.shape)}]", da, w_da,
                                w64[1]))
                max_err["sell_bwd_dst"] = max(max_err["sell_bwd_dst"], e)
                del w_dzd, w_c1, w64
                # K3 on K2's packets, its unwritten padding slots poisoned
                c1[~real] = float("nan")
                k3_args = (c1, st.ell_perm, st.srcs.cnt, st.srcs.col_off)
                dzs = sell_segsum(*k3_args)
                if not bool(torch.isfinite(dzs).all()):
                    fail(f"{name} layer {l}: K3 read a padding slot")
                w_dzs = sell_segsum_plain(*k3_args)
                lib = torch.zeros(rows_src + 1, hd, device=c1.device
                                  ).index_add_(0, lib_idx, c1)
                k3_tag = f"{name} layer {l} K3 dzs [{tuple(dzs.shape)}]"
                max_err["sell_segsum"] = max(
                    max_err["sell_segsum"],
                    compare_f64(k3_tag, dzs, w_dzs, sell_segsum_plain(
                        c1.double(), *k3_args[1:])))
                compare_f64(f"{name} layer {l} index_add_ (library) dzs",
                            lib[:rows_src], w_dzs, sell_segsum_plain(
                                c1.double(), *k3_args[1:]))
                del w_dzs, lib
                times = {
                    "sell_bwd_dst": (
                        cuda_ms(lambda: sell_bwd_dst(*args, **kw)),
                        cuda_ms(lambda: sell_bwd_dst_plain(*args, **kw),
                                reps=3, warmup=1),
                        k1_k2_bounds(counts, hd, heads,
                                     packets=True)["sell_bwd_dst"], 0.0),
                    "sell_segsum": (
                        cuda_ms(lambda: sell_segsum(*k3_args)),
                        cuda_ms(lambda: sell_segsum_plain(*k3_args),
                                reps=3, warmup=1),
                        (*k3_bound_ms(sth, hd), None),
                        cuda_ms(lambda: torch.zeros(
                            rows_src + 1, hd, device=c1.device
                        ).index_add_(0, lib_idx, c1))),
                }
                for k, (ms, plain_ms, (bound, by, floor), lib_ms) in \
                        times.items():
                    lib_txt = f", index_add_ {lib_ms:.4f} ms" if lib_ms else ""
                    floor_txt = (f", per-edge gather floor {floor:.4f} ms"
                                 if floor else "")
                    print(f"  {name} layer {l} H*D={hd}: {k} {ms:.4f} ms, "
                          f"bound {bound:.4f} ms ({by}){floor_txt}, twin "
                          f"{plain_ms:.3f} ms{lib_txt} [{card}]")
                    t = tot[k]
                    t["ms"] += ms
                    t["floor_ms"] += floor or 0.0
                    t["plain_ms"] += plain_ms
                    t["bound_ms"] += bound
                    t["bytes_ms"] += bound if by == "bytes" else 0.0
                    t["library_ms"] += lib_ms
                del c1, dzd, dzs
                x = layer(x, None, None, is_last=l == len(model.layers) - 1,
                          config=config, impl="sell", edge_tiles=st)
            totals[name] = tot
            for k, t in tot.items():
                print(f"  {name} {k} per backward: {t['ms']:.4f} ms, bound "
                      f"{t['bound_ms']:.4f} ms"
                      + (f", per-edge gather floor {t['floor_ms']:.4f} ms"
                         if t["floor_ms"] else "")
                      + f", twin {t['plain_ms']:.3f} ms"
                      + (f", index_add_ {t['library_ms']:.4f} ms"
                         if t["library_ms"] else "") + f" [{card}]")
    return max_err, totals


def _hub_and_isolated(n=2000):
    """Node 0 a hub of in-degree 1500 (split rows), nodes 1..500 without
    an in-edge."""
    rng = np.random.default_rng(7)
    deg = np.zeros(n, np.int64)
    deg[0] = 1500
    deg[501:] = rng.integers(0, 6, size=n - 501)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col_idx = rng.integers(0, n, size=int(row_ptr[-1]))
    return Graph(rng.standard_normal((n, 8)).astype(np.float32), row_ptr,
                 col_idx, rng.integers(0, 3, size=n))


def phase_bwd_cases(dev):
    """Layouts the main path does not reach at full size: 20 heads (head
    groups), bf16 streams, isolated nodes beside a split hub, no edges.
    The op's gradients on the card (K1-K3) and on the CPU (the twins), same
    inputs and upstream gradient, each against the torch path's gradients
    in float64 (on the bf16-rounded projections with streams='bf16': the
    op's gradient passes straight through the rounding)."""
    max_err = 0.0
    g = random_graph(5_000, 40_000, 8, 3, seed=5)
    gp = powerlaw_graph(20_000, 150_000, 8, 3, seed=6, alpha=1.2)
    empty = Graph(np.zeros((1000, 8), np.float32), np.zeros(1001, np.int64),
                  np.zeros(0, np.int32), np.zeros(1000, np.int32))
    rng = np.random.default_rng(1)
    cases = [
        ("H=20 (head groups), D=32", g, 20, 32, "f32"),
        ("streams=bf16, power-law split", gp, 4, 64, "bf16"),
        ("isolated nodes beside a split hub", _hub_and_isolated(), 4, 16,
         "f32"),
        ("no edges", empty, 2, 16, "f32"),
    ]
    for label, gr, h, d, streams in cases:
        n = gr.num_nodes
        st = prepare_sell_tiles(gr.row_ptr, gr.col_idx, n)
        zs, zd, w = (rng.standard_normal((n, h * d), dtype=np.float32)
                     for _ in range(3))
        a = (rng.standard_normal((h, d), dtype=np.float32)
             / np.sqrt(d)).astype(np.float32)
        res = []
        for where in (dev, torch.device("cpu")):
            x = [torch.as_tensor(v, device=where).requires_grad_()
                 for v in (zs, zd, a)]
            out = sell_attention(*x, n, negative_slope=SLOPE,
                                 sell_tiles=st.to(where), streams=streams)
            (out * torch.as_tensor(w, device=where)).sum().backward()
            res.append([v.grad.cpu() for v in x])
        x64 = [torch.as_tensor(v).double() for v in (zs, zd, a)]
        if streams == "bf16":
            x64[:2] = [v.to(torch.bfloat16).double() for v in x64[:2]]
        for v in x64:
            v.requires_grad_()
        out64 = edge_attention(
            x64[0].view(n, h, d), x64[1].view(n, h, d), x64[2],
            torch.as_tensor(gr.src), torch.as_tensor(gr.dst), n,
            negative_slope=SLOPE, impl="torch")
        (out64.reshape(n, -1) * torch.as_tensor(w).double()).sum().backward()
        print(f"case {label} (split={st.dst.split}, chunks={st.num_chunks}, "
              f"H*D={h * d}):")
        for part, kern, twin, ref in zip(("d_zs", "d_zd", "d_a"), *res,
                                         [v.grad for v in x64]):
            max_err = max(max_err, compare_f64(f"{label} {part}", kern,
                                               twin, ref))
        no_in = torch.as_tensor(np.diff(gr.row_ptr) == 0)
        if not bool((res[0][1][no_in] == 0).all()):
            fail(f"{label}: d_zd of nodes without an in-edge is not 0")
    return max_err


def phase_epoch_times(runs, dev, card):
    """Epoch ms of the sell and torch Trainers (CUDA events around
    Trainer.step, which ends with the loss's read-back), the peak memory of
    a sell epoch and a profiler table of one sell step."""
    for name, r in runs.items():
        tr, ref = r["trainer"], r["torch_trainer"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        tr.step()
        peak = torch.cuda.max_memory_allocated(dev)
        sell_ms = cuda_ms(tr.step, reps=5, warmup=1)
        torch_ms = cuda_ms(ref.step, reps=5, warmup=1)
        print(f"{name} training epoch: sell {sell_ms:.3f} ms (peak memory "
              f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above "
              f"the resident {base / 2**30:.2f} GiB), torch path "
              f"{torch_ms:.3f} ms [{card}]")
        profile_fn(tr.step, f"{name} sell training step", sell_ms, card)


def _where(filename, lineno):
    path = pathlib.Path(filename)
    if path.is_relative_to(ROOT):
        path = path.relative_to(ROOT)
    return f"{path}:{lineno}"


def host_syncs(fn):
    """The file:line of each wait for the device that fn() makes, as
    torch.cuda.set_sync_debug_mode('warn') reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted({_where(w.filename, w.lineno) for w in caught
                   if "called a synchronizing CUDA operation"
                   in str(w.message)})


def without_host_sync(fn):
    """fn() under torch.cuda.set_sync_debug_mode('error'): a wait for the
    device raises RuntimeError."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_runner(tag, tr, kernels, plan, card, step_reps=5):
    """make_multi_epoch_runner on Trainer tr's layout and weights: the host
    syncs of one Trainer.step (listed); RUNNER_EPOCHS runner epochs under
    set_sync_debug_mode('error'), the counters zeroed just before and read
    just after, their losses read back after it; as many Trainer.step
    calls from the same start (the same losses to RUNNER_ATOL; each of
    `kernels` launched RUNNER_EPOCHS times as often as by the first step,
    and at least once); the runner's differenced epoch ms beside
    Trainer.step's (CUDA events). Returns the runner's launches, its
    median epoch ms and its timed run (run_k(k): k epochs from the same
    start)."""
    mc, tc = tr.model_config, tr.train_config

    def next_epoch():
        tr.epoch += 1  # Adam's t, as Trainer.run advances it
        return tr.step()

    syncs = host_syncs(next_epoch)
    print(f"{tag}: waits for the device in one Trainer.step "
          f"(set_sync_debug_mode('warn')): {syncs}")
    if not syncs:
        fail(f"{tag}: set_sync_debug_mode('warn') saw no wait in "
             f"Trainer.step, whose loss read-back waits")
    start = (copy.deepcopy(tr.params), copy.deepcopy(tr.opt_state), tr.epoch)
    args = (tr.features, tr.src, tr.dst, tr.labels)
    run = make_multi_epoch_runner(mc, tc, RUNNER_EPOCHS,
                                  edge_tiles=tr.edge_tiles,
                                  num_valid=tr.num_valid)
    params, opt = copy.deepcopy(start[0]), copy.deepcopy(start[1])
    torch.cuda.synchronize()
    zero_counters()
    try:
        _, _, losses, _ = without_host_sync(
            lambda: run(params, opt, start[2], *args))
    except RuntimeError as e:
        fail(f"{tag}: the runner waited for the device: {e}")
    torch.cuda.synchronize()
    launches = read_counters()
    losses = losses.tolist()  # the read-back, after the mode is reset
    tr.params = copy.deepcopy(start[0])
    tr.opt_state = copy.deepcopy(start[1])
    tr.epoch = start[2]
    want, per_epoch = [], None
    for _ in range(RUNNER_EPOCHS):
        before = read_counters()
        want.append(next_epoch()[0])
        if per_epoch is None:
            per_epoch = {k: v - before[k] for k, v in read_counters().items()}
    err = max(abs(a - b) for a, b in zip(losses, want))
    print(f"{tag}: runner losses {losses}, Trainer.step {want}: max abs "
          f"difference {err:.3e} (tolerance {RUNNER_ATOL:g}; bit-equal: "
          f"{losses == want}); launches {RUNNER_EPOCHS} runner epochs "
          f"{ {k: launches[k] for k in kernels} }, one Trainer.step "
          f"{ {k: per_epoch[k] for k in kernels} }")
    if not all(np.isfinite(losses)) or err > RUNNER_ATOL:
        fail(f"{tag}: the runner's losses differ from Trainer.step's")
    for k in kernels:
        if launches[k] == 0 or launches[k] != RUNNER_EPOCHS * per_epoch[k]:
            fail(f"{tag}: {k} launched {launches[k]} times in "
                 f"{RUNNER_EPOCHS} runner epochs, {per_epoch[k]} in one "
                 f"Trainer.step")
    runners = {k: make_multi_epoch_runner(mc, tc, k, edge_tiles=tr.edge_tiles,
                                          num_valid=tr.num_valid)
               for k in plan[:2]}
    def run_k(k):
        return runners[k](params, opt, start[2], *args)

    diffs = differenced_ms({
        "runner": run_k,
        "Trainer.step": lambda k: [next_epoch() for _ in range(k)],
    }, plan)
    step_ms = cuda_ms(tr.step, reps=step_reps, warmup=1)
    ratio = float(np.median(diffs["runner"])) / float(
        np.median(diffs["Trainer.step"]))
    print(f"{tag}: runner epoch {timing_line(diffs['runner'], plan)}; "
          f"Trainer.step epoch, timed the same way in turns with it, "
          f"{timing_line(diffs['Trainer.step'], plan)}, and {step_ms:.3f} "
          f"ms as a mean of {step_reps} calls after 1; runner / step "
          f"(medians) {ratio:.3f} [{card}]")
    return launches, float(np.median(diffs["runner"])), run_k


def phase_runners(model, config, runs, dev, card):
    """The multi-epoch runner at arxiv full width, on impl='sell' (K1-K3:
    phase 5's Trainer) and impl='pallas' (K5-K7: a Trainer from the start
    weights), through check_runner; first whether building a tensor from a
    Python scalar with torch.tensor(x, device=cuda) (what apply_updates
    did three times a step before optim.step_count) waits for the device,
    and that step_count does not. Returns the runners' launches and their
    median epoch ms and timed runs by impl."""
    waits = {}
    for name, fn in (
            ("torch.tensor(t, device=cuda)",
             lambda: torch.tensor(3.0, dtype=torch.float32, device=dev)),
            ("optim.step_count(t, cuda)", lambda: optim.step_count(3, dev))):
        try:
            without_host_sync(fn)
            waits[name] = False
        except RuntimeError:
            waits[name] = True
    print(f"waits for the device under set_sync_debug_mode('error'): {waits}")
    if waits["optim.step_count(t, cuda)"]:
        fail("optim.step_count waits for the device")
    g = runs["arxiv"]["graph"]
    trainers = {"sell": runs["arxiv"]["trainer"],
                "pallas": make_trainer(g, config, "pallas", model, dev)}
    total = dict.fromkeys(KERNELS, 0)
    epoch_ms, run_k = {}, {}
    for impl, kernels in (("sell", SELL_KERNELS), ("pallas", PALLAS_KERNELS)):
        launches, epoch_ms[impl], run_k[impl] = check_runner(
            f"arxiv {impl} runner", trainers[impl], kernels,
            RUNNER_PLANS["arxiv"], card)
        for k, v in launches.items():
            total[k] += v
    return total, epoch_ms, run_k


def phase_train_entry():
    """python -m gatv2_tpu_torch.train on karate with a checkpoint, then
    predict from that checkpoint, as a user would run them."""
    arch = ["--num-layers", "2", "--heads", "4,1", "--outdims", "16,16"]
    common = ["--dataset", "karate", "--data-root", "./data", *arch]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        ck, odir = pathlib.Path(tmp, "ck"), pathlib.Path(tmp, "p")
        proc = subprocess.run(
            [sys.executable, "-m", "gatv2_tpu_torch.train", *common,
             "--epochs", "5", "--optimizer", "adam", "--lr", "0.01",
             "--clip", "--seed", "1", "--checkpoint-dir", str(ck)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        print("train: " + " | ".join(lines[-6:]))
        if proc.returncode != 0:
            fail(f"train exited {proc.returncode}: {proc.stderr[-2000:]}")
        if sum(l.startswith("Avg Loss: ") for l in lines) != 5:
            fail("train did not print 5 epochs")
        for tag, kname in (("K1", "sell_fwd"), ("K2", "sell_bwd_dst"),
                           ("K3", "sell_segsum")):
            m = re.search(rf"{tag} {kname} launches: (\d+)", proc.stdout)
            if not m or int(m.group(1)) < 10:
                fail(f"train did not show its {tag} launches")
        proc = subprocess.run(
            [sys.executable, "-m", "gatv2_tpu_torch.predict", *common,
             "--checkpoint-dir", str(ck), "--out", str(odir)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        print("predict from the checkpoint: "
              + " ".join(proc.stdout.strip().splitlines()))
        if proc.returncode != 0:
            fail(f"predict exited {proc.returncode}: {proc.stderr[-2000:]}")
        preds = np.loadtxt(odir / "predictions.txt", dtype=np.int64, ndmin=1)
        if preds.shape != (34,) or "epoch 5" not in proc.stdout:
            fail("predict from the checkpoint wrote no predictions")


def phase_predict(dev):
    graph = load_dataset("digits", str(ROOT / "data"))
    config = ModelConfig(
        num_layers=2, heads=(4, 1), out_dims=(16, 16),
        num_classes=graph.num_classes, in_dim=graph.feature_dim,
    )
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        wdir, odir = pathlib.Path(tmp, "w"), pathlib.Path(tmp, "p")
        save_params_txt(wdir, init_params(config, torch.Generator().manual_seed(1)))
        cmd = [sys.executable, "-m", "gatv2_tpu_torch.predict",
               "--dataset", "digits", "--data-root", "./data",
               "--load-weights", str(wdir), "--num-layers", "2",
               "--heads", "4,1", "--outdims", "16,16", "--impl", "sell",
               "--out", str(odir)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        print("predict: " + " ".join(proc.stdout.strip().splitlines()))
        if proc.returncode != 0:
            fail(f"predict exited {proc.returncode}: {proc.stderr[-2000:]}")
        preds = np.loadtxt(odir / "predictions.txt", dtype=np.int64, ndmin=1)
        if preds.shape != (graph.num_nodes,):
            fail(f"predictions.txt has {preds.shape} labels, "
                 f"want {graph.num_nodes}")
        m = re.search(r"K1 sell_fwd launches: (\d+)", proc.stdout)
        if not m or int(m.group(1)) < config.num_layers:
            fail("predict did not show its K1 launches")


# ---------------------------------------------------------------------------
# the third main path: sampled-minibatch training through K5, K6 and K7
# ---------------------------------------------------------------------------


def minibatch_trainer(graph, config, splits, impl, dev):
    """A MinibatchTrainer as `python -m gatv2_tpu_torch.train --batch-size
    1024 --fanouts 10,10,10 --optimizer adam --lr 0.01 --clip` builds it
    (native sampler, budget auto, device-resident features), printing
    nothing; weights from torch.Generator().manual_seed(0)."""
    tc = TrainConfig(epochs=1, optimizer="adam", lr=0.01, clip=True, seed=0,
                     impl=impl, batch_size=MB_BATCH, fanouts=MB_FANOUTS,
                     sampler_engine="native", sample_budget="auto",
                     feature_residency="device")
    return MinibatchTrainer(graph, config, tc, log_fn=lambda _: None,
                            splits=splits, device=dev)


def drive_minibatch(tr, what, kernels):
    """Drive the minibatch trainer tr: MB_WARMUP warm-up and MB_TIMED timed
    batches through the prefetching sampler, every launch counter zeroed
    just before and read just after; fails unless each of `kernels` was
    launched and every loss is finite. Returns (the first MB_CHECK
    batches, the losses, pipelined ms a timed batch, the launches)."""
    stream = prefetch(iter(tr.sampler), depth=2)
    kept, losses = [], []
    torch.cuda.synchronize()
    zero_counters()
    for i in range(MB_WARMUP + MB_TIMED):
        if i == MB_WARMUP:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        b = next(stream)
        if len(kept) < MB_CHECK:
            kept.append(b)
        losses.append(tr.train_step(b)[0])  # float(): waits for the step
    pipelined_ms = (time.perf_counter() - t_timed) * 1e3 / MB_TIMED
    torch.cuda.synchronize()
    launches = read_counters()
    stream.close()  # stops the prefetch thread
    print(f"{what} launches ({MB_WARMUP + MB_TIMED} batches): {launches}")
    for name in kernels:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the {what}")
    if not all(np.isfinite(losses)):
        fail(f"{what} losses are not finite: {losses}")
    return kept, losses, pipelined_ms, launches


def phase_minibatch_main_path(dev, card):
    """Drive the minibatch main path: 3 warm-up and 30 timed batches of
    MinibatchTrainer(impl='pallas') through the prefetching sampler, the
    K5/K6/K7 counters zeroed just before and read just after; then the
    step and pipeline times and one exact full-graph evaluation."""
    t0 = time.perf_counter()
    g = random_graph(**PRODUCTS_SUB)
    splits = random_splits(g.num_nodes, (0.6, 0.2, 0.2), seed=0)
    config = ModelConfig(
        num_layers=3, heads=HEADS, out_dims=OUTDIMS,
        num_classes=PRODUCTS_SUB["num_classes"],
        in_dim=PRODUCTS_SUB["feature_dim"],
    )
    tr = minibatch_trainer(g, config, splits, "pallas", dev)
    s = tr.sampler
    print(f"products-sub: N={g.num_nodes} E={g.num_edges} F={g.feature_dim} "
          f"C={g.num_classes}; batch {MB_BATCH}, fanouts {list(MB_FANOUTS)}, "
          f"engine {s.engine}: max_nodes={s.max_nodes} "
          f"max_edges={s.max_edges} edge tiles={s._tile_budget}, "
          f"{s.batches_per_epoch()} batches per epoch; graph and trainer "
          f"{time.perf_counter() - t0:.2f} s")
    if (s.max_nodes, s.max_edges) != (MB_MAX_NODES, MB_MAX_EDGES):
        fail(f"sampler budget {s.max_nodes}/{s.max_edges}, want "
             f"{MB_MAX_NODES}/{MB_MAX_EDGES}")
    start = copy.deepcopy(tr.params)
    kept, losses, pipelined_ms, launches = drive_minibatch(
        tr, "minibatch main path", PALLAS_KERNELS)
    edges = [b.num_edges for b in kept]
    print(f"minibatch losses {losses[0]:.6f} -> {losses[-1]:.6f}; real "
          f"edges per batch {edges}, real nodes {[b.num_nodes for b in kept]}")

    # times: the step on one batch replayed (host-to-device copies of its
    # ids and tiles included), host sampling + tile emission alone, and the
    # pipelined batches above against them (tools/bench_minibatch.py's
    # pipeline_ratio: 1.0 = the device never waits for the host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tr.train_step(kept[0])
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = cuda_ms(lambda: tr.train_step(kept[0]), reps=10, warmup=1)
    rng = np.random.default_rng(0)
    pool = np.nonzero(splits.train)[0]
    seed_sets = [np.sort(rng.choice(pool, size=MB_BATCH, replace=False))
                 for _ in range(5)]
    t0 = time.perf_counter()
    for seeds in seed_sets:
        s.sample(seeds)
    sample_ms = (time.perf_counter() - t0) * 1e3 / 5
    # its two native parts alone: the neighbour sample, the tile emission
    b = kept[0]
    t0 = time.perf_counter()
    native_loader.sample_batch(
        s._row_ptr64, g.col_idx, seed_sets[0].astype(np.int32),
        np.asarray(MB_FANOUTS, np.int32), s.max_nodes, s.max_edges, 1)
    t1 = time.perf_counter()
    native_loader.emit_tiles(b.src, b.dst, b.num_edges, s.max_nodes, 128,
                             s._tile_budget)
    t2 = time.perf_counter()
    print(f"host per batch: native sample_batch {(t1 - t0) * 1e3:.1f} ms, "
          f"native emit_tiles {(t2 - t1) * 1e3:.1f} ms, the rest of "
          f"NeighborSampler.sample "
          f"{sample_ms - (t2 - t0) * 1e3:.1f} ms ({os.cpu_count()} host "
          f"CPUs)")
    print(f"products-sub minibatch: device step {step_ms:.3f} ms, host sample "
          f"+ tile {sample_ms:.3f} ms, pipelined {pipelined_ms:.3f} ms per "
          f"batch, pipeline ratio {pipelined_ms / step_ms:.3f} (peak memory "
          f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
          f"resident {base / 2**30:.2f} GiB) [{card}]")
    profile_fn(lambda: tr.train_step(kept[0]),
               "products-sub minibatch step", step_ms, card)

    # one exact full-graph evaluation: setup_full_graph's layout, chunked if
    # the device's budget asks for it, and K5 once per chunk and layer
    k5_before = pallas_fwd.launches
    t0 = time.perf_counter()
    accs = tr.evaluate_exact()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    exact_launches = pallas_fwd.launches - k5_before
    forward_ms = cuda_ms(tr.evaluate_exact, reps=1, warmup=0)
    et = tr._exact_eval[3]  # the layout evaluate_exact built
    print(f"products-sub evaluate_exact: chunks={et.num_chunks} "
          f"tile_e={et.tile_e}; first call (layout + forward) {t1 - t0:.2f} "
          f"s, forward {forward_ms:.1f} ms, {exact_launches} K5 launches; "
          f"accuracies {accs} [{card}]")
    if exact_launches < config.num_layers * et.num_chunks or not all(
            0.0 <= v <= 1.0 for v in accs.values()):
        fail("evaluate_exact did not run K5 per chunk and layer, or its "
             "accuracies are out of range")
    return dict(graph=g, splits=splits, config=config, trainer=tr,
                start=start, kept=kept, launches=launches,
                exact_launches=exact_launches,
                times=dict(step_ms=step_ms, sample_ms=sample_ms,
                           pipelined_ms=pipelined_ms))


def phase_minibatch_losses(mb, dev):
    """The first sampled batches through impl='pallas' and impl='torch'
    minibatch steps from the same weights: per-step losses."""
    tr = mb["trainer"]
    ref = minibatch_trainer(mb["graph"], mb["config"], mb["splits"], "torch",
                            dev)
    got, want = [], []
    for t, out in ((tr, got), (ref, want)):
        t.params = copy.deepcopy(mb["start"])
        t.opt_state = optim.init_opt_state(t.params, "adam")
        t.step_count = 0
        out += [t.train_step(b)[0] for b in mb["kept"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"minibatch losses over the first {len(got)} batches: pallas {got}, "
          f"torch {want}; max relative difference {rel:.3e} (tolerance "
          f"{LOSS_RTOL:g})")
    if not all(np.isfinite(got)) or rel > LOSS_RTOL:
        fail("pallas minibatch losses disagree with the torch path")
    mb["torch_losses"] = want
    del ref


class _Branches:
    """Every LeakyReLU branch of a forward, recorded or replayed: inside the
    attention (s = zs[src] + zd[dst] per edge) and between layers. An fp32
    path decides the branch of an input near 0 by its rounding, which makes
    its gradient jump there; the float64 reference replays the path's own
    decisions, so the gradients are compared where the piecewise-linear
    model is smooth. The pallas and sell kernels' branches are recomputed
    from the op's fp32 inputs, with the kernels' own addition."""

    def __init__(self, src, dst):
        self.src, self.dst = src.long(), dst.long()
        self.masks, self.replay = [], False

    def leaky_relu(self, x, negative_slope=0.01, inplace=False):
        if self.replay:
            mask = self.masks[self.calls].reshape(x.shape)
            self.calls += 1
            return torch.where(mask, x, negative_slope * x)
        self.masks.append(x > 0)
        return self._leaky_relu(x, negative_slope)

    def attention(self, zs, zd, a, *args, **kw):
        if not self.replay and kw.get("impl") in ("pallas", "sell"):
            h, d = a.shape
            self.masks.append(zs.detach().view(-1, h, d)[self.src]
                              + zd.detach().view(-1, h, d)[self.dst] > 0)
        return self._attention(zs, zd, a, *args, **kw)

    def __enter__(self):
        import gatv2_tpu_torch.models.gatv2 as model_module

        self._module = model_module
        self._leaky_relu = torch.nn.functional.leaky_relu
        self._attention = model_module.edge_attention
        self.calls = 0
        torch.nn.functional.leaky_relu = self.leaky_relu
        model_module.edge_attention = self.attention
        return self

    def __exit__(self, *exc):
        torch.nn.functional.leaky_relu = self._leaky_relu
        self._module.edge_attention = self._attention
        self.replay = True


def phase_minibatch_gradients(mb, dev, impl="pallas", tr=None, b=None):
    """One batch's gradients: `impl` (pallas: K5-K7; sell: K1-K3, on the
    trainer tr's own layout of batch b) and the fp32 torch path, each
    against the torch path in float64 on that path's own LeakyReLU
    branches (_Branches), per parameter."""
    tr = mb["trainer"] if tr is None else tr
    b = mb["kept"][0] if b is None else b
    config = mb["config"]
    feats, _, _, labels, tiles = tr.batch_args(b)
    x = gather_rows_clip(*feats)
    src = torch.as_tensor(b.src[: b.num_edges], device=dev)
    dst = torch.as_tensor(b.dst[: b.num_edges], device=dev)
    start = mb["start"]
    start64 = copy.deepcopy(start).double()

    def grads(m, xx, path, et=None):
        loss, _ = loss_fn(m, xx, None if et else src, None if et else dst,
                          labels, config, impl=path, num_valid=b.num_seeds,
                          edge_tiles=et)
        return torch.autograd.grad(loss, optim.param_leaves(m))

    natural = _Branches(src, dst)  # float64's own branches
    with natural, torch.no_grad():
        loss_fn(start64, x.double(), src, dst, labels, config, impl="torch",
                num_valid=b.num_seeds)
    runs = {}
    for name, et in ((impl, tiles), ("torch", None)):
        branches = _Branches(src, dst)
        with branches:
            g32 = grads(start, x, name, et)
        with branches:
            g64 = grads(start64, x.double(), "torch")
        flips = sum(int((m32.reshape(m64.shape) != m64).sum())
                    for m32, m64 in zip(branches.masks, natural.masks))
        runs[name] = (g32, g64, flips)
    print("products-sub minibatch gradients, max |error| vs the float64 "
          "torch path on the same path's branches / the parameter's largest "
          f"|gradient| (LeakyReLU inputs whose fp32 sign differs from "
          f"float64's: {impl} {runs[impl][2]}, torch "
          f"{runs['torch'][2]}):")
    too_far = []
    for i, pname in enumerate(optim.param_names(start)):
        errs = {}
        for name, (g32, g64, _) in runs.items():
            scale = float(g64[i].abs().max()) or 1.0
            errs[name] = float((g32[i].double() - g64[i]).abs().max()) / scale
        ok = errs[impl] <= max(GRAD_FACTOR * errs["torch"], GRAD_FLOOR)
        print(f"  {pname:12s} {impl} {errs[impl]:.3e}  torch "
              f"{errs['torch']:.3e}  {'ok' if ok else 'TOO FAR'}")
        if not ok:
            too_far.append(pname)
    if too_far:
        fail(f"{impl} minibatch gradients of {too_far} are more than "
             f"{GRAD_FACTOR:g}x the torch path's distance (or "
             f"{GRAD_FLOOR:g}) from float64")
    del start64, runs


def phase_minibatch_sell(mb, dev, card):
    """The sampled-minibatch path on per-batch SELL layouts, on the pallas
    run's graph, model and start weights: MinibatchTrainer(impl='sell')
    (its sampler's budget and fixed geometry checked), the K1-K3 counters
    zeroed just before 3 warm-up and 30 timed batches through prefetch and
    read just after; the first batches' losses against the torch path's
    (the same batches: one sampler seed), one batch's gradients against
    float64, K1-K3 against their twins at each layer's shapes, the step,
    host and pipeline times beside the pallas run's in the same call, a
    profile, and one exact evaluation through setup_full_graph_sell."""
    g, config, splits = mb["graph"], mb["config"], mb["splits"]
    t0 = time.perf_counter()
    tr = minibatch_trainer(g, config, splits, "sell", dev)
    tr.params = copy.deepcopy(mb["start"])
    s = tr.sampler
    fixed = s._sell_fixed
    print(f"products-sub sell minibatch: engine {s.engine}, "
          f"max_nodes={s.max_nodes} max_edges={s.max_edges}; fixed SELL "
          f"geometry {fixed}: {fixed[0]} columns a side (e_ell "
          f"{fixed[0] * TILE_N}), {fixed[2]} slices a side; trainer "
          f"{time.perf_counter() - t0:.2f} s")
    if (s.max_nodes, s.max_edges) != (MB_MAX_NODES, MB_MAX_EDGES):
        fail(f"sell sampler budget {s.max_nodes}/{s.max_edges}, want "
             f"{MB_MAX_NODES}/{MB_MAX_EDGES}")
    if fixed != (MB_SELL_COLS, MB_SELL_COLS, MB_SELL_TILES, MB_SELL_TILES):
        fail(f"sell geometry {fixed}, want {MB_SELL_COLS} columns and "
             f"{MB_SELL_TILES} slices a side")
    kept, losses, pipelined_ms, launches = drive_minibatch(
        tr, "sell minibatch path", SELL_KERNELS)
    for b, pb in zip(kept, mb["kept"]):
        t = b.tiles
        if b.num_edges != pb.num_edges or not np.array_equal(b.src, pb.src) \
                or not np.array_equal(b.node_ids, pb.node_ids):
            fail("the sell sampler's batches differ from the pallas run's")
        if t.num_edges != -1 or not (t.dst.split and t.srcs.split) \
                or t.e_ell != fixed[0] * TILE_N \
                or t.num_dst_tiles != fixed[2]:
            fail("a batch's SellTiles are not in the fixed split geometry")
    print(f"sell minibatch losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"real columns per batch {[int(b.tiles.dst.col_off[-1]) for b in kept]} "
          f"of {fixed[0]}, real dst / src slices "
          f"{[(int((np.diff(b.tiles.dst.col_off) > 0).sum()), int((np.diff(b.tiles.srcs.col_off) > 0).sum())) for b in kept]} "
          f"of {fixed[2]}")

    # the first batches from the start weights against the torch path's
    tr.params = copy.deepcopy(mb["start"])
    tr.opt_state = optim.init_opt_state(tr.params, "adam")
    tr.step_count = 0
    got = [tr.train_step(b)[0] for b in kept]
    want = mb["torch_losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"minibatch losses over the first {len(got)} batches: sell {got}, "
          f"torch {want}; max relative difference {rel:.3e} (tolerance "
          f"{LOSS_RTOL:g})")
    if not all(np.isfinite(got)) or rel > LOSS_RTOL:
        fail("sell minibatch losses disagree with the torch path")
    phase_minibatch_gradients(mb, dev, impl="sell", tr=tr, b=kept[0])
    max_err, tot = sell_kernels_at_minibatch(tr, kept[0], mb, card)

    # times, in one call beside the pallas run's: the device step on one
    # batch replayed (the host-to-device copy of its layout included), in
    # turns pallas, sell, sell, pallas; host sampling + layout alone; the
    # pipelined batches above against the step
    ptr, pb = mb["trainer"], mb["kept"][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tr.train_step(kept[0])
    peak = torch.cuda.max_memory_allocated(dev)
    steps = {"pallas": [], "sell": []}
    for name in ("pallas", "sell", "sell", "pallas"):
        t_, b_ = (ptr, pb) if name == "pallas" else (tr, kept[0])
        steps[name].append(cuda_ms(lambda: t_.train_step(b_), reps=10,
                                   warmup=1))
    rng = np.random.default_rng(0)
    pool = np.nonzero(splits.train)[0]
    seed_sets = [np.sort(rng.choice(pool, size=MB_BATCH, replace=False))
                 for _ in range(5)]
    sample_ms = {}
    for name, smp in (("pallas", ptr.sampler), ("sell", s)):
        t0 = time.perf_counter()
        for seeds in seed_sets:
            smp.sample(seeds)
        sample_ms[name] = (time.perf_counter() - t0) * 1e3 / 5
    b = kept[0]
    t0 = time.perf_counter()
    native_loader.sample_batch(
        s._row_ptr64, g.col_idx, seed_sets[0].astype(np.int32),
        np.asarray(MB_FANOUTS, np.int32), s.max_nodes, s.max_edges, 1)
    t1 = time.perf_counter()
    raw = native_loader.emit_sell_tiles(b.src, b.dst, b.num_edges,
                                        s.max_nodes, tsa.DEFAULT_SPLIT_CAP,
                                        fixed)
    t2 = time.perf_counter()
    tsa.sell_tiles_from_native(raw, s.max_nodes, fixed)
    t3 = time.perf_counter()
    step_ms = float(np.mean(steps["sell"]))
    p_step = float(np.mean(steps["pallas"]))
    pt = mb["times"]
    print(f"host per batch: native sample_batch {(t1 - t0) * 1e3:.1f} ms, "
          f"native emit_sell_tiles {(t2 - t1) * 1e3:.1f} ms, "
          f"sell_tiles_from_native {(t3 - t2) * 1e3:.2f} ms "
          f"({os.cpu_count()} host CPUs)")
    print(f"products-sub minibatch, sell against pallas in one call: device "
          f"step sell {steps['sell'][0]:.3f} / {steps['sell'][1]:.3f} ms, "
          f"pallas {steps['pallas'][0]:.3f} / {steps['pallas'][1]:.3f} ms; "
          f"host sample + layout sell {sample_ms['sell']:.3f} ms, pallas "
          f"{sample_ms['pallas']:.3f} ms; pipelined sell {pipelined_ms:.3f} "
          f"ms per batch (ratio {pipelined_ms / step_ms:.3f}), pallas "
          f"{pt['pipelined_ms']:.3f} ms (ratio "
          f"{pt['pipelined_ms'] / p_step:.3f}); sell peak memory "
          f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above the "
          f"resident {base / 2**30:.2f} GiB [{card}]")
    profile_fn(lambda: tr.train_step(kept[0]),
               "products-sub sell minibatch step", step_ms, card)

    # one exact full-graph evaluation on setup_full_graph_sell's layout
    k1_before = sell_fwd.launches
    t0 = time.perf_counter()
    accs = tr.evaluate_exact()
    torch.cuda.synchronize()
    exact_launches = sell_fwd.launches - k1_before
    st = tr._exact_eval[3]  # the layout evaluate_exact built
    print(f"products-sub sell evaluate_exact: chunks={st.num_chunks} "
          f"split={st.dst.split}; first call (layout + forward) "
          f"{time.perf_counter() - t0:.2f} s, {exact_launches} K1 launches; "
          f"accuracies {accs} [{card}]")
    if exact_launches < config.num_layers * st.num_chunks or not all(
            0.0 <= v <= 1.0 for v in accs.values()):
        fail("sell evaluate_exact did not run K1 per chunk and layer, or its "
             "accuracies are out of range")
    del tr
    return dict(launches=launches, exact_launches=exact_launches,
                max_err=max_err, totals=tot)


def sell_kernels_at_minibatch(tr, b, mb, card):
    """K1, K2 and K3 against their twins, and their times, at each layer's
    shapes of one products-sub batch on its per-batch SELL layout: the
    layer's projections, sigma from the op's forward, a seeded random
    upstream gradient; K2's unwritten padding packets (the fixed tail
    included) poisoned with NaN before K3 reads the packets. Bounds count
    the real edges only; beside the kernels, the plain-PyTorch row merges
    of both split sides (_merge_rows_dst, _rows_to_nodes_sum)."""
    config, start = mb["config"], mb["start"]
    max_err = dict.fromkeys(SELL_KERNELS, 0.0)
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                   library_ms=0.0, floor_ms=0.0, device_ms=0.0)
           for k in SELL_KERNELS}
    merge_ms = dict(merge_rows_dst=0.0, rows_to_nodes_dst=0.0,
                    rows_to_nodes_src=0.0)
    rng = np.random.default_rng(6)
    with torch.no_grad():
        feats, _, _, _, st = tr.batch_args(b)
        st_host = b.tiles
        x = gather_rows_clip(*feats)
        n = x.shape[0]
        counts = dst_chunk_counts(st, 0)
        real = real_slots(st.dst.cnt)
        lib_idx = torch.as_tensor(k3_library_index(st_host),
                                  device=real.device)
        rows_src = st.num_src_tiles * TILE_N
        lay = (st.dst.perm, st.dst.gather_ids, st.dst.cnt, st.dst.col_off)
        print(f"  products-sub sell batch: {counts['e']} real edges, "
              f"{counts['cols']} of {st.e_ell // TILE_N} columns, "
              f"{counts['rows']} dst rows")
        for l, layer in enumerate(start.layers):
            zs, zd = layer.project(x, config.precision)
            a = layer.a.detach().contiguous()
            heads, hd = a.shape[0], zs.shape[1]
            tag = f"products-sub sell layer {l}"
            kw1 = dict(negative_slope=SLOPE, normalize=False)
            got = sell_fwd(zs, zd, a, *lay, **kw1)
            want = sell_fwd_plain(zs, zd, a, *lay, **kw1)
            for part, gv, wv in zip(("u", "m", "l"), got, want):
                max_err["sell_fwd"] = max(max_err["sell_fwd"], compare(
                    f"{tag} K1 {part} [{tuple(gv.shape)}]", gv, wv, K1_RTOL,
                    K1_ATOL))
            del want
            out, sigma = sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                                      sell_tiles=st)
            gout = torch.as_tensor(rng.standard_normal(
                (n, hd), dtype=np.float32), device=zs.device)
            rr = (gout * out).view(n, heads, hd // heads).sum(-1)
            args = (zs, zd, gout, sigma, rr, a, *lay)
            kw = dict(negative_slope=SLOPE)
            dzd, da, c1 = sell_bwd_dst(*args, **kw)
            w_dzd, w_da, w_c1 = sell_bwd_dst_plain(*args, **kw)
            w64 = sell_bwd_dst_plain(*(t.double() for t in args[:6]),
                                     *args[6:], **kw)
            max_err["sell_bwd_dst"] = max(
                max_err["sell_bwd_dst"],
                compare(f"{tag} K2 c1 real slots [{counts['e']}, {hd}]",
                        c1[real], w_c1[real], K1_RTOL, K1_ATOL),
                compare_f64(f"{tag} K2 dzd [{tuple(dzd.shape)}]", dzd,
                            w_dzd, w64[0]),
                compare_f64(f"{tag} K2 d_a [{tuple(da.shape)}]", da, w_da,
                            w64[1]))
            del w_dzd, w_c1, w64
            c1[~real] = float("nan")
            k3 = (c1, st.ell_perm, st.srcs.cnt, st.srcs.col_off)
            dzs = sell_segsum(*k3)
            if not bool(torch.isfinite(dzs).all()):
                fail(f"{tag}: K3 read a padding packet")
            w_dzs = sell_segsum_plain(*k3)
            w64_dzs = sell_segsum_plain(c1.double(), *k3[1:])

            def library():
                return torch.zeros(rows_src + 1, hd, device=c1.device
                                   ).index_add_(0, lib_idx, c1)

            max_err["sell_segsum"] = max(max_err["sell_segsum"], compare_f64(
                f"{tag} K3 dzs [{tuple(dzs.shape)}]", dzs, w_dzs, w64_dzs))
            compare_f64(f"{tag} index_add_ (library) dzs",
                        library()[:rows_src], w_dzs, w64_dzs)
            del w_dzs, w64_dzs
            calls = {
                "sell_fwd": (lambda: sell_fwd(zs, zd, a, *lay, **kw1),
                             lambda: sell_fwd_plain(zs, zd, a, *lay, **kw1)),
                "sell_bwd_dst": (lambda: sell_bwd_dst(*args, **kw),
                                 lambda: sell_bwd_dst_plain(*args, **kw)),
                "sell_segsum": (lambda: sell_segsum(*k3),
                                lambda: sell_segsum_plain(*k3)),
            }
            bounds = k1_k2_bounds(counts, hd, heads, packets=True)
            bounds["sell_segsum"] = (*k3_bound_ms(st_host, hd), 0.0)
            for k, (fn, twin) in calls.items():
                ms = cuda_ms(fn)
                dev_ms = device_ms(fn, DEVICE_KERNELS[k])
                plain_ms = cuda_ms(twin, reps=3, warmup=1)
                lib_ms = cuda_ms(library) if k == "sell_segsum" else 0.0
                bound, by, floor = bounds[k]
                print(f"  {tag} H*D={hd}: {k} {ms:.4f} ms (device "
                      f"{dev_ms:.4f} ms), bound {bound:.4f} ms ({by})"
                      + (f", per-edge gather floor {floor:.4f} ms"
                         if floor else "")
                      + f", twin {plain_ms:.3f} ms"
                      + (f", index_add_ {lib_ms:.4f} ms" if lib_ms else "")
                      + f" [{card}]")
                t = tot[k]
                t["ms"] += ms
                t["device_ms"] += dev_ms
                t["plain_ms"] += plain_ms
                t["bound_ms"] += bound
                t["bytes_ms"] += bound if by == "bytes" else 0.0
                t["library_ms"] += lib_ms
                t["floor_ms"] += floor
            # the row merges of the split sides, plain PyTorch
            merges = {
                "merge_rows_dst": lambda: tsa._merge_rows_dst(
                    *got, st.dst, st.padded_num_nodes, hd // heads),
                "rows_to_nodes_dst": lambda: tsa._rows_to_nodes_sum(
                    dzd, st.dst, st.padded_num_nodes, n),
                "rows_to_nodes_src": lambda: tsa._rows_to_nodes_sum(
                    dzs, st.srcs, st.padded_src_nodes, n),
            }
            times = {k: cuda_ms(fn) for k, fn in merges.items()}
            print(f"  {tag} H*D={hd}: row merges (plain PyTorch) "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                  + f" [{card}]")
            for k, v in times.items():
                merge_ms[k] += v
            del got, out, sigma, dzd, c1, dzs
            x = layer(x, None, None, is_last=l == len(start.layers) - 1,
                      config=config, impl="sell", edge_tiles=st)
    for k, t in tot.items():
        print(f"  products-sub sell {k} per step: {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms"
              + (f", per-edge gather floor {t['floor_ms']:.4f} ms"
                 if t["floor_ms"] else "")
              + f", twin {t['plain_ms']:.3f} ms"
              + (f", index_add_ {t['library_ms']:.4f} ms"
                 if t["library_ms"] else "") + f" [{card}]")
    print("  products-sub sell row merges per step: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in merge_ms.items())
          + f" [{card}]")
    return max_err, tot


def pallas_bounds(e, rows, tiles_n, hd, heads, n_src, n_dst):
    """{kernel: per-edge gather floor in ms} of K5 and K6, and (bound_ms,
    bound_by) of one K5, K6 and K7 launch: each input read once (zs rows an
    edge reads, zd/g rows and sigma/r of nodes with an in-edge, each real
    edge's two ids, the tile offsets, a) and each output written once (out,
    m, l; dzd, d_a and one c1 row per real edge; dzs), against the
    operations the real edges need."""
    meta = 2 * e + tiles_n + 1
    k5 = 4 * ((n_src + n_dst) * hd + meta + hd + rows * (hd + 2 * heads))
    k6 = 4 * ((n_src + 2 * n_dst) * hd + 2 * heads * n_dst + meta + 2 * hd
              + rows * hd + e * hd)
    k7 = 4 * (e * hd + meta + rows * hd)
    # the per-edge gather floors: one zs row read per real edge (no reuse
    # of a source across edges; K6 also writes its c1 row, in the bound
    # already), the rest as in the bound
    zs_again = 4 * (e - n_src) * hd
    floors = {k: (b + zs_again) / PEAK_BYTES_PER_S * 1e3
              for k, b in (("pallas_fwd", k5), ("pallas_bwd_dst", k6))}
    return floors, {
        "pallas_fwd": _bound(k5, e * hd * K5_OPS_PER_FEATURE),
        "pallas_bwd_dst": _bound(k6, e * hd * K6_OPS_PER_FEATURE),
        "pallas_segsum": _bound(k7, e * hd * K7_OPS_PER_FEATURE),
    }


def k7_library_index(tiles):
    """index_add_'s row per destination-sorted packet slot, the library
    call for K7's function: the edge's src row, padding slots into a spare
    row past the last one."""
    side = tiles.dst_side
    rows = (tiles.src_tile_offsets.numel() - 1) * TILE_N
    real = side.ids_grp[0] < tiles.tiles_per_chunk * TILE_N
    return torch.where(real, side.other_grp[0], rows).long()


def k7_check(tag, c1, tiles, lib_idx):
    """K7 on one layer's packets c1 (padding slots poisoned with NaN)
    against its twin and float64, and index_add_ into lib_idx's rows
    against float64. Returns (K7's max abs error, K7's arguments, the
    library call)."""
    rows = (tiles.src_tile_offsets.numel() - 1) * TILE_N
    k7 = (c1, tiles.gather_perm, tiles.src_sorted_ids,
          tiles.src_tile_offsets, tiles.tile_e)
    dzs = pallas_segsum(*k7)
    if not bool(torch.isfinite(dzs).all()):
        fail(f"{tag}: K7 read a padding packet")
    w_dzs = pallas_segsum_plain(*k7)
    w64 = pallas_segsum_plain(c1.double(), *k7[1:])

    def library():
        return torch.zeros(rows + 1, c1.shape[1],
                           device=c1.device).index_add_(0, lib_idx, c1)

    err = compare_f64(f"{tag} K7 dzs [{tuple(dzs.shape)}]", dzs, w_dzs, w64)
    compare_f64(f"{tag} index_add_ (library) dzs", library()[:rows], w_dzs,
                w64)
    return err, k7, library


def phase_pallas_kernels_at_main_path(mb, card):
    """K5, K6 and K7 against their twins, and their times, at each layer's
    shapes of one products-sub batch: the layer's projections, K5's stats,
    a seeded random upstream gradient; K6's unwritten padding packets are
    poisoned with NaN before K7 reads the packets."""
    tr, b, config, start = mb["trainer"], mb["kept"][0], mb["config"], \
        mb["start"]
    max_err = dict.fromkeys(PALLAS_KERNELS, 0.0)
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                   library_ms=0.0, floor_ms=0.0, device_ms=0.0)
           for k in PALLAS_KERNELS}
    rng = np.random.default_rng(4)
    e = b.num_edges
    n_src = int(np.unique(b.src[:e]).size)
    n_dst = int(np.unique(b.dst[:e]).size)
    with torch.no_grad():
        feats, _, _, _, tiles = tr.batch_args(b)
        x = gather_rows_clip(*feats)
        side = tiles.dst_side
        lay = (side.ids_grp[0], side.other_grp[0], side.rel_offsets[0],
               tiles.tile_e)
        rows = tiles.padded_num_nodes
        real = side.ids_grp[0] < rows
        lib_idx = k7_library_index(tiles)
        src_e = torch.as_tensor(b.src[:e], device=x.device)
        dst_e = torch.as_tensor(b.dst[:e], device=x.device)
        for l, layer in enumerate(start.layers):
            zs, zd = layer.project(x, config.precision)
            a = layer.a.detach().contiguous()
            heads, hd = a.shape[0], zs.shape[1]
            kw = dict(negative_slope=SLOPE)
            tag = f"products-sub layer {l}"
            got = pallas_fwd(zs, zd, a, *lay, **kw)
            want = pallas_fwd_plain(zs, zd, a, *lay, **kw)
            for part, gv, wv in zip(("out", "m", "l"), got, want):
                max_err["pallas_fwd"] = max(max_err["pallas_fwd"], compare(
                    f"{tag} K5 {part} [{tuple(gv.shape)}]", gv, wv, K1_RTOL,
                    K1_ATOL))
            del want
            out, m, l_ = got
            gout = torch.as_tensor(rng.standard_normal(
                (rows, hd), dtype=np.float32), device=zs.device)
            r = (gout * out).view(rows, heads, hd // heads).sum(-1)
            sr = tpa.sigma_r_table(m + torch.log(l_ + 1e-8), r)
            args = (zs, zd, gout, sr, a, *lay)
            dzd, da, c1 = pallas_bwd_dst(*args, **kw)
            w_dzd, w_da, w_c1 = pallas_bwd_dst_plain(*args, **kw)
            w64 = pallas_bwd_dst_plain(*(t.double() for t in args[:5]), *lay,
                                       **kw)
            max_err["pallas_bwd_dst"] = max(
                max_err["pallas_bwd_dst"],
                compare(f"{tag} K6 c1 real slots [{e}, {hd}]", c1[real],
                        w_c1[real], K1_RTOL, K1_ATOL),
                compare_f64(f"{tag} K6 dzd [{tuple(dzd.shape)}]", dzd, w_dzd,
                            w64[0]),
                compare_f64(f"{tag} K6 d_a [{tuple(da.shape)}]", da, w_da,
                            w64[1]))
            del w_dzd, w_c1, w64
            c1[~real] = float("nan")
            err, k7, k7_lib = k7_check(tag, c1, tiles, lib_idx)
            max_err["pallas_segsum"] = max(max_err["pallas_segsum"], err)
            # the op's gradients at this layer: pallas (K5-K7) and the fp32
            # torch path, each against the torch path in float64
            with torch.enable_grad():
                res = []
                for impl, dt in (("pallas", torch.float32),
                                 ("torch", torch.float32),
                                 ("torch", torch.float64)):
                    xs = [t.detach().to(dt).requires_grad_()
                          for t in (zs, zd, a)]
                    if impl == "pallas":
                        o = tpa.edge_attention_pallas(
                            *xs, rows, negative_slope=SLOPE, edge_tiles=tiles)
                    else:
                        o = edge_attention(
                            xs[0].view(rows, heads, -1),
                            xs[1].view(rows, heads, -1), xs[2], src_e, dst_e,
                            rows, negative_slope=SLOPE, impl="torch",
                        ).reshape(rows, -1)
                    (o * gout.to(dt)).sum().backward()
                    res.append([v.grad for v in xs])
            for part, kern, twin, ref in zip(("d_zs", "d_zd", "d_a"), *res):
                compare_f64(f"{tag} op {part} (torch fp32 as the twin)",
                            kern, twin, ref)
            del res
            floors, bounds = pallas_bounds(e, rows, tiles.num_node_tiles,
                                           hd, heads, n_src, n_dst)
            calls = {
                "pallas_fwd": lambda: pallas_fwd(zs, zd, a, *lay, **kw),
                "pallas_bwd_dst": lambda: pallas_bwd_dst(*args, **kw),
                "pallas_segsum": lambda: pallas_segsum(*k7),
            }
            dev_ms = {k: device_ms(fn, DEVICE_KERNELS[k])
                      for k, fn in calls.items()}
            times = {
                "pallas_fwd": (
                    cuda_ms(lambda: pallas_fwd(zs, zd, a, *lay, **kw)),
                    cuda_ms(lambda: pallas_fwd_plain(zs, zd, a, *lay, **kw),
                            reps=3, warmup=1), 0.0),
                "pallas_bwd_dst": (
                    cuda_ms(lambda: pallas_bwd_dst(*args, **kw)),
                    cuda_ms(lambda: pallas_bwd_dst_plain(*args, **kw),
                            reps=3, warmup=1), 0.0),
                "pallas_segsum": (
                    cuda_ms(lambda: pallas_segsum(*k7)),
                    cuda_ms(lambda: pallas_segsum_plain(*k7), reps=3,
                            warmup=1),
                    cuda_ms(k7_lib)),
            }
            for k, (ms, plain_ms, lib_ms) in times.items():
                bound, by = bounds[k]
                floor = floors.get(k, 0.0)
                lib_txt = f", index_add_ {lib_ms:.4f} ms" if lib_ms else ""
                floor_txt = (f", per-edge gather floor {floor:.4f} ms"
                             if floor else "")
                print(f"  {tag} H*D={hd}: {k} {ms:.4f} ms (device "
                      f"{dev_ms[k]:.4f} ms), bound {bound:.4f} ms ({by})"
                      f"{floor_txt}, twin {plain_ms:.3f} ms{lib_txt} "
                      f"[{card}]")
                t = tot[k]
                t["ms"] += ms
                t["device_ms"] += dev_ms[k]
                t["plain_ms"] += plain_ms
                t["bound_ms"] += bound
                t["bytes_ms"] += bound if by == "bytes" else 0.0
                t["library_ms"] += lib_ms
                t["floor_ms"] += floor
            del got, out, dzd, c1
            x = layer(x, None, None, is_last=l == len(start.layers) - 1,
                      config=config, impl="pallas", edge_tiles=tiles)
    for k, t in tot.items():
        print(f"  products-sub {k} per step: {t['ms']:.4f} ms (device "
              f"{t['device_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms"
              + (f", per-edge gather floor {t['floor_ms']:.4f} ms"
                 if t["floor_ms"] else "")
              + f", twin {t['plain_ms']:.3f} ms"
              + (f", index_add_ {t['library_ms']:.4f} ms"
                 if t["library_ms"] else "") + f" [{card}]")
    return max_err, tot


def _empty_tiles_batch(n=2048):
    """A sampled batch's shape: 2048 padded nodes, in-edges only into nodes
    below 700 from nodes below 1500, so node tiles 6..15 hold no edge."""
    rng = np.random.default_rng(11)
    dst = np.sort(rng.integers(0, 700, size=6000))
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    col = rng.integers(0, 1500, size=dst.size).astype(np.int32)
    return Graph(rng.standard_normal((n, 8)).astype(np.float32), row_ptr,
                 col, rng.integers(0, 3, size=n))


def phase_pallas_cases(dev):
    """Layouts the main path does not reach: 20 heads (head groups), a hub
    beside isolated nodes, a batch with empty node tiles (a fixed
    edge-tile budget), no edges. The op's output and gradients on the card
    (K5-K7) and on the CPU (the twins), same inputs and upstream gradient;
    the gradients each against the torch path in float64."""
    max_err = 0.0
    empty = Graph(np.zeros((1000, 8), np.float32), np.zeros(1001, np.int64),
                  np.zeros(0, np.int32), np.zeros(1000, np.int32))
    rng = np.random.default_rng(12)
    cases = [
        ("H=20 (head groups), D=32", random_graph(5_000, 40_000, 8, 3,
                                                  seed=5), 20, 32, {}),
        ("isolated nodes beside a hub", _hub_and_isolated(), 4, 16, {}),
        ("a batch with empty node tiles", _empty_tiles_batch(), 4, 16,
         dict(tile_e=128, fixed_edge_tiles=60)),
        ("no edges", empty, 2, 16, {}),
    ]
    for label, gr, h, d, opts in cases:
        n = gr.num_nodes
        et = tpa.prepare_edge_tiles(gr.row_ptr, gr.col_idx, n, **opts)
        zs, zd, w = (rng.standard_normal((n, h * d), dtype=np.float32)
                     for _ in range(3))
        a = (rng.standard_normal((h, d), dtype=np.float32)
             / np.sqrt(d)).astype(np.float32)
        res = []
        for where in (dev, torch.device("cpu")):
            x = [torch.as_tensor(v, device=where).requires_grad_()
                 for v in (zs, zd, a)]
            out = tpa.edge_attention_pallas(*x, n, negative_slope=SLOPE,
                                            edge_tiles=et.to(where))
            (out * torch.as_tensor(w, device=where)).sum().backward()
            res.append([out.detach().cpu()] + [v.grad.cpu() for v in x])
        x64 = [torch.as_tensor(v).double().requires_grad_()
               for v in (zs, zd, a)]
        out64 = edge_attention(
            x64[0].view(n, h, d), x64[1].view(n, h, d), x64[2],
            torch.as_tensor(gr.src), torch.as_tensor(gr.dst), n,
            negative_slope=SLOPE, impl="torch")
        (out64.reshape(n, -1) * torch.as_tensor(w).double()).sum().backward()
        print(f"case {label} (chunks={et.num_chunks}, tile_e={et.tile_e}, "
              f"H*D={h * d}):")
        # out sums one term per in-edge (1,500 on the hub row): held
        # against float64 like the gradients
        max_err = max(max_err, compare_f64(
            f"{label} out", res[0][0], res[1][0],
            out64.detach().reshape(n, -1)))
        for part, kern, twin, ref in zip(("d_zs", "d_zd", "d_a"), res[0][1:],
                                         res[1][1:], [v.grad for v in x64]):
            max_err = max(max_err, compare_f64(f"{label} {part}", kern, twin,
                                               ref))
        no_in = torch.as_tensor(np.diff(gr.row_ptr) == 0)
        if not (bool((res[0][0][no_in] == 0).all())
                and bool((res[0][2][no_in] == 0).all())):
            fail(f"{label}: nodes without an in-edge do not get out = 0 "
                 f"and d_zd = 0")
    return max_err


def phase_pallas_full_graph(model, config, runs, dev, card):
    """Full-graph Trainer(impl='pallas') on both graphs, TRAIN_EPOCHS epochs
    from the same weights, K5-K7 counted; losses against the torch path's
    Trainers of the training phase; epoch times beside SELL's. Returns each
    Trainer's (edge tiles, features) by graph."""
    layouts = {}
    for name, r in runs.items():
        tr = make_trainer(r["graph"], config, "pallas", model, dev)
        et = tr.edge_tiles
        torch.cuda.synchronize()
        before = read_counters()
        tr.run()
        torch.cuda.synchronize()
        after = read_counters()
        counts = {k: after[k] - before[k] for k in PALLAS_KERNELS}
        got = tr.metrics_sink.losses
        want = r["torch_trainer"].metrics_sink.losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        pallas_ms = cuda_ms(tr.step, reps=3, warmup=1)
        sell_ms = cuda_ms(r["trainer"].step, reps=3, warmup=1)
        print(f"{name} full-graph pallas training (chunks={et.num_chunks}, "
              f"tile_e={et.tile_e}): launches {counts}; losses {got}, torch "
              f"{want}, max relative difference {rel:.3e} (tolerance "
              f"{LOSS_RTOL:g}); epoch pallas {pallas_ms:.3f} ms, sell "
              f"{sell_ms:.3f} ms [{card}]")
        if min(counts.values()) == 0:
            fail(f"{name}: full-graph pallas training launched no "
                 f"{min(counts, key=counts.get)}")
        if not all(np.isfinite(got)) or rel > LOSS_RTOL:
            fail(f"{name}: pallas training losses disagree with the torch "
                 f"path")
        # each kernel's share, the hub rows' on arxiv-pl
        profile_fn(tr.step, f"{name} full-graph pallas training step",
                   pallas_ms, card, reps=2)
        layouts[name] = (tr.edge_tiles, tr.features)
        del tr
    return layouts


def phase_k7_at_arxiv_pl(model, config, layout, card):
    """K7 at each layer's shapes of the unchunked arxiv-pl pallas step,
    where a source hub of 226,772 edges meets K7's segment split: the
    layer's projections, K5's stats, a seeded random upstream gradient, K6's
    packets with their padding slots poisoned with NaN; K7 against its twin
    and float64, and its time beside its bound, its twin's and index_add_'s.
    Returns K7's max abs error."""
    et, x = layout
    if et.num_chunks != 1:
        fail(f"arxiv-pl pallas layout has {et.num_chunks} chunks: K7 runs "
             f"on an unchunked one only")
    side = et.dst_side
    lay = (side.ids_grp[0], side.other_grp[0], side.rel_offsets[0],
           et.tile_e)
    rows = et.padded_num_nodes
    real = side.ids_grp[0] < rows
    e = int(real.sum())
    n_src = int(torch.unique(side.other_grp[0][real]).numel())
    n_dst = int(torch.unique(side.ids_grp[0][real]).numel())
    lib_idx = k7_library_index(et)
    rng = np.random.default_rng(5)
    max_err = 0.0
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0)
    with torch.no_grad():
        for l, layer in enumerate(model.layers):
            zs, zd = layer.project(x, config.precision)
            a = layer.a.detach().contiguous()
            heads, hd = a.shape[0], zs.shape[1]
            kw = dict(negative_slope=SLOPE)
            out, m, l_ = pallas_fwd(zs, zd, a, *lay, **kw)
            gout = torch.as_tensor(rng.standard_normal(
                (rows, hd), dtype=np.float32), device=zs.device)
            r = (gout * out).view(rows, heads, hd // heads).sum(-1)
            sr = tpa.sigma_r_table(m + torch.log(l_ + 1e-8), r)
            _, _, c1 = pallas_bwd_dst(zs, zd, gout, sr, a, *lay, **kw)
            c1[~real] = float("nan")
            tag = f"arxiv-pl pallas layer {l}"
            err, k7, k7_lib = k7_check(tag, c1, et, lib_idx)
            max_err = max(max_err, err)
            bound, by = pallas_bounds(e, rows, et.num_node_tiles, hd, heads,
                                      n_src, n_dst)[1]["pallas_segsum"]
            ms = cuda_ms(lambda: pallas_segsum(*k7))
            dev_ms = device_ms(lambda: pallas_segsum(*k7),
                               DEVICE_KERNELS["pallas_segsum"])
            plain_ms = cuda_ms(lambda: pallas_segsum_plain(*k7), reps=3,
                               warmup=1)
            lib_ms = cuda_ms(k7_lib)
            print(f"  {tag} H*D={hd}: pallas_segsum {ms:.4f} ms (device "
                  f"{dev_ms:.4f} ms), bound {bound:.4f} ms ({by}), twin "
                  f"{plain_ms:.3f} ms, index_add_ {lib_ms:.4f} ms [{card}]")
            for k, v in (("ms", ms), ("device_ms", dev_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound),
                         ("library_ms", lib_ms)):
                tot[k] += v
            del out, m, l_, gout, sr, c1
            x = layer(x, None, None, is_last=l == len(model.layers) - 1,
                      config=config, impl="pallas", edge_tiles=et)
    print(f"  arxiv-pl pallas_segsum per step: {tot['ms']:.4f} ms (device "
          f"{tot['device_ms']:.4f} ms), bound {tot['bound_ms']:.4f} ms, twin "
          f"{tot['plain_ms']:.3f} ms, index_add_ {tot['library_ms']:.4f} ms "
          f"[{card}]")
    return max_err


def phase_minibatch_entry():
    """python -m gatv2_tpu_torch.train --batch-size on karate with a
    checkpoint, then predict --impl pallas from that checkpoint; then
    train --impl sell --batch-size with --profile DIR and --debug-nans."""
    arch = ["--num-layers", "2", "--heads", "4,1", "--outdims", "16,16"]
    common = ["--dataset", "karate", "--data-root", "./data", *arch]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        ck, odir = pathlib.Path(tmp, "ck"), pathlib.Path(tmp, "p")
        proc = subprocess.run(
            [sys.executable, "-m", "gatv2_tpu_torch.train", *common,
             "--epochs", "3", "--optimizer", "adam", "--lr", "0.01",
             "--clip", "--seed", "1", "--batch-size", "32", "--fanouts",
             "5,5", "--checkpoint-dir", str(ck)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        print("minibatch train: " + " | ".join(lines[-9:]))
        if proc.returncode != 0:
            fail(f"minibatch train exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        if sum(l.startswith("Avg Loss: ") for l in lines) != 3 or not any(
                l.startswith("Minibatch mode: ") for l in lines):
            fail("minibatch train did not print 3 minibatch epochs")
        for tag, kname in (("K5", "pallas_fwd"), ("K6", "pallas_bwd_dst"),
                           ("K7", "pallas_segsum")):
            m = re.search(rf"{tag} {kname} launches: (\d+)", proc.stdout)
            if not m or int(m.group(1)) < 2:
                fail(f"minibatch train did not show its {tag} launches")
        proc = subprocess.run(
            [sys.executable, "-m", "gatv2_tpu_torch.predict", *common,
             "--checkpoint-dir", str(ck), "--impl", "pallas", "--out",
             str(odir)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        print("predict --impl pallas from the checkpoint: "
              + " ".join(proc.stdout.strip().splitlines()))
        if proc.returncode != 0:
            fail(f"predict exited {proc.returncode}: {proc.stderr[-2000:]}")
        preds = np.loadtxt(odir / "predictions.txt", dtype=np.int64, ndmin=1)
        m = re.search(r"K5 pallas_fwd launches: (\d+)", proc.stdout)
        if preds.shape != (34,) or "epoch 3" not in proc.stdout or not m \
                or int(m.group(1)) < 2:
            fail("predict --impl pallas from the checkpoint did not run K5 "
                 "or wrote no predictions")
        prof = pathlib.Path(tmp, "prof")
        proc = subprocess.run(
            [sys.executable, "-m", "gatv2_tpu_torch.train", *common,
             "--epochs", "2", "--optimizer", "adam", "--lr", "0.01",
             "--clip", "--seed", "1", "--impl", "sell", "--batch-size",
             "32", "--fanouts", "5,5", "--profile", str(prof),
             "--debug-nans"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        print("minibatch train --impl sell --profile --debug-nans: "
              + " | ".join(lines[-8:]))
        if proc.returncode != 0:
            fail(f"minibatch sell train exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        if sum(l.startswith("Avg Loss: ") for l in lines) != 2 or \
                f"Profiling to {prof}/" not in lines:
            fail("minibatch sell train did not print 2 epochs and its "
                 "profile directory")
        for tag, kname in (("K1", "sell_fwd"), ("K2", "sell_bwd_dst"),
                           ("K3", "sell_segsum")):
            m = re.search(rf"{tag} {kname} launches: (\d+)", proc.stdout)
            if not m or int(m.group(1)) < 2:
                fail(f"minibatch sell train did not show its {tag} launches")
        traces = sorted(prof.glob("*")) if prof.is_dir() else []
        print(f"  --profile wrote {[(t.name, t.stat().st_size) for t in traces]}")
        if not traces or min(t.stat().st_size for t in traces) == 0:
            fail("--profile wrote no trace file")


# ---------------------------------------------------------------------------
# the fourth main path: chunked full-graph training through K4 and K8
# ---------------------------------------------------------------------------


def k4_bound_ms(st, chunk, hd, heads):
    """(bound_ms, bound_by, real edges, gather floor ms) of one K4 launch on
    src chunk `chunk` of the SELL layout st (on the card). The bound: the zs
    rows of the chunk's sources with an edge, the zd and g rows and sigma, r
    of the destinations its edges reach, each read once; the perm rows, the
    ids of real slots, the column counts and offsets, a; the dzs rows
    written. The floor reads the destination side once per edge."""
    side = st.srcs
    cnt, rel = side.cnt_grp[chunk].long(), side.rel_off[chunk].long()
    real = real_slots(side.cnt_grp[chunk])
    e = int(real.sum())
    n_dst = int(torch.unique(side.ids_grp[chunk][real]).numel())
    widths = rel[1:] - rel[:-1]
    first = cnt[rel[:-1].clamp(max=cnt.numel() - 1)]
    row_used = (torch.where(widths > 0, first, 0)[:, None]
                > torch.arange(TILE_N, device=cnt.device)).reshape(-1)
    perm = chunk_rows(side, st.spc_src, chunk)
    n_src = int(torch.unique(perm[row_used]).numel())
    rows = perm.numel()
    nbytes = 4 * (n_src * hd + 2 * n_dst * hd + 2 * n_dst * heads + e + rows
                  + cnt.numel() + rel.numel() + hd + rows * hd)
    # the per-edge gather floor: a zd and a g row, sigma, r and the id read
    # per real edge (no destination reuse on a random graph whose tables
    # outgrow the L2), the used rows' zs read and every dzs row written
    floor = 4 * (e * (2 * hd + 2 * heads + 1) + int(row_used.sum()) * hd
                 + rows * hd)
    return (*_bound(nbytes, e * hd * K4_OPS_PER_FEATURE), e,
            floor / PEAK_BYTES_PER_S * 1e3)


def k8_bound_ms(et, chunk, hd, heads):
    """(bound_ms, bound_by, real edges, gather floor ms) of one K8 launch on
    src chunk `chunk` of the edge tiles et (on the card). The bound: the zs
    rows of the chunk's sources with an edge, the zd and g rows and sigma,
    r of the destinations its edges reach, each read once; each real
    edge's two ids, the tile offsets, a; the dzs rows written. The floor
    reads the destination side once per edge: a zd and a g row and the two
    32-byte sectors of its sr row that hold sigma and r."""
    side = et.src_side
    rows = et.padded_src_nodes // et.num_chunks
    real = side.ids_grp[chunk] < rows
    e = int(real.sum())
    n_src = int(torch.unique(side.ids_grp[chunk][real]).numel())
    n_dst = int(torch.unique(side.other_grp[chunk][real]).numel())
    rest = 4 * (n_src * hd + 2 * e + side.rel_offsets[chunk].numel() + hd
                + rows * hd)
    nbytes = rest + 4 * (2 * n_dst * hd + 2 * n_dst * heads)
    floor = rest + 4 * e * (2 * hd + 16)
    return (*_bound(nbytes, e * hd * K8_OPS_PER_FEATURE), e,
            floor / PEAK_BYTES_PER_S * 1e3)


def phase_products_full(dev, card):
    """Drive the chunked main path: full-graph training of bench.py's
    products-full (61.9 M edges, heads 2,1,1, outdims 64,32,16, weights
    from torch.Generator seed 0) through Trainer(impl='sell') with its own
    default chunk budget, TRAIN_EPOCHS epochs of Adam with clipping, the
    K1-K4 counters zeroed just before and read just after; then its epoch
    time, peak memory, a profiler table, and one epoch with remat=True
    from the same start: the same first loss, K1's launches an epoch's
    without remat, sell_attention.reused one per layer and head group."""
    t0 = time.perf_counter()
    g = random_graph(**PRODUCTS_FULL)
    t1 = time.perf_counter()
    config = ModelConfig(
        num_layers=3, heads=PF_HEADS, out_dims=PF_OUTDIMS,
        num_classes=PRODUCTS_FULL["num_classes"],
        in_dim=PRODUCTS_FULL["feature_dim"],
    )
    start = init_params(config, torch.Generator().manual_seed(0))
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    tr = make_trainer(g, config, "sell", start, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st = tr.edge_tiles
    print(f"products-full: N={g.num_nodes} E={g.num_edges} "
          f"F={g.feature_dim} C={g.num_classes}, heads {list(PF_HEADS)}, "
          f"outdims {list(PF_OUTDIMS)}; free device memory "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB, chunk budget "
          f"{free // 4 / 1e9:.2f} GB -> num_chunks={st.num_chunks} "
          f"(slices per chunk dst {st.spc_dst}, src {st.spc_src}); "
          f"e_ell={st.e_ell} e2_ell={st.e2_ell} pad={st.pad_overhead:.4f} "
          f"split dst/src={st.dst.split}/{st.srcs.split}; graph "
          f"{t1 - t0:.2f} s, Trainer set-up (host layout and copies) "
          f"{t2 - t1:.2f} s [{card}]")
    if st.num_chunks == 1:
        fail("products-full: the default chunk budget chose 1 chunk; the "
             "phase exists to run the chunked backward (K4)")
    torch.cuda.synchronize()
    zero_counters()
    tr.run()
    torch.cuda.synchronize()
    launches = read_counters()
    losses = list(tr.metrics_sink.losses)
    print(f"products-full main path launches ({TRAIN_EPOCHS} epochs): "
          f"{launches}; losses {losses}")
    for name in CHUNKED_SELL_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the products-full main "
                 f"path")
    if launches["sell_segsum"] != 0:
        fail("K3 (the packet sum) ran on a chunked layout")
    if not all(np.isfinite(losses)):
        fail(f"products-full losses are not finite: {losses}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    tr.step()
    peak = torch.cuda.max_memory_allocated(dev)
    epoch_ms = cuda_ms(tr.step, reps=3, warmup=0)
    print(f"products-full training epoch: sell {epoch_ms:.3f} ms on "
          f"{st.num_chunks} chunks (peak memory {peak / 2**30:.2f} GiB, "
          f"{(peak - base) / 2**30:.2f} GiB above the resident "
          f"{base / 2**30:.2f} GiB) [{card}]")
    profile_fn(tr.step, "products-full sell training step", epoch_ms, card,
               reps=2)

    # one epoch with remat=True from the same start: the same first loss
    tr.params = copy.deepcopy(start)
    tr.opt_state = optim.init_opt_state(tr.params, "adam")
    tr.epoch = 0
    tr.model_config = dataclasses.replace(config, remat=True)
    tr.metrics_sink = LossSink()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    tr.run(1)
    torch.cuda.synchronize()
    remat_peak = torch.cuda.max_memory_allocated(dev)
    k1, reused = read_counters()["sell_fwd"], tsa.sell_attention.reused
    # the recompute takes the forward's result: K1 as often as without
    # remat, and one reuse per layer and head group
    groups = sum(len(tsa._head_groups(h, d))
                 for h, d in zip(PF_HEADS, PF_OUTDIMS))
    tr.model_config = config
    remat_loss = tr.metrics_sink.losses[0]
    rel = abs(remat_loss - losses[0]) / abs(losses[0])
    print(f"products-full remat epoch: loss {remat_loss!r} against epoch 1's "
          f"{losses[0]!r}, relative difference {rel:.3e} (tolerance "
          f"{REMAT_RTOL:g}); peak memory {remat_peak / 2**30:.2f} GiB; "
          f"sell_fwd launches {k1} (an epoch without remat: "
          f"{launches['sell_fwd'] / TRAIN_EPOCHS:g}), sell_attention.reused "
          f"{reused} (layers x head groups: {groups}) [{card}]")
    if rel > REMAT_RTOL:
        fail("products-full: the remat epoch's loss differs from epoch 1's")
    if k1 * TRAIN_EPOCHS != launches["sell_fwd"] or reused != groups:
        fail("products-full: the remat epoch ran K1 again in its recompute")
    return dict(graph=g, config=config, start=start, trainer=tr,
                launches=launches)


def products_full_layers(pf, seed):
    """Per products-full layer l: (l, (zs, zd, g, sigma, r, a)), the
    backward kernels' tables at the layer's shapes: its projections from
    the start weights, sigma from its chunked forward, a random upstream
    gradient g (torch.Generator seed `seed`) and r = <g, out>."""
    tr, config = pf["trainer"], pf["config"]
    st = tr.edge_tiles
    model = copy.deepcopy(pf["start"]).to(st.srcs.perm.device)
    gen = torch.Generator(device=st.srcs.perm.device).manual_seed(seed)
    x = tr.features
    for l, layer in enumerate(model.layers):
        zs, zd = layer.project(x, config.precision)
        a = layer.a.detach().contiguous()
        heads, hd = a.shape[0], zs.shape[1]
        out, sigma = sell_forward(zs, zd, a, x.shape[0],
                                  negative_slope=SLOPE, sell_tiles=st)
        gout = torch.randn(x.shape[0], hd, generator=gen, device=x.device)
        rr = (gout * out).view(-1, heads, hd // heads).sum(-1)
        del out
        yield l, (zs, zd, gout, sigma, rr, a)
        x = layer(x, None, None, is_last=l == len(model.layers) - 1,
                  config=config, impl="sell", edge_tiles=st)


def phase_k4_at_products_full(pf, card):
    """K4 against its twin and float64, and K2 on a dst chunk without
    packets against its launch with them, its twin and float64, at each
    products-full layer's shapes on chunk 0 (products_full_layers); each
    layer's K4 time beside its bound and its twin's."""
    st = pf["trainer"].edge_tiles
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
               floor_ms=0.0)
    max_err = 0.0
    lay_s = (chunk_rows(st.srcs, st.spc_src, 0), st.srcs.ids_grp[0],
             st.srcs.cnt_grp[0], st.srcs.rel_off[0])
    lay_d = (chunk_rows(st.dst, st.spc_dst, 0), st.dst.ids_grp[0],
             st.dst.cnt_grp[0], st.dst.rel_off[0])
    kw = dict(negative_slope=SLOPE)
    with torch.no_grad():
        for l, tables in products_full_layers(pf, seed=4):
            heads, hd = tables[5].shape[0], tables[0].shape[1]
            tag = f"products-full layer {l} chunk 0"
            dzs = sell_bwd_src(*tables, *lay_s, **kw)
            w_dzs = sell_bwd_src_plain(*tables, *lay_s, **kw)
            w64 = sell_bwd_src_plain(*(t.double() for t in tables), *lay_s,
                                     **kw)
            max_err = max(max_err, compare_f64(
                f"{tag} K4 dzs [{tuple(dzs.shape)}]", dzs, w_dzs, w64))
            del w_dzs, w64
            # K2 without packets: the same dzd and d_a as with them
            dzd, da, c1 = sell_bwd_dst(*tables, *lay_d, **kw)
            del c1
            dzd0, da0, none = sell_bwd_dst(*tables, *lay_d, emit_c1=False,
                                           **kw)
            same = none is None and torch.equal(dzd0, dzd) and \
                torch.equal(da0, da)
            print(f"  {tag} K2 emit_c1=False: dzd and d_a "
                  f"{'equal to' if same else 'DIFFER FROM'} the "
                  f"emit_c1=True launch")
            if not same:
                fail(f"{tag}: K2 without packets differs from K2 with them")
            w_dzd, w_da, _ = sell_bwd_dst_plain(*tables, *lay_d,
                                                emit_c1=False, **kw)
            w64 = sell_bwd_dst_plain(*(t.double() for t in tables), *lay_d,
                                     emit_c1=False, **kw)
            compare_f64(f"{tag} K2 dzd without packets", dzd0, w_dzd, w64[0])
            compare_f64(f"{tag} K2 d_a without packets", da0, w_da, w64[1])
            del w_dzd, w64, dzd, dzd0
            ms = cuda_ms(lambda: sell_bwd_src(*tables, *lay_s, **kw))
            plain_ms = cuda_ms(
                lambda: sell_bwd_src_plain(*tables, *lay_s, **kw),
                reps=2, warmup=1)
            bound, by, e, floor = k4_bound_ms(st, 0, hd, heads)
            print(f"  {tag} H*D={hd}, {e} real edges: sell_bwd_src {ms:.4f} "
                  f"ms, bound {bound:.4f} ms ({by}), per-edge gather floor "
                  f"{floor:.4f} ms, twin {plain_ms:.3f} ms, library none "
                  f"[{card}]")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["bytes_ms"] += bound if by == "bytes" else 0.0
            tot["floor_ms"] += floor
            del dzs, tables
    print(f"  products-full sell_bwd_src, chunk 0 of each layer: "
          f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, per-edge "
          f"gather floor {tot['floor_ms']:.4f} ms, twin "
          f"{tot['plain_ms']:.3f} ms [{card}]")
    return max_err, tot


def phase_k1_k2_at_products_full(pf, card):
    """K1 against its twin at each products-full layer's shapes on dst
    chunk 0 (products_full_layers; K2 there is held to its twin and
    float64 by phase_k4_at_products_full), and each layer's K1 and K2
    (without packets, as the chunked backward launches it) time beside its
    bound, per-edge gather floor and twin's time; then the bounds and
    floors summed over every chunk and layer of one epoch, beside the
    epoch's profile rows of K1 and K2."""
    st = pf["trainer"].edge_tiles
    side = st.dst
    lay = (chunk_rows(side, st.spc_dst, 0), side.ids_grp[0],
           side.cnt_grp[0], side.rel_off[0])
    counts = [dst_chunk_counts(st, c) for c in range(st.num_chunks)]
    names = ("sell_fwd", "sell_bwd_dst")
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                   floor_ms=0.0) for k in names}
    epoch = {k: dict(bound_ms=0.0, floor_ms=0.0) for k in names}
    max_err = 0.0
    fwd_kw = dict(negative_slope=SLOPE, normalize=not side.split)
    bwd_kw = dict(negative_slope=SLOPE, emit_c1=False)
    with torch.no_grad():
        for l, tables in products_full_layers(pf, seed=5):
            zs, zd, a = tables[0], tables[1], tables[5]
            heads, hd = a.shape[0], zs.shape[1]
            tag = f"products-full layer {l} chunk 0"
            got = sell_fwd(zs, zd, a, *lay, **fwd_kw)
            want = sell_fwd_plain(zs, zd, a, *lay, **fwd_kw)
            for part, gv, wv in zip(("out", "m", "l"), got, want):
                max_err = max(max_err, compare(
                    f"{tag} K1 {part} [{tuple(gv.shape)}]", gv, wv,
                    K1_RTOL, K1_ATOL))
            del got, want
            times = {
                "sell_fwd": (
                    cuda_ms(lambda: sell_fwd(zs, zd, a, *lay, **fwd_kw)),
                    cuda_ms(lambda: sell_fwd_plain(zs, zd, a, *lay,
                                                   **fwd_kw),
                            reps=2, warmup=1)),
                "sell_bwd_dst": (
                    cuda_ms(lambda: sell_bwd_dst(*tables, *lay, **bwd_kw)),
                    cuda_ms(lambda: sell_bwd_dst_plain(*tables, *lay,
                                                       **bwd_kw),
                            reps=2, warmup=1)),
            }
            bounds = k1_k2_bounds(counts[0], hd, heads, packets=False)
            for c in counts:
                for k, (bound, _, floor) in k1_k2_bounds(
                        c, hd, heads, packets=False).items():
                    epoch[k]["bound_ms"] += bound
                    epoch[k]["floor_ms"] += floor
            for k, (ms, plain_ms) in times.items():
                bound, by, floor = bounds[k]
                print(f"  {tag} H*D={hd}, {counts[0]['e']} real edges: {k} "
                      f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), per-edge "
                      f"gather floor {floor:.4f} ms, twin {plain_ms:.3f} ms, "
                      f"library none [{card}]")
                t = tot[k]
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["bound_ms"] += bound
                t["bytes_ms"] += bound if by == "bytes" else 0.0
                t["floor_ms"] += floor
            del tables, zs, zd
    for k, t in tot.items():
        print(f"  products-full {k}, chunk 0 of each layer: {t['ms']:.4f} "
              f"ms, bound {t['bound_ms']:.4f} ms, per-edge gather floor "
              f"{t['floor_ms']:.4f} ms, twin {t['plain_ms']:.3f} ms; one "
              f"epoch ({st.num_chunks} chunks x {len(pf['start'].layers)} "
              f"layers): bound {epoch[k]['bound_ms']:.4f} ms, per-edge "
              f"gather floor {epoch[k]['floor_ms']:.4f} ms [{card}]")
    return max_err, tot


@contextlib.contextmanager
def forced_chunks(module, suggest, chunks):
    """Within the block, `module`'s default chunk budget is the smallest
    budget for which suggest(budget) (its chunk policy, non-increasing in
    the budget) picks `chunks` chunks, so a Trainer built there lays its
    graph out in that many chunks."""
    lo, hi = 1, 1 << 45
    while lo < hi:
        mid = (lo + hi) // 2
        if suggest(mid) > chunks:
            lo = mid + 1
        else:
            hi = mid
    if suggest(lo) != chunks:
        fail(f"no chunk budget gives {chunks} chunks")
    saved = module.default_chunk_budget
    module.default_chunk_budget = lambda device, num_edges=0: lo
    try:
        yield lo
    finally:
        module.default_chunk_budget = saved


# the edge-conditioned block at the ogbn-proteins widths on a graph one
# phase can hold: 2 layers of 6 heads x 80 with 8-dim edge features,
# residual, BatchNorm and the multi-label loss, remat on, 3 chunks
EDGE_GRAPH = dict(num_nodes=20_000, num_edges=1_000_000, feature_dim=8,
                  edge_dim=8, tasks=112)
EDGE_EPOCHS = 3
# the kernels alone at the ogbn-proteins cell's row shape: uniform
# endpoints at its in-degree (79,122,504 / 132,534 ~ 597), its head width
# and edge-feature width, laid out in 3 chunks
EDGE_KERNEL_GRAPH = dict(num_nodes=4_000, num_edges=2_388_000, heads=6,
                         head_dim=80, edge_dim=8, chunks=3)
# an edge-feature kernel against its fp32 twin, relative to the row's
# largest |value| (compare): the kernel sums each row's ~600 edges in lane
# groups and per-block partials, the twin column by column, so they differ
# by fp32 rounding of ~600-term sums; a K2 whose dW_e came out 0 would read
# a relative error of 1
EDGE_KERNEL_RTOL, EDGE_KERNEL_ATOL = 1e-4, 1e-5


def edge_kernels_at_proteins_degree(dev, card):
    """K1, K2 and K4 in their edge-feature variants, each launched once on
    chunk 0 of its side of a 3-chunk layout at the ogbn-proteins cell's
    row shape (EDGE_KERNEL_GRAPH), against the twins on the same inputs
    (EDGE_KERNEL_RTOL of the row's largest value) and, for the sums that
    cancel (dzd, da, dW_e, dzs), against float64 (compare_f64). dW_e is the
    sum of K2's per-block partials, as the op takes it."""
    cfg = EDGE_KERNEL_GRAPH
    h, d, k = cfg["heads"], cfg["head_dim"], cfg["edge_dim"]
    g = random_graph(cfg["num_nodes"], cfg["num_edges"], 8, 2, seed=37)
    n = g.num_nodes
    rng = np.random.default_rng(37)
    ef = rng.standard_normal((g.num_edges, k)).astype(np.float32)
    st = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, n,
                                num_chunks=cfg["chunks"],
                                edge_features=ef).to(dev)
    zs, zd, gr = (torch.from_numpy(rng.standard_normal((n, h * d))
                                   .astype(np.float32)).to(dev)
                  for _ in range(3))
    a = torch.from_numpy(rng.standard_normal((h, d)).astype(np.float32)
                         ).to(dev)
    w_e = torch.from_numpy((0.3 * rng.standard_normal((h, d, k)))
                           .astype(np.float32)).to(dev)
    out, sigma = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                                  sell_tiles=st, w_e=w_e)
    r = (gr * out).view(n, h, d).sum(-1)
    tables = (zs, zd, gr, sigma, r, a)

    def chunk0(side, spc):
        return (chunk_rows(side, spc, 0), side.ids_grp[0], side.cnt_grp[0],
                side.rel_off[0])

    def f64(ts):
        return [t.double() for t in ts]

    dst, src = chunk0(st.dst, st.spc_dst), chunk0(st.srcs, st.spc_src)
    kw = dict(negative_slope=SLOPE, w_e=w_e, edge_feat=st.dst.edge_feat[0])
    kw64 = dict(kw, w_e=w_e.double(), edge_feat=kw["edge_feat"].double())
    norm = not st.dst.split
    real = int(st.dst.cnt_grp[0].sum())
    print(f"edge-feature kernels ({n} nodes, {g.num_edges} edges, in-degree "
          f"{g.num_edges / n:.0f}, {h} x {d} heads, k = {k}; chunk 0 of "
          f"{st.num_chunks}: {real} edges, split rows {st.dst.split}) "
          f"[{card}]")
    got = sell_fwd(*tables[:2], a, *dst, normalize=norm, **kw)
    twin = sell_fwd_plain(*tables[:2], a, *dst, normalize=norm, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("K1 out", "K1 m", "K1 l"), got, twin):
        compare(name, x, y, EDGE_KERNEL_RTOL, EDGE_KERNEL_ATOL)
    got = sell_bwd_dst(*tables, *dst, emit_c1=False, **kw)
    twin = sell_bwd_dst_plain(*tables, *dst, emit_c1=False, **kw)
    twin64 = sell_bwd_dst_plain(*f64(tables), *dst, emit_c1=False, **kw64)
    torch.cuda.synchronize()
    dwe = [x[3].sum(0) for x in (got, twin, twin64)]
    if not float(dwe[2].abs().max()) > 0:
        fail("edge-feature kernels: the float64 dW_e is zero")
    for name, x, y, y64 in (
            ("K2 dzd", got[0], twin[0], twin64[0]),
            ("K2 da", got[1], twin[1], twin64[1]),
            ("K2 dW_e (summed partials)", *dwe)):
        compare(name, x, y, EDGE_KERNEL_RTOL, EDGE_KERNEL_ATOL)
        compare_f64(name, x, y, y64)
    kw = dict(kw, edge_feat=st.srcs.edge_feat[0])
    kw64 = dict(kw64, edge_feat=kw["edge_feat"].double())
    got = sell_bwd_src(*tables, *src, **kw)
    twin = sell_bwd_src_plain(*tables, *src, **kw)
    twin64 = sell_bwd_src_plain(*f64(tables), *src, **kw64)
    torch.cuda.synchronize()
    compare("K4 dzs", got, twin, EDGE_KERNEL_RTOL, EDGE_KERNEL_ATOL)
    compare_f64("K4 dzs", got, twin, twin64)
    del st, zs, zd, gr, out, sigma, r, tables, got, twin, twin64
    torch.cuda.empty_cache()


def phase_edge_features(dev, card):
    """The edge-feature kernels at the ogbn-proteins row shape against
    their twins (edge_kernels_at_proteins_degree); then a short
    edge-feature run: a sell Trainer with remat on a forced 3-chunk layout
    (K1, K2 and K4 with the edge term), EDGE_EPOCHS epochs against the
    torch path's losses on the card, with K1 launched once per layer,
    chunk and epoch (remat's recompute takes the kept result)."""
    edge_kernels_at_proteins_degree(dev, card)
    cfg = EDGE_GRAPH
    g0 = random_graph(cfg["num_nodes"], cfg["num_edges"],
                      cfg["feature_dim"], 2, seed=31)
    rng = np.random.default_rng(31)
    g = Graph(g0.features, g0.row_ptr, g0.col_idx,
              (rng.random((g0.num_nodes, cfg["tasks"])) < 0.5).astype(
                  np.int32),
              edge_features=rng.standard_normal(
                  (g0.num_edges, cfg["edge_dim"])).astype(np.float32))
    heads, dims = (6, 6), (80, 80)
    losses, ms = {}, {}
    for impl in ("torch", "sell"):
        mc = ModelConfig(num_layers=2, heads=heads, out_dims=dims,
                         num_classes=cfg["tasks"], in_dim=cfg["feature_dim"],
                         negative_slope=0.2, remat=True,
                         edge_dim=cfg["edge_dim"], residual=True,
                         norm="batch", loss="bce")
        tc = TrainConfig(epochs=EDGE_EPOCHS, optimizer="adam", lr=0.01,
                         seed=5, impl=impl)
        suggest = functools.partial(
            tsa.suggest_chunks_for_graph, g.row_ptr, g.col_idx,
            g.num_nodes, heads, dims)
        with forced_chunks(tsa, lambda b: suggest(budget_bytes=b), 3):
            tr = Trainer(g, mc, tc, device=dev, log_fn=lambda _: None)
        torch.cuda.synchronize()
        zero_counters()
        got = []
        for _ in range(EDGE_EPOCHS):
            tr.epoch += 1
            got.append(tr.step()[0])
        torch.cuda.synchronize()
        counts = read_counters()
        losses[impl] = got
        if impl == "sell":
            want_k1 = 2 * tr.edge_tiles.num_chunks * EDGE_EPOCHS
            if counts["sell_fwd"] != want_k1 or \
                    tsa.sell_attention.reused != 2 * EDGE_EPOCHS:
                fail(f"edge features: K1 launched {counts['sell_fwd']} "
                     f"times (want {want_k1}), the recompute reused "
                     f"{tsa.sell_attention.reused} head groups")
            if counts["sell_bwd_src"] == 0 or counts["sell_bwd_dst"] == 0:
                fail(f"edge features: launches {counts}")
        tr.epoch += 1
        ms[impl] = cuda_ms(tr.step, reps=2, warmup=1)
        print(f"edge features {impl} ({g.num_nodes} nodes, {g.num_edges} "
              f"edges, 2 layers of 6 x 80, k = 8, remat): launches "
              f"{ {k: v for k, v in counts.items() if v} }; losses {got}; "
              f"epoch {ms[impl]:.3f} ms [{card}]")
        del tr
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["sell"],
                                                  losses["torch"]))
    print(f"edge features: sell against torch losses, max relative "
          f"difference {rel:.3e} (tolerance {LOSS_RTOL:g})")
    if not all(np.isfinite(losses["sell"])) or rel > LOSS_RTOL:
        fail("edge features: sell losses disagree with the torch path")


def phase_chunk_invariance(model, config, runs, dev, card):
    """arxiv and arxiv-pl on a forced FORCED_CHUNKS-chunk layout: sell (K1,
    K2, K4) and pallas (K5, K6, K8) Trainers, TRAIN_EPOCHS epochs from the
    training phase's weights, against the torch path's losses; then one
    step's gradients of both against float64."""
    max_hd = max(-(-h * d // 128) * 128 for h, d in zip(HEADS, OUTDIMS))
    for name, r in runs.items():
        g = r["graph"]
        policies = {
            "sell": (tsa, lambda b: tsa.suggest_chunks_for_graph(
                g.row_ptr, g.col_idx, g.num_nodes, HEADS, OUTDIMS,
                budget_bytes=b)),
            "pallas": (tpa, lambda b: tpa.suggest_num_chunks(
                g.num_edges, max_hd, budget_bytes=b)),
        }
        paths = {}
        for impl, (module, suggest) in policies.items():
            with forced_chunks(module, suggest, FORCED_CHUNKS) as budget:
                tr = make_trainer(g, config, impl, model, dev)
            tiles = tr.edge_tiles
            if tiles.num_chunks != FORCED_CHUNKS:
                fail(f"{name} {impl}: {tiles.num_chunks} chunks, want "
                     f"{FORCED_CHUNKS}")
            torch.cuda.synchronize()
            before = read_counters()
            tr.run()
            torch.cuda.synchronize()
            after = read_counters()
            counts = {k: after[k] - before[k] for k in KERNELS
                      if after[k] != before[k]}
            got = tr.metrics_sink.losses
            want = r["torch_trainer"].metrics_sink.losses
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            epoch_ms = cuda_ms(tr.step, reps=3, warmup=1)
            print(f"{name} {impl} on {FORCED_CHUNKS} chunks (budget {budget} "
                  f"bytes): launches {counts}; losses {got}, torch {want}, "
                  f"max relative difference {rel:.3e} (tolerance "
                  f"{LOSS_RTOL:g}); epoch {epoch_ms:.3f} ms [{card}]")
            if impl == "pallas" and name == "arxiv-pl":
                profile_fn(tr.step, f"{name} pallas training step on "
                           f"{FORCED_CHUNKS} chunks", epoch_ms, card, reps=2)
            kernels = (CHUNKED_SELL_KERNELS if impl == "sell"
                       else CHUNKED_PALLAS_KERNELS)
            if any(counts.get(k, 0) == 0 for k in kernels):
                fail(f"{name} {impl}: the chunked path launched "
                     f"{counts}, not all of {kernels}")
            if not all(np.isfinite(got)) or rel > LOSS_RTOL:
                fail(f"{name} {impl}: chunked losses disagree with the torch "
                     f"path")
            paths[f"{impl} {FORCED_CHUNKS} chunks"] = (
                impl, tiles, tr.features, tr.labels, tr.num_valid)
            del tr
        r["chunked_paths"] = paths
    phase_gradients(model, config, runs, dev,
                    paths=lambda r: r["chunked_paths"])
    for r in runs.values():
        del r["chunked_paths"]


def _hubs_and_isolated():
    """_hub_and_isolated's graph (node 0 an in-hub of 1,500 edges, nodes
    1..500 without an in-edge) with node 1 an out-hub of 600 edges: both
    SELL sides split rows."""
    gr = _hub_and_isolated()
    col = gr.col_idx.copy()
    col[:600] = 1
    return Graph(gr.features, gr.row_ptr, col, gr.labels)


def _edges_among_first(n=1000, k=100, e=3000):
    """Edges only among nodes 0..k-1 of n: on 3 chunks two chunks of each
    side hold no edge."""
    rng = np.random.default_rng(13)
    dst = np.sort(rng.integers(0, k, size=e))
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    return Graph(rng.standard_normal((n, 8)).astype(np.float32), row_ptr,
                 rng.integers(0, k, size=e).astype(np.int32),
                 rng.integers(0, 3, size=n))


def phase_chunked_cases(dev):
    """Chunked layouts the main paths do not reach: 20 heads (two head
    groups), split hubs beside isolated nodes, chunks without an edge, no
    edges at all, and (SELL) bf16 streams. Both ops on FORCED_CHUNKS
    chunks: the gradients on the card (K1/K2/K4, K5/K6/K8) and on the CPU
    (the twins), same inputs and upstream gradient, each against the torch
    path's gradients in float64."""
    max_err = 0.0
    empty = Graph(np.zeros((1000, 8), np.float32), np.zeros(1001, np.int64),
                  np.zeros(0, np.int32), np.zeros(1000, np.int32))
    rng = np.random.default_rng(21)
    cases = [
        ("H=20 (two head groups), D=32", random_graph(5_000, 40_000, 8, 3,
                                                      seed=5), 20, 32, "f32"),
        ("split hubs beside isolated nodes", _hubs_and_isolated(), 4, 16,
         "f32"),
        ("chunks without an edge", _edges_among_first(), 2, 16, "f32"),
        ("no edges", empty, 2, 16, "f32"),
        ("streams=bf16, power-law split", powerlaw_graph(
            20_000, 150_000, 8, 3, seed=6, alpha=1.2), 4, 64, "bf16"),
    ]
    for label, gr, h, d, streams in cases:
        n = gr.num_nodes
        zs, zd, w = (rng.standard_normal((n, h * d), dtype=np.float32)
                     for _ in range(3))
        a = (rng.standard_normal((h, d), dtype=np.float32)
             / np.sqrt(d)).astype(np.float32)
        x64 = [torch.as_tensor(v).double() for v in (zs, zd, a)]
        if streams == "bf16":
            x64[:2] = [v.to(torch.bfloat16).double() for v in x64[:2]]
        for v in x64:
            v.requires_grad_()
        out64 = edge_attention(
            x64[0].view(n, h, d), x64[1].view(n, h, d), x64[2],
            torch.as_tensor(gr.src), torch.as_tensor(gr.dst), n,
            negative_slope=SLOPE, impl="torch")
        (out64.reshape(n, -1) * torch.as_tensor(w).double()).sum().backward()
        ops = {"sell": tsa.prepare_sell_tiles(gr.row_ptr, gr.col_idx, n,
                                              num_chunks=FORCED_CHUNKS)}
        if streams == "f32":
            ops["pallas"] = tpa.prepare_edge_tiles(
                gr.row_ptr, gr.col_idx, n, num_chunks=FORCED_CHUNKS)
        for impl, lay in ops.items():
            res = []
            before = read_counters()
            for where in (dev, torch.device("cpu")):
                x = [torch.as_tensor(v, device=where).requires_grad_()
                     for v in (zs, zd, a)]
                if impl == "sell":
                    out = sell_attention(*x, n, negative_slope=SLOPE,
                                         sell_tiles=lay.to(where),
                                         streams=streams)
                else:
                    out = tpa.edge_attention_pallas(
                        *x, n, negative_slope=SLOPE, edge_tiles=lay.to(where))
                (out * torch.as_tensor(w, device=where)).sum().backward()
                res.append([v.grad.cpu() for v in x])
            torch.cuda.synchronize()
            k = "sell_bwd_src" if impl == "sell" else "pallas_bwd_src"
            launched = read_counters()[k] - before[k]
            if impl == "sell":
                detail = (f"split dst/src {lay.dst.split}/{lay.srcs.split}, "
                          f"src chunks without an edge "
                          f"{int((lay.srcs.rel_off[:, -1] == 0).sum())}")
            else:
                detail = (f"src chunks without an edge "
                          f"{int((lay.src_side.rel_offsets[:, -1] == 0).sum())}")
            print(f"case {label}, {impl} on {lay.num_chunks} chunks "
                  f"({detail}, H*D={h * d}, {k} launches {launched}):")
            if launched == 0:
                fail(f"{label} {impl}: {k} was not launched")
            for part, kern, twin, ref in zip(("d_zs", "d_zd", "d_a"), *res,
                                             [v.grad for v in x64]):
                max_err = max(max_err, compare_f64(
                    f"{label} {impl} {part}", kern, twin, ref))
            no_in = torch.as_tensor(np.diff(gr.row_ptr) == 0)
            if not bool((res[0][1][no_in] == 0).all()):
                fail(f"{label} {impl}: d_zd of nodes without an in-edge is "
                     f"not 0")
    return max_err


def phase_products_sub_full_graph(mb, dev, card):
    """Full-graph Trainer(impl='pallas') on products-sub with the chunk
    count its default budget picks (K5, K6 per dst chunk, K8 per src
    chunk), TRAIN_EPOCHS epochs with the K5-K8 counters zeroed just before
    and read just after; against a sell Trainer on the same graph from the
    same weights; then the multi-epoch runner on the pallas Trainer's
    chunks (check_runner: K5, K6, K8)."""
    g, config, start = mb["graph"], mb["config"], mb["start"]
    trainers, setup_s = {}, {}
    for impl in ("pallas", "sell"):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        trainers[impl] = make_trainer(g, config, impl, start, dev)
        setup_s[impl] = time.perf_counter() - t0
    et, st = trainers["pallas"].edge_tiles, trainers["sell"].edge_tiles
    print(f"products-sub full graph: pallas chunks={et.num_chunks} "
          f"tile_e={et.tile_e} (set-up {setup_s['pallas']:.2f} s), sell "
          f"chunks={st.num_chunks} (set-up {setup_s['sell']:.2f} s)")
    if et.num_chunks == 1:
        fail("products-sub: the default budget chose 1 chunk for pallas; "
             "the phase exists to run K8")
    torch.cuda.synchronize()
    zero_counters()
    trainers["pallas"].run()
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"products-sub full-graph pallas launches ({TRAIN_EPOCHS} epochs): "
          f"{ {k: launches[k] for k in PALLAS_KERNELS + ('pallas_bwd_src',)} }")
    for name in CHUNKED_PALLAS_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the products-sub "
                 f"full-graph pallas path")
    if launches["pallas_segsum"] != 0:
        fail("K7 (the packet sum) ran on a chunked layout")
    before = read_counters()
    trainers["sell"].run()
    torch.cuda.synchronize()
    sell_counts = {k: v - before[k] for k, v in read_counters().items()
                   if v != before[k]}
    got = trainers["pallas"].metrics_sink.losses
    want = trainers["sell"].metrics_sink.losses
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    times = {impl: cuda_ms(tr.step, reps=3, warmup=1)
             for impl, tr in trainers.items()}
    print(f"products-sub full-graph losses: pallas {got}, sell {want} (sell "
          f"launches {sell_counts}); max relative difference {rel:.3e} "
          f"(tolerance {LOSS_RTOL:g}); epoch pallas {times['pallas']:.3f} "
          f"ms, sell {times['sell']:.3f} ms [{card}]")
    if not all(np.isfinite(got)) or rel > LOSS_RTOL:
        fail("products-sub: full-graph pallas losses disagree with sell")
    del trainers["sell"]
    torch.cuda.empty_cache()
    runner_launches = check_runner(
        f"products-sub pallas runner ({et.num_chunks} chunks)",
        trainers["pallas"], CHUNKED_PALLAS_KERNELS,
        RUNNER_PLANS["products-sub"], card, step_reps=3)[0]
    return dict(trainer=trainers["pallas"], launches=launches,
                runner_launches=runner_launches)


def phase_k8_at_products_sub(mb, pfs, card):
    """K8 against its twin and float64, and K6 on a dst chunk without
    packets against its launch with them, at each products-sub layer's
    shapes on chunk 0 of the full-graph layout (the layer's projections
    from the minibatch phase's start weights, K5's stats, a seeded random
    upstream gradient); each layer's K8 time beside its bound and its
    twin's."""
    tr, config = pfs["trainer"], mb["config"]
    et = tr.edge_tiles
    dev = et.src_side.ids_grp.device
    model = copy.deepcopy(mb["start"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
               floor_ms=0.0, device_ms=0.0)
    max_err = 0.0
    src, dsts = et.src_side, et.dst_side
    lay_s = (src.ids_grp[0], src.other_grp[0], src.rel_offsets[0], et.tile_e)
    lay_d = (dsts.ids_grp[0], dsts.other_grp[0], dsts.rel_offsets[0],
             et.tile_e)
    kw = dict(negative_slope=SLOPE)
    with torch.no_grad():
        x = tr.features
        for l, layer in enumerate(model.layers):
            zs, zd = layer.project(x, config.precision)
            a = layer.a.detach().contiguous()
            heads, hd = a.shape[0], zs.shape[1]
            out, m, l_ = tpa.pallas_forward(zs, zd, a, et, x.shape[0], SLOPE)
            gout = torch.randn(x.shape[0], hd, generator=gen, device=dev)
            rr = (gout * out).view(-1, heads, hd // heads).sum(-1)
            sr = tpa.sigma_r_table(m + torch.log(l_ + 1e-8), rr)
            del out, m, l_
            tables = (zs, zd, gout, sr, a)
            tag = f"products-sub full graph layer {l} chunk 0"
            dzs = pallas_bwd_src(*tables, *lay_s, **kw)
            w_dzs = pallas_bwd_src_plain(*tables, *lay_s, **kw)
            w64 = pallas_bwd_src_plain(*(t.double() for t in tables), *lay_s,
                                       **kw)
            max_err = max(max_err, compare_f64(
                f"{tag} K8 dzs [{tuple(dzs.shape)}]", dzs, w_dzs, w64))
            del w_dzs, w64
            dzd, da, c1 = pallas_bwd_dst(*tables, *lay_d, **kw)
            del c1
            dzd0, da0, none = pallas_bwd_dst(*tables, *lay_d, emit_c1=False,
                                             **kw)
            same = none is None and torch.equal(dzd0, dzd) and \
                torch.equal(da0, da)
            print(f"  {tag} K6 emit_c1=False: dzd and d_a "
                  f"{'equal to' if same else 'DIFFER FROM'} the "
                  f"emit_c1=True launch")
            if not same:
                fail(f"{tag}: K6 without packets differs from K6 with them")
            del dzd, dzd0
            ms = cuda_ms(lambda: pallas_bwd_src(*tables, *lay_s, **kw))
            k8_dev = device_ms(
                lambda: pallas_bwd_src(*tables, *lay_s, **kw),
                DEVICE_KERNELS["pallas_bwd_src"])
            plain_ms = cuda_ms(
                lambda: pallas_bwd_src_plain(*tables, *lay_s, **kw),
                reps=2, warmup=1)
            bound, by, e, floor = k8_bound_ms(et, 0, hd, heads)
            print(f"  {tag} H*D={hd}, {e} real edges: pallas_bwd_src "
                  f"{ms:.4f} ms (device {k8_dev:.4f} ms), bound {bound:.4f} ms "
                  f"({by}), per-edge gather floor {floor:.4f} ms, twin "
                  f"{plain_ms:.3f} ms, library none [{card}]")
            tot["ms"] += ms
            tot["device_ms"] += k8_dev
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["bytes_ms"] += bound if by == "bytes" else 0.0
            tot["floor_ms"] += floor
            del dzs, tables, zs, zd, gout
            x = layer(x, None, None, is_last=l == len(model.layers) - 1,
                      config=config, impl="pallas", edge_tiles=et)
    print(f"  products-sub pallas_bwd_src, chunk 0 of each layer: "
          f"{tot['ms']:.4f} ms (device {tot['device_ms']:.4f} ms), bound "
          f"{tot['bound_ms']:.4f} ms, per-edge "
          f"gather floor {tot['floor_ms']:.4f} ms, twin "
          f"{tot['plain_ms']:.3f} ms [{card}]")
    return max_err, tot


# ---------------------------------------------------------------------------
# multi-GPU on one card: ranks sharing cuda:0 over gloo
# ---------------------------------------------------------------------------

# the mesh of the sharded and data-parallel phases: 2 ranks on the one card
MESH_RANKS = 2
# (impl, --overlap, head_shards) of the sharded arxiv routes: mesh 2 over
# 'graph' on each impl with and without the overlap layer, then 1 x 2 over
# 'head' (layer 0's 4 heads split 2 + 2)
SHARDED_ROUTES = [("sell", False, 1), ("sell", True, 1), ("pallas", False, 1),
                  ("pallas", True, 1), ("torch", False, 1),
                  ("torch", True, 1), ("sell", False, 2)]
# the data-parallel phase's super-steps (2 products-sub batches each)
DP_STEPS = 5
# SHARDED_ROUTES' indices whose extra epoch is profiled: sell single pass,
# sell --overlap, pallas --overlap
PROFILED_ROUTES = (0, 1, 3)
# rounds of the overlap turns: single, overlap, overlap, single, ...
OVERLAP_TURNS = 4
_RANK_GRAPHS = {}  # per rank process: graphs built once for all its jobs


def _rank_graph(name):
    if name not in _RANK_GRAPHS:
        if name == "products-sub":
            g = random_graph(**PRODUCTS_SUB)
            _RANK_GRAPHS[name] = (g, random_splits(g.num_nodes,
                                                   (0.6, 0.2, 0.2), seed=0))
        else:
            _RANK_GRAPHS[name] = make_graph(name)
    return _RANK_GRAPHS[name]


def _counters():
    c = read_counters()
    c["sell_fwd normalize=False"] = sell_fwd.raw_launches
    c["pallas_fwd normalize=False"] = pallas_fwd.raw_launches
    return c


def _weights(model):
    return [p.detach().cpu().numpy() for p in optim.param_leaves(model)]


def _load_weights(model, leaves):
    with torch.no_grad():
        for p, v in zip(optim.param_leaves(model), leaves):
            p.copy_(torch.as_tensor(v, device=p.device))


def rank_transport(info):
    """(the Transport: line, this rank's device, the collectives the port
    calls, each run once here on CUDA tensors of this rank's device, and
    whether each gave the right result) of a pool rank. The port stages
    nothing through host memory itself: the backend must take them all."""
    import torch.distributed as dist

    from gatv2_tpu_torch.parallel import collectives as cc

    n, r, dev = info.world_size, info.rank, info.device
    x = torch.arange(4.0, device=dev) + r
    checks = {
        "all_reduce": (lambda: cc.all_reduce_sum(x, None),
                       sum(torch.arange(4.0) + k for k in range(n))),
        "broadcast": (lambda: (dist.broadcast(y := x.clone(), 0), y)[1],
                      torch.arange(4.0)),
        "all_gather_into_tensor": (
            lambda: cc.all_gather_dim0(x, None),
            torch.cat([torch.arange(4.0) + k for k in range(n)])),
        "reduce_scatter_tensor": (
            lambda: cc.reduce_scatter_dim0(torch.arange(4.0 * n,
                                                        device=dev), None),
            n * torch.arange(4.0 * r, 4.0 * (r + 1))),
        "all_to_all_single": (
            lambda: cc.all_to_all_dim0(
                (torch.arange(2.0 * n, device=dev) + 10 * r).view(n, 2),
                None).reshape(-1),
            torch.cat([torch.arange(2.0 * r, 2.0 * (r + 1)) + 10 * k
                       for k in range(n)])),
    }
    ok = {k: bool(torch.equal(fn().cpu(), want))
          for k, (fn, want) in checks.items()}
    return multihost.transport_line(info), str(dev), ok


@contextlib.contextmanager
def overlap_recorder(impl, local_tiles, timed=False):
    """Records on this rank, in host order, what the fused overlap layer
    (ops/merge.py _MergeExchange) does: each exchange start and wait
    (parallel/collectives.all_to_all_start and the wait of what it
    returns) and each pass, the op module's forward_raw or backward on the
    local or the halo layout (told apart by a leaf of the layout), with
    how many times the pass launched its K1 / K5 or K2 / K6. With timed,
    also CUDA events around each local pass and the host ms of each wait,
    per direction. Wraps module attributes for the with block only: the
    package has no hook for it."""
    from gatv2_tpu_torch.parallel import collectives as cc

    mod = tsa if impl == "sell" else tpa
    bwd_name = "sell_backward" if impl == "sell" else "pallas_backward"
    fwd_k, bwd_k = (("sell_fwd", "sell_bwd_dst") if impl == "sell"
                    else ("pallas_fwd", "pallas_bwd_dst"))
    leaf = (lambda t: t.ell_perm) if impl == "sell" else (lambda t: t.src)
    local_leaf = leaf(local_tiles)
    rec = dict(log=[], events={"fwd": [], "bwd": []},
               wait_ms={"fwd": 0.0, "bwd": 0.0})
    log = rec["log"]
    start, fwd, bwd = (cc.all_to_all_start, mod._forward_raw,
                       getattr(mod, bwd_name))

    class Pending:
        def __init__(self, pending, way):
            self._pending, self._way = pending, way

        def wait(self):
            t0 = time.perf_counter()
            out = self._pending.wait()
            rec["wait_ms"][self._way] += (time.perf_counter() - t0) * 1e3
            log.append(("wait", 0))
            return out

    def logged_start(x, group):
        way = "bwd" if log and log[-1][0] == "bwd halo" else "fwd"
        log.append(("start", 0))
        return Pending(start(x, group), way)

    def run_pass(way, k, fn, lay, *args):
        which = "local" if leaf(lay) is local_leaf else "halo"
        counter = KERNELS[k]["fn"]
        n0 = counter.launches
        ev = None
        if timed and which == "local":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out = fn(*args)
        if ev is not None:
            ev[1].record()
            rec["events"][way].append(ev)
        log.append((f"{way} {which}", counter.launches - n0))
        return out

    patches = {(cc, "all_to_all_start"): logged_start,
               (mod, "_forward_raw"): lambda *a: run_pass(
                   "fwd", fwd_k, fwd, a[3], *a),
               (mod, bwd_name): lambda *a: run_pass(
                   "bwd", bwd_k, bwd, a[6], *a)}
    saved = {key: getattr(*key) for key in patches}
    for (m, n), v in patches.items():
        setattr(m, n, v)
    try:
        yield rec
    finally:
        for (m, n), v in saved.items():
            setattr(m, n, v)


def check_overlap_order(tag, log, epochs):
    """Fails unless every layer of every epoch ran, in host order: forward
    start -> local pass -> wait -> halo pass; backward halo pass -> start
    of the reverse exchange -> local pass -> wait; and every pass launched
    its kernel."""
    layers = len(HEADS)
    fwd = ["start", "fwd local", "wait", "fwd halo"]
    bwd = ["bwd halo", "start", "bwd local", "wait"]
    got = [e for e, _ in log]
    if got != (fwd * layers + bwd * layers) * epochs:
        fail(f"{tag}: overlap order {got[:2 * len(fwd) * layers]}... is "
             f"not (forward {fwd}, backward {bwd}) per layer")
    if any(n == 0 for e, n in log if e not in ("start", "wait")):
        fail(f"{tag}: an overlap pass launched no kernel")


def rank_sharded(info, name, impl, overlap, head_shards, weights, grads,
                 profile):
    """One sharded route on this rank: ShardedTrainer on graph `name` with
    the arxiv model from `weights`, TRAIN_EPOCHS epochs with the launch
    counters zeroed just before and read just after (on the fused overlap
    layer under overlap_recorder). With grads, one step's gradients at the
    start weights first (full shape, head shards gathered); with profile,
    one more epoch under torch.profiler after them (the fused overlap
    layer's local passes timed by CUDA events, its waits by the host
    clock). Returns the trainer's log lines, losses, epoch ms, set-up
    seconds, launches, the gradients, the overlap order and the
    profile."""
    g = _rank_graph(name)
    config = ModelConfig(num_layers=3, heads=HEADS, out_dims=OUTDIMS,
                         num_classes=ARXIV["num_classes"],
                         in_dim=ARXIV["feature_dim"])
    tc = TrainConfig(epochs=TRAIN_EPOCHS, optimizer="adam", lr=0.01,
                     clip=True, seed=0, impl=impl)
    logs = []
    t0 = time.perf_counter()
    tr = sharded.ShardedTrainer(g, config, tc, MESH_RANKS, log_fn=logs.append,
                                overlap=overlap, head_shards=head_shards,
                                device=info.device)
    full = init_params(config, torch.Generator())
    _load_weights(full, weights)
    tr.params = full
    setup_s = time.perf_counter() - t0
    full_grads = None
    if grads:
        loss, _ = tr._step.loss_fn(tr.params, tr.features, tr.labels)
        gl = sharded.sharded_gradients(loss, tr.params, config, tr.mesh)
        mask = sharded._sharded_leaf_mask(config, tr.mesh)
        full_grads = [sharded._gather_leaf(x, m, tr.mesh).cpu().numpy()
                      for x, m in zip(gl, mask)]
    fused_overlap = tr.layout.overlap_tiles is not None
    if fused_overlap:
        record = functools.partial(overlap_recorder, impl,
                                   tr.layout.overlap_tiles[0])
    else:
        record = lambda timed=False: contextlib.nullcontext()
    torch.cuda.synchronize()
    zero_counters()
    losses, ms = [], []
    with record() as rec:
        for _ in range(TRAIN_EPOCHS):
            out = tr.run(1)
            losses.append(out["loss"])
            ms.append(out["ms"])
    torch.cuda.synchronize()
    launches = _counters()
    prof_out = None
    if profile:
        # one more epoch under torch.profiler: the device's busy time, and
        # the host rows that take the most of the epoch
        from torch.profiler import ProfilerActivity, profile as tprofile

        with record(timed=True) as timed, \
                tprofile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
            wall = tr.run(1)["ms"]
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum((getattr(e, "self_device_time_total", 0) or 0)
                   for e in events
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False))
        host = sorted(((e.cpu_time_total / 1e3, e.count, e.key)
                       for e in events if e.key.startswith("gloo:")),
                      reverse=True)
        prof_out = dict(wall_ms=wall, busy_ms=busy / 1e3, host=host[:6])
        if fused_overlap:
            prof_out.update(
                local_ms={w: sum(a.elapsed_time(b) for a, b in evs)
                          for w, evs in timed["events"].items()},
                wait_ms=timed["wait_ms"])
    return dict(logs=logs, losses=losses, ms=ms, setup_s=setup_s,
                launches=launches, grads=full_grads, profile=prof_out,
                order=rec["log"] if fused_overlap else None)


def rank_overlap_turns(info, weights):
    """The arxiv sell and pallas routes' epochs, single pass and
    --overlap, timed in turns on this rank (one ShardedTrainer each from
    `weights`, one warm-up epoch each, then OVERLAP_TURNS rounds of
    single, overlap / overlap, single). Returns {impl: (single ms,
    overlap ms)}, the host clock around each epoch's read-back."""
    g = _rank_graph("arxiv")
    config = ModelConfig(num_layers=3, heads=HEADS, out_dims=OUTDIMS,
                         num_classes=ARXIV["num_classes"],
                         in_dim=ARXIV["feature_dim"])
    out = {}
    for impl in ("sell", "pallas"):
        tc = TrainConfig(epochs=1, optimizer="adam", lr=0.01, clip=True,
                         seed=0, impl=impl)
        trs = []
        for overlap in (False, True):
            tr = sharded.ShardedTrainer(g, config, tc, MESH_RANKS,
                                        log_fn=lambda _: None,
                                        overlap=overlap, device=info.device)
            full = init_params(config, torch.Generator())
            _load_weights(full, weights)
            tr.params = full
            tr.run(1)
            trs.append(tr)
        ms = ([], [])
        for r in range(OVERLAP_TURNS):
            for k in ((0, 1) if r % 2 == 0 else (1, 0)):
                ms[k].append(trs[k].run(1)["ms"])
        out[impl] = ms
        del trs
    return out


def rank_runner(info, weights):
    """make_sharded_multi_epoch_runner on this rank of the arxiv sell route
    (no overlap) from `weights`: RUNNER_EPOCHS epochs with the launch
    counters zeroed just before and read just after, as many
    ShardedTrainer steps from the same weights, then the runner's
    differenced epoch ms (SHARDED_RUNNER_PLAN, CUDA events). Returns the
    runner's and the steps' losses, the launches and the per-epoch ms."""
    g = _rank_graph("arxiv")
    config = ModelConfig(num_layers=3, heads=HEADS, out_dims=OUTDIMS,
                         num_classes=ARXIV["num_classes"],
                         in_dim=ARXIV["feature_dim"])
    tc = TrainConfig(epochs=TRAIN_EPOCHS, optimizer="adam", lr=0.01,
                     clip=True, seed=0, impl="sell")
    tr = sharded.ShardedTrainer(g, config, tc, MESH_RANKS,
                                log_fn=lambda _: None, device=info.device)
    full = init_params(config, torch.Generator())
    _load_weights(full, weights)
    tr.params = full
    params, opt = copy.deepcopy(tr.params), copy.deepcopy(tr.opt_state)
    runners = {k: sharded.make_sharded_multi_epoch_runner(
        config, tc, tr.mesh, tr.pg.num_real_nodes, k, layout=tr.layout)
        for k in (RUNNER_EPOCHS, *SHARDED_RUNNER_PLAN[:2])}
    torch.cuda.synchronize()
    zero_counters()
    _, _, losses, _ = runners[RUNNER_EPOCHS](params, opt, 0, tr.features,
                                             tr.labels)
    torch.cuda.synchronize()
    launches = _counters()
    steps = [tr.run(1)["loss"] for _ in range(RUNNER_EPOCHS)]
    diffs = differenced_ms({"runner": lambda k: runners[k](
        params, opt, RUNNER_EPOCHS, tr.features, tr.labels)},
        SHARDED_RUNNER_PLAN)["runner"]
    return dict(losses=losses.tolist(), steps=steps, launches=launches,
                diffs=diffs)


def rank_dp(info, impl, weights):
    """DataParallelMinibatchTrainer on products-sub (batch 1024, fanouts
    10,10,10, native sampler, the minibatch phase's start weights): DP_STEPS
    super-steps with the launch counters zeroed just before and read just
    after. Returns the group losses, seed counts, ms a super-step (its
    batches sampled before the timed loop), launches."""
    g, splits = _rank_graph("products-sub")
    config = ModelConfig(num_layers=3, heads=HEADS, out_dims=OUTDIMS,
                         num_classes=PRODUCTS_SUB["num_classes"],
                         in_dim=PRODUCTS_SUB["feature_dim"])
    tc = TrainConfig(epochs=1, optimizer="adam", lr=0.01, clip=True, seed=0,
                     impl=impl, batch_size=MB_BATCH, fanouts=MB_FANOUTS,
                     sampler_engine="native", sample_budget="auto",
                     feature_residency="device")
    tr = DataParallelMinibatchTrainer(g, config, tc, MESH_RANKS,
                                      log_fn=lambda _: None, splits=splits,
                                      device=info.device)
    _load_weights(tr.params, weights)
    groups = tr.sampler.iter_groups(MESH_RANKS, info.rank)
    pairs = [next(groups) for _ in range(DP_STEPS)]
    torch.cuda.synchronize()
    zero_counters()
    losses, seeds = [], []
    t0 = time.perf_counter()
    for own, first in pairs:
        loss, _, n = tr.train_group(own, first)  # float(): waits
        losses.append(loss)
        seeds.append(n)
    step_ms = (time.perf_counter() - t0) * 1e3 / DP_STEPS
    torch.cuda.synchronize()
    return dict(losses=losses, seeds=seeds, step_ms=step_ms,
                launches=_counters())


def _check_rank_launches(what, results, kernels):
    """Fails unless every rank launched each of `kernels`."""
    for r, res in enumerate(results):
        for k in kernels:
            if res["launches"][k] == 0:
                fail(f"{what}: rank {r} launched no {k}")


def phase_sharded(pool, model, runs, card):
    """ShardedTrainer at arxiv full width on 2 ranks sharing the card over
    gloo, every route of SHARDED_ROUTES, then sell with --overlap on
    arxiv-pl (hub-heavy: the single pass takes over): each rank's launch
    counters zeroed just before its epochs and read just after; the losses
    against the single-process sell Trainer from the same weights (phase
    5). Returns the launches summed over ranks and routes, and {route:
    one step's gradients at the start weights} of every arxiv route."""
    weights = _weights(model)
    total = dict.fromkeys(_counters(), 0)
    grads = {}
    routes = [("arxiv", *r) for r in SHARDED_ROUTES] + [
        ("arxiv-pl", "sell", True, 1)]
    for i, (name, impl, overlap, hs) in enumerate(routes):
        res = pool.run(rank_sharded, name, impl, overlap, hs, weights,
                       name == "arxiv", i in PROFILED_ROUTES)
        r0 = res[0]
        tag = (f"{name} sharded {impl}{' --overlap' if overlap else ''} "
               f"mesh {MESH_RANKS // hs}x{hs}")
        for line in r0["logs"]:
            if line.split(":")[0] in ("Partition", "Halo", "Overlap"):
                print(f"  {tag}: {line}")
        want = runs[name]["trainer"].metrics_sink.losses
        got = r0["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"{tag}: losses {got}, single-process sell Trainer {want}; "
              f"max relative difference {rel:.3e} (tolerance {LOSS_RTOL:g}); "
              f"epoch ms (gloo on one card, not a multi-GPU time) "
              f"{[round(m, 2) for m in r0['ms']]}; set-up "
              f"{r0['setup_s']:.2f} s; launches per rank "
              f"{[{k: v for k, v in x['launches'].items() if v} for x in res]}"
              f" [{card}]")
        if not all(np.isfinite(got)) or rel > LOSS_RTOL:
            fail(f"{tag}: losses disagree with the single-process Trainer")
        if any(x["losses"] != got for x in res[1:]):
            fail(f"{tag}: the ranks report different losses")
        if not any(l.startswith("Partition:") for l in r0["logs"]) or \
                not any(l.startswith("Halo:") for l in r0["logs"]):
            fail(f"{tag}: no Partition: / Halo: line")
        hub_fallback = any(l.startswith("Overlap: unavailable")
                           for l in r0["logs"])
        if name == "arxiv-pl" and not hub_fallback:
            fail("arxiv-pl: the SELL overlap did not give way to the "
                 "single pass on a hub-heavy partition")
        if overlap and name == "arxiv" and not any(
                l.startswith("Overlap: two-pass") for l in r0["logs"]):
            fail(f"{tag}: the overlap layer did not run")
        kernels = {"sell": SELL_KERNELS, "pallas": PALLAS_KERNELS}.get(
            impl, ())
        if overlap and name == "arxiv" and impl != "torch":
            kernels += (f"{kernels[0]} normalize=False",)
            for r, x in enumerate(res):
                if x["order"] is None:
                    fail(f"{tag}: rank {r} did not run the fused overlap "
                         f"layer")
                check_overlap_order(f"{tag} rank {r}", x["order"],
                                    TRAIN_EPOCHS)
            print(f"{tag}: every layer of every epoch on both ranks ran "
                  f"forward start -> local pass -> wait -> halo pass and "
                  f"backward halo pass -> start -> local pass -> wait")
        _check_rank_launches(tag, res, kernels)
        for x in res:
            for k, v in x["launches"].items():
                total[k] += v
        if name == "arxiv":
            grads[tag.removeprefix("arxiv ")] = r0["grads"]
        if i in PROFILED_ROUTES:
            p = r0["profile"]
            print(f"{tag}, one more epoch under torch.profiler on rank 0: "
                  f"{p['wall_ms']:.2f} ms wall, device busy "
                  f"{p['busy_ms']:.2f} ms; the gloo collectives' host time "
                  f"(gloo on one card, not a multi-GPU time) [{card}]:")
            for ms_, count, key in p["host"]:
                print(f"  {ms_:9.3f} ms  x{count:<3d} {key[:80]}")
            if "local_ms" in p:
                print(f"  overlap: the local passes' device ms (CUDA events "
                      f"around their launches, 3 layers) forward "
                      f"{p['local_ms']['fwd']:.3f}, backward "
                      f"{p['local_ms']['bwd']:.3f}; the host's wait for the "
                      f"exchange after them forward "
                      f"{p['wait_ms']['fwd']:.3f} ms, backward "
                      f"{p['wait_ms']['bwd']:.3f} ms [{card}]")
    return total, grads


def phase_overlap_turns(pool, model, card):
    """The arxiv sell and pallas epochs, single pass against --overlap,
    timed in turns in this call (rank_overlap_turns); rank 0's medians."""
    res = pool.run(rank_overlap_turns, _weights(model))
    for impl, (single, over) in res[0].items():
        ratio = float(np.median(over)) / float(np.median(single))
        print(f"arxiv sharded {impl} mesh {MESH_RANKS}x1 epoch ms in turns "
              f"(rank 0; gloo on one card, not a multi-GPU time): single "
              f"pass median {float(np.median(single)):.2f} "
              f"{[round(m, 2) for m in single]}, --overlap median "
              f"{float(np.median(over)):.2f} {[round(m, 2) for m in over]}; "
              f"overlap / single {ratio:.3f} [{card}]")


def phase_sharded_runner(pool, model, card):
    """The sharded multi-epoch runner (rank_runner) on both ranks: its
    losses against ShardedTrainer's from the same weights to RUNNER_ATOL,
    the same on both ranks, K1-K3 launched on each; its differenced epoch
    ms. Returns the launches summed over the ranks."""
    res = pool.run(rank_runner, _weights(model))
    r0 = res[0]
    err = max(abs(a - b) for a, b in zip(r0["losses"], r0["steps"]))
    print(f"arxiv sharded sell runner mesh {MESH_RANKS}x1: losses "
          f"{r0['losses']}, ShardedTrainer {r0['steps']}: max abs difference "
          f"{err:.3e} (tolerance {RUNNER_ATOL:g}); launches per rank "
          f"{[{k: v for k, v in x['launches'].items() if v} for x in res]}; "
          f"runner epoch (gloo on one card, not a multi-GPU time) "
          f"{timing_line(r0['diffs'], SHARDED_RUNNER_PLAN)} [{card}]")
    if not all(np.isfinite(r0["losses"])) or err > RUNNER_ATOL:
        fail("the sharded runner's losses differ from ShardedTrainer's")
    if any(x["losses"] != r0["losses"] for x in res[1:]):
        fail("sharded runner: the ranks report different losses")
    _check_rank_launches("sharded runner", res, SELL_KERNELS)
    total = dict.fromkeys(res[0]["launches"], 0)
    for x in res:
        for k, v in x["launches"].items():
            total[k] += v
    return total


def phase_sharded_gradients(model, config, runs, dev, grads):
    """One sharded step's gradients on every arxiv route (rank 0's, full
    shape) against the single-process float64 torch path, by phase 6's
    rule."""
    given = {route: [torch.as_tensor(x, device=dev) for x in g]
             for route, g in grads.items()}
    phase_gradients(model, config, {"arxiv": runs["arxiv"]}, dev,
                    paths=lambda r: {}, given=given)


def phase_k5_unnormalised(model, dev, card):
    """K5 with normalize=False (each pass of edge_attention_pallas_merge)
    against its twin at each layer's widths on a layout with a hub row
    split over the block beside nodes without an in-edge (m = -1e30, l = 0,
    raw out = 0); each launch's time beside its bound and the twin's. The
    arxiv shard layouts are phase_shard_kernels'."""
    hub = _hub_and_isolated()
    et = tpa.prepare_edge_tiles(hub.row_ptr, hub.col_idx,
                                hub.num_nodes).to(dev)
    side = et.dst_side
    lay = (side.ids_grp[0], side.other_grp[0], side.rel_offsets[0],
           et.tile_e)
    rows = et.padded_num_nodes
    gen = torch.Generator(device=dev).manual_seed(6)
    max_err = 0.0
    kw = dict(negative_slope=SLOPE, normalize=False)
    for l, layer in enumerate(model.layers):
        a = layer.a.detach().contiguous()
        hd = a.numel()
        zs = torch.randn(hub.num_nodes, hd, generator=gen, device=dev)
        zd = torch.randn(rows, hd, generator=gen, device=dev)
        args = (zs, zd, a, *lay)
        got = pallas_fwd(*args, **kw)
        max_err = max(max_err, check_forward(
            f"hub + isolated layer {l}", "pallas_fwd", args, kw, got))
        ms = cuda_ms(lambda: pallas_fwd(*args, **kw))
        plain_ms = cuda_ms(lambda: pallas_fwd_plain(*args, **kw), reps=3)
        c = pallas_counts(*lay[:3])
        bound, by = pallas_bounds(c["e"], rows, c["tiles"], hd, a.shape[0],
                                  c["n_src"], c["n_dst"])[1]["pallas_fwd"]
        print(f"  hub + isolated layer {l} K5 normalize=False H*D={hd}, "
              f"{c['e']} real edges: {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), twin {plain_ms:.3f} ms, library none [{card}]")
    return max_err


# the kernel wrappers each op module calls, with their twins
_OP_KERNELS = {
    "sell": ("sell_fwd", "sell_bwd_dst", "sell_segsum"),
    "pallas": ("pallas_fwd", "pallas_bwd_dst", "pallas_segsum"),
}
_TWINS = {"sell_fwd": sell_fwd_plain, "sell_bwd_dst": sell_bwd_dst_plain,
          "sell_segsum": sell_segsum_plain, "pallas_fwd": pallas_fwd_plain,
          "pallas_bwd_dst": pallas_bwd_dst_plain,
          "pallas_segsum": pallas_segsum_plain}


@contextlib.contextmanager
def captured_launches(impl):
    """Records every call the op module of `impl` makes to its kernel
    wrappers, in launch order: [(kernel, args, kwargs, result)]."""
    module = tsa if impl == "sell" else tpa
    saved = {k: getattr(module, k) for k in _OP_KERNELS[impl]}
    calls = []

    def wrap(k, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((k, args, kw, out))
            return out
        return call

    for k, fn in saved.items():
        setattr(module, k, wrap(k, fn))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


def pallas_counts(ids, other, rel):
    """(real edges, distinct sources and destinations, node tiles) of one
    K5 or K6 launch on an edge-tile side."""
    rows = (rel.numel() - 1) * TILE_N
    real = ids < rows
    return dict(e=int(real.sum()), tiles=rel.numel() - 1,
                n_src=int(torch.unique(other[real]).numel()),
                n_dst=int(torch.unique(ids[real]).numel()))


def check_forward(tag, k, args, kw, got):
    """K1 or K5 (`k`) against its twin on the same arguments; for K5 with
    normalize=False also a node without an in-edge: out = 0, m = -1e30,
    l = 0. Returns the max abs error."""
    want = _TWINS[k](*args, **kw)
    norm = kw.get("normalize", True)
    err = max(compare(f"{tag} {k} normalize={norm} {part} "
                      f"[{tuple(gv.shape)}]", gv, wv, K1_RTOL, K1_ATOL)
              for part, gv, wv in zip(("out", "m", "l"), got, want))
    if k == "pallas_fwd" and not norm:
        ids, rel = args[3], args[5]
        rows = (rel.numel() - 1) * TILE_N
        no_in = torch.ones(rows, dtype=torch.bool, device=ids.device)
        no_in[ids[ids < rows].long()] = False
        out, m, l_ = got
        if not int(no_in.sum()) or not (
                bool((out[no_in] == 0).all())
                and bool((m[no_in] == NEG_INF).all())
                and bool((l_[no_in] == 0).all())):
            fail(f"{tag}: no node without an in-edge, or one that is not "
                 f"out = 0, m = -1e30, l = 0")
    return err


def check_launch(tag, k, args, kw, got, state):
    """One captured launch against its twin on the same arguments, by the
    main path's rules: forward outputs and c1 on real slots to K1's
    tolerance, dzd, d_a and dzs against float64. A backward-over-dst
    launch poisons its unwritten packet slots, so that the packet sum that
    reads them next must skip them; `state` carries its edge count to that
    launch's bound. Returns (max abs error, kernel ms, twin ms, bound ms,
    bound_by)."""
    fn = KERNELS[k]["fn"]
    if k in ("sell_fwd", "pallas_fwd"):
        err = check_forward(tag, k, args, kw, got)
    elif k in ("sell_bwd_dst", "pallas_bwd_dst"):
        nf = 6 if k == "sell_bwd_dst" else 5
        dzd, da, c1 = got
        w_dzd, w_da, w_c1 = _TWINS[k](*args, **kw)
        w64 = _TWINS[k](*(t.double() for t in args[:nf]), *args[nf:], **kw)
        if k == "sell_bwd_dst":
            real = real_slots(args[8])
        else:
            real = torch.zeros(c1.shape[0], dtype=torch.bool,
                               device=c1.device)
            pos, _ = real_edges(args[5], args[7], args[8])
            real[pos] = True
        hd = c1.shape[1]
        err = max(
            compare(f"{tag} {k} c1 real slots [{int(real.sum())}, {hd}]",
                    c1[real], w_c1[real], K1_RTOL, K1_ATOL),
            compare_f64(f"{tag} {k} dzd [{tuple(dzd.shape)}]", dzd, w_dzd,
                        w64[0]),
            compare_f64(f"{tag} {k} d_a [{tuple(da.shape)}]", da, w_da,
                        w64[1]))
        del w_dzd, w_c1, w64
        c1[~real] = float("nan")
    else:
        dzs = fn(*args, **kw)
        if not bool(torch.isfinite(dzs).all()):
            fail(f"{tag}: {k} read a padding packet")
        err = compare_f64(f"{tag} {k} dzs [{tuple(dzs.shape)}]", dzs,
                          _TWINS[k](*args, **kw),
                          _TWINS[k](args[0].double(), *args[1:], **kw))
    ms = cuda_ms(lambda: fn(*args, **kw))
    plain_ms = cuda_ms(lambda: _TWINS[k](*args, **kw), reps=3, warmup=1)
    if k.startswith("sell"):
        if k == "sell_segsum":
            c1, _, cnt, col = args
            hd, e, cols = c1.shape[1], int(cnt.sum()), int(col[-1])
            tiles = col.numel() - 1
            bound, by = _bound(4 * (e * hd + e + cols + tiles + 1
                                    + tiles * TILE_N * hd),
                               e * hd * K3_OPS_PER_FEATURE)
        else:
            lay = args[3:7] if k == "sell_fwd" else args[6:10]
            a = args[2] if k == "sell_fwd" else args[5]
            bound, by, _ = k1_k2_bounds(
                sell_counts(*lay), a.numel(), a.shape[0], packets=True)[k]
    else:
        if k == "pallas_segsum":
            c1, _, _, src_off, _ = args
            c = dict(state["pallas_bwd_dst"], tiles=src_off.numel() - 1)
            rows, hd, heads = c["tiles"] * TILE_N, c1.shape[1], 1
        else:
            a = args[2] if k == "pallas_fwd" else args[4]
            lay = args[3:6] if k == "pallas_fwd" else args[5:8]
            c = pallas_counts(*lay)
            rows, hd, heads = c["tiles"] * TILE_N, a.numel(), a.shape[0]
            state[k] = c
        bound, by = pallas_bounds(c["e"], rows, c["tiles"], hd, heads,
                                  c["n_src"], c["n_dst"])[1][k]
    return err, ms, plain_ms, bound, by


def shard_routes(graph, dev):
    """{route: (impl, [shard 0's layout per pass])} of the sharded layer
    on a 2-shard partition of `graph`: the single pass on the per-shard
    bipartite tiles of each impl and, where the partition allows it, the
    (local, halo) overlap pair (ShardedTrainer's choice of layouts), and
    the shard's node count."""
    from gatv2_tpu_torch.parallel import partition as part

    pg = part.partition_graph(graph, MESH_RANKS)
    plan = part.halo_exchange_plan(pg)
    split = part.overlap_split_plan(pg, plan)
    routes = {
        "sell": ("sell", [part.prepare_partitioned_sell_tiles(
            pg, halo_plan=plan)[0]]),
        "pallas": ("pallas", [part.prepare_partitioned_tiles(
            pg, halo_plan=plan)[0]]),
        "pallas --overlap": ("pallas", [
            x[0] for x in part.prepare_overlap_tiles(pg, plan, split)]),
    }
    try:
        routes["sell --overlap"] = ("sell", [
            x[0] for x in part.prepare_overlap_sell_tiles(pg, plan, split)])
    except ValueError:
        pass  # hub-heavy: ShardedTrainer takes the single pass
    return ({r: (impl, [t.to(dev) for t in lays])
             for r, (impl, lays) in routes.items()}, pg.nodes_per_shard)


def phase_shard_kernels(model, runs, dev, card):
    """Every kernel launch of the sharded layer's ops on shard 0 of the
    2-shard arxiv partition (and arxiv-pl's single-pass sell, its hub rows
    split), layer by layer at the arxiv model's widths: one forward and
    backward of the op per route, with seeded random projections and
    upstream gradient, records each launch's arguments; each launch is
    then held against its twin on them and timed beside its bound. On the
    overlap routes that is K1 / K5 with normalize=False per pass and K2 +
    K3 / K6 + K7 per pass against the MERGED stats. Returns the max abs
    error per kernel."""
    max_err = dict.fromkeys(SELL_KERNELS + PALLAS_KERNELS, 0.0)
    gen = torch.Generator(device=dev).manual_seed(8)
    for name in ("arxiv", "arxiv-pl"):
        routes, nps = shard_routes(runs[name]["graph"], dev)
        if name == "arxiv-pl":
            routes = {"sell": routes["sell"]}
        for route, (impl, lays) in routes.items():
            tot = {}
            for l, layer in enumerate(model.layers):
                a = layer.a.detach().contiguous().requires_grad_()
                hd = a.numel()
                n_src = [t.num_src_nodes if impl == "sell"
                         else t.src_num_nodes for t in lays]
                zs = [torch.randn(n, hd, generator=gen, device=dev)
                      .requires_grad_() for n in n_src]
                zd = torch.randn(nps, hd, generator=gen,
                                 device=dev).requires_grad_()
                g = torch.randn(nps, hd, generator=gen, device=dev)
                with captured_launches(impl) as calls:
                    if len(lays) == 2 and impl == "sell":
                        h = tsa.sell_attention_merge(
                            zs, zd, a, nps, negative_slope=SLOPE,
                            sell_tiles_parts=lays)
                    elif len(lays) == 2:
                        h = tpa.edge_attention_pallas_merge(
                            zs, zd, a, nps, negative_slope=SLOPE,
                            edge_tiles_parts=lays)
                    else:
                        h = edge_attention(zs[0], zd, a, None, None, nps,
                                           negative_slope=SLOPE, impl=impl,
                                           edge_tiles=lays[0])
                    (h * g).sum().backward()
                tag = f"{name} shard 0 {impl} route '{route}' layer {l}"
                state = {}
                for i, (k, args, kw, got) in enumerate(calls):
                    err, ms, plain_ms, bound, by = check_launch(
                        f"{tag} launch {i}", k, args, kw, got, state)
                    max_err[k] = max(max_err[k], err)
                    print(f"  {tag} launch {i} {k} H*D={hd}: {ms:.4f} ms, "
                          f"bound {bound:.4f} ms ({by}), twin "
                          f"{plain_ms:.3f} ms [{card}]")
                    t = tot.setdefault(k, [0, 0.0, 0.0, 0.0])
                    t[0] += 1
                    t[1] += ms
                    t[2] += bound
                    t[3] += plain_ms
                del calls, h
            print(f"  {name} shard 0 route '{route}', one forward and "
                  f"backward of the 3 layers: " + "; ".join(
                      f"{k} x{n} {ms:.4f} ms, bound {b:.4f} ms, twin "
                      f"{p:.3f} ms" for k, (n, ms, b, p) in tot.items())
                  + f" [{card}]")
            if "overlap" in route and tot["sell_fwd" if impl == "sell"
                                          else "pallas_fwd"][0] < 6:
                fail(f"{route}: fewer than two forward launches a layer")
    return max_err


def dp_oracle(mb, impl, dev, steps):
    """The single-process oracle of the data-parallel phase: from the
    minibatch phase's start weights, per super-step the seed-weighted mean
    loss of the stream's next MESH_RANKS batches and one optimizer step."""
    tr = minibatch_trainer(mb["graph"], mb["config"], mb["splits"], impl, dev)
    tr.params = copy.deepcopy(mb["start"])
    stream = iter(tr.sampler)
    losses = []
    for t in range(1, steps + 1):
        total, n_all = 0.0, 0
        for b in [next(stream) for _ in range(MESH_RANKS)]:
            feats, src, dst, labels, tiles = tr.batch_args(b)
            loss, _ = loss_fn(tr.params, gather_rows_clip(*feats), src, dst,
                              labels, mb["config"], impl=impl,
                              num_valid=max(b.num_seeds, 1), edge_tiles=tiles)
            total = total + loss * b.num_seeds
            n_all += b.num_seeds
        loss = total / n_all
        grads = optim.gradients(loss, tr.params)
        optim.apply_updates(optim.param_leaves(tr.params), grads,
                            tr.opt_state, t, tr.train_config)
        losses.append(float(loss.detach()))
    return losses


def phase_dp(pool, mb, dev, card):
    """DataParallelMinibatchTrainer on products-sub, 2 ranks sharing the
    card: pallas then sell, DP_STEPS super-steps each with every rank's
    launch counters zeroed just before and read just after; the group
    losses against dp_oracle. Returns the launches summed over ranks."""
    weights = _weights(mb["start"])
    total = dict.fromkeys(_counters(), 0)
    for impl, kernels in (("pallas", PALLAS_KERNELS), ("sell", SELL_KERNELS)):
        res = pool.run(rank_dp, impl, weights)
        want = dp_oracle(mb, impl, dev, DP_STEPS)
        got = res[0]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"products-sub data-parallel {impl}, {MESH_RANKS} ranks x batch "
              f"{MB_BATCH}: group losses {got}, single-process oracle {want}; "
              f"max relative difference {rel:.3e} (tolerance {LOSS_RTOL:g}); "
              f"seeds a step {res[0]['seeds']}; ms a super-step on batches "
              f"sampled beforehand (gloo on one card, not a multi-GPU time) "
              f"{res[0]['step_ms']:.2f}; "
              f"launches per rank "
              f"{[{k: v for k, v in x['launches'].items() if v} for x in res]}"
              f" [{card}]")
        if not all(np.isfinite(got)) or rel > LOSS_RTOL:
            fail(f"data-parallel {impl}: losses disagree with the oracle")
        _check_rank_launches(f"data-parallel {impl}", res, kernels)
        for x in res:
            for k, v in x["launches"].items():
                total[k] += v
    return total


def phase_mesh_entry():
    """python -m gatv2_tpu_torch.train --mesh 2 on karate, as a user would
    run it on this machine: the command starts 2 ranks, which share the
    one card over gloo."""
    proc = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.train", "--mesh", "2",
         "--overlap", "--dataset", "karate", "--data-root", "./data",
         "--num-layers", "2", "--heads", "4,1", "--outdims", "16,16",
         "--epochs", "3", "--optimizer", "adam", "--lr", "0.01", "--clip",
         "--seed", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    print("train --mesh 2: " + " | ".join(
        l for l in lines if l.split(":")[0] in (
            "Transport", "Sharded mode", "Partition", "Halo", "Overlap",
            "Avg Loss", "Final Test Accuracy") or "launches" in l))
    if proc.returncode != 0:
        fail(f"train --mesh 2 exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    want = [f"Transport: gloo, {MESH_RANKS} ranks share cuda:0"]
    for key in ("Partition: ", "Halo: ", "Overlap: two-pass"):
        want += [l for l in lines if l.startswith(key)][:1] or [key]
    if not all(w in lines for w in want):
        fail(f"train --mesh 2 lacks one of {want}")
    if sum(l.startswith("Avg Loss: ") for l in lines) != 3:
        fail("train --mesh 2 did not print 3 epochs once")
    m = re.search(r"K1 sell_fwd launches: (\d+)", proc.stdout)
    if not m or int(m.group(1)) == 0:
        fail("train --mesh 2 did not show its K1 launches")


def phase_multi_gpu(model, config, runs, mb, dev, card):
    """The multi-GPU phases on 2 ranks sharing cuda:0 over gloo: no
    measure of multi-GPU speed (no NVLink, no NCCL; the collectives go
    through host memory), but every per-rank layout, launch, collective
    and gradient runs on the card."""
    t0 = time.perf_counter()
    with multihost.RankPool(MESH_RANKS, device="cuda") as pool:
        info = pool.run(rank_transport)
        print(f"{info[0][0]}; rank devices {[i[1] for i in info]}; pool "
              f"started in {time.perf_counter() - t0:.1f} s; collectives on "
              f"CUDA tensors (right result per rank): "
              f"{[i[2] for i in info]} [{card}]")
        if info[0][0] != f"Transport: gloo, {MESH_RANKS} ranks share cuda:0":
            fail(f"unexpected transport: {info[0][0]}")
        if not all(all(i[2].values()) for i in info):
            fail("gloo refused or miscomputed a collective on CUDA tensors")
        sharded_launches, grads = phase_sharded(pool, model, runs, card)
        phase_overlap_turns(pool, model, card)
        for k, v in phase_sharded_runner(pool, model, card).items():
            sharded_launches[k] += v
        dp_launches = phase_dp(pool, mb, dev, card)
    phase_sharded_gradients(model, config, runs, dev, grads)
    err = phase_shard_kernels(model, runs, dev, card)
    err["pallas_fwd"] = max(err["pallas_fwd"],
                            phase_k5_unnormalised(model, dev, card))
    phase_mesh_entry()
    print(f"multi-GPU phases: {time.perf_counter() - t0:.1f} s")
    return sharded_launches, dp_launches, err


BENCH_PLAN_MESH = (1, 3, 3)
# the bench's arxiv epoch over the runner epoch of phase 8b, the two timed in
# turns: the 25% that epochs move between calls
BENCH_RATIO = (0.75, 1.25)
MINIBATCH_TOOL_FIELDS = ("device_step_ms", "sample_ms", "replay_per_batch_ms",
                         "pipelined_per_batch_ms", "pipeline_ratio",
                         "device", "power_limit_w")
PROFILE_TOOL_FIELDS = ("wall_ms", "device_busy_ms", "busy_pct", "idle_pct",
                       "categories_ms", "top_kernels", "device",
                       "power_limit_w")


def check_line(tag, line, fields, nullable=()):
    """Fails unless `line` holds every one of `fields`, non-null (but for
    `nullable`), no NaN or infinity, and no `correct: false`."""
    missing = [k for k in fields if k not in line]
    null = [k for k in fields if k in line and line[k] is None
            and k not in nullable]
    bad = [k for k, v in line.items()
           if isinstance(v, float) and not np.isfinite(v)]
    print(f"{tag}: {json.dumps(line)}")
    if missing or null or bad or line.get("correct") is False:
        fail(f"{tag}: missing {missing}, null {null}, not finite {bad}, "
             f"correct {line.get('correct')}")


def run_tool(tag, argv, fields, timeout=300):
    """One of the bench's tools as a subprocess; its last line, checked."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *argv], cwd=ROOT, text=True,
                         capture_output=True, timeout=timeout)
    if out.returncode:
        fail(f"{tag} exited {out.returncode}: {out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    check_line(f"{tag} ({time.perf_counter() - t0:.1f} s)", line, fields)
    return line


def phase_bench(runner_ms, runner_runs, card):
    """The bench and its tools on the card (phase 16): bench_config on
    arxiv (sell, pallas), its epoch ms within BENCH_RATIO of the runner
    epoch of phase 8b timed in turns with it (the arxiv epoch waits on the
    host's launches, whose pace moves with the host's load between the two
    phases); `correct: false` for each planted fault; a 2-rank mesh line;
    the minibatch and profile tools."""
    t0 = time.perf_counter()
    for impl in ("sell", "pallas"):
        r = bench.bench_config("arxiv", impl=impl,
                               alongside={"8b": runner_runs[impl]})
        along = r.pop("alongside_ms")["8b"]
        check_line(f"bench arxiv {impl}", bench.headline(r, "arxiv"),
                   bench.LINE_FIELDS, nullable=("vs_baseline",))
        ratio = r["epoch_ms"] / float(np.median(along))
        print(f"bench arxiv {impl}: epoch {r['epoch_ms']:.3f} ms; runner "
              f"epoch of phase 8b timed in turns with it "
              f"{timing_line(along, (r['k1'], r['k2'], r['reps']))}, in "
              f"phase 8b {runner_ms[impl]:.3f} ms: ratio {ratio:.3f} "
              f"[{card}]")
        if not BENCH_RATIO[0] <= ratio <= BENCH_RATIO[1]:
            fail(f"bench arxiv {impl}: epoch / runner epoch {ratio:.3f} "
                 f"outside {BENCH_RATIO}")
    # `correct` catches a fault planted in the sell path at this size
    for fault, part in bench.FAULTS.items():
        with bench.planted_fault(fault):
            r = bench.bench_config("arxiv", impl="sell", k1=1, k2=2, reps=1)
        err, tol = r["check_errs"][part], bench.CHECK_RTOL[part]
        print(f"bench arxiv sell, planted {fault}: correct {r['correct']}, "
              f"{part} {err:.3e} (tol {tol:g}): {r['correct_check']}")
        if r["correct"] or not err > 10 * tol:
            fail(f"bench: the planted {fault} passed the check")
    k1, k2, reps = BENCH_PLAN_MESH
    r = bench.bench_mesh_config("arxiv", MESH_RANKS, device="cuda",
                                impl="sell", k1=k1, k2=k2, reps=reps)
    check_line("bench --mesh 2 arxiv sell",
               bench.mesh_line(r, "arxiv", MESH_RANKS), bench.MESH_FIELDS)
    if r["ranks_per_card"] != MESH_RANKS or r["transport"] != "gloo":
        fail(f"bench --mesh: ranks_per_card {r['ranks_per_card']}, "
             f"transport {r['transport']}")
    run_tool("tools/torch_bench_minibatch.py products-sub pallas",
             ["tools/torch_bench_minibatch.py", "--impl", "pallas",
              "--batches", "5"], MINIBATCH_TOOL_FIELDS)
    with tempfile.TemporaryDirectory() as out:
        line = run_tool("tools/torch_profile_roofline.py arxiv sell",
                        ["tools/torch_profile_roofline.py", "--config",
                         "arxiv", "--impl", "sell", "--epochs", "3",
                         "--top", "8", "--out", out], PROFILE_TOOL_FIELDS)
    for k in ("K1 sell_fwd", "K2 sell_bwd_dst", "K3 sell_segsum"):
        if not line["categories_ms"].get(k):
            fail(f"the profile tool saw no device time in {k}")
    print(f"bench phase: {time.perf_counter() - t0:.1f} s [{card}]")


# tools/torch_*.py run by phase_tools: the sweep's legs (cora: small, so a
# leg takes seconds), the multi-host smoke's processes
TOOL_SWEEP_LEGS = ("cora", "cora-sell")
TOOL_HOSTS = 2


def _tool(name):
    """tools/<name>.py as a module (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tool_main(name, argv):
    """tools/<name>.py's main(argv) in this process; its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _tool(name).main(argv)
    if rc:
        fail(f"tools/{name}.py {' '.join(argv)} returned {rc}")
    return buf.getvalue()


def _finite_numbers(tag, obj):
    """Fails unless every number in the (nested) JSON object is finite."""
    vals = obj.values() if isinstance(obj, dict) else obj
    for v in vals:
        if isinstance(v, (dict, list)):
            _finite_numbers(tag, v)
        elif isinstance(v, float) and not np.isfinite(v):
            fail(f"{tag}: a number is not finite: {json.dumps(obj)}")


def phase_tools(card):
    """The JAX tools' counterparts on the card (phase 17). The probe and
    the two multi-host processes run beside the in-process gradient-error
    runs (their own processes, so this process's counters count only the
    latter); the sweep's legs run last, alone. Returns the K1-K3 launches
    of the gradient-error runs."""
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    probe = subprocess.Popen(
        [sys.executable, "tools/torch_bisect_sell_high.py", "--nodes",
         str(ARXIV["num_nodes"]), "--edges", str(ARXIV["num_edges"])],
        cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    port = multihost.free_port()
    hosts = [subprocess.Popen(
        [sys.executable, "tools/torch_multihost_smoke.py", str(i),
         str(TOOL_HOSTS), str(port), "sell"], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(TOOL_HOSTS)]
    try:
        launches = dict.fromkeys(KERNELS, 0)
        for argv in (["--streams", "bf16"], ["--precision", "high"]):
            zero_counters()
            line = json.loads(run_tool_main("torch_grad_error_at_scale",
                                            argv).strip().splitlines()[-1])
            counts = read_counters()
            print(f"tools/torch_grad_error_at_scale.py {' '.join(argv)}: "
                  f"{json.dumps(line)}; launches {counts} [{card}]")
            _finite_numbers("grad error", line)
            if line["nodes"] != ARXIV["num_nodes"] or line["device"] != name:
                fail(f"grad error: not arxiv scale on the card: {line}")
            idle = [k for k in SELL_KERNELS if not counts[k]]
            if idle:
                fail(f"grad error {argv}: {idle} never launched")
            for k in KERNELS:
                launches[k] += counts[k]
        out, err = probe.communicate(timeout=300)
        print(f"tools/torch_bisect_sell_high.py arxiv: {out.strip()}")
        ran = re.search(r"kernels: (\{.*\})", out)
        if (probe.returncode or "OK fwd+bwd" not in out or ran is None
                or not all(json.loads(ran.group(1))[k]
                           for k in SELL_KERNELS)):
            fail(f"the SELL probe failed (rc {probe.returncode}): "
                 f"{out[-1000:]} {err[-2000:]}")
        losses = []
        for i, p in enumerate(hosts):
            out, err = p.communicate(timeout=300)
            if p.returncode:
                fail(f"multi-host process {i} exited {p.returncode}: "
                     f"{err[-2000:]}")
            losses.append(json.loads(out.strip().splitlines()[-1])["losses"])
            transport = next((ln for ln in err.splitlines()
                              if ln.startswith("Transport:")), "")
            print(f"tools/torch_multihost_smoke.py sell, process {i}: "
                  f"{losses[-1]} ({transport})")
            if not transport.startswith("Transport: gloo"):
                fail(f"multi-host process {i}: {transport!r}, not gloo")
        if losses[0] != losses[1] or not np.isfinite(losses[0]).all():
            fail(f"multi-host processes disagree: {losses}")
    finally:
        for p in (probe, *hosts):
            if p.poll() is None:
                p.kill()
                p.communicate()
    with tempfile.TemporaryDirectory() as d:
        out = pathlib.Path(d) / "sweep.jsonl"
        table = run_tool_main("torch_run_sweep", [
            "--only", ",".join(TOOL_SWEEP_LEGS), "--out", str(out)])
        print(table)
        recs = [json.loads(s) for s in out.read_text().splitlines()]
        report = run_tool_main("torch_sweep_report", ["--in", str(out)])
    print(report)
    bad = [r for r in recs if "error" in r or r.get("correct") is not True
           or r.get("device") != name or r.get("power_limit_w") is None]
    if bad or sorted(r["tag"] for r in recs) != sorted(TOOL_SWEEP_LEGS):
        fail(f"sweep legs: {[json.dumps(r)[:300] for r in bad]}")
    row = next((ln for ln in report.splitlines()
                if ln.startswith("| cora |")), "")
    if row.count("| — |") or "x |" not in row:
        fail(f"the sweep report's A/B table has no full cora row: {row!r}")
    print(f"tools phase: {time.perf_counter() - t0:.1f} s [{card}]")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    card = phase_device()  # the nvidia-smi name and power limit
    dev = torch.device("cuda", 0)
    phase_build()
    # the chunked main path first, while the card's memory is free: the
    # default chunk budget is a quarter of it
    pf = phase_products_full(dev, card)
    err_k4, k4_totals = phase_k4_at_products_full(pf, card)
    err_pf_k1, _ = phase_k1_k2_at_products_full(pf, card)
    pf_launches = pf["launches"]
    # the chunked runner while the card's memory is still free
    pf_runner_launches = check_runner(
        "products-full sell runner (chunked)", pf["trainer"],
        CHUNKED_SELL_KERNELS, RUNNER_PLANS["products-full"], card,
        step_reps=3)[0]
    del pf
    torch.cuda.empty_cache()
    model, config, runs, infer_launches = phase_main_path(dev)
    train_launches = phase_train_main_path(model, config, runs, dev)
    phase_gradients(model, config, runs, dev)
    err_main, totals = phase_kernels_at_main_path(model, config, runs, card)
    err_cases = phase_kernel_cases(dev)
    err_bwd, bwd_totals = phase_bwd_kernels_at_main_path(
        model, config, runs, card)
    err_bwd_cases = phase_bwd_cases(dev)
    phase_forward_times(model, config, runs, dev, card)
    phase_epoch_times(runs, dev, card)
    runner_launches, runner_ms, runner_runs = phase_runners(
        model, config, runs, dev, card)
    torch.cuda.empty_cache()
    phase_predict(dev)
    phase_train_entry()
    mb = phase_minibatch_main_path(dev, card)
    phase_minibatch_losses(mb, dev)
    err_pallas, pallas_totals = phase_pallas_kernels_at_main_path(mb, card)
    phase_minibatch_gradients(mb, dev)
    mb_sell = phase_minibatch_sell(mb, dev, card)
    torch.cuda.empty_cache()
    err_pallas_cases = phase_pallas_cases(dev)
    pallas_layouts = phase_pallas_full_graph(model, config, runs, dev, card)
    err_k7_pl = phase_k7_at_arxiv_pl(model, config,
                                     pallas_layouts.pop("arxiv-pl"), card)
    del pallas_layouts
    phase_chunk_invariance(model, config, runs, dev, card)
    err_chunked_cases = phase_chunked_cases(dev)
    phase_edge_features(dev, card)
    phase_minibatch_entry()
    pfs = phase_products_sub_full_graph(mb, dev, card)
    err_k8, k8_totals = phase_k8_at_products_sub(mb, pfs, card)
    pfs_launches = pfs["launches"]
    pfs_runner_launches = pfs["runner_launches"]
    del pfs
    torch.cuda.empty_cache()
    sharded_launches, dp_launches, err_shard = phase_multi_gpu(
        model, config, runs, mb, dev, card)
    phase_bench(runner_ms, runner_runs, card)
    tool_launches = phase_tools(card)
    sell_err = mb_sell["max_err"]
    measured = {
        "sell_fwd": (totals["arxiv"], max(err_main, err_cases, err_pf_k1,
                                          sell_err["sell_fwd"])),
        "sell_bwd_dst": (bwd_totals["arxiv"]["sell_bwd_dst"],
                         max(err_bwd["sell_bwd_dst"], err_bwd_cases,
                             sell_err["sell_bwd_dst"])),
        "sell_segsum": (bwd_totals["arxiv"]["sell_segsum"],
                        max(err_bwd["sell_segsum"], err_bwd_cases,
                            sell_err["sell_segsum"])),
    }
    measured.update({k: (pallas_totals[k], max(err_pallas[k],
                                               err_pallas_cases))
                     for k in PALLAS_KERNELS})
    measured["pallas_segsum"] = (pallas_totals["pallas_segsum"], max(
        measured["pallas_segsum"][1], err_k7_pl))
    for k, err in err_shard.items():
        measured[k] = (measured[k][0], max(measured[k][1], err))
    measured["sell_bwd_src"] = (k4_totals, max(err_k4, err_chunked_cases))
    measured["pallas_bwd_src"] = (k8_totals, max(err_k8, err_chunked_cases))
    launches = {k: infer_launches[k] + train_launches[k]
                + mb_sell["launches"][k] for k in SELL_KERNELS}
    launches["sell_fwd"] += mb_sell["exact_launches"]
    launches.update({k: mb["launches"][k] for k in PALLAS_KERNELS})
    launches["pallas_fwd"] += mb["exact_launches"]
    for k in CHUNKED_SELL_KERNELS:
        launches[k] = launches.get(k, 0) + pf_launches[k]
    for k in CHUNKED_PALLAS_KERNELS:
        launches[k] = launches.get(k, 0) + pfs_launches[k]
    for k in KERNELS:
        launches[k] += sharded_launches[k] + dp_launches[k]
        launches[k] += (runner_launches[k] + pf_runner_launches[k]
                        + pfs_runner_launches[k] + tool_launches[k])
    line = {"kernels": []}
    for name, (t, err) in measured.items():
        k = KERNELS[name]
        line["kernels"].append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": launches[name],
            "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["bound_ms"] / 2
            else "operations",
            "library_ms": t.get("library_ms") or None,
        })
    print("ms / plain_ms / bound_ms / library_ms: sum over the 3 layers of "
          "one 'arxiv' forward (K1) or backward (K2, K3), of one "
          "products-sub minibatch step (K5 forward, K6 and K7 backward), of "
          "chunk 0 of one products-full backward (K4) or of chunk 0 of one "
          "products-sub full-graph backward (K8); launches: K1-K3 on the "
          "inference and full-graph training main paths (both graphs' "
          f"forwards, {TRAIN_EPOCHS} training epochs on each graph) and on "
          f"the sell minibatch path ({MB_WARMUP + MB_TIMED} batches; K1 also "
          "its exact evaluation), K5-K7 "
          f"on the minibatch main path ({MB_WARMUP + MB_TIMED} batches) and, "
          "for K5, its exact evaluation; K1, K2 and K4 also on the "
          f"products-full main path ({TRAIN_EPOCHS} epochs), K5, K6 and K8 "
          f"on products-sub full-graph pallas training ({TRAIN_EPOCHS} "
          "epochs); every kernel also its launches on both ranks of the "
          f"sharded arxiv routes ({TRAIN_EPOCHS} epochs each) and the "
          f"data-parallel products-sub phase ({DP_STEPS} super-steps per "
          f"impl), and the multi-epoch runners' checked runs "
          f"({RUNNER_EPOCHS} epochs each: arxiv sell K1-K3 and pallas "
          "K5-K7, products-full K1, K2, K4, products-sub full-graph K5, K6, "
          "K8, the sharded arxiv sell runner K1-K3 on both ranks), and "
          "K1-K3 in the gradient-error tool's two runs at arxiv scale; "
          "library_ms: K1, K2, K4, K5, K6 and K8 have no single "
          "PyTorch call that computes their fused function, K3's and K7's "
          "is index_add_")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
