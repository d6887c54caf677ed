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
     table, one remat epoch with the same first loss; then K4 against its
     twin and float64, and K2 without packets against K2 with them, at
     each layer's shapes on one chunk;
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
     'arxiv' and 'arxiv-pl' against the torch path;
 12. chunk invariance: 'arxiv' and 'arxiv-pl' on a forced 3-chunk layout,
     sell (K1, K2, K4) and pallas (K5, K6, K8) Trainers against the torch
     path's losses, one step's gradients against float64; both ops'
     gradients on chunked extra layouts (20 heads, split hubs beside
     isolated nodes, chunks without an edge, no edges, bf16 streams)
     against the twins and float64;
 13. its times: device step, host sample + tile, the pipeline ratio of
     tools/bench_minibatch.py, each kernel beside its bound, its twin and,
     for K7, index_add_; a profiler table; peak memory; and the minibatch
     entry point (train --batch-size on karate, then predict --impl pallas
     from its checkpoint);
 14. products-sub full-graph Trainer(impl='pallas') on the chunk count its
     default budget picks, the K5-K8 counters zeroed just before and read
     just after (K8 launched, K7 not), against a sell Trainer from the same
     weights; then K8 against its twin and float64, and K6 without packets
     against K6 with them, at each layer's shapes on one chunk;
 15. one JSON line listing every kernel, the nvidia-smi line, then the
     result line {"ok": true, "device": {...}}.

Every time is measured with CUDA events and printed with the card's name
and power limit.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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
from gatv2_tpu_torch.ops.pallas_fwd import pallas_fwd, pallas_fwd_plain
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
from gatv2_tpu_torch.train.loop import Trainer
from gatv2_tpu_torch.train.minibatch import MinibatchTrainer, gather_rows_clip
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


def k1_bound_ms(st_host, num_src_used, num_dst_used, hd, heads):
    """(bound_ms, bound_by) of one K1 launch: each input read once, each
    output written once (zs/zd rows only where an edge needs them, gather
    ids only for real slots), against the operations the real edges need."""
    rows = st_host.num_dst_tiles * TILE_N
    e = st_host.num_edges
    cols = st_host.e_ell // TILE_N
    nbytes = 4 * ((num_src_used + num_dst_used) * hd + e + rows + cols
                  + st_host.num_dst_tiles + 1 + hd
                  + rows * (hd + 2 * heads))
    return _bound(nbytes, e * hd * K1_OPS_PER_FEATURE)


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound_ms(st_host, num_src_used, num_dst_used, hd, heads):
    """(bound_ms, bound_by) of one K2 launch: zs rows an edge reads, zd and
    g rows and sigma, r of nodes with an in-edge, the layout (ids of real
    slots), a; dzd rows, d_a and one c1 row per real edge written."""
    rows = st_host.num_dst_tiles * TILE_N
    e = st_host.num_edges
    cols = st_host.e_ell // TILE_N
    nbytes = 4 * ((num_src_used + 2 * num_dst_used) * hd
                  + 2 * num_dst_used * heads + e + rows + cols
                  + st_host.num_dst_tiles + 1 + 2 * hd
                  + rows * hd + e * hd)
    return _bound(nbytes, e * hd * K2_OPS_PER_FEATURE)


def k3_bound_ms(st_host, hd):
    """(bound_ms, bound_by) of one K3 launch: one c1 row and one ell_perm
    entry per real edge and the src layout read, dzs rows written."""
    rows = st_host.num_src_tiles * TILE_N
    e = st_host.num_edges
    cols = st_host.e2_ell // TILE_N
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
            st, sth, g = r["st"], r["st_host"], r["graph"]
            n = g.num_nodes
            deg = np.diff(g.row_ptr)
            num_src_used = int(np.count_nonzero(np.bincount(
                g.col_idx, minlength=n)))
            num_dst_used = int(np.count_nonzero(deg))
            x = r["feats"]
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0)
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
                bound, by = k1_bound_ms(sth, num_src_used, num_dst_used, hd,
                                        a.shape[0])
                # what the kernel really reads: one zs row per real edge
                gather_ms = (g.num_edges * hd * 4) / PEAK_BYTES_PER_S * 1e3
                print(f"  {name} layer {l} H*D={hd}: K1 {ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by}), per-edge zs reads alone "
                      f"{gather_ms:.4f} ms, twin {plain_ms:.3f} ms [{card}]")
                tot["ms"] += ms
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
                  f"{tot['bound_ms']:.4f} ms, twin {tot['plain_ms']:.3f} ms "
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


def profile_fn(fn, what, wall_ms, card, reps=5):
    """Device time per call of fn by kernel (torch.profiler), and the share
    of the CUDA-event wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device kernels only: a host op's self device time repeats theirs
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((t / 1e3 / reps, ev.count // reps, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{what}, device time by kernel (torch.profiler, {reps} calls) "
          f"[{card}]: busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy / wall_ms:.0f}%)")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.4f} ms  x{count:<3d} {key[:90]}")


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


def param_names(model):
    names = []
    for l in range(len(model.layers)):
        names += [f"layer{l}.a", f"layer{l}.w_dst", f"layer{l}.w_src"]
    return names + ["w_o"]


def phase_gradients(model, config, runs, dev, paths=None):
    """One step's gradients of the loss: each path (by default sell, K1-K3;
    paths(r) maps a label to (impl, tiles, features, labels, num_valid))
    and the fp32 torch path, each against the torch path in float64, per
    parameter."""
    model64 = copy.deepcopy(model).double()
    names = param_names(model)
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
            st, sth, g = r["st"], r["st_host"], r["graph"]
            deg = np.diff(g.row_ptr)
            num_src_used = int(np.count_nonzero(np.bincount(
                g.col_idx, minlength=g.num_nodes)))
            num_dst_used = int(np.count_nonzero(deg))
            real = real_slots(st.dst.cnt)
            lib_idx = torch.as_tensor(k3_library_index(sth),
                                      device=real.device)
            rows_src = sth.num_src_tiles * TILE_N
            x = r["feats"]
            tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                           library_ms=0.0) for k in max_err}
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
                        k2_bound_ms(sth, num_src_used, num_dst_used, hd,
                                    heads), 0.0),
                    "sell_segsum": (
                        cuda_ms(lambda: sell_segsum(*k3_args)),
                        cuda_ms(lambda: sell_segsum_plain(*k3_args),
                                reps=3, warmup=1),
                        k3_bound_ms(sth, hd),
                        cuda_ms(lambda: torch.zeros(
                            rows_src + 1, hd, device=c1.device
                        ).index_add_(0, lib_idx, c1))),
                }
                for k, (ms, plain_ms, (bound, by), lib_ms) in times.items():
                    lib_txt = f", index_add_ {lib_ms:.4f} ms" if lib_ms else ""
                    print(f"  {name} layer {l} H*D={hd}: {k} {ms:.4f} ms, "
                          f"bound {bound:.4f} ms ({by}), twin "
                          f"{plain_ms:.3f} ms{lib_txt} [{card}]")
                    t = tot[k]
                    t["ms"] += ms
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
                      f"{t['bound_ms']:.4f} ms, twin {t['plain_ms']:.3f} ms"
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
    stream = prefetch(iter(s), depth=2)
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
    print(f"minibatch main path launches ({MB_WARMUP + MB_TIMED} batches): "
          f"{launches}")
    for name in PALLAS_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the minibatch main path")
    if not all(np.isfinite(losses)):
        fail(f"minibatch losses are not finite: {losses}")
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
                exact_launches=exact_launches)


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
    del ref


class _Branches:
    """Every LeakyReLU branch of a forward, recorded or replayed: inside the
    attention (s = zs[src] + zd[dst] per edge) and between layers. An fp32
    path decides the branch of an input near 0 by its rounding, which makes
    its gradient jump there; the float64 reference replays the path's own
    decisions, so the gradients are compared where the piecewise-linear
    model is smooth. The pallas kernels' branches are recomputed from the
    op's fp32 inputs, with the kernels' own addition."""

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
        if not self.replay and kw.get("impl") == "pallas":
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


def phase_minibatch_gradients(mb, dev):
    """One batch's gradients: pallas (K5-K7) and the fp32 torch path, each
    against the torch path in float64 on that path's own LeakyReLU branches
    (_Branches), per parameter."""
    tr, b, config = mb["trainer"], mb["kept"][0], mb["config"]
    feats, _, _, labels, tiles = tr.batch_args(b)
    x = gather_rows_clip(*feats)
    src = torch.as_tensor(b.src[: b.num_edges], device=dev)
    dst = torch.as_tensor(b.dst[: b.num_edges], device=dev)
    start = mb["start"]
    start64 = copy.deepcopy(start).double()

    def grads(m, xx, impl, et=None):
        kw = dict(edge_tiles=et) if impl == "pallas" else {}
        loss, _ = loss_fn(m, xx, None if et else src, None if et else dst,
                          labels, config, impl=impl, num_valid=b.num_seeds,
                          **kw)
        return torch.autograd.grad(loss, optim.param_leaves(m))

    natural = _Branches(src, dst)  # float64's own branches
    with natural, torch.no_grad():
        loss_fn(start64, x.double(), src, dst, labels, config, impl="torch",
                num_valid=b.num_seeds)
    runs = {}
    for name, impl, et in (("pallas", "pallas", tiles),
                           ("torch", "torch", None)):
        branches = _Branches(src, dst)
        with branches:
            g32 = grads(start, x, impl, et)
        with branches:
            g64 = grads(start64, x.double(), "torch")
        flips = sum(int((m32.reshape(m64.shape) != m64).sum())
                    for m32, m64 in zip(branches.masks, natural.masks))
        runs[name] = (g32, g64, flips)
    print("products-sub minibatch gradients, max |error| vs the float64 "
          "torch path on the same path's branches / the parameter's largest "
          f"|gradient| (LeakyReLU inputs whose fp32 sign differs from "
          f"float64's: pallas {runs['pallas'][2]}, torch "
          f"{runs['torch'][2]}):")
    too_far = []
    for i, pname in enumerate(param_names(start)):
        errs = {}
        for name, (g32, g64, _) in runs.items():
            scale = float(g64[i].abs().max()) or 1.0
            errs[name] = float((g32[i].double() - g64[i]).abs().max()) / scale
        ok = errs["pallas"] <= max(GRAD_FACTOR * errs["torch"], GRAD_FLOOR)
        print(f"  {pname:12s} pallas {errs['pallas']:.3e}  torch "
              f"{errs['torch']:.3e}  {'ok' if ok else 'TOO FAR'}")
        if not ok:
            too_far.append(pname)
    if too_far:
        fail(f"pallas minibatch gradients of {too_far} are more than "
             f"{GRAD_FACTOR:g}x the torch path's distance (or "
             f"{GRAD_FLOOR:g}) from float64")
    del start64, runs


def pallas_bounds(e, rows, tiles_n, hd, heads, n_src, n_dst):
    """K5's per-edge gather floor in ms, and (bound_ms, bound_by) of one K5,
    K6 and K7 launch: each input read once (zs rows an edge reads, zd/g
    rows and sigma/r of nodes with an in-edge, each real edge's two ids,
    the tile offsets, a) and each output written once (out, m, l; dzd, d_a
    and one c1 row per real edge; dzs), against the operations the real
    edges need."""
    meta = 2 * e + tiles_n + 1
    k5 = 4 * ((n_src + n_dst) * hd + meta + hd + rows * (hd + 2 * heads))
    k6 = 4 * ((n_src + 2 * n_dst) * hd + 2 * heads * n_dst + meta + 2 * hd
              + rows * hd + e * hd)
    k7 = 4 * (e * hd + meta + rows * hd)
    # K5's per-edge gather floor: one zs row per real edge (no reuse of a
    # source across edges), the rest as in its bound
    k5_floor = k5 + 4 * (e - n_src) * hd
    return k5_floor / PEAK_BYTES_PER_S * 1e3, {
        "pallas_fwd": _bound(k5, e * hd * K5_OPS_PER_FEATURE),
        "pallas_bwd_dst": _bound(k6, e * hd * K6_OPS_PER_FEATURE),
        "pallas_segsum": _bound(k7, e * hd * K7_OPS_PER_FEATURE),
    }


def phase_pallas_kernels_at_main_path(mb, card):
    """K5, K6 and K7 against their twins, and their times, at each layer's
    shapes of one products-sub batch: the layer's projections, K5's stats,
    a seeded random upstream gradient; K6's unwritten padding packets are
    poisoned with NaN before K7 reads the packets."""
    tr, b, config, start = mb["trainer"], mb["kept"][0], mb["config"], \
        mb["start"]
    max_err = dict.fromkeys(PALLAS_KERNELS, 0.0)
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                   library_ms=0.0, floor_ms=0.0) for k in PALLAS_KERNELS}
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
        # the library call for K7's function: one index_add_ of every
        # packet into its edge's src row (padding slots into a spare row)
        lib_idx = torch.where(real, side.other_grp[0], rows).long()
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
            k7 = (c1, tiles.gather_perm, tiles.src_sorted_ids,
                  tiles.src_tile_offsets, tiles.tile_e)
            dzs = pallas_segsum(*k7)
            if not bool(torch.isfinite(dzs).all()):
                fail(f"{tag}: K7 read a padding packet")
            w_dzs = pallas_segsum_plain(*k7)
            w64 = pallas_segsum_plain(c1.double(), *k7[1:])
            lib = torch.zeros(rows + 1, hd, device=c1.device).index_add_(
                0, lib_idx, c1)
            max_err["pallas_segsum"] = max(
                max_err["pallas_segsum"],
                compare_f64(f"{tag} K7 dzs [{tuple(dzs.shape)}]", dzs, w_dzs,
                            w64))
            compare_f64(f"{tag} index_add_ (library) dzs", lib[:rows], w_dzs,
                        w64)
            del w_dzs, w64, lib
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
            k5_floor, bounds = pallas_bounds(e, rows, tiles.num_node_tiles,
                                             hd, heads, n_src, n_dst)
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
                    cuda_ms(lambda: torch.zeros(
                        rows + 1, hd, device=c1.device
                    ).index_add_(0, lib_idx, c1))),
            }
            for k, (ms, plain_ms, lib_ms) in times.items():
                bound, by = bounds[k]
                lib_txt = f", index_add_ {lib_ms:.4f} ms" if lib_ms else ""
                floor_txt = (f", per-edge gather floor {k5_floor:.4f} ms"
                             if k == "pallas_fwd" else "")
                print(f"  {tag} H*D={hd}: {k} {ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({by}){floor_txt}, twin "
                      f"{plain_ms:.3f} ms{lib_txt} [{card}]")
                t = tot[k]
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["bound_ms"] += bound
                t["bytes_ms"] += bound if by == "bytes" else 0.0
                t["library_ms"] += lib_ms
                t["floor_ms"] += k5_floor if k == "pallas_fwd" else 0.0
            del got, out, dzd, c1, dzs
            x = layer(x, None, None, is_last=l == len(start.layers) - 1,
                      config=config, impl="pallas", edge_tiles=tiles)
    for k, t in tot.items():
        print(f"  products-sub {k} per step: {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms"
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
    Trainers of the training phase; epoch times beside SELL's."""
    launches = {}
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
        launches[name] = counts
        del tr
    return launches


def phase_minibatch_entry():
    """python -m gatv2_tpu_torch.train --batch-size on karate with a
    checkpoint, then predict --impl pallas from that checkpoint."""
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


# ---------------------------------------------------------------------------
# the fourth main path: chunked full-graph training through K4 and K8
# ---------------------------------------------------------------------------


def chunk_rows(side, spc, chunk):
    """The perm rows of one chunk of a SELL side."""
    return side.perm[chunk * spc * TILE_N: (chunk + 1) * spc * TILE_N]


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
    """(bound_ms, bound_by, real edges) of one K8 launch on src chunk
    `chunk` of the edge tiles et (on the card): the zs rows of the chunk's
    sources with an edge, the zd and g rows and sigma, r of the destinations
    its edges reach, each read once; each real edge's two ids, the tile
    offsets, a; the dzs rows written."""
    side = et.src_side
    rows = et.padded_src_nodes // et.num_chunks
    real = side.ids_grp[chunk] < rows
    e = int(real.sum())
    n_src = int(torch.unique(side.ids_grp[chunk][real]).numel())
    n_dst = int(torch.unique(side.other_grp[chunk][real]).numel())
    nbytes = 4 * (n_src * hd + 2 * n_dst * hd + 2 * n_dst * heads + 2 * e
                  + side.rel_offsets[chunk].numel() + hd + rows * hd)
    return (*_bound(nbytes, e * hd * K8_OPS_PER_FEATURE), e)


def phase_products_full(dev, card):
    """Drive the chunked main path: full-graph training of bench.py's
    products-full (61.9 M edges, heads 2,1,1, outdims 64,32,16, weights
    from torch.Generator seed 0) through Trainer(impl='sell') with its own
    default chunk budget, TRAIN_EPOCHS epochs of Adam with clipping, the
    K1-K4 counters zeroed just before and read just after; then its epoch
    time, peak memory, a profiler table, and one epoch with remat=True
    from the same start."""
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
    tr.run(1)
    remat_peak = torch.cuda.max_memory_allocated(dev)
    tr.model_config = config
    remat_loss = tr.metrics_sink.losses[0]
    rel = abs(remat_loss - losses[0]) / abs(losses[0])
    print(f"products-full remat epoch: loss {remat_loss!r} against epoch 1's "
          f"{losses[0]!r}, relative difference {rel:.3e} (tolerance "
          f"{REMAT_RTOL:g}); peak memory {remat_peak / 2**30:.2f} GiB "
          f"[{card}]")
    if rel > REMAT_RTOL:
        fail("products-full: the remat epoch's loss differs from epoch 1's")
    return dict(graph=g, config=config, start=start, trainer=tr,
                launches=launches)


def phase_k4_at_products_full(pf, card):
    """K4 against its twin and float64, and K2 on a dst chunk without
    packets against its launch with them, its twin and float64, at each
    products-full layer's shapes on chunk 0 (the layer's projections from
    the start weights, sigma from its chunked forward, a seeded random
    upstream gradient); each layer's K4 time beside its bound and its
    twin's."""
    tr, config = pf["trainer"], pf["config"]
    st = tr.edge_tiles
    model = copy.deepcopy(pf["start"]).to(st.srcs.perm.device)
    gen = torch.Generator(device=st.srcs.perm.device).manual_seed(4)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
               floor_ms=0.0)
    max_err = 0.0
    lay_s = (chunk_rows(st.srcs, st.spc_src, 0), st.srcs.ids_grp[0],
             st.srcs.cnt_grp[0], st.srcs.rel_off[0])
    lay_d = (chunk_rows(st.dst, st.spc_dst, 0), st.dst.ids_grp[0],
             st.dst.cnt_grp[0], st.dst.rel_off[0])
    kw = dict(negative_slope=SLOPE)
    with torch.no_grad():
        x = tr.features
        for l, layer in enumerate(model.layers):
            zs, zd = layer.project(x, config.precision)
            a = layer.a.detach().contiguous()
            heads, hd = a.shape[0], zs.shape[1]
            out, sigma = sell_forward(zs, zd, a, x.shape[0],
                                      negative_slope=SLOPE, sell_tiles=st)
            gout = torch.randn(x.shape[0], hd, generator=gen,
                               device=x.device)
            rr = (gout * out).view(-1, heads, hd // heads).sum(-1)
            del out
            tables = (zs, zd, gout, sigma, rr, a)
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
            del dzs, tables, zs, zd, gout
            x = layer(x, None, None, is_last=l == len(model.layers) - 1,
                      config=config, impl="sell", edge_tiles=st)
    print(f"  products-full sell_bwd_src, chunk 0 of each layer: "
          f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, per-edge "
          f"gather floor {tot['floor_ms']:.4f} ms, twin "
          f"{tot['plain_ms']:.3f} ms [{card}]")
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
    same weights."""
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
    return dict(trainer=trainers["pallas"], launches=launches)


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
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0)
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
            plain_ms = cuda_ms(
                lambda: pallas_bwd_src_plain(*tables, *lay_s, **kw),
                reps=2, warmup=1)
            bound, by, e = k8_bound_ms(et, 0, hd, heads)
            print(f"  {tag} H*D={hd}, {e} real edges: pallas_bwd_src "
                  f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), twin "
                  f"{plain_ms:.3f} ms, library none [{card}]")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["bytes_ms"] += bound if by == "bytes" else 0.0
            del dzs, tables, zs, zd, gout
            x = layer(x, None, None, is_last=l == len(model.layers) - 1,
                      config=config, impl="pallas", edge_tiles=et)
    print(f"  products-sub pallas_bwd_src, chunk 0 of each layer: "
          f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, twin "
          f"{tot['plain_ms']:.3f} ms [{card}]")
    return max_err, tot


def main() -> int:
    card = phase_device()  # the nvidia-smi name and power limit
    dev = torch.device("cuda", 0)
    phase_build()
    # the chunked main path first, while the card's memory is free: the
    # default chunk budget is a quarter of it
    pf = phase_products_full(dev, card)
    err_k4, k4_totals = phase_k4_at_products_full(pf, card)
    pf_launches = pf["launches"]
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
    phase_predict(dev)
    phase_train_entry()
    mb = phase_minibatch_main_path(dev, card)
    phase_minibatch_losses(mb, dev)
    err_pallas, pallas_totals = phase_pallas_kernels_at_main_path(mb, card)
    phase_minibatch_gradients(mb, dev)
    err_pallas_cases = phase_pallas_cases(dev)
    phase_pallas_full_graph(model, config, runs, dev, card)
    phase_chunk_invariance(model, config, runs, dev, card)
    err_chunked_cases = phase_chunked_cases(dev)
    phase_minibatch_entry()
    pfs = phase_products_sub_full_graph(mb, dev, card)
    err_k8, k8_totals = phase_k8_at_products_sub(mb, pfs, card)
    measured = {
        "sell_fwd": (totals["arxiv"], max(err_main, err_cases)),
        "sell_bwd_dst": (bwd_totals["arxiv"]["sell_bwd_dst"],
                         max(err_bwd["sell_bwd_dst"], err_bwd_cases)),
        "sell_segsum": (bwd_totals["arxiv"]["sell_segsum"],
                        max(err_bwd["sell_segsum"], err_bwd_cases)),
    }
    measured.update({k: (pallas_totals[k], max(err_pallas[k],
                                               err_pallas_cases))
                     for k in PALLAS_KERNELS})
    measured["sell_bwd_src"] = (k4_totals, max(err_k4, err_chunked_cases))
    measured["pallas_bwd_src"] = (k8_totals, max(err_k8, err_chunked_cases))
    launches = {k: infer_launches[k] + train_launches[k]
                for k in SELL_KERNELS}
    launches.update({k: mb["launches"][k] for k in PALLAS_KERNELS})
    launches["pallas_fwd"] += mb["exact_launches"]
    for k in CHUNKED_SELL_KERNELS:
        launches[k] = launches.get(k, 0) + pf_launches[k]
    for k in CHUNKED_PALLAS_KERNELS:
        launches[k] = launches.get(k, 0) + pfs["launches"][k]
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
          f"forwards, {TRAIN_EPOCHS} training epochs on each graph), K5-K7 "
          f"on the minibatch main path ({MB_WARMUP + MB_TIMED} batches) and, "
          "for K5, its exact evaluation; K1, K2 and K4 also on the "
          f"products-full main path ({TRAIN_EPOCHS} epochs), K5, K6 and K8 "
          f"on products-sub full-graph pallas training ({TRAIN_EPOCHS} "
          "epochs); library_ms: K1, K2, K4, K5, K6 and K8 have no single "
          "PyTorch call that computes their fused function, K3's and K7's "
          "is index_add_")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
