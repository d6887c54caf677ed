#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gatv2_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases (any failure exits non-zero):
  1. the device: name, count, torch/CUDA versions, nvidia-smi name and
     power limit; no CUDA device is a failure;
  2. build every CUDA kernel from gatv2_tpu_torch/csrc (one nvcc per
     source, all at once), with nvcc's register / shared-memory report;
  3. full-width inference, the first main path: the headline model (3
     layers, heads 4,1,1, outdims 64,32,16, random weights from a seeded
     torch.Generator) at ogbn-arxiv scale on a uniform graph ('arxiv') and
     a Zipf(1.2) graph ('arxiv-pl'), through model_forward(impl='sell');
     K1's launch counter is zeroed just before and read just after. The
     logits must be finite and match impl='torch';
  4. full-width training, the second main path: the port's Trainer
     (impl='sell', Adam, lr 0.01, clipping, 3 epochs) on both graphs from
     the same weights, K1/K2/K3 counters zeroed just before and read just
     after; the losses must be finite and match a Trainer on impl='torch';
  5. one step's gradients: sell and the fp32 torch path, each against the
     torch path in float64;
  6. every kernel against its plain PyTorch twin on the card, at the main
     paths' per-layer shapes and on extra layouts (chunked, 20 heads, bf16
     streams, isolated nodes, no edges), with each layer's kernel time
     beside its bound, the twin's time and, for K3, index_add_'s;
  7. forward and epoch times, peak memory, profiler tables;
  8. the entry points end to end, as subprocesses: predict on data/digits;
     train on data/karate with a checkpoint, then predict from it;
  9. one JSON line listing every kernel, the nvidia-smi line, then the
     result line {"ok": true, "device": {...}}.

Every time is measured with CUDA events and printed with the card's name
and power limit.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
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
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models.gatv2 import init_params, loss_fn, model_forward
from gatv2_tpu_torch.models.params_io import save_params_txt
from gatv2_tpu_torch.ops import build
from gatv2_tpu_torch.ops.attention import edge_attention
from gatv2_tpu_torch.ops.sell_attention import (
    TILE_N,
    prepare_sell_tiles,
    sell_attention,
    sell_forward,
    setup_full_graph_sell,
)
from gatv2_tpu_torch.ops.sell_bwd_dst import sell_bwd_dst, sell_bwd_dst_plain
from gatv2_tpu_torch.ops.sell_fwd import sell_fwd, sell_fwd_plain
from gatv2_tpu_torch.ops.sell_segsum import sell_segsum, sell_segsum_plain
from gatv2_tpu_torch.train import optim
from gatv2_tpu_torch.train.loop import Trainer

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
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(build.build, names)))
    print(f"built {', '.join(names)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
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
    for name, k in launches.items():
        if k == 0:
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


def phase_gradients(model, config, runs, dev):
    """One step's gradients of the loss: sell (K1-K3) and the fp32 torch
    path, each against the torch path in float64, per parameter."""
    model64 = copy.deepcopy(model).double()
    names = param_names(model)

    def grads(m, feats, src, dst, labels, impl, st=None, num_valid=None):
        loss, _ = loss_fn(m, feats, src, dst, labels, config, impl=impl,
                          edge_tiles=st, num_valid=num_valid)
        return torch.autograd.grad(loss, optim.param_leaves(m))

    for name, r in runs.items():
        n = r["graph"].num_nodes
        labels = r["labels"][:n]
        g_sell = grads(model, r["feats"], None, None, r["labels"], "sell",
                       r["st"], r["num_valid"])
        g_torch = grads(model, r["feats"][:n], r["src"], r["dst"], labels,
                        "torch")
        g64 = grads(model64, r["feats"][:n].double(), r["src"], r["dst"],
                    labels, "torch")
        print(f"{name} gradients, max |error| vs the float64 torch path / "
              f"the parameter's largest |gradient|:")
        for pname, a, b, c in zip(names, g_sell, g_torch, g64):
            scale = float(c.abs().max()) or 1.0
            e_sell = float((a.double() - c).abs().max()) / scale
            e_torch = float((b.double() - c).abs().max()) / scale
            ok = e_sell <= max(GRAD_FACTOR * e_torch, GRAD_FLOOR)
            print(f"  {pname:12s} sell {e_sell:.3e}  torch {e_torch:.3e}  "
                  f"{'ok' if ok else 'TOO FAR'}")
            if not ok:
                fail(f"{name}: sell gradient of {pname} is more than "
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


def main() -> int:
    card = phase_device()  # the nvidia-smi name and power limit
    dev = torch.device("cuda", 0)
    phase_build()
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
    measured = {
        "sell_fwd": (totals["arxiv"], max(err_main, err_cases)),
        "sell_bwd_dst": (bwd_totals["arxiv"]["sell_bwd_dst"],
                         max(err_bwd["sell_bwd_dst"], err_bwd_cases)),
        "sell_segsum": (bwd_totals["arxiv"]["sell_segsum"],
                        max(err_bwd["sell_segsum"], err_bwd_cases)),
    }
    line = {"kernels": []}
    for name, (t, err) in measured.items():
        k = KERNELS[name]
        line["kernels"].append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": infer_launches[name] + train_launches[name],
            "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["bound_ms"] / 2
            else "operations",
            "library_ms": t.get("library_ms") or None,
        })
    print("ms / plain_ms / bound_ms / library_ms: sum over the 3 layers of "
          "one 'arxiv' forward (K1) or backward (K2, K3); launches: both "
          "main paths (both graphs' forwards, and "
          f"{TRAIN_EPOCHS} training epochs on each graph); library_ms: K1 and "
          "K2 have no single PyTorch call that computes their fused "
          "function, K3's is index_add_")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
