#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gatv2_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases (any failure exits non-zero):
  1. the device: name, count, torch/CUDA versions, nvidia-smi name and
     power limit; no CUDA device is a failure;
  2. build every CUDA kernel from gatv2_tpu_torch/csrc (one nvcc per
     source, all at once), with nvcc's register / shared-memory report;
  3. full-width inference, the main path: the headline model (3 layers,
     heads 4,1,1, outdims 64,32,16, random weights from a seeded
     torch.Generator) at ogbn-arxiv scale on a uniform graph ('arxiv') and
     a Zipf(1.2) graph ('arxiv-pl'), through model_forward(impl='sell');
     kernel launch counters are zeroed just before and read just after.
     The logits must be finite and match impl='torch';
  4. every kernel against its plain PyTorch twin on the card, at the main
     path's per-layer shapes and on extra layouts (chunked, 20 heads, bf16
     streams, isolated nodes), with each layer's kernel time beside its
     bound and the twin's time;
  5. forward times and peak memory;
  6. the predict entry point end to end, as a subprocess, on data/digits;
  7. one JSON line listing every kernel, the nvidia-smi line, then the
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

from gatv2_tpu_torch.config import ModelConfig
from gatv2_tpu_torch.data.io import load_dataset
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models.gatv2 import init_params, model_forward
from gatv2_tpu_torch.models.params_io import save_params_txt
from gatv2_tpu_torch.ops import build
from gatv2_tpu_torch.ops.sell_attention import (
    TILE_N,
    prepare_sell_tiles,
    sell_forward,
    setup_full_graph_sell,
)
from gatv2_tpu_torch.ops.sell_fwd import sell_fwd, sell_fwd_plain

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

KERNELS = {
    "sell_fwd": dict(
        fn=sell_fwd, route="cuda", source="gatv2_tpu_torch/csrc/sell_fwd.cu",
        replaces="gatv2_tpu/ops/sell_attention.py:802",
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
    ops = e * hd * K1_OPS_PER_FEATURE
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
        st, feats, _, _ = setup_full_graph_sell(
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
            src=torch.as_tensor(g.src, device=dev),
            dst=torch.as_tensor(g.dst, device=dev),
        )

    for k in KERNELS.values():
        k["fn"].launches = 0
    with torch.inference_mode():
        for name, r in runs.items():
            before = sell_fwd.launches
            r["logits"] = model_forward(
                model, r["feats"], None, None, config, impl="sell",
                edge_tiles=r["st"], device=dev,
            )[: r["graph"].num_nodes]
            torch.cuda.synchronize()
            r["launches"] = sell_fwd.launches - before
    launches = {n: k["fn"].launches for n, k in KERNELS.items()}
    print(f"main path launches: {launches}")
    for name, k in launches.items():
        if k == 0:
            fail(f"kernel {name} was not launched on the main path")

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
            profile_forward(lambda: model_forward(
                model, r["feats"], None, None, config, impl="sell",
                edge_tiles=r["st"], device=dev), name, sell_ms, card)


def profile_forward(fn, name, wall_ms, card, reps=5):
    """Device time per forward by kernel (torch.profiler), and the share of
    the CUDA-event wall time the device was busy."""
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
    print(f"{name} sell forward, device time by kernel (torch.profiler, "
          f"{reps} forwards) [{card}]: busy {busy:.3f} ms of {wall_ms:.3f} "
          f"ms wall ({100 * busy / wall_ms:.0f}%)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.4f} ms  x{count:<3d} {key[:90]}")


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
    model, config, runs, launches = phase_main_path(dev)
    err_main, totals = phase_kernels_at_main_path(model, config, runs, card)
    err_cases = phase_kernel_cases(dev)
    phase_forward_times(model, config, runs, dev, card)
    phase_predict(dev)
    t = totals["arxiv"]
    k1 = KERNELS["sell_fwd"]
    line = {"kernels": [{
        "name": "sell_fwd", "route": k1["route"], "source": k1["source"],
        "replaces": k1["replaces"], "launches": launches["sell_fwd"],
        "max_abs_err": max(err_main, err_cases),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes" if t["bytes_ms"] >= t["bound_ms"] / 2
        else "operations",
        "library_ms": None,
    }]}
    print("K1 ms / plain_ms / bound_ms: sum over the 3 layers of one 'arxiv' "
          "forward; launches: both graphs' main-path forwards; library_ms: "
          "no single PyTorch call computes the fused function")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
