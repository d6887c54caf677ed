#!/usr/bin/env python
"""Where an epoch's device time goes: torch.profiler over runner epochs of
one bench config, device time summed by kernel category (port of
tools/profile_roofline.py).

    python tools/torch_profile_roofline.py --config arxiv --impl sell \
        [--precision highest] [--epochs 8] [--top 25] [--out DIR] \
        [--device cuda|cpu]

Builds the config as gatv2_tpu_torch.bench does, runs the multi-epoch
runner once to warm up (outside the trace), then traces one call of
--epochs epochs (fresh weights from a torch.Generator seeded 0) and writes
DIR/trace.json (chrome://tracing or Perfetto; default
profiles/roofline_<config>_<impl> under the repo root). Prints one JSON
summary: the call's wall time (CUDA events, profiler on), the device's
busy time (the kernels' and copies' self time) and idle share, device time
by category (categorize) and the top kernels. With --device cpu the
categories sum the host's self time of each op and the busy and idle
fields are null.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gatv2_tpu_torch.bench import (  # noqa: E402
    CONFIGS,
    device_fields,
    fresh_state,
    setup_config,
)

# the hand-written kernels by their csrc symbol: K1-K8, and the merge
# launch of hub segments that K6, K7 and K8 share (csrc/edge_tiles.cuh)
HAND_KERNELS = (
    ("sell_fwd_kernel", "K1 sell_fwd"),
    ("sell_bwd_dst_kernel", "K2 sell_bwd_dst"),
    ("sell_segsum_kernel", "K3 sell_segsum"),
    ("sell_bwd_src_kernel", "K4 sell_bwd_src"),
    ("pallas_fwd_kernel", "K5 pallas_fwd"),
    ("pallas_bwd_dst_kernel", "K6 pallas_bwd_dst"),
    ("pallas_segsum_kernel", "K7 pallas_segsum"),
    ("pallas_bwd_src_kernel", "K8 pallas_bwd_src"),
    ("merge_segments", "K6-K8 merge_segments"),
)


def categorize(name: str) -> str:
    """The category of a kernel (or, on the CPU, an op) by the name the
    profiler gives it: a hand kernel by its csrc symbol; collectives
    (gloo:*, nccl*); dense GEMMs (sm80_xmma_gemm_*, cutlass_*, cuBLAS's
    split-K reduction); scatters (indexFuncLargeIndex: index_add_,
    index_put, scatter); gathers (vectorized_gather_kernel, index_select,
    advanced indexing); layout copies (memcpy, memset, CatArrayBatchedCopy,
    copy kernels); elementwise kernels and reductions; else other."""
    for symbol, kernel in HAND_KERNELS:
        if symbol in name:
            return kernel
    low = name.lower()
    if low.startswith("gloo:") or "nccl" in low:
        return "collective"
    if ("gemm" in low or "cutlass" in low or "cublas" in low
            or low in ("aten::mm", "aten::addmm")):
        return "dense_gemm"
    if ("indexfunc" in low or "index_add" in low or "index_put" in low
            or "scatter" in low):
        return "scatter_index_add"
    if ("gather" in low or "index_select" in low or "indexselect" in low
            or "gpu_index_kernel" in low or low == "aten::index"):
        return "gather_index_select"
    if ("memcpy" in low or "memset" in low or "catarraybatchedcopy" in low
            or "copy" in low or low == "aten::cat"):
        return "layout_copy"
    if "elementwise" in low or "reduce" in low or "softmax" in low:
        return "elementwise"
    return "other"


def capture(config, impl, precision, epochs, out_dir, dev, tile_e=None):
    """Trace one runner call of `epochs` epochs; returns (the profiler,
    the call's wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

    s = setup_config(config, impl=impl, device=dev, precision=precision,
                     tile_e=tile_e)
    mc = s["model_config"]
    runner = make_multi_epoch_runner(mc, s["train_config"], epochs,
                                     edge_tiles=s["edge_tiles"],
                                     num_valid=s["num_valid"])
    args = tuple(s[k] for k in ("features", "src", "dst", "labels"))

    def run_once():
        params, opt = fresh_state(mc, 0, dev)
        return runner(params, opt, 0, *args)[2]

    on_card = dev.type == "cuda"
    run_once()
    activities = [ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize(dev)
        activities.append(ProfilerActivity.CUDA)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    with profile(activities=activities) as prof:
        if on_card:
            start.record()
        losses = run_once()
        if on_card:
            end.record()
            end.synchronize()
    if not bool(torch.isfinite(losses).all()):
        raise SystemExit(f"non-finite losses: {losses.tolist()}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    return prof, (start.elapsed_time(end) if on_card else None)


def summarize(prof, wall_ms, epochs, top, on_card) -> dict:
    """Device time (host self time on the CPU) by category and by kernel,
    the busy and idle share of the wall time. On the card a program span's
    device row (its user annotation, which covers its kernels) is not
    counted again."""
    per: dict[str, list] = {}
    for ev in prof.key_averages():
        if on_card:
            if not str(getattr(ev, "device_type", "")).endswith("CUDA") \
                    or getattr(ev, "is_user_annotation", False):
                continue
            t = getattr(ev, "self_device_time_total", 0) or 0
        else:
            t = ev.self_cpu_time_total
        if t > 0:
            row = per.setdefault(ev.key, [0.0, 0])
            row[0] += t / 1e3
            row[1] += ev.count
    total = sum(ms for ms, _ in per.values())
    cats: dict[str, float] = {}
    for name, (ms, _) in per.items():
        cats[categorize(name)] = cats.get(categorize(name), 0.0) + ms
    order = sorted(cats.items(), key=lambda kv: -kv[1])
    rows = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    pct = (lambda ms: round(ms / total * 100, 2)) if total else (
        lambda ms: None)
    return {
        "wall_ms": round(wall_ms, 3) if on_card else None,
        "device_busy_ms": round(total, 3) if on_card else None,
        "busy_pct": round(total / wall_ms * 100, 2) if on_card else None,
        "idle_pct": (round(100 - total / wall_ms * 100, 2) if on_card
                     else None),
        "host_self_ms": None if on_card else round(total, 3),
        "per_epoch_ms": {k: round(v / epochs, 4) for k, v in order},
        "categories_ms": {k: round(v, 3) for k, v in order},
        "categories_pct": {k: pct(v) for k, v in order},
        "top_kernels": [
            {"name": n[:160], "ms": round(ms, 3), "count": cnt,
             "pct": pct(ms), "cat": categorize(n)}
            for n, (ms, cnt) in rows],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="arxiv", choices=list(CONFIGS))
    ap.add_argument("--impl", default="sell",
                    choices=["torch", "sell", "pallas"])
    ap.add_argument("--precision", default="highest",
                    choices=["highest", "high", "default"])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--tile-e", type=int, default=None)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None,
                    help="trace directory (default: profiles/roofline_"
                         "<config>_<impl> under the repo root)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    out = args.out or str(ROOT / "profiles"
                          / f"roofline_{args.config}_{args.impl}")
    prof, wall = capture(args.config, args.impl, args.precision,
                         args.epochs, out, dev, tile_e=args.tile_e)
    s = summarize(prof, wall, args.epochs, args.top, dev.type == "cuda")
    print(json.dumps({
        "config": args.config, "impl": args.impl,
        "precision": args.precision, "epochs_traced": args.epochs,
        "trace": str(pathlib.Path(out) / "trace.json"), **s,
        **device_fields(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
