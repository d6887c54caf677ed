"""Benchmark: GATv2 full-graph training throughput of the port on the card
(port of the root bench.py).

    python -m gatv2_tpu_torch.bench [--config arxiv] [--impl auto]
    python -m gatv2_tpu_torch.bench --all          # every config, stderr
    python -m gatv2_tpu_torch.bench --mesh 2 --config arxiv
    python -m gatv2_tpu_torch.bench --config citeseer3 --device cpu

Measures the reference's headline model (3 layers, heads 4,1,1, outdims
64,32,16, Adam lr 0.01) on the synthetic graphs of CONFIGS and prints ONE
JSON line: the epoch time (forward, backward, update), edges/s, the model
FLOP share of the card's peak at the run's precision tier, the spread of the
samples, peak memory, set-up time, the card's name and power limit, and
whether the result is right (`correct`: check_run holds the run's logits
and gradient at its start weights, and its logits after one runner epoch,
to an independent path's from the same weights).

Methodology: the epochs run in the multi-epoch runner
(train/loop.py make_multi_epoch_runner), which reads nothing back between
epochs. The epoch time is a difference of two runner calls of k1 and k2
epochs, (t(k2) - t(k1)) / (k2 - k1), timed with CUDA events, which cancels
the fixed cost of a call (weights and Adam state made afresh from a
torch.Generator seeded by --seed, the first launches); reps such pairs give
the samples. With --device cpu the same runs go through the kernels' plain
twins, timed by the host clock, and the line says "device": "cpu" with null
in every field only the card can give. Without --device cpu and without a
card it raises; it never falls back.

--mesh N times the sharded step (parallel/sharded.py) on N ranks, one
process each: started here (parallel/multihost.RankPool) or joined from
torchrun's environment (torchrun --nproc-per-node N -m
gatv2_tpu_torch.bench --mesh N). Rank 0 prints the line. Ranks that share
one card go through gloo and host memory: the line says so
(ranks_per_card), and such a time is not a multi-GPU time.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the reference's one published epoch time: its README's Citeseer example
# (3 layers, heads 4,1,1, outdims 64,32,16) on its example GPU
REFERENCE_EPOCH_MS = 6367.0

CONFIGS = {
    # name: (N, E, F, C, layers, heads, outdims)
    "citeseer3": (3327, 4732, 3703, 6, 3, (4, 1, 1), (64, 32, 16)),
    "cora": (2708, 5429, 1433, 7, 2, (8, 1), (64, 32)),
    "pubmed": (19717, 44338, 500, 3, 3, (4, 1, 1), (64, 32, 16)),
    "arxiv": (169343, 1166243, 128, 40, 3, (4, 1, 1), (64, 32, 16)),
    "products-sub": (500000, 8000000, 100, 47, 3, (4, 1, 1), (64, 32, 16)),
    # ogbn-products at full scale, trained full-graph on one card through
    # the chunked kernels and per-layer remat, with 2 heads in layer 0
    "products-full": (2449029, 61859140, 100, 47, 3, (2, 1, 1), (64, 32, 16)),
    # the reference's 4-head headline at full products scale; --all skips
    # it unless it is named
    "products-full-4h": (2449029, 61859140, 100, 47, 3, (4, 1, 1), (64, 32, 16)),
    # arxiv scale with a Zipf(1.2) degree profile on both endpoints: the
    # hub-heavy regime of real citation and product graphs (SELL splits hub
    # rows, the edge-tile kernels split hubs over blocks)
    "arxiv-pl": (169343, 1166243, 128, 40, 3, (4, 1, 1), (64, 32, 16)),
    # the same hub-heavy profile at full products scale: row splitting,
    # chunking and remat together on 61.9 M edges
    "products-full-pl": (
        2449029, 61859140, 100, 47, 3, (2, 1, 1), (64, 32, 16)
    ),
}
# --all runs every config but these, unless --config names one
ALL_SKIPS = ("products-full-4h",)

# H100 SXM peaks (NVIDIA data sheet, dense) of the dense projections' tier:
# --precision highest is IEEE fp32 outside the tensor cores, high is TF32,
# default rounds the inputs to bf16 (models/gatv2.py dense)
PEAK_TFLOPS = {"highest": (67.0, "fp32"), "high": (495.0, "tf32"),
               "default": (989.0, "bf16")}
# remat from this many edges (per shard on a mesh), as the JAX bench does
REMAT_EDGES = 30_000_000
# `correct` holds the runner to an independent path from the same weights:
# the torch impl up to this many edges (and sell for the torch impl
# itself); above it, where the torch path's edge-space tensors outgrow the
# card, the other kernel family (sell <-> pallas: other layouts, other
# kernels), which is held to the torch path below it
CHECK_MAX_EDGES = 8_000_000
# its tolerances (_compare), each of the oracle's size: the logits at the
# start weights and after one runner epoch in max|logit|, each gradient
# leaf at the start weights in its norm
CHECK_RTOL = {"logits0": 1e-3, "logits1": 1e-2, "grads0": 1e-2}

# the keys of the single-device line and of the --mesh line
LINE_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "edges_per_s", "mfu",
    "achieved_model_tflops", "variance_pct", "device", "impl", "precision",
    "epoch_ms", "epoch_ms_min", "epoch_ms_q1", "epoch_ms_q3",
    "epoch_ms_all", "samples", "peak_tflops", "peak_tier", "num_chunks",
    "streams", "peak_mem_gib", "setup_s", "host_cpus", "final_loss",
    "power_limit_w", "correct", "correct_check", "check_errs")
MESH_FIELDS = (
    "metric", "value", "unit", "mesh", "halo", "overlap", "edges_per_s",
    "edges_per_s_per_chip", "comm_volume", "transport", "ranks_per_card",
    "variance_pct", "device", "impl", "precision", "epoch_ms",
    "epoch_ms_min", "epoch_ms_q1", "epoch_ms_q3", "epoch_ms_all", "samples",
    "setup_s", "host_cpus", "final_loss", "power_limit_w", "correct",
    "correct_check", "check_errs")
# the fields only the card gives (null with --device cpu)
DEVICE_ONLY = ("mfu", "achieved_model_tflops", "peak_mem_gib",
               "power_limit_w")


def bench_graph(name, n, e, f, c, seed):
    from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph

    if name.endswith("-pl"):
        return powerlaw_graph(n, e, f, c, seed=seed, alpha=1.2)
    return random_graph(n, e, f, c, seed=seed)


def flops_per_epoch(name: str) -> dict:
    """Model FLOPs of one training epoch (forward, backward, update): dense
    projections (zs and zd per layer, and the classifier) and per-edge work
    (score dot, softmax, aggregation: ~6D+10 FLOPs per edge and head). A
    matmul's backward costs twice its forward, so the epoch is ~3x the
    forward. The JAX bench's structural count (the extra products of the
    TPU's 128-lane padding) is not kept: no kernel of the port computes
    them."""
    n, e, f, c, layers, heads, outdims = CONFIGS[name]
    in_dims = [f] + [heads[l] * outdims[l] for l in range(layers - 1)]
    dense = 0.0
    edge = 0.0
    for l in range(layers):
        h, d = heads[l], outdims[l]
        dense += 2 * 2.0 * n * in_dims[l] * h * d  # zs and zd projections
        edge += e * h * (6.0 * d + 10.0)
    dense += 2.0 * n * outdims[-1] * c  # classifier
    fwd_bwd = 3.0
    return {
        "model_gflop": fwd_bwd * (dense + edge) / 1e9,
        "dense_gflop": fwd_bwd * dense / 1e9,
        "edge_gflop": fwd_bwd * edge / 1e9,
    }


def _rep_plan(e: int, k1, k2, reps):
    """(k1, k2, reps) by edge count, one table for the single-card and the
    sharded bench: every tier takes at least 3 reps; big graphs take fewer
    epochs a call (set-up and memory), tiny ones longer calls and more
    repeats (launch noise)."""
    if k1 is not None:
        return k1, k2, reps
    if e >= 30_000_000:
        return 1, 2, 3
    if e >= 4_000_000:
        return 1, 3, 5
    if e >= 500_000:
        return 8, 40, 5
    return 10, 310, 7


def differenced_ms(runs, plan, device="cuda"):
    """The differenced epoch time of each of `runs` ({name: run_k}):
    run_k(k1) and run_k(k2) once each to warm up, then reps pairs, the runs
    taking turns (their order alternating from rep to rep); each pair gives
    (t(k2) - t(k1)) / (k2 - k1) ms an epoch. Timed with CUDA events on the
    card, by the host clock on the CPU (where every call is synchronous).
    Returns {name: the reps values}."""
    k1, k2, reps = plan
    on_card = torch.device(device).type == "cuda"

    def timed(run_k, k):
        if not on_card:
            t0 = time.perf_counter()
            run_k(k)
            return (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_k(k)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for run_k in runs.values():
        timed(run_k, k1)
        timed(run_k, k2)
    diffs = {name: [] for name in runs}
    order = list(runs)
    for _ in range(reps):
        for name in order:
            small = timed(runs[name], k1)
            diffs[name].append((timed(runs[name], k2) - small) / (k2 - k1))
        order.reverse()
    return diffs


def timing_line(diffs, plan):
    k1, k2, reps = plan
    return (f"median {float(np.median(diffs)):.3f} ms, min {min(diffs):.3f} "
            f"(differenced, k1={k1}, k2={k2}, {reps} reps: "
            f"{[round(d, 3) for d in diffs]})")


def timing_fields(diffs):
    """The epoch time's median, min, quartiles, every sample and their
    count, and variance_pct: (max - min) / median in percent, the JAX
    bench's spread."""
    epoch_ms = float(np.median(diffs))
    q1, q3 = (float(q) for q in np.percentile(diffs, [25, 75]))
    variance_pct = (
        (max(diffs) - min(diffs)) / epoch_ms * 100.0 if len(diffs) > 1 else 0.0
    )
    return {
        "epoch_ms": epoch_ms,
        "epoch_ms_min": float(min(diffs)),
        "epoch_ms_q1": q1,
        "epoch_ms_q3": q3,
        "epoch_ms_all": [round(d, 4) for d in diffs],
        "samples": len(diffs),
        "variance_pct": round(variance_pct, 1),
    }


def _host_cpus() -> int:
    """CPUs this process may run on (its affinity, not the machine's
    count)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


def card_line() -> str:
    """`name, power limit` of card 0 as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_fields(dev) -> dict:
    """The card's name and power limit, or the CPU with nulls."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    limit = card_line().rsplit(",", 1)[1].strip()
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit_w": float(limit.split()[0])}


def _oracle(impl, num_edges):
    """The path that `correct` holds a run of `impl` to (None: the torch
    impl above CHECK_MAX_EDGES)."""
    if impl == "torch":
        return "sell" if num_edges <= CHECK_MAX_EDGES else None
    if num_edges <= CHECK_MAX_EDGES:
        return "torch"
    return {"sell": "pallas", "pallas": "sell"}[impl]


def _logits(params, inp, mc, impl):
    """The logits of the real nodes (the padding rows dropped)."""
    logits = params(inp["features"], inp["src"], inp["dst"], mc, impl=impl,
                    edge_tiles=inp["edge_tiles"])
    return logits[:inp["num_nodes"]]


def _probe(params, inp, mc, impl):
    """(logits, d loss / d param leaves) of `params` through `impl` on the
    runner inputs `inp` (runner_inputs)."""
    from gatv2_tpu_torch.models.gatv2 import loss_and_accuracy
    from gatv2_tpu_torch.train import optim

    logits = _logits(params, inp, mc, impl)
    loss, _ = loss_and_accuracy(logits, inp["labels"][:inp["num_nodes"]])
    grads = torch.autograd.grad(loss, optim.param_leaves(params))
    return logits.detach(), [g.detach() for g in grads]


def reference_run(graph, mc, tc, oracle, seed, dev) -> dict:
    """What `oracle` gives from the bench's start weights (fresh_state):
    the logits and the gradient at them (logits0, grads0) and the logits
    after one epoch of its runner (logits1), with its inputs (inp)."""
    from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

    inp = runner_inputs(graph, mc, oracle, dev)
    params, opt = fresh_state(mc, seed, dev)
    logits0, grads0 = _probe(params, inp, mc, oracle)
    run = make_multi_epoch_runner(
        mc, dataclasses.replace(tc, impl=oracle), 1,
        edge_tiles=inp["edge_tiles"], num_valid=inp["num_valid"])
    run(params, opt, 0, inp["features"], inp["src"], inp["dst"],
        inp["labels"])
    with torch.no_grad():
        logits1 = _logits(params, inp, mc, oracle)
    return dict(inp=inp, logits0=logits0, grads0=grads0, logits1=logits1)


def _compare(got, ref, oracle) -> tuple[bool, str, dict]:
    """(correct, what was checked, the errors) of `got` against the
    oracle's `ref` (reference_run's keys; got may lack logits0), each error
    of the oracle's size: the logits in max|logit|, each gradient leaf in
    its norm (the largest over the leaves).

    Why these: with random labels every loss sits near ln C, so a model
    that outputs uniform logits has the right loss; the logits do not.
    The gradient catches a backward that errs by a scale, which Adam's
    update does not see. The logits after one epoch catch a runner that
    updates wrongly or not at all (one epoch moves the logits by about
    their own size). Not after more: Adam turns the rounding of the
    near-zero gradient elements (layer 0's shares what the softmax's shift
    invariance cancels) into steps of lr in either direction, and two
    correct paths drift apart by ~5e-4 of the logits after one epoch, ~1e-2
    after two and ~1e-1 after five (the kernels' CPU twins against the
    torch impl on 3,000-20,000-node graphs; up to 2.1e-3 after one epoch
    on an H100)."""
    errs = {}
    for key in ("logits0", "logits1"):
        if key in got:
            errs[key] = float((got[key] - ref[key]).abs().max()
                              / ref[key].abs().max())
    errs["grads0"] = max(float(torch.linalg.vector_norm(g - r)
                               / torch.linalg.vector_norm(r))
                         for g, r in zip(got["grads0"], ref["grads0"]))
    ok = all(v <= CHECK_RTOL[k] for k, v in errs.items())
    return ok, (f"vs the {oracle} impl from the same weights: "
                + ", ".join(f"{k} {v:.2e} (tol {CHECK_RTOL[k]:g})"
                            for k, v in errs.items())), errs


def check_run(graph, mc, tc, impl, seed, dev, got, inp=None
              ) -> tuple[bool, str, dict]:
    """(correct, check, errors) of a timed run against reference_run of
    _oracle(impl). got: the timed run's losses, the parameters after one
    epoch of the run's runner from the start weights (params1), the
    gradient at those weights (grads0) and, on one device, the logits there
    (logits0). correct: every loss finite and _compare. The logits after
    the epoch go through `impl` on the run's inputs `inp` (one device), or
    without them (a mesh) through the oracle's path."""
    finite = bool(np.all(np.isfinite(got["losses"])))
    oracle = _oracle(impl, graph.num_edges)
    if oracle is None:
        return finite, (f"losses finite: {finite}; no oracle for impl "
                        f"{impl} above {CHECK_MAX_EDGES} edges"), {}
    ref = reference_run(graph, mc, tc, oracle, seed, dev)
    mine = {k: got[k] for k in ("grads0", "logits0") if k in got}
    with torch.no_grad():
        mine["logits1"] = (
            _logits(got["params1"], ref["inp"], mc, oracle) if inp is None
            else _logits(got["params1"], inp, mc, impl))
    ok, check, errs = _compare(mine, ref, oracle)
    return finite and ok, (f"{check}; all {len(got['losses'])} losses "
                           f"finite: {finite}"), errs


# the faults planted_fault can plant, and the part of the check that
# catches each
FAULTS = {"zero_attention": "logits0", "doubled_backward": "grads0",
          "skipped_update": "logits1"}


@contextlib.contextmanager
def planted_fault(fault, impl="sell"):
    """A fault of FAULTS in `impl`'s path only (its oracle's stays right),
    to show that `correct` catches it: uniform logits from zero attention
    (their loss is ln C, as a right run's nearly is at the start), a
    backward off by a scale (the same forward, twice the gradient: Adam's
    update does not see it), or a runner that never updates."""
    from gatv2_tpu_torch.models import gatv2 as model
    from gatv2_tpu_torch.train import loop

    attention, epoch = model.edge_attention, loop.train_epoch

    def faulty_attention(*args, **kw):
        h = attention(*args, **kw)
        if kw["impl"] != impl:
            return h
        if fault == "zero_attention":
            return h * 0
        return h.detach() + 2 * (h - h.detach())

    def no_update(params, opt_state, t, features, src, dst, labels, mc, tc,
                  **kw):
        if tc.impl != impl:
            return epoch(params, opt_state, t, features, src, dst, labels,
                         mc, tc, **kw)
        loss, acc = model.loss_fn(params, features, src, dst, labels, mc,
                                  impl=tc.impl, **kw)
        return loss.detach(), acc

    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {list(FAULTS)}, got "
                         f"{fault!r}")
    if fault == "skipped_update":
        loop.train_epoch = no_update
    else:
        model.edge_attention = faulty_attention
    try:
        yield
    finally:
        model.edge_attention, loop.train_epoch = attention, epoch


def _model_config(spec, precision, streams, remat):
    from gatv2_tpu_torch.config import ModelConfig

    n, e, f, c, layers, heads, outdims = spec
    return ModelConfig(num_layers=layers, heads=heads, out_dims=outdims,
                       num_classes=c, in_dim=f, matmul_precision=precision,
                       remat=remat, streams=streams)


def runner_inputs(graph, mc, impl, device, *, tile_e=None,
                  chunk_budget=None) -> dict:
    """The runner's inputs for `impl` on `device`
    (ops.attention.full_graph_inputs): the layout (SellTiles for
    impl='sell', EdgeTiles for 'pallas', chunked by chunk_budget or a
    quarter of the card's free memory; None for 'torch'), features, src
    and dst (torch only), labels, num_valid, and the graph's node count."""
    from gatv2_tpu_torch.ops.attention import full_graph_inputs

    inputs = full_graph_inputs(graph, mc, impl, device=device,
                               budget_bytes=chunk_budget, tile_e=tile_e)
    return dict(
        edge_tiles=inputs.layout, features=inputs.features, src=inputs.src,
        dst=inputs.dst, labels=inputs.labels, num_valid=inputs.num_valid,
        num_nodes=graph.num_nodes)


def setup_config(name, *, impl, device, seed=0, precision="highest",
                 tile_e=None, streams="f32", chunk_budget=None) -> dict:
    """Config `name`'s graph, model and training configs, and the runner's
    inputs (runner_inputs) on `device`."""
    from gatv2_tpu_torch.config import TrainConfig

    n, e, f, c, layers, heads, outdims = spec = CONFIGS[name]
    g = bench_graph(name, n, e, f, c, seed)
    mc = _model_config(spec, precision, streams, e >= REMAT_EDGES)
    tc = TrainConfig(optimizer="adam", lr=0.01, seed=seed, impl=impl)
    return dict(graph=g, model_config=mc, train_config=tc,
                **runner_inputs(g, mc, impl, device, tile_e=tile_e,
                                chunk_budget=chunk_budget))


def fresh_state(model_config, seed, device):
    """(params, Adam state): weights from torch.Generator seeded by
    `seed`, on `device`."""
    from gatv2_tpu_torch.models.gatv2 import init_params_for_variant
    from gatv2_tpu_torch.train import optim

    params = init_params_for_variant(
        model_config, torch.Generator().manual_seed(seed)).to(device)
    return params, optim.init_opt_state(params, "adam")


def bench_config(
    name, *, impl="sell", device="cuda", k1=None, k2=None, reps=None,
    seed=0, precision="highest", tile_e=None, streams="f32",
    chunk_budget=None, alongside=None,
) -> dict:
    """The single-device bench of config `name` (see the module
    docstring). Returns the fields of its JSON line. `alongside`
    ({name: run_k}) are runs timed in turns with the bench's runner, their
    samples returned under "alongside_ms": a comparison that the host's
    load, which moves a launch-bound epoch from one minute to the next,
    cannot tilt."""
    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

    dev = resolve_device(device)
    n, e, f, c, layers, heads, outdims = CONFIGS[name]
    k1, k2, reps = _rep_plan(e, k1, k2, reps)
    if dev.type == "cuda":
        # the chunk budget is a quarter of the free memory: what an earlier
        # config of --all left cached must not change this one's chunks
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s = setup_config(name, impl=impl, device=dev, seed=seed,
                     precision=precision, tile_e=tile_e, streams=streams,
                     chunk_budget=chunk_budget)
    mc, layout = s["model_config"], s["edge_tiles"]
    args = tuple(s[k] for k in ("features", "src", "dst", "labels"))
    runners = {k: make_multi_epoch_runner(mc, s["train_config"], k,
                                          edge_tiles=layout,
                                          num_valid=s["num_valid"])
               for k in {1, k1, k2}}  # 1: the check's epoch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    run_losses = {}

    def run_k(k):
        # fresh weights and Adam state every call; the timing drops the
        # weights it returns, so only the losses outlive it (peak memory)
        params, opt = fresh_state(mc, seed, dev)
        params, _, run_losses[k], _ = runners[k](params, opt, 0, *args)
        return params

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    diffs = differenced_ms({"runner": run_k, **(alongside or {})},
                           (k1, k2, reps), dev)
    alongside_ms = {k: diffs[k] for k in alongside or {}}
    diffs = diffs["runner"]
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else None)
    losses = run_losses[k2].tolist()
    params1 = run_k(1)
    logits0, grads0 = _probe(fresh_state(mc, seed, dev)[0], s, mc, impl)
    correct, check, errs = check_run(
        s["graph"], mc, s["train_config"], impl, seed, dev,
        dict(losses=losses, params1=params1, grads0=grads0,
             logits0=logits0), inp=s)

    timing = timing_fields(diffs)
    epoch_ms = timing["epoch_ms"]
    fl = flops_per_epoch(name)
    achieved = fl["model_gflop"] / epoch_ms  # GFLOP / ms == TFLOP/s
    peak, tier = PEAK_TFLOPS[precision]
    on_card = dev.type == "cuda"
    return {
        "config": name,
        **timing,
        "k1": k1, "k2": k2, "reps": reps,
        "edges_per_s": e * layers / (epoch_ms / 1e3),
        "model_gflop_per_epoch": round(fl["model_gflop"], 3),
        "achieved_model_tflops": round(achieved, 3) if on_card else None,
        "mfu": round(achieved / peak * 100.0, 3) if on_card else None,
        "peak_tflops": peak if on_card else None,
        "peak_tier": tier if on_card else None,
        "num_chunks": getattr(layout, "num_chunks", 1),
        "streams": streams,
        "peak_mem_gib": round(peak_gib, 3) if on_card else None,
        "setup_s": round(setup_s, 3),
        "host_cpus": _host_cpus(),
        "final_loss": losses[-1],
        "correct": correct,
        "correct_check": check,
        "check_errs": errs,
        **device_fields(dev),
        "impl": impl,
        "precision": precision,
        **({"alongside_ms": alongside_ms} if alongside else {}),
    }


def comm_volume_table(pg, plan, heads, outdims) -> list[dict]:
    """Per-layer communication volume of the sharded forward, per rank (the
    backward moves the same rows back, so a step moves ~2x these bytes).

    all_gather: each rank receives every other shard's padded node block.
    halo (boundary-only all_to_all): each rank receives (S-1) * M rows, M =
    the padded per-pair cut (HaloPlan.m_per_pair); its own block of the
    S*M-row table is not sent."""
    s = pg.num_shards
    rows_ag = pg.padded_num_nodes - pg.nodes_per_shard
    rows_halo = (s - 1) * plan.m_per_pair if plan is not None else None
    out = []
    for l, (h, d) in enumerate(zip(heads, outdims)):
        hd = h * d
        row = {
            "layer": l,
            "hd": hd,
            "all_gather_mb_per_chip": round(rows_ag * hd * 4 / 1e6, 3),
        }
        if rows_halo is not None:
            row["halo_mb_per_chip"] = round(rows_halo * hd * 4 / 1e6, 3)
            row["halo_vs_ag"] = round(rows_halo / max(rows_ag, 1), 4)
        out.append(row)
    return out


def _ranks_per_card(info) -> int:
    if info.device.type != "cuda":
        return 0
    return -(-info.local_world_size // torch.cuda.device_count())


def mesh_rank(info, name, spec, n_devices, *, halo=True, overlap=False,
              k1=None, k2=None, reps=None, impl="sell", seed=0,
              precision="highest", streams="f32"):
    """One rank of bench_mesh_config: the sharded multi-epoch runner of
    ShardedTrainer's partition, halo plan and layouts, timed as the
    single-device bench times its runner. spec: CONFIGS[name] (passed, so
    that the ranks need not know the name). Rank 0 returns the fields of
    the line, the others None."""
    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.parallel import multihost
    from gatv2_tpu_torch.parallel.sharded import (
        ShardedTrainer,
        gather_leaves,
        gather_params,
        make_sharded_loss_fn,
        make_sharded_multi_epoch_runner,
        sharded_gradients,
        shard_params,
    )
    from gatv2_tpu_torch.train import optim

    dev = info.device
    n, e, f, c, layers, heads, outdims = spec
    k1, k2, reps = _rep_plan(e, k1, k2, reps)
    t0 = time.perf_counter()
    g = bench_graph(name, n, e, f, c, seed)
    # remat on per-shard edges, so the rows of a scaling table never differ
    # in it
    mc = _model_config(spec, precision, streams,
                       e // n_devices >= REMAT_EDGES)
    tc = TrainConfig(optimizer="adam", lr=0.01, seed=seed, impl=impl)
    tr = ShardedTrainer(g, mc, tc, n_devices, log_fn=lambda _: None,
                        overlap=overlap, halo=halo, device=dev)
    runners = {k: make_sharded_multi_epoch_runner(
        mc, tc, tr.mesh, tr.pg.num_real_nodes, k, layout=tr.layout)
        for k in {1, k1, k2}}  # 1: the check's epoch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0

    def full():  # the full model's weights, on the CPU
        return fresh_state(mc, seed, "cpu")[0]

    run_losses = {}

    def run_k(k):  # as bench_config's
        params = shard_params(full().to(dev), mc, tr.mesh)
        opt = optim.init_opt_state(params, "adam")
        params, _, run_losses[k], _ = runners[k](params, opt, 0,
                                                 tr.features, tr.labels)
        return params

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    diffs = differenced_ms({"runner": run_k}, (k1, k2, reps), dev)["runner"]
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else None)
    # the full model after one epoch and its gradient at the start weights
    # (collectives: every rank)
    params1 = gather_params(run_k(1), mc, tr.mesh)
    params0 = shard_params(full().to(dev), mc, tr.mesh)
    loss, _ = make_sharded_loss_fn(mc, tr.mesh, tr.pg.num_real_nodes,
                                   impl=impl, layout=tr.layout)(
        params0, tr.features, tr.labels)
    grads0 = gather_leaves(sharded_gradients(loss, params0, mc, tr.mesh),
                           mc, tr.mesh)
    if info.rank != 0:
        return None
    losses = run_losses[k2].tolist()
    correct, check, errs = check_run(
        g, mc, tc, impl, seed, dev,
        dict(losses=losses, params1=params1, grads0=grads0))
    timing = timing_fields(diffs)
    edges_per_s = e * layers / (timing["epoch_ms"] / 1e3)
    plan = tr.halo_plan
    per_card = _ranks_per_card(info)
    return {
        "config": name,
        "mesh": n_devices,
        "halo": "boundary" if plan is not None else "all_gather",
        "overlap": (tr.overlap_tiles is not None
                    or tr.overlap_split is not None),
        **timing,
        "k1": k1, "k2": k2, "reps": reps,
        "edges_per_s": edges_per_s,
        "edges_per_s_per_chip": edges_per_s / n_devices,
        "halo_rows_per_chip": plan.halo_size if plan is not None else None,
        "comm_volume": comm_volume_table(tr.pg, plan, heads, outdims),
        "transport": info.backend,
        "transport_line": multihost.transport_line(info),
        "ranks_per_card": per_card,
        "multi_gpu_time": per_card == 1,
        "peak_mem_gib": round(peak_gib, 3) if peak_gib is not None else None,
        "setup_s": round(setup_s, 3),
        "host_cpus": _host_cpus(),
        "final_loss": losses[-1],
        "correct": correct,
        "correct_check": check,
        "check_errs": errs,
        **device_fields(dev),
        "impl": impl,
        "precision": precision,
        "streams": streams,
    }


def bench_mesh_config(name, n_devices, *, device="cuda", **kw) -> dict:
    """The sharded bench of config `name` on n_devices ranks started here
    (a RankPool; gloo when they share a card or run on the CPU). Returns
    rank 0's fields."""
    from gatv2_tpu_torch.parallel import multihost

    # the ranks import this module by its package name, not as __main__
    me = importlib.import_module("gatv2_tpu_torch.bench")
    # CPU ranks share the host's cores
    threads = max(1, _host_cpus() // n_devices) if device == "cpu" else None
    with multihost.RankPool(n_devices, device=device,
                            threads=threads) as pool:
        return pool.run(me.mesh_rank, name, CONFIGS[name], n_devices,
                        **kw)[0]


def headline(r, name) -> dict:
    """The single-device line: root bench.py's names first."""
    nodes, edges = CONFIGS[name][0], CONFIGS[name][1]
    return {
        "metric": f"epoch_time_{name}_{nodes}N_{edges}E_fwd_bwd_update",
        "value": round(r["epoch_ms"], 3),
        "unit": "ms",
        # the reference's one published number is the citeseer3 example;
        # dividing it by another config's epoch time is no speed-up claim
        "vs_baseline": (round(REFERENCE_EPOCH_MS / r["epoch_ms"], 2)
                        if name == "citeseer3" else None),
        **r,
    }


def mesh_line(r, name, n_devices) -> dict:
    return {
        "metric": f"sharded_epoch_time_{name}_mesh{n_devices}",
        "value": round(r["epoch_ms"], 3),
        "unit": "ms",
        "vs_baseline": None,
        **r,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gatv2_tpu_torch.bench")
    ap.add_argument("--config", default="citeseer3", choices=list(CONFIGS))
    ap.add_argument(
        "--impl", default="auto", choices=["auto", "torch", "pallas", "sell"],
        help="attention path; auto resolves as the CLI does: sell on the "
             "card, torch with --device cpu")
    ap.add_argument("--precision", default="highest",
                    choices=["highest", "high", "default"])
    ap.add_argument("--streams", default="f32", choices=["f32", "bf16"],
                    help="SELL stream tier (bf16 = projections rounded once "
                         "to bf16)")
    ap.add_argument("--chunk-budget-gb", type=float, default=None,
                    help="the chunking budget of the edge temporaries "
                         "(default: a quarter of the card's free memory)")
    ap.add_argument("--all", action="store_true",
                    help="bench every config, one line each on stderr")
    ap.add_argument("--tile-e", type=int, default=None,
                    help="the edge-tile size of --impl pallas (default: "
                         "auto)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="N > 0: bench the sharded step on N ranks")
    ap.add_argument("--no-halo", action="store_true",
                    help="--mesh: the dense all_gather exchange")
    ap.add_argument("--overlap", action="store_true",
                    help="--mesh: the two-pass halo/compute-overlap layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.parallel import multihost

    resolve_device(args.device)  # no card without --device cpu: raise
    if args.impl == "auto":
        args.impl = "sell" if args.device == "cuda" else "torch"
    budget = (int(args.chunk_budget_gb * (1 << 30))
              if args.chunk_budget_gb else None)
    common = dict(impl=args.impl, precision=args.precision,
                  streams=args.streams, seed=args.seed)

    if args.mesh > 0:
        if args.all or args.tile_e or budget:
            ap.error("--mesh takes none of --all, --tile-e, "
                     "--chunk-budget-gb")
        kw = dict(halo=not args.no_halo, overlap=args.overlap, **common)
        if multihost.is_multihost_env():
            import torch.distributed as dist

            info = multihost.initialize(device=args.device)
            try:
                r = mesh_rank(info, args.config, CONFIGS[args.config],
                              args.mesh, **kw)
            finally:
                dist.destroy_process_group()
        else:
            r = bench_mesh_config(args.config, args.mesh,
                                  device=args.device, **kw)
        if r is None:  # a rank other than 0 under torchrun
            return 0
        print(json.dumps(mesh_line(r, args.config, args.mesh)))
        return 0 if r["correct"] else 1

    one = dict(device=args.device, tile_e=args.tile_e, chunk_budget=budget,
               **common)
    r = None
    if args.all:
        for name in CONFIGS:
            if name in ALL_SKIPS and name != args.config:
                continue
            rr = bench_config(name, **one)
            print(json.dumps(headline(rr, name)), file=sys.stderr,
                  flush=True)
            if name == args.config:
                r = rr  # the headline line reuses it
    if r is None:
        r = bench_config(args.config, **one)
    print(json.dumps(headline(r, args.config)))
    return 0 if r["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
