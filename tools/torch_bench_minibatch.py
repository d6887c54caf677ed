#!/usr/bin/env python
"""The port's sampled-minibatch pipeline: does the device wait for the
host? (port of tools/bench_minibatch.py)

    python tools/torch_bench_minibatch.py [--impl pallas|sell|torch]
        [--nodes 500000 --edges 8000000] [--batch 1024]
        [--fanouts 10,10,10] [--batches 30] [--device cuda|cpu]

On the random graph of the bench's products-sub config by default, a
MinibatchTrainer as `python -m gatv2_tpu_torch.train --batch-size B
--fanouts ...` builds it (native sampler engine, its per-batch edge tiles
or SELL layouts, the feature table resident on the device, Adam lr 0.01;
the JAX tool's model: heads 4,...,4,1, outdims 64,...,64,32). Each step is
MinibatchTrainer.train_step, which ends with the loss's read-back, as the
CLI's loop does. Reports:

  - device_step_ms: one batch replayed (its copies to the device
    included), mean of 10 after 1, CUDA events;
  - sample_ms: host sampling + layout emission per batch, mean of 5;
  - replay_per_batch_ms: a fixed list of batches through prefetch(depth=2)
    (no sampling in the loop);
  - pipelined_per_batch_ms: fresh batches sampled through prefetch(depth=2)
    while the device steps, the real pipeline;
  - pipeline_ratio: pipelined / device step (1.0: the device never waits).

Host-clock times are wall times of work that ends with a read-back. With
--device cpu every time is the host's and the line says "device": "cpu".
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from gatv2_tpu_torch.bench import device_fields  # noqa: E402


def _mean_ms(fn, reps, dev):
    """Mean ms of fn() over reps calls after one warm-up: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=500_000)
    ap.add_argument("--edges", type=int, default=8_000_000)
    ap.add_argument("--features", type=int, default=100)
    ap.add_argument("--classes", type=int, default=47)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--fanouts", default="10,10,10")
    ap.add_argument("--impl", default="pallas",
                    choices=["torch", "pallas", "sell"])
    ap.add_argument("--budget", default="auto",
                    choices=["auto", "worst", "probe"])
    ap.add_argument("--batches", type=int, default=30,
                    help="batches per timed pass (a whole epoch is long)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.config import ModelConfig, TrainConfig
    from gatv2_tpu_torch.data.sampling import prefetch
    from gatv2_tpu_torch.data.synthetic import random_graph
    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.train.minibatch import MinibatchTrainer

    dev = resolve_device(args.device)
    fanouts = tuple(int(v) for v in args.fanouts.split(","))
    t0 = time.perf_counter()
    g = random_graph(args.nodes, args.edges, args.features, args.classes,
                     seed=0)
    layers = len(fanouts)
    mc = ModelConfig(num_layers=layers, heads=(4,) * (layers - 1) + (1,),
                     out_dims=(64,) * (layers - 1) + (32,),
                     num_classes=args.classes, in_dim=args.features)
    tc = TrainConfig(optimizer="adam", lr=0.01, seed=0, impl=args.impl,
                     batch_size=args.batch, fanouts=fanouts,
                     sampler_engine="native", sample_budget=args.budget,
                     feature_residency="device")
    tr = MinibatchTrainer(g, mc, tc, log_fn=lambda _: None, device=dev)
    sampler = tr.sampler
    setup_s = time.perf_counter() - t0
    batches_n = min(args.batches, sampler.batches_per_epoch())

    b0 = sampler.sample(np.arange(min(args.batch, args.nodes)))
    device_step_ms = _mean_ms(lambda: tr.train_step(b0), 10, dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(5):
        sampler.sample(np.sort(rng.choice(
            args.nodes, size=min(args.batch, args.nodes), replace=False)))
    sample_ms = (time.perf_counter() - t0) / 5 * 1e3

    it = iter(sampler)
    batches = [next(it) for _ in range(batches_n)]
    t0 = time.perf_counter()
    losses = [tr.train_step(b)[0] for b in prefetch(iter(batches), depth=2)]
    replay_ms = (time.perf_counter() - t0) / batches_n * 1e3

    def fresh_batches():
        it = iter(sampler)
        for _ in range(batches_n):
            yield next(it)

    t0 = time.perf_counter()
    losses += [tr.train_step(b)[0]
               for b in prefetch(fresh_batches(), depth=2)]
    pipelined_ms = (time.perf_counter() - t0) / batches_n * 1e3

    print(json.dumps({
        "nodes": args.nodes, "edges": args.edges, "batch": args.batch,
        "budget": args.budget, "max_nodes": sampler.max_nodes,
        "max_edges": sampler.max_edges, "fanouts": list(fanouts),
        "impl": args.impl, "batches": batches_n,
        "device_step_ms": round(device_step_ms, 3),
        "sample_ms": round(sample_ms, 3),
        "replay_per_batch_ms": round(replay_ms, 3),
        "pipelined_per_batch_ms": round(pipelined_ms, 3),
        "pipeline_ratio": round(pipelined_ms / device_step_ms, 3),
        "losses_finite": bool(np.all(np.isfinite(losses))),
        "setup_s": round(setup_s, 3),
        **device_fields(dev),
    }))
    return 0 if np.all(np.isfinite(losses)) else 1


if __name__ == "__main__":
    sys.exit(main())
