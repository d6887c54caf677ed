"""Sampled training steps replayed from a pool of batches drawn in set-up
(traffic mode "replay").

Set-up: the benchmark's graph and weights from the seed; the program's
MinibatchTrainer (train/minibatch.py) with its NeighborSampler at the
traffic's batch size, fanouts, engine and feature residency, and the
kernels that gatv2_tpu_torch.cli picks for minibatch training on CUDA;
the benchmark's weights loaded into it. The sampler draws the first
`pool` batches of an epoch, each next() timed on the host clock, and
they are kept on the host as it returns them. The first `check_steps` of
them go through train_step (warm-up, and the readings the reference is
compared with). The window: train_step on the pool's batches in turn
until `--seconds` have passed, a CUDA event after each step; no sampler
call runs in it. Each step copies its batch to the card and reads its
loss back, as train_step does. Traced runs then profile `trace_steps`
more steps and time the attention op alone on the first batch's tiles.

After the window the reference checks every batch of the pool against
the graph (reference/sampled.py: the draws are the program's to make)
and trains on the first `check_steps` of them.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import flops, trace
from benchmark.drivers import common
from benchmark.reference import sampled


def batch_edges(traffic: dict, num_edges: int) -> int:
    """The most edges a sampled batch can hold: every frontier node takes
    its full fanout, capped at the graph's edges."""
    total, frontier = 0, traffic["batch_size"]
    for f in traffic["fanouts"]:
        frontier *= f
        total += frontier
    return min(total, num_edges)


def draw_pool(sampler, size: int) -> tuple[list, list[float]]:
    """The sampler's first `size` batches of an epoch, and the host ms of
    each next()."""
    it = iter(sampler)
    pool, ms = [], []
    try:
        for _ in range(size):
            t0 = time.perf_counter()
            pool.append(next(it))
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        it.close()
    return pool, ms


def run(ctx) -> dict:
    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.train import optim
    from gatv2_tpu_torch.train.minibatch import MinibatchTrainer

    dev, cfg, tr = ctx.device, ctx.config, ctx.traffic
    if not tr["check_steps"] <= tr["pool"]:
        raise ValueError("the check steps are the pool's first batches: "
                         f"check_steps {tr['check_steps']} > pool "
                         f"{tr['pool']}")
    marks = common.Marks(ctx.t0, dev)
    graph, w0 = common.inputs(ctx)
    mc = common.model_config(cfg, ctx.precision or cfg["precision"],
                             batch_edges(tr, cfg["num_edges"]))
    impl = common.resolve_impl(tr["batch_size"])
    tc = TrainConfig(
        optimizer="adam", lr=cfg["lr"], seed=ctx.seed, impl=impl,
        batch_size=tr["batch_size"], fanouts=tuple(tr["fanouts"]),
        sampler_engine=tr["sampler_engine"],
        feature_residency=tr["feature_residency"])
    common.free(dev)
    marks("start_graph_s")
    trainer = MinibatchTrainer(common.host_graph(graph), mc, tc,
                               log_fn=lambda _: None, device=dev)
    common.load_weights(trainer.params, w0)
    marks("program_setup_s")
    pool, sample_ms = draw_pool(trainer.sampler, tr["pool"])
    marks("pool_s")
    losses, m1 = [], None
    for k in range(tr["check_steps"]):
        loss, _ = trainer.train_step(pool[k])
        losses.append(loss)
        if k == 0:
            m1 = common.snapshot(trainer.opt_state["m"])
    readings = dict(losses=losses, m1=m1, params=common.snapshot(
        optim.param_leaves(trainer.params)))
    marks("first_steps_s")
    batch_flops = [flops.model_flops(b.num_nodes, b.num_edges,
                                     cfg["feature_dim"], cfg["num_classes"],
                                     cfg["heads"], cfg["out_dims"])
                   for b in pool]
    record = {"kind": "replay", "impl": impl, "marks": marks.out,
              "remat": mc.remat, "spans": {"sample_ms": sample_ms},
              "pool_nodes": [b.num_nodes for b in pool],
              "pool_edges": [b.num_edges for b in pool],
              "peak_flops": flops.PEAK_TFLOPS[mc.precision][0] * 1e12}
    nxt = [tr["check_steps"]]

    def replay() -> tuple[float, int]:
        i = nxt[0] % len(pool)
        nxt[0] += 1
        loss, _ = trainer.train_step(pool[i])
        return loss, i

    if not ctx.check_only:
        card = common.on_card(dev)
        events, work, failed = [], [0.0], [0]

        def mark():
            if card:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()

        def step():
            loss, i = replay()
            mark()
            work[0] += batch_flops[i]
            failed[0] += not math.isfinite(loss)

        common.sync(dev)
        mark()
        steps, start = common.timed(ctx.seconds, step)
        common.sync(dev)
        record["window_s"] = time.perf_counter() - start
        record["setup_s"] = start - ctx.t0
        record["steps"] = steps
        record["failed"] = failed[0]
        record["flops_window"] = work[0]
        record["memory_peak_bytes"] = common.memory_peak(dev)
        if card:
            record["step_ms"] = [a.elapsed_time(b)
                                 for a, b in zip(events, events[1:])]
            if ctx.trace:
                record["trace"] = trace.capture(replay, tr["trace_steps"],
                                                dev)
                b = pool[0]
                tiles = b.tiles.to(dev)
                record["attention"] = common.attention_alone(
                    ctx, impl, tiles, trainer.sampler.max_nodes,
                    b.num_nodes, b.num_edges, tr["op_reps"])
                del tiles
    del trainer
    common.free(dev)

    marks.restart()
    index = sampled.GraphIndex(graph)
    seen: set = set()
    invalid = sum(sampled.batch_violations(
        index, b.node_ids, b.src, b.dst, b.num_nodes, b.num_edges,
        b.num_seeds, tr["fanouts"], seen) for b in pool)
    del index
    steps = [sampled.subgraph(graph, b.node_ids, b.src, b.dst, b.num_nodes,
                              b.num_edges, b.num_seeds)
             for b in pool[:tr["check_steps"]]]
    record["numbers"] = common.compare(ctx, readings, steps, w0)
    record["numbers"]["batch_invalid"] = invalid
    marks("reference_s")
    record["batches_checked"] = len(pool)
    return record
