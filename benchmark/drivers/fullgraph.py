"""Full-graph training epochs (traffic mode "fullgraph").

Set-up: the benchmark's graph and weights from the seed; the program's
own layout for the kernels that gatv2_tpu_torch.cli picks on CUDA; its
multi-epoch runner (train/loop.py make_multi_epoch_runner) of one epoch,
called once per epoch without a read-back; the first `check_steps`
epochs, which warm up every shape and give the readings that the
reference is compared with. The window: runner calls until `--seconds`
have passed, then a synchronize; epoch time = the window's wall / its
epochs. Traced runs then profile `trace_steps` more epochs and time the
attention op alone on the same layout (forward + backward, each layer).
"""

from __future__ import annotations

import time

import torch

from benchmark import flops, trace
from benchmark.drivers import common


def setup(ctx, graph: dict, mc):
    """The program's set-up: (impl, layout, features, labels, num_valid,
    runner) on ctx.device."""
    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

    dev = ctx.device
    impl = common.resolve_impl(0)
    g = common.host_graph(graph)
    if impl == "sell":
        from gatv2_tpu_torch.ops.sell_attention import setup_full_graph_sell

        layout, feats, labels, num_valid = setup_full_graph_sell(
            g, mc.heads, mc.out_dims, device=dev)
    else:
        from gatv2_tpu_torch.ops.pallas_attention import setup_full_graph

        layout, feats, labels, num_valid = setup_full_graph(
            g, mc.heads, mc.out_dims, device=dev)
    layout = layout.to(dev)
    tc = TrainConfig(optimizer="adam", lr=ctx.config["lr"], seed=ctx.seed,
                     impl=impl)
    runner = make_multi_epoch_runner(mc, tc, 1, edge_tiles=layout,
                                     num_valid=num_valid)
    return dict(impl=impl, layout=layout,
                features=torch.as_tensor(feats, device=dev),
                labels=torch.as_tensor(labels, device=dev),
                num_valid=num_valid, runner=runner)


def first_steps(prog: dict, params, opt, n: int) -> dict:
    """The program's first n epochs through the window's runner: their
    losses, Adam's first moment after the first, and the leaves after
    the last."""
    from gatv2_tpu_torch.train import optim

    losses, m1 = [], None
    for k in range(n):
        _, _, loss, _ = prog["runner"](params, opt, k, prog["features"],
                                       None, None, prog["labels"])
        losses.append(loss)
        if k == 0:
            m1 = common.snapshot(opt["m"])
    return dict(losses=[float(x) for x in torch.cat(losses)], m1=m1,
                params=common.snapshot(optim.param_leaves(params)))


def run(ctx) -> dict:
    dev, cfg, tr = ctx.device, ctx.config, ctx.traffic
    marks = common.Marks(ctx.t0, dev)
    graph, w0 = common.inputs(ctx)
    mc = common.model_config(cfg, ctx.precision or cfg["precision"],
                            cfg["num_edges"])
    common.free(dev)
    marks("start_graph_s")
    prog = setup(ctx, graph, mc)
    params, opt = common.program_state(mc, w0, dev)
    marks("program_setup_s")
    readings = first_steps(prog, params, opt, tr["check_steps"])
    marks("first_steps_s")
    record = {"kind": "fullgraph", "impl": prog["impl"], "marks": marks.out,
              "num_chunks": getattr(prog["layout"], "num_chunks", 1),
              "flops_per_step": flops.model_flops(
                  cfg["num_nodes"], cfg["num_edges"], cfg["feature_dim"],
                  cfg["num_classes"], cfg["heads"], cfg["out_dims"]),
              "peak_flops": flops.PEAK_TFLOPS[mc.precision][0] * 1e12}
    t = [tr["check_steps"]]
    losses = []

    def epoch():
        _, _, loss, _ = prog["runner"](params, opt, t[0], prog["features"],
                                       None, None, prog["labels"])
        t[0] += 1
        losses.append(loss)

    if not ctx.check_only:
        common.sync(dev)
        steps, start = common.timed(ctx.seconds, epoch)
        common.sync(dev)
        record["window_s"] = time.perf_counter() - start
        record["setup_s"] = start - ctx.t0
        record["steps"] = steps
        record["failed"] = int((~torch.isfinite(torch.cat(losses))).sum())
        record["memory_peak_bytes"] = common.memory_peak(dev)
        if ctx.trace and common.on_card(dev):
            record["trace"] = trace.capture(epoch, tr["trace_steps"], dev)
            record["attention"] = common.attention_alone(
                ctx, prog["impl"], prog["layout"], prog["features"].shape[0],
                graph["num_nodes"], graph["num_edges"], tr["op_reps"])
    del prog, params, opt, losses
    common.free(dev)
    steps = [(graph["features"], graph["src"], graph["dst"],
              graph["labels"],
              torch.ones(cfg["num_nodes"], dtype=torch.bool, device=dev))
             ] * tr["check_steps"]
    marks.restart()
    record["numbers"] = common.compare(ctx, readings, steps, w0)
    marks("reference_s")
    return record
