"""Full-graph training epochs of the edge-conditioned block (traffic mode
"fullgraph_edge"): GATv2 scores that read per-edge features, residual
layers, BatchNorm and a multi-label loss (the ogbn-proteins
configuration).

The program's ModelConfig is built first, before any input: a program
without the block's fields fails there at once. Set-up: the benchmark's
graph (benchmark/graphgen.py) and, from the same seed, the edge features
[E, k] (standard normal, in the graph's dst-sorted edge order), the [N, C]
0/1 labels (Bernoulli(0.5)) and the starting weights; the program's own
SELL layout with the edge features, built for the kernels that
gatv2_tpu_torch.cli picks on CUDA; its multi-epoch runner of one epoch;
the first `check_steps` epochs, which warm up every shape and give the
readings the reference (reference/gatv2_edge.py) is compared with. The
window, as in mode "fullgraph": runner calls until `--seconds` have
passed, then a synchronize. Traced runs also read set-up's host seconds in
the span layout.edge_features (a CPU-only profiler around the layout),
profile `trace_steps` more epochs with each device operation credited to
the program's spans (benchmark/span_trace.py), and time the attention op
alone, with the edge term, on the same layout. The record has kind
"fullgraph", so the readers of the full-graph cells read it unchanged.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import flops, flops_edge, span_trace
from benchmark.drivers import common, fullgraph
from benchmark.graphgen import _generator, make_graph
from benchmark.reference import gatv2_edge as reference

TRACED_SPANS = ("attn.edge_grad",)


def model_config(cfg: dict, precision: str):
    """The program's ModelConfig of the configuration (remat from
    cfg["remat_from_edges"] on, as in mode "fullgraph")."""
    from gatv2_tpu_torch.config import ModelConfig

    return ModelConfig(
        num_layers=cfg["num_layers"], heads=tuple(cfg["heads"]),
        out_dims=tuple(cfg["out_dims"]), num_classes=cfg["num_classes"],
        in_dim=cfg["feature_dim"], negative_slope=cfg["negative_slope"],
        variant=cfg["variant"], matmul_precision=precision,
        remat=cfg["num_edges"] >= cfg["remat_from_edges"], streams="f32",
        edge_dim=cfg.get("edge_dim", 8), residual=cfg.get("residual", True),
        norm=cfg.get("norm", "batch"), loss=cfg.get("loss", "bce"))


def weight_shapes(cfg: dict, edge_dim: int):
    """[(shape, limit)] of the leaves in the program's order (module
    docstring of reference/gatv2_edge.py); a limit of 0 or 1 is
    BatchNorm's shift (bn_b, 0) or scale (bn_g, 1), a constant."""
    heads, dims = cfg["heads"], cfg["out_dims"]
    f, out = cfg["feature_dim"], []
    for l, (h, d) in enumerate(zip(heads, dims)):
        lim = math.sqrt(6.0 / (2 * f + d))
        out.append(((h, d), lim))
        if l < len(heads) - 1:
            out += [((h * d,), 0), ((h * d,), 1)]
        out += [((h, d, f), lim),
                ((h, d, edge_dim), math.sqrt(6.0 / (edge_dim + d))),
                ((h * d, f), math.sqrt(6.0 / (f + h * d))),
                ((h, d, f), lim)]
        f = h * d
    c = cfg["num_classes"]
    out.append(((c, dims[-1]), math.sqrt(6.0 / (c + dims[-1]))))
    return out


def inputs(ctx, edge_dim: int) -> tuple[dict, list]:
    """The graph of graphgen.make_graph with, from the same seed, its edge
    features "edge_feat" [E, k], its labels [N, C] (0/1) and the starting
    weights (Glorot-uniform per leaf; BatchNorm at 1 and 0)."""
    cfg, dev = ctx.config, ctx.device
    graph = make_graph(cfg["num_nodes"], cfg["num_edges"],
                       cfg["feature_dim"], 2,
                       endpoints=ctx.traffic["endpoints"], seed=ctx.seed,
                       device=dev)
    g = _generator(ctx.seed, 2, dev)
    graph["edge_feat"] = torch.randn(graph["num_edges"], edge_dim,
                                     generator=g, device=dev)
    graph["labels"] = (torch.rand(graph["num_nodes"], cfg["num_classes"],
                                  generator=g, device=dev) < 0.5).to(
        torch.int32)
    shapes = weight_shapes(cfg, edge_dim)
    sizes = [math.prod(s) for s, _ in shapes]
    u = torch.rand(sum(sizes), generator=_generator(ctx.seed, 3, dev),
                   device=dev)
    w0 = [torch.full(shape, float(lim), device=dev) if lim in (0, 1)
          else (2.0 * part - 1.0).mul_(lim).view(shape)
          for part, (shape, lim) in zip(u.split(sizes), shapes)]
    return graph, w0


def setup(ctx, graph: dict, mc) -> tuple[dict, float]:
    """The program's set-up: ({impl, layout, features, labels, num_valid,
    runner} on ctx.device, the host seconds in layout.edge_features when
    ctx.trace, else 0)."""
    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.data.graph import Graph
    from gatv2_tpu_torch.ops.sell_attention import setup_full_graph_sell
    from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

    dev = ctx.device
    impl = common.resolve_impl(0)
    g = Graph(features=graph["features"].cpu().numpy(),
              row_ptr=graph["row_ptr"].to(torch.int32).cpu().numpy(),
              col_idx=graph["src"].to(torch.int32).cpu().numpy(),
              labels=graph["labels"].cpu().numpy(),
              edge_features=graph["edge_feat"].cpu().numpy())

    def layout():
        return setup_full_graph_sell(g, mc.heads, mc.out_dims, device=dev,
                                     edge_features=g.edge_features)

    layout_s = 0.0
    if ctx.trace:
        built, spans = span_trace.host_span_seconds(
            layout, ("layout.edge_features",))
        layout_s = spans["layout.edge_features"]
    else:
        built = layout()
    st, feats, labels, num_valid = built
    del g
    st = st.to(dev)
    tc = TrainConfig(optimizer="adam", lr=ctx.config["lr"], seed=ctx.seed,
                     impl=impl)
    runner = make_multi_epoch_runner(mc, tc, 1, edge_tiles=st,
                                     num_valid=num_valid)
    return dict(impl=impl, layout=st,
                features=torch.as_tensor(feats, device=dev),
                labels=torch.as_tensor(labels, device=dev),
                num_valid=num_valid, runner=runner), layout_s


def attention_alone(ctx, prog: dict, num_nodes: int, num_edges: int,
                    edge_dim: int, reps: int) -> dict:
    """The attention op with the edge term alone, forward + backward of
    each layer on the program's layout, timed with CUDA events; its time
    and its bound (flops_edge.attention_bound_s), summed over layers."""
    from gatv2_tpu_torch.ops.attention import edge_attention

    dev, cfg = ctx.device, ctx.config
    n_pad = prog["features"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    time_s = bound_s = 0.0
    for h, d in zip(cfg["heads"], cfg["out_dims"]):
        zs, zd, g = (torch.randn(n_pad, h * d, generator=gen, device=dev)
                     for _ in range(3))
        a = torch.randn(h, d, generator=gen, device=dev)
        w_e = 0.1 * torch.randn(h, d, edge_dim, generator=gen, device=dev)
        for x in (zs, zd, a, w_e):
            x.requires_grad_(True)

        def op():
            out = edge_attention(zs, zd, a, None, None, n_pad,
                                 negative_slope=cfg["negative_slope"],
                                 impl=prog["impl"],
                                 edge_tiles=prog["layout"], w_e=w_e)
            torch.autograd.grad(out, (zs, zd, a, w_e), g)

        op()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            op()
        end.record()
        end.synchronize()
        time_s += start.elapsed_time(end) / 1e3 / reps
        bound_s += flops_edge.attention_bound_s(num_nodes, num_edges, h, d,
                                                edge_dim)
        del zs, zd, g, a, w_e
    return {"time_s": time_s, "bound_s": bound_s}


def compare(ctx, graph: dict, readings: dict, w0) -> dict:
    """The reference's training over check_steps epochs from w0, and the
    numbers of correct.training_numbers against the program's readings."""
    from benchmark import correct

    cfg = ctx.config
    steps = [(graph["features"], graph["src"], graph["dst"],
              graph["edge_feat"], graph["labels"])
             ] * ctx.traffic["check_steps"]
    ref = reference.train(w0, steps, cfg["heads"], cfg["out_dims"],
                          lr=cfg["lr"], slope=cfg["negative_slope"])
    return correct.training_numbers(readings, ref, w0)


def run(ctx) -> dict:
    dev, cfg, tr = ctx.device, ctx.config, ctx.traffic
    mc = model_config(cfg, ctx.precision or cfg["precision"])
    marks = common.Marks(ctx.t0, dev)
    graph, w0 = inputs(ctx, mc.edge_dim)
    common.free(dev)
    marks("start_graph_s")
    prog, layout_s = setup(ctx, graph, mc)
    params, opt = common.program_state(mc, w0, dev)
    marks("program_setup_s")
    readings = fullgraph.first_steps(prog, params, opt, tr["check_steps"])
    marks("first_steps_s")
    record = {"kind": "fullgraph", "impl": prog["impl"], "marks": marks.out,
              "num_chunks": getattr(prog["layout"], "num_chunks", 1),
              "flops_per_step": flops_edge.model_flops(
                  cfg["num_nodes"], cfg["num_edges"], cfg["feature_dim"],
                  cfg["num_classes"], cfg["heads"], cfg["out_dims"],
                  mc.edge_dim),
              "peak_flops": flops.PEAK_TFLOPS[mc.precision][0] * 1e12,
              "spans": {"edge_layout_s": layout_s}}
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
            record["trace"] = span_trace.capture(epoch, tr["trace_steps"],
                                                 dev, TRACED_SPANS)
            record["attention"] = attention_alone(
                ctx, prog, graph["num_nodes"], graph["num_edges"],
                mc.edge_dim, tr["op_reps"])
    del prog, params, opt, losses
    common.free(dev)
    marks.restart()
    record["numbers"] = compare(ctx, graph, readings, w0)
    marks("reference_s")
    return record
