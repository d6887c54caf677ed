"""What the traffic drivers share: the model's configuration from a
configuration file, the program's state from the benchmark's weights,
device helpers, and the comparison with the reference."""

from __future__ import annotations

import argparse
import gc
import time

import torch

from benchmark import correct, flops
from benchmark.graphgen import make_graph, make_weights
from benchmark.reference import gatv2 as reference


class Marks:
    """Seconds between consecutive marks, under the marks' names: the
    split of a run's set-up (the first mark counts from the process's
    start) and of its reference."""

    def __init__(self, t0: float, device):
        self.last, self.device, self.out = t0, device, {}

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.last
        self.last = now

    def restart(self) -> None:
        self.last = time.perf_counter()


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize(device)


def resolve_impl(batch_size: int) -> str:
    """The program's own choice of kernels for this traffic on CUDA
    (gatv2_tpu_torch.cli._resolve_impl of --impl auto)."""
    from gatv2_tpu_torch import cli

    return cli._resolve_impl(argparse.Namespace(
        impl="auto", device="cuda", batch_size=batch_size))


def model_config(cfg: dict, precision: str, num_edges: int):
    """The program's ModelConfig of the configuration, for steps on a
    graph of `num_edges` edges: remat from cfg["remat_from_edges"] on, as
    the port's bench sets it."""
    from gatv2_tpu_torch.config import ModelConfig

    return ModelConfig(
        num_layers=cfg["num_layers"], heads=tuple(cfg["heads"]),
        out_dims=tuple(cfg["out_dims"]), num_classes=cfg["num_classes"],
        in_dim=cfg["feature_dim"], negative_slope=cfg["negative_slope"],
        variant=cfg["variant"], matmul_precision=precision,
        remat=num_edges >= cfg["remat_from_edges"], streams="f32")


def inputs(ctx) -> tuple[dict, list]:
    """The benchmark's graph and starting weights for ctx.seed."""
    cfg, tr = ctx.config, ctx.traffic
    graph = make_graph(cfg["num_nodes"], cfg["num_edges"],
                       cfg["feature_dim"], cfg["num_classes"],
                       endpoints=tr["endpoints"], seed=ctx.seed,
                       device=ctx.device)
    w0 = make_weights(cfg["feature_dim"], cfg["num_classes"], cfg["heads"],
                      cfg["out_dims"], seed=ctx.seed, device=ctx.device)
    return graph, w0


def host_graph(graph: dict):
    """The program's Graph (numpy, on the host) of the benchmark's."""
    from gatv2_tpu_torch.data.graph import Graph

    return Graph(
        features=graph["features"].cpu().numpy(),
        row_ptr=graph["row_ptr"].to(torch.int32).cpu().numpy(),
        col_idx=graph["src"].to(torch.int32).cpu().numpy(),
        labels=graph["labels"].to(torch.int32).cpu().numpy())


def load_weights(params, w0) -> None:
    """Copy the benchmark's weights into the program's GATv2 module."""
    from gatv2_tpu_torch.train import optim

    with torch.no_grad():
        for p, w in zip(optim.param_leaves(params), w0, strict=True):
            p.copy_(w)


def program_state(mc, w0, device):
    """(params, Adam state) of the program, from the benchmark's
    weights."""
    from gatv2_tpu_torch.models.gatv2 import GATv2
    from gatv2_tpu_torch.train import optim

    params = GATv2(mc).to(device)
    load_weights(params, w0)
    return params, optim.init_opt_state(params, "adam")


def snapshot(leaves) -> list[torch.Tensor]:
    return [x.detach().clone() for x in leaves]


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if on_card(
        device) else 0


def free(device) -> None:
    gc.collect()
    if on_card(device):
        torch.cuda.empty_cache()


def compare(ctx, readings: dict, steps: list, w0) -> dict:
    """The reference's training over `steps` from w0, and the numbers
    of correct.training_numbers against the program's readings."""
    cfg = ctx.config
    ref = reference.train(w0, steps, cfg["heads"], cfg["out_dims"],
                          lr=cfg["lr"])
    return correct.training_numbers(readings, ref, w0)


def attention_alone(ctx, impl: str, tiles, n_pad: int, num_nodes: int,
                    num_edges: int, reps: int) -> dict:
    """The attention op (ops.attention.edge_attention) alone, forward +
    backward of each layer on the program's layout `tiles` over n_pad
    (padded) nodes, timed with CUDA events; its time and its bound
    (flops.attention_bound_s of the real num_nodes and num_edges), summed
    over the layers."""
    from gatv2_tpu_torch.ops.attention import edge_attention

    dev, cfg = ctx.device, ctx.config
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    time_s = bound_s = 0.0
    for h, d in zip(cfg["heads"], cfg["out_dims"]):
        zs, zd, g = (torch.randn(n_pad, h * d, generator=gen, device=dev)
                     for _ in range(3))
        a = torch.randn(h, d, generator=gen, device=dev)
        for x in (zs, zd, a):
            x.requires_grad_(True)

        def op():
            out = edge_attention(zs, zd, a, None, None, n_pad,
                                 negative_slope=cfg["negative_slope"],
                                 impl=impl, edge_tiles=tiles)
            torch.autograd.grad(out, (zs, zd, a), g)

        op()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            op()
        end.record()
        end.synchronize()
        time_s += start.elapsed_time(end) / 1e3 / reps
        bound_s += flops.attention_bound_s(num_nodes, num_edges, h, d)
        del zs, zd, g, a
    return {"time_s": time_s, "bound_s": bound_s}


def timed(seconds: float, step) -> tuple[int, float]:
    """Call step() until `seconds` have passed on the host clock; returns
    (calls, the clock at the start)."""
    start = time.perf_counter()
    calls = 0
    while True:
        step()
        calls += 1
        if time.perf_counter() - start >= seconds:
            return calls, start
