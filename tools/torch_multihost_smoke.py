#!/usr/bin/env python
"""Multi-host (multi-process) sharded-training smoke of the port
(counterpart of tools/multihost_smoke.py): one process per "host", each
joining the process group through parallel/multihost.initialize from the
environment a multi-host launcher gives it (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, with LOCAL_RANK 0 and LOCAL_WORLD_SIZE 1: one rank on each
host, which the torchrun start of one host with several local ranks does
not cover), then running a few sharded training epochs. Each process
prints its per-epoch losses as one JSON line; they must agree across
processes (the loss is all-reduced) and with a single-process run of the
same program from the same weights.

Modes (the JAX modes' graph and model: random_graph(256, 2048, 16, 4,
seed=11), heads (2, 2), out dims (8, 6), Adam, lr 0.02):
  step     the sharded train step on the 'torch' route (dense all_gather);
  sell     the same on the SELL kernels (per-shard bipartite layouts);
  trainer  ShardedTrainer with splits: per epoch the loss and the
           train/val/test accuracies (the default seed broadcast from
           process 0 when no weights are given).

--load-weights DIR starts from a text weight dump (models/params_io
format), so the losses can be held against the JAX tool's run_training.
All processes of this smoke run on one machine and share its first card
(or the CPU): NCCL refuses two ranks on one device, so the group is gloo.

Usage (launched by the test, or by hand, one command per process):
  python tools/torch_multihost_smoke.py <process_id> <num_processes> <port>
      [step|trainer|sell] [--load-weights DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

GRAPH = (256, 2048, 16, 4)
SEED = 11
HEADS, OUT_DIMS = (2, 2), (8, 6)


def _model(g):
    from gatv2_tpu_torch.config import ModelConfig

    return ModelConfig(num_layers=2, heads=HEADS, out_dims=OUT_DIMS,
                       num_classes=g.num_classes, in_dim=g.feature_dim)


def _full_params(mc, weights, seed=0):
    import torch

    from gatv2_tpu_torch.models.gatv2 import init_params_for_variant
    from gatv2_tpu_torch.models.params_io import load_params_txt

    if weights:
        return load_params_txt(weights, mc)
    return init_params_for_variant(mc, torch.Generator().manual_seed(seed))


def run_training(num_devices: int, epochs: int = 4, impl: str = "torch", *,
                 weights: str | None = None, device: str = "cpu"
                 ) -> list[float]:
    """Deterministic sharded training of this rank in the joined group
    (dense all_gather exchange); returns the mesh's per-epoch losses."""
    import torch

    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.data.synthetic import random_graph
    from gatv2_tpu_torch.parallel.mesh import make_mesh
    from gatv2_tpu_torch.parallel.partition import (
        partition_graph,
        prepare_partitioned_sell_tiles,
    )
    from gatv2_tpu_torch.parallel.sharded import (
        make_sharded_train_step,
        shard_layout,
        shard_params,
    )
    from gatv2_tpu_torch.train import optim

    g = random_graph(*GRAPH, seed=SEED)
    mc = _model(g)
    tc = TrainConfig(optimizer="adam", lr=0.02, seed=0, impl=impl)
    mesh = make_mesh(num_devices, device=device)
    pg = partition_graph(g, num_devices)
    tiles = prepare_partitioned_sell_tiles(pg) if impl == "sell" else None
    layout = shard_layout(pg, mesh.graph_index, mesh.device,
                          edge_tiles=tiles)
    params = shard_params(_full_params(mc, weights), mc, mesh).to(
        mesh.device)
    opt_state = optim.init_opt_state(params, "adam")
    step = make_sharded_train_step(mc, tc, mesh, pg.num_real_nodes,
                                   layout=layout)
    rows = pg.shard_rows(mesh.graph_index)
    features = torch.as_tensor(pg.features[rows], device=mesh.device)
    labels = torch.as_tensor(pg.labels[rows], device=mesh.device)
    losses = []
    for epoch in range(1, epochs + 1):
        loss, _ = step(params, opt_state, epoch, features, labels)
        losses.append(float(loss))
    return losses


def run_trainer(num_devices: int, epochs: int = 4, *,
                weights: str | None = None, device: str = "cpu") -> list:
    """ShardedTrainer with splits (masked labels, per-epoch split eval;
    without weights, the time-based default seed broadcast from process
    0): per epoch [loss, train, val, test accuracy]."""
    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.data.splits import random_splits
    from gatv2_tpu_torch.data.synthetic import random_graph
    from gatv2_tpu_torch.parallel.sharded import ShardedTrainer

    g = random_graph(*GRAPH, seed=SEED)
    mc = _model(g)
    tc = TrainConfig(optimizer="adam", lr=0.02, seed=None, epochs=0)
    sp = random_splits(g.num_nodes, (0.6, 0.2, 0.2), seed=3)
    tr = ShardedTrainer(g, mc, tc, num_devices, log_fn=lambda s: None,
                        splits=sp, device=device)
    if weights:
        tr.params = _full_params(mc, weights)
    out = []
    for _ in range(epochs):
        last = tr.run(1)
        out.append([last["loss"], last["train_accuracy"],
                    last["val_accuracy"], last["test_accuracy"]])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("mode", nargs="?", default="step",
                    choices=["step", "trainer", "sell"])
    ap.add_argument("--load-weights", default=None, metavar="DIR")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.parallel import multihost

    resolve_device(args.device)  # no card without --device cpu: raise
    # the environment of one rank on each of num_processes hosts
    os.environ.update(
        RANK=str(args.process_id), WORLD_SIZE=str(args.num_processes),
        MASTER_ADDR="localhost", MASTER_PORT=str(args.port),
        LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    assert multihost.is_multihost_env() or args.num_processes == 1
    # every "host" of this smoke is this machine: they share cuda:0
    info = multihost.initialize(device=args.device, backend="gloo")
    print(multihost.process_summary(info), file=sys.stderr)
    # the line states each host's own facts (one rank, one card); here the
    # hosts are processes of one machine, all on its first card
    print(f"{multihost.transport_line(info)} (simulated hosts: every "
          f"process of this smoke runs on this machine's {info.device})",
          file=sys.stderr)
    try:
        kw = dict(weights=args.load_weights, device=info.device)
        if args.mode == "trainer":
            losses = run_trainer(info.world_size, args.epochs, **kw)
        else:
            losses = run_training(
                info.world_size, args.epochs,
                impl="sell" if args.mode == "sell" else "torch", **kw)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"process": args.process_id, "losses": losses}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
