"""Training entry point (port of the root train.py): full-graph or
sampled-minibatch training on one device, or over a mesh of ranks.

    python -m gatv2_tpu_torch.train --num-layers 3 --heads 4,1,1 \\
        --outdims 64,32,16 --epochs 200 --optimizer adam --lr 0.01 --clip \\
        --dataset citeseer --data-root /data/graphs
    python -m gatv2_tpu_torch.train --batch-size 1024 --fanouts 10,10,10 \\
        --num-layers 3 --heads 4,1,1 --outdims 64,32,16 --optimizer adam \\
        --lr 0.01 --clip --dataset products --data-root /data/graphs
    python -m gatv2_tpu_torch.train --mesh 2 [--overlap] [--batch-size B] ...
    torchrun --nproc-per-node 4 -m gatv2_tpu_torch.train --mesh 4 ...

Runs on the CUDA device, where --impl auto is 'sell' full-graph (the SELL
kernels K1, K2 and K3) and 'pallas' with --batch-size (the edge-tile
kernels K5, K6 and K7), unless given --device cpu ('torch'); --impl sell
--batch-size trains on per-batch SELL layouts through K1, K2 and K3.
Prints the JAX package's console lines and, on impl 'sell' or 'pallas',
how many times each kernel was launched. --profile DIR writes a
torch.profiler trace of the training run into DIR/trace.json; it carries
the program's spans (utils/metrics.py span) by name as user annotations,
so each kernel and each idle gap sits under the span that launched it
(train.step, train.h2d, train.readback, attn.join, model.remat, ...).
--debug-nans raises FloatingPointError at the first non-finite loss,
backward value or gradient.

--mesh N trains on N ranks, one process each: edge-partitioned full-graph
(ShardedTrainer; --overlap for the two-pass local/halo layer) or, with
--batch-size, data-parallel minibatch (DataParallelMinibatchTrainer).
Under torchrun each process joins the group from torchrun's environment;
otherwise this command starts the N ranks itself. A `Transport:` line
says which backend carries the collectives (--transport): NCCL when every
rank has a card of its own, gloo on the CPU (--device cpu) or when ranks
share a card. Only rank 0 prints, profiles and writes files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import sys


def _profiler(device):
    """torch.profiler over host ops and, on a CUDA device, its kernels."""
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    return tp.profile(activities=acts)


def _export_trace(prof, directory: str) -> None:
    """Write the profile as a Chrome trace, DIR/trace.json."""
    out = pathlib.Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def main(argv: list[str] | None = None) -> int:
    import torch.distributed as dist

    from gatv2_tpu_torch import cli
    from gatv2_tpu_torch.parallel import multihost

    # under torchrun only rank 0 reports the parser's warnings
    quiet = multihost.is_multihost_env() and os.environ.get("RANK") != "0"
    with _silenced(quiet):
        model_config, train_config, args = cli.parse_args(argv)
    if args.load_weights and train_config.resume:
        # fresh weights on top of a restored checkpoint would be paired with
        # its warm Adam moments and epoch counter
        raise SystemExit(
            "Error: --load-weights cannot be combined with --resume "
            "(the restored optimizer state/epoch belong to the "
            "checkpointed weights)."
        )
    if args.mesh > 0 and not multihost.is_multihost_env():
        # start the N ranks here (torchrun starts them otherwise); they
        # import this module by its package name, not as __main__
        import importlib

        entry = importlib.import_module("gatv2_tpu_torch.train.__main__")
        with multihost.RankPool(args.mesh, device=args.device,
                                backend=args.transport) as pool:
            pool.run(entry._rank_main, model_config, train_config, args)
        return 0
    if args.mesh == 0:
        return _train(model_config, train_config, args, None)
    info = multihost.initialize(device=args.device, backend=args.transport)
    try:
        return _train(model_config, train_config, args, info)
    finally:
        dist.destroy_process_group()


def _rank_main(info, model_config, train_config, args) -> None:
    """One rank of `--mesh N` started by main() (its RankPool ends the
    group)."""
    _train(model_config, train_config, args, info)


@contextlib.contextmanager
def _silenced(quiet: bool):
    """stdout and stderr to /dev/null while quiet (ranks other than 0);
    an exception still reaches the caller and prints after the block."""
    if not quiet:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
            contextlib.redirect_stderr(null):
        yield


def _train(model_config, train_config, args, info) -> int:
    if info is not None and args.mesh != info.world_size:
        raise SystemExit(
            f"Error: --mesh {args.mesh} but the process group has "
            f"{info.world_size} ranks.")
    rank = 0 if info is None else info.rank
    with _silenced(rank != 0):
        return _run(model_config, train_config, args, info, rank)


def _run(model_config, train_config, args, info, rank: int) -> int:
    from gatv2_tpu_torch.data.io import load_dataset, resolve_dataset_dir
    from gatv2_tpu_torch.data.splits import load_split_files, random_splits
    from gatv2_tpu_torch.device import resolve_device
    from gatv2_tpu_torch.models.params_io import (
        load_params_txt,
        save_params_txt,
    )
    from gatv2_tpu_torch.ops.pallas_bwd_dst import pallas_bwd_dst
    from gatv2_tpu_torch.ops.pallas_fwd import pallas_fwd
    from gatv2_tpu_torch.ops.pallas_segsum import pallas_segsum
    from gatv2_tpu_torch.ops.sell_bwd_dst import sell_bwd_dst
    from gatv2_tpu_torch.ops.sell_fwd import sell_fwd
    from gatv2_tpu_torch.ops.sell_segsum import sell_segsum
    from gatv2_tpu_torch.parallel import multihost
    from gatv2_tpu_torch.train import checkpoint as ckpt
    from gatv2_tpu_torch.utils.metrics import JsonlSink, device_memory_report

    from gatv2_tpu_torch import cli

    device = info.device if info is not None else resolve_device(args.device)
    print(cli.echo_config(model_config, train_config))
    data_root = train_config.data_root
    dataset_dir = resolve_dataset_dir(train_config.dataset, data_root)
    print(f"Using dataset: {train_config.dataset}")
    print(f"Dataset path: {dataset_dir}/")
    graph = load_dataset(train_config.dataset, data_root)
    if args.edge_features and graph.edge_features is None:
        raise SystemExit(
            f"Error: --edge-features but {dataset_dir}/ has no "
            "edge_features.txt.")
    model_config = dataclasses.replace(
        model_config, num_classes=graph.num_classes, in_dim=graph.feature_dim,
        edge_dim=graph.edge_dim if args.edge_features else 0,
    )
    print(f"Max degree = {graph.max_degree}")
    print(f"Number of classes = {graph.num_classes}")
    print(
        f"Graph loaded: {graph.num_nodes} nodes, {graph.num_edges} edges, "
        f"input_feature_vector_dim = {graph.feature_dim}"
    )
    mem_before = device_memory_report()

    splits = load_split_files(dataset_dir, graph.num_nodes)
    if splits is not None:
        print("Using split masks from dataset directory")
    elif args.split_fractions:
        fr = tuple(float(v) for v in args.split_fractions.split(","))
        splits = random_splits(graph.num_nodes, fr, seed=args.split_seed)
    if splits is not None:
        tr, va, te = splits.counts
        print(f"Split: {tr} train / {va} val / {te} test nodes")

    sink = (JsonlSink(train_config.log_file)
            if train_config.log_file and rank == 0 else None)
    kw = dict(metrics_sink=sink, splits=splits, device=device)
    if info is not None:
        print(multihost.transport_line(info))
    if args.mesh > 0 and train_config.batch_size > 0:
        from gatv2_tpu_torch.train.minibatch import (
            DataParallelMinibatchTrainer,
        )

        if args.overlap:
            print(
                "Warning: --overlap applies to full-graph --mesh training "
                "only; ignored in data-parallel minibatch mode (sampled "
                "subgraphs are device-local, there is no halo exchange).",
                file=sys.stderr,
            )
        print(
            f"Data-parallel minibatch mode: {args.mesh} devices x "
            f"batch_size={train_config.batch_size}, "
            f"fanouts={list(train_config.fanouts)}"
        )
        trainer = DataParallelMinibatchTrainer(
            graph, model_config, train_config, args.mesh, **kw)
    elif args.mesh > 0:
        from gatv2_tpu_torch.parallel.sharded import ShardedTrainer

        print(f"Sharded mode: edge-partitioned over {args.mesh} devices")
        trainer = ShardedTrainer(graph, model_config, train_config,
                                 args.mesh, overlap=args.overlap, **kw)
    elif train_config.batch_size > 0:
        from gatv2_tpu_torch.train.minibatch import MinibatchTrainer

        if args.overlap:
            print("Warning: --overlap requires --mesh; ignored.",
                  file=sys.stderr)
        print(
            f"Minibatch mode: batch_size={train_config.batch_size}, "
            f"fanouts={list(train_config.fanouts)}, "
            f"sampler={train_config.sampler_engine}"
        )
        trainer = MinibatchTrainer(graph, model_config, train_config, **kw)
    else:
        from gatv2_tpu_torch.train.loop import Trainer

        if args.overlap:
            print("Warning: --overlap requires --mesh; ignored.",
                  file=sys.stderr)
        trainer = Trainer(graph, model_config, train_config, **kw)
    meta = ckpt.run_meta(model_config, train_config)
    if train_config.resume and train_config.checkpoint_dir:
        if ckpt.restore_into(train_config.checkpoint_dir, trainer,
                             expect_meta=meta):
            print(f"Resumed from checkpoint at epoch {trainer.epoch}")
            if train_config.batch_size > 0:
                trainer.sync_step_count()

    mem_after = device_memory_report()
    for dev in mem_after:
        used = (mem_after[dev] - mem_before.get(dev, 0)) / 1e6
        print(f"Device memory allocated on {dev}: {used:.1f} MB")

    if args.load_weights:
        trainer.params = load_params_txt(args.load_weights, model_config)
        print(f"Loaded weights from {args.load_weights}/")

    kernel_lines = (
        (("K1", sell_fwd), ("K2", sell_bwd_dst), ("K3", sell_segsum)),
        (("K5", pallas_fwd), ("K6", pallas_bwd_dst), ("K7", pallas_segsum)),
    )
    launches0 = [[k.launches for _, k in line] for line in kernel_lines]
    with contextlib.ExitStack() as stack:
        if args.profile and rank == 0:
            prof = _profiler(device)
            # registered first, so it runs after the profiler has stopped
            stack.callback(_export_trace, prof, args.profile)
            stack.enter_context(prof)
            print(f"Profiling to {args.profile}/")
        every = train_config.checkpoint_every
        if train_config.checkpoint_dir and every > 0:
            while trainer.epoch < train_config.epochs:
                trainer.run(min(every, train_config.epochs - trainer.epoch))
                ckpt.save_trainer(train_config.checkpoint_dir, trainer,
                                  meta=meta)
        elif train_config.epochs > trainer.epoch:
            trainer.run(train_config.epochs - trainer.epoch)
            if train_config.checkpoint_dir:
                ckpt.save_trainer(train_config.checkpoint_dir, trainer,
                                  meta=meta)
    if train_config.impl in ("sell", "pallas"):
        for line, counts0 in zip(kernel_lines, launches0):
            print(", ".join(
                f"{tag} {k.__name__} launches: {k.launches - n0}"
                for (tag, k), n0 in zip(line, counts0)))

    if splits is not None:
        if train_config.batch_size == 0:
            acc = trainer.evaluate()["test"]
        elif args.eval_mode == "sampled":
            acc = trainer.evaluate("test")
        elif train_config.feature_residency == "host":
            # --feature-residency host exists because the feature table does
            # not fit the device; exact evaluation would upload all of it
            print(
                "Note: --eval-mode exact needs the full feature table "
                "on device; with --feature-residency host falling back "
                "to sampled evaluation"
            )
            acc = trainer.evaluate("test")
        else:
            # one deterministic full-graph forward, the reference's
            # all-nodes evaluation
            acc = trainer.evaluate_exact()["test"]
        print(f"Final Test Accuracy: {acc * 100:.2f}%")
    if args.save_weights:
        full = (trainer.full_params() if hasattr(trainer, "full_params")
                else trainer.params)
        if rank == 0:
            save_params_txt(args.save_weights, full)
        print(f"Saved weights to {args.save_weights}/")
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
