"""Training entry point (port of the root train.py): full-graph or
sampled-minibatch training on one device.

    python -m gatv2_tpu_torch.train --num-layers 3 --heads 4,1,1 \\
        --outdims 64,32,16 --epochs 200 --optimizer adam --lr 0.01 --clip \\
        --dataset citeseer --data-root /data/graphs
    python -m gatv2_tpu_torch.train --batch-size 1024 --fanouts 10,10,10 \\
        --num-layers 3 --heads 4,1,1 --outdims 64,32,16 --optimizer adam \\
        --lr 0.01 --clip --dataset products --data-root /data/graphs

Runs on the CUDA device, where --impl auto is 'sell' full-graph (the SELL
kernels K1, K2 and K3) and 'pallas' with --batch-size (the edge-tile
kernels K5, K6 and K7), unless given --device cpu ('torch'); --impl sell
--batch-size trains on per-batch SELL layouts through K1, K2 and K3.
Prints the JAX package's console lines and, on impl 'sell' or 'pallas',
how many times each kernel was launched. --profile DIR writes a
torch.profiler trace of the training run into DIR; --debug-nans raises
FloatingPointError at the first non-finite loss, backward value or
gradient. Flags of paths not ported yet (--mesh, --overlap) exit with an
error naming their ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    from gatv2_tpu_torch import cli
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
    from gatv2_tpu_torch.train import checkpoint as ckpt
    from gatv2_tpu_torch.train.loop import Trainer
    from gatv2_tpu_torch.train.minibatch import MinibatchTrainer
    from gatv2_tpu_torch.utils.metrics import JsonlSink, device_memory_report

    model_config, train_config, args = cli.parse_args(argv)
    device = resolve_device(args.device)
    if args.load_weights and train_config.resume:
        # fresh weights on top of a restored checkpoint would be paired with
        # its warm Adam moments and epoch counter
        raise SystemExit(
            "Error: --load-weights cannot be combined with --resume "
            "(the restored optimizer state/epoch belong to the "
            "checkpointed weights)."
        )

    print(cli.echo_config(model_config, train_config))
    data_root = train_config.data_root
    dataset_dir = resolve_dataset_dir(train_config.dataset, data_root)
    print(f"Using dataset: {train_config.dataset}")
    print(f"Dataset path: {dataset_dir}/")
    graph = load_dataset(train_config.dataset, data_root)
    model_config = dataclasses.replace(
        model_config, num_classes=graph.num_classes, in_dim=graph.feature_dim
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

    sink = JsonlSink(train_config.log_file) if train_config.log_file else None
    if train_config.batch_size > 0:
        print(
            f"Minibatch mode: batch_size={train_config.batch_size}, "
            f"fanouts={list(train_config.fanouts)}, "
            f"sampler={train_config.sampler_engine}"
        )
        trainer = MinibatchTrainer(graph, model_config, train_config,
                                   metrics_sink=sink, splits=splits,
                                   device=device)
    else:
        trainer = Trainer(graph, model_config, train_config,
                          metrics_sink=sink, splits=splits, device=device)
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
        if args.profile:
            prof = _profiler(device)
            # registered first, so it runs after the profiler has stopped
            stack.callback(_export_trace, prof, args.profile)
            stack.enter_context(prof)
            print(f"Profiling to {args.profile}/")
        every = train_config.checkpoint_every
        if train_config.checkpoint_dir and every > 0:
            while trainer.epoch < train_config.epochs:
                trainer.run(min(every, train_config.epochs - trainer.epoch))
                ckpt.save(train_config.checkpoint_dir, trainer.params,
                          trainer.opt_state, trainer.epoch, meta=meta)
        elif train_config.epochs > trainer.epoch:
            trainer.run(train_config.epochs - trainer.epoch)
            if train_config.checkpoint_dir:
                ckpt.save(train_config.checkpoint_dir, trainer.params,
                          trainer.opt_state, trainer.epoch, meta=meta)
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
        save_params_txt(args.save_weights, trainer.params)
        print(f"Saved weights to {args.save_weights}/")
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
