"""Command-line interface (port of gatv2_tpu/cli.py): the same flags,
defaults, validation messages and configuration echo.

Reference surface: --num-layers, --heads, --outdims, --epochs, --optimizer,
--beta1/--beta2, --lr, --clip, --dataset, --data-root (DATA_ROOT env
fallback). Parsing is order-insensitive. Port-specific: --impl takes
torch|sell|pallas|auto, --device cuda|cpu and, with --mesh, --transport
auto|nccl|gloo. Every other flag parses as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

from gatv2_tpu_torch.config import ModelConfig, TrainConfig


def _resolve_impl(args) -> str:
    """--impl auto, as the JAX package resolves it on an accelerator: the
    pallas kernels for minibatch training, the SELL kernels full-graph, on
    CUDA; the plain PyTorch path on the CPU (the CUDA kernels do not run
    there)."""
    if args.impl != "auto":
        return args.impl
    if args.device != "cuda":
        return "torch"
    return "pallas" if args.batch_size > 0 else "sell"


def _int_list(s: str) -> list[int]:
    try:
        return [int(v) for v in s.split(",") if v != ""]
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected comma-separated ints, got {s!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gatv2-tpu-torch",
        description="GATv2 node classification on PyTorch/CUDA",
    )
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--heads", type=_int_list, default=None)
    p.add_argument("--outdims", type=_int_list, default=None)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--optimizer", choices=["sgd", "adam"], default="sgd")
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--clip", action="store_true")
    p.add_argument("--dataset", type=str, default="pubmed")
    p.add_argument("--data-root", type=str, default=None)
    # framework extensions
    p.add_argument("--impl", choices=["torch", "sell", "auto", "pallas"],
                   default="auto",
                   help="attention implementation: torch (plain PyTorch), "
                        "sell (degree-sorted sliced-ELLPACK layout through "
                        "the CUDA kernels K1-K3), pallas (edge tiles "
                        "through the CUDA kernels K5-K7), auto (on CUDA "
                        "pallas with --batch-size, else sell; torch with "
                        "--device cpu)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to run on (default cuda; no CUDA device "
                        "is an error, never a silent CPU run)")
    p.add_argument("--variant", choices=["edge", "node"], default="edge",
                   help="reference variant semantics (last-layer activation order)")
    p.add_argument("--precision", choices=["highest", "high", "default"], default="highest",
                   help="dense projection precision: IEEE fp32 (parity), "
                        "TF32, or bf16 inputs with fp32 accumulation")
    p.add_argument("--streams", choices=["f32", "bf16"], default="f32",
                   help="SELL stream tier: f32 (exact, default) or bf16 — "
                        "projections rounded once to bfloat16, all math "
                        "and transport fp32. sell impl only")
    p.add_argument("--seed", type=int, default=None,
                   help="PRNG seed (default: time-based, like the reference)")
    p.add_argument("--log-file", type=str, default=None,
                   help="JSONL per-epoch metrics sink")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the graph over this many ranks, one process "
                        "each (0 = single); with --batch-size, data-parallel "
                        "minibatch training. Started here unless launched "
                        "by torchrun")
    p.add_argument("--transport", choices=["auto", "nccl", "gloo"],
                   default="auto",
                   help="with --mesh: the collectives' backend; auto = "
                        "nccl when every rank has a card of its own, gloo "
                        "on the CPU or when ranks share a card (printed on "
                        "the Transport: line)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="minibatch mode: seed nodes per sampled subgraph "
                        "(0 = full-graph training, like the reference)")
    p.add_argument("--fanouts", type=_int_list, default=None,
                   help="per-layer neighbor-sampling fanouts for --batch-size "
                        "mode (default: 10 per layer)")
    p.add_argument("--sampler-engine", choices=["auto", "native", "python"],
                   default="auto", help="neighbor-sampler implementation")
    p.add_argument("--feature-residency", choices=["device", "host"],
                   default="device",
                   help="minibatch features: device-resident table (default) "
                        "or per-batch host gather")
    p.add_argument("--sample-budget", choices=["auto", "worst", "probe"],
                   default="auto",
                   help="static-shape budget for sampled subgraphs")
    p.add_argument("--eval-mode", choices=["exact", "sampled"],
                   default="exact",
                   help="minibatch-mode test evaluation: one full-graph "
                        "forward (exact) or fanout-sampled subgraphs")
    p.add_argument("--split-fractions", type=str, default=None,
                   metavar="TR,VA,TE",
                   help="random train/val/test split, e.g. 0.6,0.2,0.2")
    p.add_argument("--split-seed", type=int, default=0)
    p.add_argument("--overlap", action="store_true",
                   help="with --mesh: two-pass local/halo attention")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize layers in the backward pass "
                        "(torch.utils.checkpoint): projections and "
                        "elementwise ops; with --impl torch also the "
                        "attention, which sell and pallas keep from the "
                        "forward; no effect on inference")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on NaN/Inf: check the loss and every "
                        "gradient each step (autograd anomaly mode in the "
                        "backward) and raise FloatingPointError")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace of training into "
                        "DIR")
    p.add_argument("--save-weights", type=str, default=None, metavar="DIR",
                   help="dump final weights as text into DIR")
    p.add_argument("--load-weights", type=str, default=None, metavar="DIR",
                   help="initialize weights from a --save-weights dump")
    # the edge-conditioned block (ModelConfig edge_dim, residual, norm,
    # loss); full-graph training with --impl torch or sell only
    p.add_argument("--edge-features", action="store_true",
                   help="scores read the dataset's per-edge features "
                        "(edge_features.txt; edge_dim is its width)")
    p.add_argument("--residual", action="store_true",
                   help="each layer adds a linear residual W_res x")
    p.add_argument("--norm", choices=["none", "batch"], default="none",
                   help="batch: BatchNorm then ReLU between layers, the "
                        "last layer a plain head mean")
    p.add_argument("--loss", choices=["ce", "bce"], default="ce",
                   help="ce: softmax cross-entropy over class labels; "
                        "bce: binary cross-entropy over multi-label rows")
    return p


def parse_args_from(
    parser: argparse.ArgumentParser, argv: list[str] | None = None
) -> tuple[ModelConfig, TrainConfig, argparse.Namespace]:
    """parse_args against an extended parser (e.g. predict's)."""
    return _finish(parser.parse_args(argv))


def parse_args(argv: list[str] | None = None) -> tuple[ModelConfig, TrainConfig, argparse.Namespace]:
    return _finish(build_parser().parse_args(argv))


def _finish(args: argparse.Namespace) -> tuple[ModelConfig, TrainConfig, argparse.Namespace]:
    if args.num_layers < 1:
        raise SystemExit(
            f"Error: --num-layers must be >= 1 (got {args.num_layers})."
        )
    # the reference leaves heads/outdims uninitialized when the flags are
    # absent; default to 1 head / 16 dims instead
    heads = args.heads if args.heads is not None else [1] * args.num_layers
    outdims = args.outdims if args.outdims is not None else [16] * args.num_layers
    if len(heads) != args.num_layers:
        raise SystemExit(
            f"Error: --heads must have {args.num_layers} comma-separated values "
            f"(got {len(heads)})."
        )
    if len(outdims) != args.num_layers:
        raise SystemExit(
            f"Error: --outdims must have {args.num_layers} comma-separated values "
            f"(got {len(outdims)})."
        )

    impl = _resolve_impl(args)
    model_config = ModelConfig(
        num_layers=args.num_layers,
        heads=tuple(heads),
        out_dims=tuple(outdims),
        variant=args.variant,
        matmul_precision=args.precision,
        remat=args.remat,
        streams=args.streams,
        residual=args.residual,
        norm=args.norm,
        loss=args.loss,
    )
    if args.streams == "bf16" and impl != "sell":
        print(
            "Warning: --streams bf16 applies to the SELL kernels only; "
            f"impl={impl!r} runs exact f32 streams.", file=sys.stderr,
        )
    train_config = TrainConfig(
        epochs=args.epochs,
        optimizer=args.optimizer,
        lr=args.lr,
        beta1=args.beta1,
        beta2=args.beta2,
        clip=args.clip,
        seed=args.seed,
        dataset=args.dataset,
        # precedence: --data-root flag, else DATA_ROOT env, else ./data
        data_root=(
            args.data_root
            if args.data_root is not None
            else os.environ.get("DATA_ROOT", "./data")
        ),
        impl=impl,
        batch_size=args.batch_size,
        fanouts=tuple(args.fanouts) if args.fanouts is not None
        else tuple([10] * args.num_layers if args.batch_size > 0 else []),
        sampler_engine=args.sampler_engine,
        sample_budget=args.sample_budget,
        feature_residency=args.feature_residency,
        log_file=args.log_file,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        debug_nans=args.debug_nans,
    )
    try:
        warnings = train_config.validate()
    except ValueError as e:
        raise SystemExit(str(e))
    for w in warnings:
        print(w, file=sys.stderr)
    return model_config, train_config, args


def echo_config(model_config: ModelConfig, train_config: TrainConfig) -> str:
    """Config echo in the reference's format."""
    return (
        "Configuration:\n"
        f"  Number of layers: {model_config.num_layers}\n"
        f"  Epochs: {train_config.epochs}\n"
        f"  Attention heads: [{', '.join(map(str, model_config.heads))}]\n"
        f"  Output dimensions: [{', '.join(map(str, model_config.out_dims))}]\n"
        f"  Gradient clipping: {'true' if train_config.clip else 'false'}\n"
        f"  Optimizer: {train_config.optimizer}\n"
        f"  Learning rate: {train_config.lr:g}\n"
    )
