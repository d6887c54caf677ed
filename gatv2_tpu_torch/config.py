"""Model / training configuration (port of gatv2_tpu/config.py).

Same fields, defaults and validation as the JAX package: L=2 layers,
epochs=200, optimizer sgd, lr=1e-4, betas 0.9/0.999, clip off (threshold
5.0 when on), dataset pubmed, data root ./data with DATA_ROOT env fallback,
LeakyReLU slope 0.01. `precision` returns the port's tier name instead of a
jax.lax.Precision; models/gatv2.py maps the tiers onto the GPU's matmul
modes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of a multi-layer GATv2 + linear classifier."""

    num_layers: int = 2
    heads: tuple[int, ...] = (1, 1)
    out_dims: tuple[int, ...] = (16, 16)  # per-head output dim, per layer
    num_classes: int = 0  # inferred from labels (max+1)
    in_dim: int = 0  # feature dim, inferred from features.txt
    negative_slope: float = 0.01
    # 'edge' = fused-W semantics incl. last-layer LeakyReLU-then-mean;
    # 'node' = split-W semantics, last-layer mean-then-LeakyReLU.
    variant: str = "edge"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # dense-projection precision tier: 'highest' = IEEE fp32 (TF32 off),
    # 'high' = TF32, 'default' = bf16 inputs with fp32 accumulation. The
    # attention kernel computes in fp32 at every tier.
    matmul_precision: str = "highest"
    # rematerialize each layer in the backward pass
    # (torch.utils.checkpoint): the projections and elementwise ops; the
    # attention too with impl 'torch', while 'sell' and 'pallas' keep the
    # attention op's node-space result from the forward; inference keeps
    # no activations, so it has nothing to rematerialize there
    remat: bool = False
    # SELL stream tier: 'f32' (exact) or 'bf16' — projections are rounded
    # once to bfloat16 and carried as fp32, so the kernel computes exactly
    # what it would on bf16-rounded projections.
    streams: str = "f32"
    # the edge-conditioned block (ogbn-proteins GAT of DGL's OGB examples);
    # the defaults give the plain GATv2 above, unchanged.
    # edge_dim: width k of per-edge features f_ij; each layer gains W_e
    # [H, D, k] and scores read LeakyReLU(W_src x_i + W_dst x_j + W_e f_ij)
    edge_dim: int = 0
    # residual: each layer adds (W_res x_j) [H*D] to its heads' output
    residual: bool = False
    # norm: 'none', or 'batch': hidden layers apply BatchNorm over the
    # real nodes, then ReLU, and the last layer takes the head mean with no
    # activation (the DGL block)
    norm: str = "none"
    # loss: 'ce' (softmax cross-entropy over [N] class labels) or 'bce'
    # (mean binary cross-entropy with logits over [N, C] 0/1 labels)
    loss: str = "ce"

    def __post_init__(self):
        if len(self.heads) != self.num_layers or len(self.out_dims) != self.num_layers:
            raise ValueError(
                f"--heads and --outdims must each have --num-layers={self.num_layers} "
                f"entries; got heads={list(self.heads)} outdims={list(self.out_dims)}"
            )
        if self.variant not in ("edge", "node"):
            raise ValueError(f"variant must be 'edge' or 'node', got {self.variant!r}")
        if self.matmul_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"matmul_precision must be 'highest', 'high' or 'default', "
                f"got {self.matmul_precision!r}"
            )
        if self.streams not in ("f32", "bf16"):
            raise ValueError(
                f"streams must be 'f32' or 'bf16', got {self.streams!r}"
            )
        if self.edge_dim < 0:
            raise ValueError(f"edge_dim must be >= 0, got {self.edge_dim}")
        if self.norm not in ("none", "batch"):
            raise ValueError(
                f"norm must be 'none' or 'batch', got {self.norm!r}")
        if self.loss not in ("ce", "bce"):
            raise ValueError(f"loss must be 'ce' or 'bce', got {self.loss!r}")
        if self.variant == "node" and self.extended:
            raise ValueError(
                "variant 'node' takes none of edge_dim, residual, norm "
                "'batch' or loss 'bce' (the block is defined on the 'edge' "
                "variant only)")

    @property
    def extended(self) -> bool:
        """Whether any field of the edge-conditioned block is set."""
        return (self.edge_dim > 0 or self.residual or self.norm != "none"
                or self.loss != "ce")

    def check_full_graph_only(self, where: str) -> None:
        """ValueError naming the first field of the edge-conditioned block
        that is set: `where` (a trainer or option) runs only the plain
        model."""
        for name, on in (("edge_dim", self.edge_dim > 0),
                         ("residual", self.residual),
                         ("norm", self.norm != "none"),
                         ("loss", self.loss != "ce")):
            if on:
                raise ValueError(
                    f"{where} does not support {name}={getattr(self, name)!r}"
                    ": the edge-conditioned block runs on the full-graph "
                    "path (Trainer, impl 'torch' or 'sell') only")

    @property
    def precision(self) -> str:
        """The projection tier name: 'highest' | 'high' | 'default'."""
        return self.matmul_precision

    @property
    def layer_in_dims(self) -> tuple[int, ...]:
        """in_dim of each layer: features, then heads[l-1]*out_dims[l-1]."""
        dims = [self.in_dim]
        for l in range(1, self.num_layers):
            dims.append(self.heads[l - 1] * self.out_dims[l - 1])
        return tuple(dims)

    @property
    def final_dim(self) -> int:
        """Classifier input dim: last layer averages heads -> out_dims[-1]."""
        return self.out_dims[-1]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 200
    optimizer: str = "sgd"  # 'sgd' | 'adam'
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    clip: bool = False
    clip_norm: float = 5.0
    seed: int | None = None  # None -> time-based, like the reference
    dataset: str = "pubmed"
    data_root: str = "./data"
    # attention implementation: 'torch' (plain PyTorch, the oracle), 'sell'
    # (the SELL layout through the hand-written CUDA kernels K1-K3) or
    # 'pallas' (the edge-tile layout through K5-K7)
    impl: str = "torch"
    # minibatch mode: batch_size > 0 trains on neighbour-sampled subgraphs
    # (fanouts = per-layer in-neighbour caps) instead of full-graph epochs
    batch_size: int = 0
    fanouts: tuple = ()
    sampler_engine: str = "auto"  # 'auto' (= 'native') | 'native' | 'python'
    # static-shape budget of sampled subgraphs: 'auto' (worst case capped at
    # the graph size), 'worst' (uncapped), 'probe' (from probe batches)
    sample_budget: str = "auto"
    # minibatch features: 'device' (the full table on the device, rows
    # gathered there by node id) or 'host' (rows gathered on the host)
    feature_residency: str = "device"
    log_file: str | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0  # epochs; 0 = off
    resume: bool = False
    # --debug-nans: every step checks the loss and the gradients and raises
    # FloatingPointError at the first non-finite value (optim.gradients)
    debug_nans: bool = False

    def validate(self) -> list[str]:
        """Returns warnings; raises on errors (mirrors the reference)."""
        warnings = []
        if self.optimizer not in ("sgd", "adam"):
            raise ValueError(f"Unknown optimizer: {self.optimizer}")
        if self.optimizer == "adam":
            if not (0.0 < self.beta1 < 1.0 and 0.0 < self.beta2 < 1.0):
                raise ValueError(
                    "Error: beta1 and beta2 must be in range (0,1) for Adam optimizer."
                )
        elif self.optimizer == "sgd":
            if self.beta1 != 0.9 or self.beta2 != 0.999:
                warnings.append(
                    "Warning: beta parameters are ignored when using SGD optimizer."
                )
        if self.feature_residency not in ("device", "host"):
            raise ValueError(
                f"feature_residency must be 'device' or 'host', "
                f"got {self.feature_residency!r}"
            )
        if self.batch_size < 0:
            raise ValueError(f"--batch-size must be >= 0, got {self.batch_size}")
        if self.batch_size > 0 and any(f < 1 for f in self.fanouts):
            raise ValueError(
                f"--fanouts entries must be >= 1, got {list(self.fanouts)}"
            )
        if self.sampler_engine not in ("auto", "native", "python"):
            raise ValueError(
                f"sampler_engine must be 'auto', 'native' or 'python', "
                f"got {self.sampler_engine!r}"
            )
        if self.sample_budget not in ("auto", "worst", "probe"):
            raise ValueError(
                f"sample_budget must be 'auto', 'worst' or 'probe', "
                f"got {self.sample_budget!r}"
            )
        return warnings
