"""The full-graph Trainer and the multi-epoch runner (port of
gatv2_tpu/train/loop.py:68-118, :170-306).

One optimizer step per epoch (`train_epoch`, the body both share):
forward, masked cross-entropy, backward through autograd (on impl='sell'
the backward runs the SELL kernels K2 and K3, or K2 and K4 on a chunked
layout; on impl='pallas' K6 and K7, or K6 and K8), optional group-norm
clipping, SGD or Adam. Each epoch prints the reference's console lines

    Epoch 1
    Avg Loss: 1.791234, Accuracy: 54.32%  total time: 6372.27 ms

and, with splits, `Train/Val/Test Accuracy: ...` from one extra forward.
The epoch time is the host's clock up to the loss read-back, which waits
for the device. make_multi_epoch_runner runs K epochs of the same body and
reads nothing back between them: its losses and accuracies stay on the
device.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from gatv2_tpu_torch.config import ModelConfig, TrainConfig
from gatv2_tpu_torch.data.graph import Graph
from gatv2_tpu_torch.device import resolve_device
from gatv2_tpu_torch.models.gatv2 import GATv2, init_params_for_variant, loss_fn
from gatv2_tpu_torch.train import optim
from gatv2_tpu_torch.utils.metrics import span


def train_epoch(params: GATv2, opt_state: dict, t: torch.Tensor, features,
                src, dst, labels, model_config: ModelConfig,
                train_config: TrainConfig, *, edge_tiles: Any = None,
                num_valid: int | None = None, edge_feat=None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One epoch: loss, gradients, update, written into params and
    opt_state in place. t: Adam's 1-indexed step as a 0-d fp32 tensor on
    the device (optim.step_count). Returns (loss, accuracy) as 0-d tensors
    on the device; nothing is read back (train_config.debug_nans checks,
    and so waits, by design). Runs under the span train.step. edge_feat
    [E, k]: impl 'torch''s edge features (the SELL layout holds its own);
    labels are [N, C] 0/1 with model_config.loss 'bce'."""
    with span("train.step"):
        kw = {} if edge_feat is None else dict(edge_feat=edge_feat)
        loss, acc = loss_fn(
            params, features, src, dst, labels, model_config,
            impl=train_config.impl, edge_tiles=edge_tiles,
            num_valid=num_valid, **kw,
        )
        grads = optim.gradients(loss, params,
                                debug_nans=train_config.debug_nans)
        optim.apply_updates(optim.param_leaves(params), grads, opt_state, t,
                            train_config, optim.param_names(params))
    return loss.detach(), acc


def make_multi_epoch_runner(
    model_config: ModelConfig,
    train_config: TrainConfig,
    num_epochs: int,
    *,
    edge_tiles: Any = None,
    num_valid: int | None = None,
    edge_feat: Any = None,
) -> Callable:
    """K = num_epochs epochs of train_epoch with no read-back between them.

    Returns run(params, opt_state, t0, features, src, dst, labels) ->
    (params, opt_state, losses[K], accs[K]); params (a GATv2 module) and
    opt_state are updated in place and returned for parity with the JAX
    package; t0 is the number of epochs already done (Adam's t runs t0+1
    ... t0+K); losses and accs are fp32 tensors on the device. edge_tiles
    and num_valid are a Trainer's (SellTiles for impl='sell', EdgeTiles for
    'pallas', on the device), and so is edge_feat (impl 'torch''s edge
    features; a SELL layout carries its own)."""
    if num_epochs < 1:
        raise ValueError(f"num_epochs must be >= 1, got {num_epochs}")

    def run(params, opt_state, t0, features, src, dst, labels):
        dev = params.w_o.device
        out = [train_epoch(params, opt_state, optim.step_count(t0 + k, dev),
                           features, src, dst, labels, model_config,
                           train_config, edge_tiles=edge_tiles,
                           num_valid=num_valid, edge_feat=edge_feat)
               for k in range(1, num_epochs + 1)]
        losses, accs = (torch.stack(x) for x in zip(*out))
        return params, opt_state, losses, accs

    return run


def edge_features_for(graph: Graph, model_config: ModelConfig):
    """The graph's edge features [E, k] when the model reads them
    (model_config.edge_dim > 0), else None; ValueError when the model
    wants features the graph lacks or of another width."""
    if model_config.edge_dim == 0:
        return None
    ef = graph.edge_features
    if ef is None or ef.shape[1] != model_config.edge_dim:
        raise ValueError(
            f"edge_dim={model_config.edge_dim} needs the graph's edge "
            f"features of that width; it has "
            f"{'none' if ef is None else ef.shape[1]}")
    return ef


class Trainer:
    """Full-graph trainer with the reference's observable behaviour.

    `params` (a GATv2 module) may be replaced, e.g. by weights loaded from
    a dump; the new module moves to the trainer's device and keeps the
    current optimizer state, as in the JAX package. `device` defaults to
    CUDA and raises without it unless the caller asks for the CPU."""

    def __init__(
        self,
        graph: Graph,
        model_config: ModelConfig,
        train_config: TrainConfig,
        *,
        log_fn: Callable[[str], None] = print,
        metrics_sink: Any = None,
        splits: Any = None,
        device: str | torch.device = "cuda",
    ):
        self.graph = graph
        self.model_config = model_config
        self.train_config = train_config
        self.log = log_fn
        self.metrics_sink = metrics_sink
        self.splits = splits
        self.device = resolve_device(device)
        dev = self.device

        seed = train_config.seed
        if seed is None:
            seed = int(time.time())  # the reference seeds with time(NULL)
        self.params = init_params_for_variant(
            model_config, torch.Generator().manual_seed(seed))
        self.opt_state = optim.init_opt_state(self._params,
                                              train_config.optimizer)
        self.epoch = 0  # completed epochs

        labels, self.num_valid = graph.labels, None
        if splits is not None:
            labels = splits.masked_labels(labels, "train")
            self.num_valid = int(splits.train.sum())
        feats, self.src, self.dst, self.edge_tiles = graph.features, None, None, None
        if train_config.impl == "pallas":
            model_config.check_full_graph_only("--impl pallas")
        edge_features = edge_features_for(graph, model_config)
        self.edge_feat = None
        if train_config.impl == "sell":
            from gatv2_tpu_torch.ops.sell_attention import setup_full_graph_sell

            st, feats, labels, pad_valid = setup_full_graph_sell(
                graph, model_config.heads, model_config.out_dims, device=dev,
                labels=labels, edge_features=edge_features,
            )
            with span("setup.layout"), span("layout.to_device"):
                self.edge_tiles = st.to(dev)
            if pad_valid is not None and self.num_valid is None:
                self.num_valid = pad_valid
        elif train_config.impl == "pallas":
            from gatv2_tpu_torch.ops.pallas_attention import setup_full_graph

            et, feats, labels, pad_valid = setup_full_graph(
                graph, model_config.heads, model_config.out_dims, device=dev,
                labels=labels,
            )
            self.edge_tiles = et.to(dev)
            if pad_valid is not None and self.num_valid is None:
                self.num_valid = pad_valid
        elif train_config.impl == "torch":
            self.src = torch.as_tensor(graph.src, device=dev)
            self.dst = torch.as_tensor(graph.dst, device=dev)
            if edge_features is not None:
                self.edge_feat = torch.as_tensor(edge_features, device=dev)
        else:
            raise ValueError(
                f"Trainer: impl must be 'torch', 'sell' or 'pallas', got "
                f"{train_config.impl!r}"
            )
        self.features = torch.as_tensor(feats, device=dev)
        self.labels = torch.as_tensor(labels, device=dev)
        if splits is not None:
            n_all = self.features.shape[0]

            def padmask(m):
                out = np.zeros(n_all, bool)
                out[: m.shape[0]] = m
                return torch.as_tensor(out, device=dev)

            self._masks = tuple(
                padmask(m) for m in (splits.train, splits.val, splits.test))
            full = np.full((n_all, *graph.labels.shape[1:]), -1, np.int32)
            full[: graph.num_nodes] = graph.labels
            self._eval_labels = torch.as_tensor(full, device=dev)

    @property
    def params(self) -> GATv2:
        return self._params

    @params.setter
    def params(self, params: GATv2) -> None:
        self._params = params.to(self.device)

    def _forward_kw(self):
        kw = dict(impl=self.train_config.impl, edge_tiles=self.edge_tiles)
        if self.edge_feat is not None:
            kw["edge_feat"] = self.edge_feat
        return kw

    def step(self) -> tuple[float, float]:
        """One epoch (train_epoch at Adam step self.epoch), then its
        read-back. Returns (loss, accuracy)."""
        loss, acc = train_epoch(
            self._params, self.opt_state,
            optim.step_count(self.epoch, self.device), self.features,
            self.src, self.dst, self.labels, self.model_config,
            self.train_config, edge_tiles=self.edge_tiles,
            num_valid=self.num_valid, edge_feat=self.edge_feat,
        )
        return float(loss), float(acc)

    def run(self, epochs: int | None = None) -> dict[str, float]:
        epochs = epochs if epochs is not None else self.train_config.epochs
        last = {}
        for _ in range(epochs):
            self.epoch += 1
            t0 = time.perf_counter()
            loss, acc = self.step()
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.log(f"Epoch {self.epoch}")
            self.log(
                f"Avg Loss: {loss:.6f}, Accuracy: {acc * 100.0:.2f}%  "
                f"total time: {dt_ms:.2f} ms"
            )
            last = {"epoch": self.epoch, "loss": loss, "accuracy": acc,
                    "ms": dt_ms}
            if self.splits is not None:
                accs = self.evaluate()
                self.log(
                    f"Train/Val/Test Accuracy: {accs['train'] * 100:.2f}% / "
                    f"{accs['val'] * 100:.2f}% / {accs['test'] * 100:.2f}%"
                )
                last.update({f"{k}_accuracy": v for k, v in accs.items()})
            if self.metrics_sink is not None:
                self.metrics_sink.write(last)
        return last

    @torch.no_grad()
    def evaluate(self) -> dict[str, float]:
        """Accuracy on the train/val/test splits from one full forward."""
        if self.splits is None:
            raise ValueError("Trainer built without splits")
        logits = self._params(self.features, self.src, self.dst,
                              self.model_config, **self._forward_kw())
        if self.model_config.loss == "bce":
            hit = ((logits > 0) == (self._eval_labels > 0)).float().mean(1)
        else:
            hit = (logits.argmax(dim=-1) == self._eval_labels).float()
        return {
            k: float(torch.where(m, hit, 0.0).sum() / m.sum().clamp(min=1))
            for k, m in zip(("train", "val", "test"), self._masks)
        }
