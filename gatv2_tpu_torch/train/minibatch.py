"""Minibatch (sampled-subgraph) training, on one device and data-parallel
over ranks (port of gatv2_tpu/train/minibatch.py).

Pairs with data.sampling.NeighborSampler. The loss is computed over seed
nodes only (labels are -1 elsewhere); Adam bias correction is indexed by the
global STEP count here (the full-graph Trainer indexes it by epoch, as the
reference does). On impl='pallas' each batch's fixed-shape EdgeTiles go to
the device once and the model runs K5 forward and K6/K7 backward on them;
on impl='sell' each batch's SellTiles (fixed geometry, both sides split) do,
and the model runs K1 forward and K2/K3 backward.

Features: with feature_residency='device' the whole feature table stays on
the device and each batch gathers its rows there by node id (an
index_select with the ids clamped into range, the JAX package's
mode='clip'); with 'host' the sampler gathers the rows on the host (the
native gather_rows on the native engine) and the batch uploads them.

Data parallelism (DataParallelMinibatchTrainer, --mesh N --batch-size B):
one process per rank, each training on its own batch of the epoch's
stream per super-step; parameters stay replicated and the gradients are
combined seed-weighted by one all_reduce (make_dp_minibatch_step).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from gatv2_tpu_torch.config import ModelConfig, TrainConfig
from gatv2_tpu_torch.data.sampling import MiniBatch, NeighborSampler, prefetch
from gatv2_tpu_torch.device import resolve_device
from gatv2_tpu_torch.models.gatv2 import (
    GATv2,
    init_params_for_variant,
    loss_and_accuracy,
    loss_fn,
)
from gatv2_tpu_torch.train import optim
from gatv2_tpu_torch.utils.metrics import span


def gather_rows_clip(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] with out-of-range ids clamped onto the first or last row
    (jnp.take's mode='clip')."""
    return table.index_select(0, ids.long().clamp(0, table.shape[0] - 1))


def make_minibatch_step(
    model_config: ModelConfig, train_config: TrainConfig, *,
    device_gather: bool = False,
) -> Callable:
    """step(params, opt_state, t, features, src, dst, labels, num_seeds
    [, edge_tiles]) -> (params, opt_state, loss, acc): one optimizer step on
    one batch, written into params and opt_state in place (the JAX
    package returns new ones). t is the 1-indexed global step.

    device_gather=True: `features` is (feat_table, node_ids) — the full
    feature table on the device and the batch's node ids — and the rows
    are gathered on the device."""

    def step(params: GATv2, opt_state: dict, t: int, features, src, dst,
             labels, num_seeds: int, edge_tiles=None):
        if device_gather:
            feat_table, node_ids = features
            features = gather_rows_clip(feat_table, node_ids)
        loss, acc = loss_fn(
            params, features, src, dst, labels, model_config,
            impl=train_config.impl, num_valid=num_seeds,
            edge_tiles=edge_tiles,
        )
        grads = optim.gradients(loss, params,
                                debug_nans=train_config.debug_nans)
        optim.apply_updates(optim.param_leaves(params), grads, opt_state, t,
                            train_config)
        return params, opt_state, loss.detach(), acc

    return step


class MinibatchTrainer:
    """Sampled-subgraph trainer with the reference's console contract
    (per-epoch 'Avg Loss / Accuracy / total time' lines; loss and accuracy
    are seed-weighted averages over the epoch's batches). `device` defaults
    to CUDA and raises without it unless the caller asks for the CPU."""

    def __init__(
        self,
        graph,
        model_config: ModelConfig,
        train_config: TrainConfig,
        *,
        log_fn: Callable[[str], None] = print,
        metrics_sink: Any = None,
        splits: Any = None,
        device: str | torch.device = "cuda",
    ):
        model_config.check_full_graph_only("--batch-size (minibatch training)")
        self.graph = graph
        self.model_config = model_config
        self.train_config = train_config
        self.log = log_fn
        self.metrics_sink = metrics_sink
        self.splits = splits
        self.device = resolve_device(device)
        fanouts = train_config.fanouts or tuple([10] * model_config.num_layers)
        if len(fanouts) != model_config.num_layers:
            raise ValueError(
                f"--fanouts needs {model_config.num_layers} entries, got "
                f"{len(fanouts)}")
        seed = train_config.seed
        if seed is None:
            seed = int(time.time())
        self._seed = seed
        # with splits, only train nodes seed batches (no val/test leakage)
        seed_nodes = (np.nonzero(splits.train)[0] if splits is not None
                      else None)
        self.sampler = self._make_sampler(fanouts, seed, seed_nodes)
        self.params = init_params_for_variant(
            model_config, torch.Generator().manual_seed(seed))
        self.opt_state = optim.init_opt_state(self._params,
                                              train_config.optimizer)
        self.epoch = 0
        self.step_count = 0
        self._device_gather = train_config.feature_residency == "device"
        if self._device_gather:
            self._feat_table = torch.as_tensor(graph.features,
                                               device=self.device)
        self._step = make_minibatch_step(
            model_config, train_config, device_gather=self._device_gather)
        self._eval_samplers: dict[str, NeighborSampler] = {}
        self._exact_eval = None

    @property
    def params(self) -> GATv2:
        return self._params

    @params.setter
    def params(self, params: GATv2) -> None:
        self._params = params.to(self.device)

    def _make_sampler(self, fanouts, seed, seed_nodes) -> NeighborSampler:
        tc = self.train_config
        return NeighborSampler(
            self.graph, tc.batch_size, fanouts, seed=seed,
            engine=tc.sampler_engine, seed_nodes=seed_nodes,
            emit_tiles=tc.impl if tc.impl in ("pallas", "sell") else False,
            budget=tc.sample_budget,
            gather_features=tc.feature_residency == "host",
        )

    def sync_step_count(self) -> None:
        """After a checkpoint resume (which restores `epoch`): rebuild the
        Adam step counter so bias correction continues, instead of
        restarting at t=1 with warm moments."""
        self.step_count = self.epoch * self.sampler.batches_per_epoch()

    def batch_args(self, b: MiniBatch) -> tuple:
        """(features, src, dst, labels, edge_tiles) of a batch on the
        device, as the step takes them. impl='torch' gets the real edges
        only (its segment ops take no padding id); 'pallas' and 'sell' read
        their edges from the batch's tiles, copied to the device here,
        under the span train.h2d."""
        dev = self.device
        with span("train.h2d"):
            if self._device_gather:
                feats = (self._feat_table,
                         torch.as_tensor(b.node_ids, device=dev))
            else:
                feats = torch.as_tensor(b.features, device=dev)
            src = dst = None
            if self.train_config.impl == "torch":
                src = torch.as_tensor(b.src[: b.num_edges], device=dev)
                dst = torch.as_tensor(b.dst[: b.num_edges], device=dev)
            tiles = b.tiles.to(dev) if b.tiles is not None else None
            return (feats, src, dst, torch.as_tensor(b.labels, device=dev),
                    tiles)

    def train_step(self, b: MiniBatch) -> tuple[float, float]:
        """One optimizer step on batch b, under the span train.step; the
        loss and accuracy are read back under train.readback. Returns
        (loss, accuracy)."""
        with span("train.step"):
            self.step_count += 1
            feats, src, dst, labels, tiles = self.batch_args(b)
            _, _, loss, acc = self._step(
                self._params, self.opt_state, self.step_count, feats, src,
                dst, labels, b.num_seeds, tiles)
            with span("train.readback"):
                return float(loss), float(acc)

    @torch.no_grad()
    def evaluate(self, which: str = "test") -> float:
        """Accuracy on a split by sampled-subgraph inference: every node of
        the split seeds exactly one batch; accuracy is seed-weighted."""
        if self.splits is None:
            raise ValueError("MinibatchTrainer built without splits")
        # one sampler per split, kept: a new one would re-run probe batches
        sampler = self._eval_samplers.get(which)
        if sampler is None:
            nodes = np.nonzero(getattr(self.splits, which))[0]
            sampler = self._eval_samplers[which] = self._make_sampler(
                self.sampler.fanouts, self._seed + 1, nodes)
        mc, impl = self.model_config, self.train_config.impl
        correct, total = 0.0, 0
        for b in prefetch(sampler, depth=2):
            feats, src, dst, labels, tiles = self.batch_args(b)
            if self._device_gather:
                feats = gather_rows_clip(*feats)
            logits = self._params(feats, src, dst, mc, impl=impl,
                                  edge_tiles=tiles)
            _, acc = loss_and_accuracy(logits, labels, b.num_seeds)
            correct += float(acc) * b.num_seeds
            total += b.num_seeds
        return correct / max(total, 1)

    @torch.no_grad()
    def evaluate_exact(self) -> dict[str, float]:
        """Split accuracies from ONE exact full-graph forward: every node
        aggregates its full in-neighbourhood, the reference's evaluation
        semantics. Deterministic, unlike the sampled evaluate(). impl
        'pallas' runs through setup_full_graph's layout and 'sell' through
        setup_full_graph_sell's (chunked when the device's budget asks for
        it: the forward runs K5 or K1 per chunk)."""
        if self.splits is None:
            raise ValueError("MinibatchTrainer built without splits")
        if self._exact_eval is None:
            self._exact_eval = self._setup_exact_eval()
        feats, src, dst, et, labels, masks = self._exact_eval
        logits = self._params(feats, src, dst, self.model_config,
                              impl=self.train_config.impl, edge_tiles=et)
        hit = (logits.argmax(dim=-1) == labels).float()
        return {
            k: float(torch.where(m, hit, 0.0).sum() / m.sum().clamp(min=1))
            for k, m in zip(("train", "val", "test"), masks)
        }

    def _setup_exact_eval(self):
        graph, mc, dev = self.graph, self.model_config, self.device
        impl = self.train_config.impl
        feats, src, dst, et = graph.features, None, None, None
        if impl == "pallas":
            from gatv2_tpu_torch.ops.pallas_attention import setup_full_graph

            et, feats, _, _ = setup_full_graph(graph, mc.heads, mc.out_dims,
                                               device=dev)
            et = et.to(dev)
        elif impl == "sell":
            from gatv2_tpu_torch.ops.sell_attention import (
                setup_full_graph_sell,
            )

            et, feats, _, _ = setup_full_graph_sell(
                graph, mc.heads, mc.out_dims, device=dev)
            et = et.to(dev)
        else:
            src = torch.as_tensor(graph.src, device=dev)
            dst = torch.as_tensor(graph.dst, device=dev)
        n_all = feats.shape[0]
        full = np.full(n_all, -1, np.int32)
        full[: graph.num_nodes] = graph.labels

        def padmask(m):
            out = np.zeros(n_all, bool)
            out[: m.shape[0]] = m
            return torch.as_tensor(out, device=dev)

        masks = tuple(padmask(m) for m in (
            self.splits.train, self.splits.val, self.splits.test))
        return (torch.as_tensor(feats, device=dev), src, dst, et,
                torch.as_tensor(full, device=dev), masks)

    def run(self, epochs: int | None = None) -> dict:
        epochs = epochs if epochs is not None else self.train_config.epochs
        last = {}
        for _ in range(epochs):
            self.epoch += 1
            t0 = time.perf_counter()
            loss_sum = correct_sum = 0.0
            seeds_total = 0
            for b in prefetch(self.sampler, depth=2):
                loss, acc = self.train_step(b)
                loss_sum += loss * b.num_seeds
                correct_sum += acc * b.num_seeds
                seeds_total += b.num_seeds
            dt_ms = (time.perf_counter() - t0) * 1e3
            avg_loss = loss_sum / max(seeds_total, 1)
            avg_acc = correct_sum / max(seeds_total, 1)
            self.log(f"Epoch {self.epoch}")
            self.log(
                f"Avg Loss: {avg_loss:.6f}, Accuracy: {avg_acc * 100.0:.2f}%  "
                f"total time: {dt_ms:.2f} ms"
            )
            last = {
                "epoch": self.epoch, "loss": avg_loss, "accuracy": avg_acc,
                "ms": dt_ms, "batches": self.sampler.batches_per_epoch(),
            }
            if self.metrics_sink is not None:
                self.metrics_sink.write(last)
        return last


def make_dp_minibatch_step(
    model_config: ModelConfig, train_config: TrainConfig, mesh, *,
    device_gather: bool = False,
) -> Callable:
    """Data-parallel step: step(params, opt_state, t, features, src, dst,
    labels, num_seeds[, edge_tiles]) -> (loss, acc, seeds) of the whole
    group (seeds: its seed count), each rank with its own batch. Loss,
    accuracy and gradients are SEED-WEIGHTED across the ranks: every rank differentiates num_seeds x its batch's
    mean loss, then one all_reduce sums the gradients with the weighted
    loss and accuracy sums and the seed count, and the sums are divided by
    that count. A padding batch with num_seeds=0 contributes nothing.
    params and opt_state (replicated) are updated in place."""

    def step(params: GATv2, opt_state: dict, t: int, features, src, dst,
             labels, num_seeds: int, edge_tiles=None):
        if device_gather:
            features = gather_rows_clip(*features)
        loss, acc = loss_fn(
            params, features, src, dst, labels, model_config,
            impl=train_config.impl, num_valid=max(num_seeds, 1),
            edge_tiles=edge_tiles,
        )
        grads = optim.gradients(loss * num_seeds, params,
                                debug_nans=train_config.debug_nans)
        stats = torch.stack([loss.detach() * num_seeds, acc * num_seeds,
                             loss.new_tensor(float(num_seeds))])
        flat = torch.cat([g.reshape(-1) for g in grads] + [stats])
        dist.all_reduce(flat, group=mesh.world)
        total = flat[-1].clamp(min=1.0)
        parts = flat[:-3].split([g.numel() for g in grads])
        grads = [p.view_as(g) / total for p, g in zip(parts, grads)]
        optim.apply_updates(optim.param_leaves(params), grads, opt_state, t,
                            train_config)
        return flat[-3] / total, flat[-2] / total, int(flat[-1])

    return step


class DataParallelMinibatchTrainer(MinibatchTrainer):
    """Sampled-subgraph training data-parallel over a rank mesh:
    each rank trains on its own sampled subgraph per super-step, and the
    gradients combine seed-weighted (make_dp_minibatch_step). Reached from
    the CLI via --mesh N --batch-size B. Every rank of the process group
    constructs it; only rank 0 logs.

    Rank r of N takes batch g*N + r of the same epoch stream the
    single-device trainer walks (NeighborSampler.iter_groups); a trailing
    partial group is padded with zero-seed copies of its first batch
    (num_seeds=0, all labels -1) that add nothing to the metrics or the
    gradient. The seed (rank 0's when train_config.seed is None), hence
    the initial parameters and every epoch's seed permutation, is the same
    on every rank; parameters stay replicated, so evaluate() and
    evaluate_exact() run on each rank's copy."""

    def __init__(
        self,
        graph,
        model_config: ModelConfig,
        train_config: TrainConfig,
        num_devices: int,
        *,
        log_fn: Callable[[str], None] = print,
        metrics_sink: Any = None,
        splits: Any = None,
        device: str | torch.device = "cuda",
    ):
        from gatv2_tpu_torch.parallel.mesh import make_mesh
        from gatv2_tpu_torch.parallel.sharded import broadcast_seed

        model_config.check_full_graph_only("--mesh (multi-GPU training)")
        dev = resolve_device(device)
        self.mesh = make_mesh(num_devices, device=dev)
        if self.mesh is None:
            raise ValueError(
                f"rank {dist.get_rank()} is outside the {num_devices}-rank "
                f"mesh")
        self.ndev = num_devices
        rank0 = self.mesh.rank == 0
        if train_config.seed is None:
            train_config = dataclasses.replace(
                train_config, seed=broadcast_seed(int(time.time()),
                                                  self.mesh))
        super().__init__(graph, model_config, train_config,
                         log_fn=log_fn if rank0 else (lambda _: None),
                         metrics_sink=metrics_sink if rank0 else None,
                         splits=splits, device=dev)
        self._dp_step = make_dp_minibatch_step(
            model_config, train_config, self.mesh,
            device_gather=self._device_gather)

    @staticmethod
    def _pad_batch(b0: MiniBatch) -> MiniBatch:
        return dataclasses.replace(b0, labels=np.full_like(b0.labels, -1),
                                   num_seeds=0)

    def sync_step_count(self) -> None:
        steps_per_epoch = -(-self.sampler.batches_per_epoch() // self.ndev)
        self.step_count = self.epoch * steps_per_epoch

    def train_group(self, own: MiniBatch | None,
                    first: MiniBatch | None) -> tuple[float, float, int]:
        """One super-step, on this rank with its batch `own` of the group or,
        past the epoch's end, a zero-seed copy of the group's `first`
        (NeighborSampler.iter_groups yields the pair). Returns the group's
        seed-weighted (loss, accuracy) and its seed count."""
        b = own if own is not None else self._pad_batch(first)
        feats, src, dst, labels, tiles = self.batch_args(b)
        self.step_count += 1
        loss, acc, n_all = self._dp_step(
            self._params, self.opt_state, self.step_count, feats, src, dst,
            labels, b.num_seeds, tiles)
        return float(loss), float(acc), n_all

    def run(self, epochs: int | None = None) -> dict:
        epochs = epochs if epochs is not None else self.train_config.epochs
        last = {}
        for _ in range(epochs):
            self.epoch += 1
            t0 = time.perf_counter()
            loss_sum = correct_sum = 0.0
            seeds_total = 0
            groups = self.sampler.iter_groups(self.ndev, self.mesh.rank)
            for own, first in prefetch(groups, depth=2):
                loss, acc, n_all = self.train_group(own, first)
                loss_sum += loss * n_all
                correct_sum += acc * n_all
                seeds_total += n_all
            dt_ms = (time.perf_counter() - t0) * 1e3
            avg_loss = loss_sum / max(seeds_total, 1)
            avg_acc = correct_sum / max(seeds_total, 1)
            self.log(f"Epoch {self.epoch}")
            self.log(
                f"Avg Loss: {avg_loss:.6f}, Accuracy: {avg_acc * 100.0:.2f}%  "
                f"total time: {dt_ms:.2f} ms"
            )
            last = {"epoch": self.epoch, "loss": avg_loss,
                    "accuracy": avg_acc, "ms": dt_ms, "devices": self.ndev}
            if self.metrics_sink is not None:
                self.metrics_sink.write(last)
        return last
