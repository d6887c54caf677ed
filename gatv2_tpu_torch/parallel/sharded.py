"""Sharded full-graph training over a ('graph', 'head') rank mesh (port of
gatv2_tpu/parallel/sharded.py) on torch.distributed, one process per rank.

graph axis — edge partitioning (parallel/partition.py): each rank holds
  one shard's nodes and the edges whose destination it owns. Per layer it
  projects its own nodes, then exchanges the source-side projections: an
  all_gather of every node's, or (HaloPlan) a boundary all_to_all of only
  the rows its peers' edges read. Attention, softmax and aggregation stay
  local. Loss and accuracy are local sums and one all_reduce, over the
  real node count.

head axis — tensor parallelism over attention heads: a layer whose head
  count divides the axis keeps only this rank's heads of W_src, W_dst and
  a; a hidden layer all_gathers the heads' outputs over 'head', the last
  layer all_reduces its head sum. Other layers are replicated.

Gradients. JAX gets them from shard_map's transpose; here each rank
differentiates its own share of the loss — its shard's summed
cross-entropy over (real nodes x head ranks) — so the shares of all ranks
add up to the loss. Each collective's backward is its adjoint
(parallel/collectives.py), which makes the sum over a parameter's copies
of their gradients the loss's gradient: replicated leaves are
all-reduced over the whole mesh, head-sharded leaves over 'graph'.
Clipping measures each group's norm over every head shard.

Routes per layer (_sharded_layer), as in the JAX package:
  - 'torch' (the JAX 'xla'): gathers and segment ops on the dense
    all_gather's or the halo's gather space; with an OverlapSplit, two
    passes (local sources, halo sources) whose softmax stats merge;
  - 'sell' / 'pallas': the fused kernels (K1-K4 / K5-K8) on per-shard
    bipartite layouts, one pass;
  - 'sell' / 'pallas' with overlap tiles: the family's
    merged_attention_exchange (ops/fused.py) on the (local, halo) layout
    pair, K1 / K5 with normalize=False per pass.

Overlap (--overlap): the boundary all_to_all is started asynchronously
(collectives.all_to_all_start) and the local pass, which reads no
exchanged row, runs before its wait. On the fused routes the exchange
lives inside the op (ops/fused.py): forward, start -> local pass -> wait
-> halo pass; backward, halo pass -> start of the reverse exchange of the
halo rows' gradient -> local pass -> wait. On the 'torch' route the
forward computes the local edges' scores and their max between start and
wait; its backward is autograd's order, so the reverse exchange runs
synchronously when the engine reaches it. The other collectives are
synchronous calls. The results are those of an exchange that finishes
before either pass (the JAX package's numbers).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from gatv2_tpu_torch.config import ModelConfig, TrainConfig
from gatv2_tpu_torch.device import resolve_device
from gatv2_tpu_torch.models.gatv2 import GATv2, dense, init_params_for_variant
from gatv2_tpu_torch.ops.attention import edge_attention, family
from gatv2_tpu_torch.ops.fused import merged_attention_exchange
from gatv2_tpu_torch.ops.segment import (
    EXP_CLAMP,
    SOFTMAX_EPS,
    segment_max,
    segment_sum,
)
from gatv2_tpu_torch.parallel import collectives as cc
from gatv2_tpu_torch.parallel.mesh import Mesh, make_mesh
from gatv2_tpu_torch.parallel.partition import (
    PartitionedGraph,
    halo_exchange_plan,
    overlap_split_plan,
    partition_graph,
    prepare_overlap_sell_tiles,
    prepare_overlap_tiles,
    prepare_partitioned_sell_tiles,
    prepare_partitioned_tiles,
)
from gatv2_tpu_torch.train import optim


def _layer_head_sharded(num_heads: int, head_size: int) -> bool:
    return head_size > 1 and num_heads % head_size == 0


def param_specs(model_config: ModelConfig, mesh: Mesh) -> dict:
    """Per leaf, the mesh axis its leading (head) dim is split over:
    'head' where the layer's head count divides the head axis, None
    (replicated) otherwise; the JAX package's PartitionSpec tree."""
    layers = []
    for h in model_config.heads:
        ax = "head" if _layer_head_sharded(h, mesh.head_size) else None
        layers.append({"w_src": ax, "w_dst": ax, "a": ax})
    return {"layers": tuple(layers), "w_o": None}


def _sharded_leaf_mask(model_config: ModelConfig, mesh: Mesh) -> list[bool]:
    """param_leaves order (per layer a, w_dst, w_src; then w_o): True where
    the leaf is split over 'head'."""
    specs = param_specs(model_config, mesh)
    return [specs["layers"][l][k] == "head"
            for l in range(model_config.num_layers)
            for k in ("a", "w_dst", "w_src")] + [False]


def shard_params(full: GATv2, model_config: ModelConfig,
                 mesh: Mesh) -> GATv2:
    """This rank's parameters: the head slice of every head-sharded layer,
    the whole of the others (a copy, on full's device)."""
    local = copy.deepcopy(full)
    hs, hi = mesh.head_size, mesh.head_index
    with torch.no_grad():
        for l, (layer, h) in enumerate(zip(local.layers,
                                           model_config.heads)):
            if not _layer_head_sharded(h, hs):
                continue
            per = h // hs
            for name in ("w_src", "w_dst", "a"):
                p = getattr(layer, name)
                setattr(layer, name, nn.Parameter(
                    p[hi * per:(hi + 1) * per].clone()))
    return local


def _gather_leaf(t: torch.Tensor, sharded: bool, mesh: Mesh) -> torch.Tensor:
    return cc.all_gather_dim0(t.detach(), mesh.head) if sharded else \
        t.detach()


def gather_leaves(leaves: list[torch.Tensor], model_config: ModelConfig,
                  mesh: Mesh) -> list[torch.Tensor]:
    """The full model's leaves (param_leaves order: parameters, gradients
    or optimizer moments) from every rank's (a collective over 'head':
    every rank of the mesh calls it)."""
    mask = _sharded_leaf_mask(model_config, mesh)
    return [_gather_leaf(t, sh, mesh) for t, sh in zip(leaves, mask)]


def gather_params(local: GATv2, model_config: ModelConfig,
                  mesh: Mesh) -> GATv2:
    """The full model from every rank's shard (a collective over 'head':
    every rank of the mesh calls it); on local's device."""
    full = GATv2(model_config).to(local.w_o.device)
    with torch.no_grad():
        for dst, src in zip(optim.param_leaves(full), gather_leaves(
                optim.param_leaves(local), model_config, mesh)):
            dst.copy_(src)
    return full


def _halo_send(zs_loc, send_ids_me):
    """[S, M, ...]: the rows of zs_loc each peer's edges reference (the
    index_select's backward scatters their gradient back)."""
    send = zs_loc.index_select(0, send_ids_me.reshape(-1))
    return send.reshape(*send_ids_me.shape, *zs_loc.shape[1:])


def _halo_all_to_all(zs_loc, send_ids_me, group):
    """Boundary-only halo exchange: gather the rows each peer references,
    route them with one all_to_all (its backward the reverse one)."""
    send = _halo_send(zs_loc, send_ids_me)
    return cc.all_to_all(send, group).reshape(-1, *zs_loc.shape[1:])


def _overlap_attention_torch(zs_loc, zd_loc, a, lay, group, slope):
    """The overlap layer on the 'torch' route: local-source edges, then
    halo-source edges; the per-destination softmax stats merge exactly
    (the same max shift and eps as segment_softmax). The exchange is
    started first and waited on after the local edges' scores, gather and
    max; its backward (the reverse all_to_all) runs synchronously in
    autograd's order. -> h [n_loc, nh, hd]."""
    n_loc = zs_loc.shape[0]
    nh, hdim = a.shape
    zs3, zd3 = zs_loc.view(n_loc, nh, hdim), zd_loc.view(n_loc, nh, hdim)
    l_src, l_dst, h_src, h_dst = (t.long() for t in lay.overlap)

    def edge_scores(space, src_idx, dst_idx):
        zs_e = space[src_idx]
        s = nn.functional.leaky_relu(zs_e + zd3[dst_idx], slope)
        return torch.einsum("ehd,hd->eh", s, a), zs_e

    send = _halo_send(zs_loc, lay.send_ids)
    pending = cc.all_to_all_start(send, group)
    try:
        e1, zs1 = edge_scores(zs3, l_src, l_dst)
        m1 = segment_max(e1, l_dst, n_loc)
    finally:
        halo_rows = cc.all_to_all_wait(send, pending)
    e2, zs2 = edge_scores(halo_rows.view(-1, nh, hdim), h_src, h_dst)
    m_all = torch.maximum(m1, segment_max(e2, h_dst, n_loc))
    m_all = torch.where(torch.isfinite(m_all), m_all, 0.0)

    def pass_sums(e_k, zs_k, dst_k):
        w = torch.exp(torch.clamp(e_k - m_all[dst_k], min=EXP_CLAMP))
        return (segment_sum(w[:, :, None] * zs_k, dst_k, n_loc),
                segment_sum(w, dst_k, n_loc))

    u1, l1 = pass_sums(e1, zs1, l_dst)
    u2, l2 = pass_sums(e2, zs2, h_dst)
    return (u1 + u2) / (l1 + l2 + SOFTMAX_EPS)[:, :, None]


@dataclasses.dataclass
class ShardLayout:
    """One rank's edge data on its device, per route: real edges only for
    the 'torch' route (its segment ops take no padding id)."""

    src: torch.Tensor | None = None  # gather-space source id per real edge
    dst: torch.Tensor | None = None  # local dst per real edge
    send_ids: torch.Tensor | None = None  # [S, M] halo rows this rank sends
    overlap: tuple | None = None  # (l_src, l_dst, h_src, h_dst), real only
    edge_tiles: Any = None  # EdgeTiles / SellTiles of this shard
    overlap_tiles: tuple | None = None  # (local, halo) layouts


def shard_layout(pg: PartitionedGraph, shard: int, device, *,
                 halo_plan=None, overlap_split=None, edge_tiles=None,
                 overlap_tiles=None) -> ShardLayout:
    """Shard `shard`'s slice of the partition's edge arrays, halo plan,
    overlap split and layouts (per-shard lists), moved to `device`."""
    nps = pg.nodes_per_shard
    dst_l = pg.dst_local[pg.shard_edges(shard)]
    real = dst_l < nps
    src = (halo_plan.src_halo[shard] if halo_plan is not None
           else pg.src[pg.shard_edges(shard)])
    as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    lay = ShardLayout(src=as_t(src[real]), dst=as_t(dst_l[real]))
    if halo_plan is not None:
        lay.send_ids = as_t(halo_plan.send_ids[shard])
    if overlap_split is not None:
        ov = overlap_split
        lr = ov.local_dst[shard] < nps
        hr = ov.halo_dst[shard] < nps
        lay.overlap = (as_t(ov.local_src[shard][lr]),
                       as_t(ov.local_dst[shard][lr]),
                       as_t(ov.halo_src[shard][hr]),
                       as_t(ov.halo_dst[shard][hr]))
    if edge_tiles is not None:
        lay.edge_tiles = edge_tiles[shard].to(device)
    if overlap_tiles is not None:
        lay.overlap_tiles = tuple(t[shard].to(device) for t in overlap_tiles)
    return lay


def _sharded_layer(layer, x_loc: torch.Tensor, lay: ShardLayout, *,
                   mesh: Mesh, head_sharded: bool, num_heads_global: int,
                   is_last: bool, config: ModelConfig, impl: str
                   ) -> torch.Tensor:
    slope = config.negative_slope
    n_loc = x_loc.shape[0]
    nh, hdim = layer.a.shape  # this rank's heads
    zs_loc, zd_loc = layer.project(x_loc, config.precision)  # [n, nh*hd]
    a = layer.a
    combine = dict(is_last=is_last, slope=slope, variant=config.variant,
                   head_sharded=head_sharded, head_group=mesh.head,
                   num_heads_global=num_heads_global)

    if lay.overlap_tiles is not None and lay.send_ids is not None:
        # the overlap layer on the fused kernels: a LOCAL pass that does
        # not read the exchanged rows runs while they are in flight, then
        # a HALO pass that does; their per-destination softmax stats merge
        # in the op (the JAX package's passes)
        h = merged_attention_exchange(
            family(impl), zs_loc, _halo_send(zs_loc, lay.send_ids), zd_loc,
            a, n_loc, group=mesh.graph, negative_slope=slope,
            layouts=lay.overlap_tiles)
        return _combine_heads(h.view(n_loc, nh, hdim), n_loc, **combine)

    if lay.overlap is not None and lay.send_ids is not None:
        h = _overlap_attention_torch(zs_loc, zd_loc, a, lay, mesh.graph,
                                     slope)
        return _combine_heads(h, n_loc, **combine)

    if lay.send_ids is None:
        # dense exchange: every node's source projection
        zs_space = cc.all_gather(zs_loc, mesh.graph)
    else:
        # boundary exchange: own rows, then the rows peers sent
        zs_space = torch.cat(
            [zs_loc, _halo_all_to_all(zs_loc, lay.send_ids, mesh.graph)])

    h = edge_attention(zs_space, zd_loc, a, lay.src, lay.dst, n_loc,
                       negative_slope=slope, impl=impl,
                       edge_tiles=lay.edge_tiles, streams=config.streams)
    return _combine_heads(h.view(n_loc, nh, hdim), n_loc, **combine)


def _combine_heads(h, n_loc, *, is_last, slope, variant, head_sharded,
                   head_group, num_heads_global):
    """Hidden layers: LeakyReLU, heads concatenated (over 'head' when
    sharded); the last layer: the head mean with the variant's activation
    order, the head sum all-reduced over 'head' when sharded."""
    act = lambda x: nn.functional.leaky_relu(x, slope)
    if not is_last:
        h = act(h)
        if head_sharded:
            h = cc.all_gather(h, head_group, dim=1)
        return h.reshape(n_loc, -1)
    if variant == "edge":
        hsum = act(h).sum(dim=1)
        if head_sharded:
            hsum = cc.all_reduce(hsum, head_group)
        return hsum / num_heads_global
    hsum = h.sum(dim=1)
    if head_sharded:
        hsum = cc.all_reduce(hsum, head_group)
    return act(hsum / num_heads_global)


class _MeshLoss(torch.autograd.Function):
    """The mesh's loss as the value, this rank's share as what it
    differentiates to."""

    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_sharded_loss_fn(model_config: ModelConfig, mesh: Mesh,
                         num_real_nodes: int, *, impl: str = "torch",
                         layout: ShardLayout) -> Callable:
    """loss_fn(params, features, labels) -> (loss, acc) on this rank's
    shard (features [nps, F] and labels [nps], -1 on padding). `loss`
    holds the mesh's loss and differentiates to this rank's share of it
    (module docstring); `acc` is the mesh's accuracy. fn.logits_fn(params,
    features) gives the shard's logits. config.remat recomputes each
    layer in the backward pass (collectives included)."""
    if impl in ("sell", "pallas") and layout.edge_tiles is None and (
            layout.overlap_tiles is None):
        raise ValueError(
            f"impl={impl!r} needs edge_tiles (per shard: "
            "prepare_partitioned_tiles / prepare_partitioned_sell_tiles) "
            "or overlap_tiles")
    if layout.overlap_tiles is not None and layout.send_ids is None:
        raise ValueError("overlap_tiles needs halo_plan (boundary exchange)")
    if layout.overlap is not None and (layout.send_ids is None
                                       or impl != "torch"):
        raise ValueError(
            "overlap_split needs halo_plan and the torch impl (the fused "
            "kernels do their own softmax)")
    heads = model_config.heads

    def logits_fn(params: GATv2, features: torch.Tensor) -> torch.Tensor:
        x = features
        remat = model_config.remat and torch.is_grad_enabled()
        for l, layer in enumerate(params.layers):
            kw = dict(
                mesh=mesh, head_sharded=_layer_head_sharded(
                    heads[l], mesh.head_size),
                num_heads_global=heads[l],
                is_last=l == model_config.num_layers - 1,
                config=model_config, impl=impl)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    _sharded_layer, layer, x, layout, use_reentrant=False,
                    **kw)
            else:
                x = _sharded_layer(layer, x, layout, **kw)
        return dense(x, params.w_o, model_config.precision)

    def loss_fn(params: GATv2, features: torch.Tensor,
                labels: torch.Tensor):
        logits = logits_fn(params, features)
        logp = torch.log_softmax(logits, dim=-1)
        valid = labels >= 0
        safe = torch.where(valid, labels, 0).long()
        nll = torch.where(valid, -logp.gather(1, safe[:, None])[:, 0], 0.0)
        nll_sum = nll.sum()
        correct = ((logits.argmax(dim=-1) == safe) & valid).sum()
        # this rank's share: its shard's sum over (real nodes x head ranks)
        share = nll_sum / (num_real_nodes * mesh.head_size)
        tot = cc.all_reduce_sum(
            torch.stack([nll_sum.detach(), correct.to(nll_sum.dtype)]),
            mesh.graph) / num_real_nodes
        return _MeshLoss.apply(share, tot[0]), tot[1]

    loss_fn.logits_fn = logits_fn
    return loss_fn


def sharded_gradients(loss: torch.Tensor, params: GATv2,
                      model_config: ModelConfig, mesh: Mesh, *,
                      debug_nans: bool = False) -> list[torch.Tensor]:
    """d loss / d param_leaves(params) of the whole mesh: this rank's
    share's gradients summed over each leaf's copies — head-sharded leaves
    over 'graph', replicated ones over the whole mesh (one flat all_reduce
    per group)."""
    grads = optim.gradients(loss, params, debug_nans=debug_nans)
    mask = _sharded_leaf_mask(model_config, mesh)
    for sharded, group in ((True, mesh.graph), (False, mesh.world)):
        idx = [i for i, m in enumerate(mask) if m == sharded]
        if not idx or cc.group_size(group) == 1:
            continue
        flat = cc.all_reduce_sum(
            torch.cat([grads[i].reshape(-1) for i in idx]), group)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            grads[i] = part.view_as(grads[i])
    return grads


def clip_sharded(grads: list[torch.Tensor], clip_norm: float,
                 model_config: ModelConfig, mesh: Mesh
                 ) -> list[torch.Tensor]:
    """optim.clip_by_group_norm with each group's norm over the whole
    model: the squares of head-sharded leaves summed over 'head'."""
    if mesh.head_size == 1:
        return optim.clip_by_group_norm(grads, clip_norm)
    mask = _sharded_leaf_mask(model_config, mesh)
    num_layers = model_config.num_layers
    groups = {
        "w": [i for l in range(num_layers) for i in (3 * l + 2, 3 * l + 1)],
        "a": [3 * l for l in range(num_layers)],
        "o": [len(grads) - 1],
    }
    scale = {}
    for name, idx in groups.items():
        sq_sh = sum((torch.sum(torch.square(grads[i])) for i in idx
                     if mask[i]), torch.zeros((), device=grads[0].device))
        sq_rep = sum((torch.sum(torch.square(grads[i])) for i in idx
                      if not mask[i]), torch.zeros((), device=grads[0].device))
        norm = torch.sqrt(cc.all_reduce_sum(sq_sh, mesh.head) + sq_rep
                          ) + optim.CLIP_EPS
        scale[name] = torch.where(norm > clip_norm, clip_norm / norm,
                                  torch.ones_like(norm))
    per_leaf = [scale["a"] if i % 3 == 0 else scale["w"]
                for i in range(3 * num_layers)] + [scale["o"]]
    return [g * s for g, s in zip(grads, per_leaf)]


def make_sharded_train_step(model_config: ModelConfig,
                            train_config: TrainConfig, mesh: Mesh,
                            num_real_nodes: int, *,
                            layout: ShardLayout) -> Callable:
    """step(params, opt_state, t, features, labels) -> (loss, acc): one
    optimizer step of the mesh, written into this rank's params and
    opt_state in place. t: Adam's step, an int or a 0-d fp32 tensor on the
    device (optim.step_count); loss and acc stay on the device."""
    loss_fn = make_sharded_loss_fn(model_config, mesh, num_real_nodes,
                                   impl=train_config.impl, layout=layout)
    no_clip = dataclasses.replace(train_config, clip=False)

    def step(params, opt_state, t, features, labels):
        loss, acc = loss_fn(params, features, labels)
        grads = sharded_gradients(loss, params, model_config, mesh,
                                  debug_nans=train_config.debug_nans)
        if train_config.clip:
            grads = clip_sharded(grads, train_config.clip_norm,
                                 model_config, mesh)
        optim.apply_updates(optim.param_leaves(params), grads, opt_state, t,
                            no_clip)
        return loss.detach(), acc

    step.loss_fn = loss_fn
    return step


def make_sharded_multi_epoch_runner(model_config: ModelConfig,
                                    train_config: TrainConfig, mesh: Mesh,
                                    num_real_nodes: int, num_epochs: int, *,
                                    layout: ShardLayout) -> Callable:
    """K = num_epochs steps of make_sharded_train_step's step with no
    read-back between them (the collectives of a gloo mesh still wait on
    the host; the runner adds no wait of its own).

    Returns run(params, opt_state, t0, features, labels) -> (params,
    opt_state, losses[K], accs[K]): this rank's params and opt_state
    updated in place, Adam's t running t0+1 ... t0+K, the mesh's losses
    and accuracies as fp32 tensors on the device."""
    if num_epochs < 1:
        raise ValueError(f"num_epochs must be >= 1, got {num_epochs}")
    step = make_sharded_train_step(model_config, train_config, mesh,
                                   num_real_nodes, layout=layout)

    def run(params, opt_state, t0, features, labels):
        out = [step(params, opt_state,
                    optim.step_count(t0 + k, features.device), features,
                    labels) for k in range(1, num_epochs + 1)]
        losses, accs = (torch.stack(x) for x in zip(*out))
        return params, opt_state, losses, accs

    return run


def make_sharded_eval_step(model_config: ModelConfig, mesh: Mesh,
                           num_real_nodes: int, *, impl: str = "torch",
                           layout: ShardLayout) -> Callable:
    """eval(params, features, labels) -> (loss, acc) without gradients,
    through the same configured forward as training."""
    loss_fn = make_sharded_loss_fn(model_config, mesh, num_real_nodes,
                                   impl=impl, layout=layout)

    @torch.no_grad()
    def eval_step(params, features, labels):
        loss, acc = loss_fn(params, features, labels)
        return loss.detach(), acc

    return eval_step


def make_sharded_split_eval_step(model_config: ModelConfig, mesh: Mesh, *,
                                 impl: str = "torch",
                                 layout: ShardLayout) -> Callable:
    """eval(params, features, labels, *masks) -> per-mask accuracies of the
    mesh from one sharded forward; labels and masks are this shard's
    (padding: label -1, mask False)."""
    logits_fn = make_sharded_loss_fn(model_config, mesh, 1, impl=impl,
                                     layout=layout).logits_fn

    @torch.no_grad()
    def eval_step(params, features, labels, *masks):
        hit = (logits_fn(params, features).argmax(dim=-1) == labels).float()
        sums = torch.stack([torch.stack([torch.where(m, hit, 0.0).sum(),
                                         m.sum().float()]) for m in masks])
        sums = cc.all_reduce_sum(sums, mesh.graph)
        return tuple(sums[:, 0] / sums[:, 1].clamp(min=1))

    return eval_step


def broadcast_seed(seed: int, mesh: Mesh) -> int:
    """Rank 0's seed on every rank (each rank's clock differs)."""
    t = torch.tensor([seed], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.world)
    return int(t.item())


class ShardedTrainer:
    """Multi-GPU full-graph trainer (edge partitioning over the 'graph'
    axis, optional head parallelism over 'head'), with the reference's
    console contract. Reached from the CLI via --mesh N. Every rank of the
    process group constructs it (the groups are made collectively); only
    rank 0 logs and writes metrics.

    `params` is this rank's model (its head shard of each head-sharded
    layer); assigning a FULL model (e.g. loaded weights) shards it onto
    the rank and keeps the optimizer state. full_params() gathers the
    full model (a collective)."""

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
        overlap: bool = False,
        head_shards: int = 1,
        halo: bool = True,
        device: str | torch.device = "cuda",
    ):
        model_config.check_full_graph_only("--mesh (multi-GPU training)")
        self.model_config = model_config
        self.train_config = train_config
        self.device = dev = resolve_device(device)
        self.mesh = mesh = make_mesh(num_devices, head_shards=head_shards,
                                     device=dev)
        if mesh is None:
            raise ValueError(
                f"rank {dist.get_rank()} is outside the {num_devices}-rank "
                f"mesh")
        self.rank = mesh.rank
        self.log = log_fn if self.rank == 0 else (lambda _: None)
        self.metrics_sink = metrics_sink if self.rank == 0 else None
        self.splits = splits
        num_shards = mesh.graph_size
        self.pg = pg = partition_graph(graph, num_shards)
        log = self.log
        log(f"Partition: {pg.balance_report()}")
        # boundary-only exchange when it moves less data than an all_gather
        # (halo=False: always the all_gather)
        plan = halo_exchange_plan(pg) if halo and num_shards > 1 else None
        if plan is not None and plan.halo_size >= pg.padded_num_nodes:
            plan = None  # no locality in this partition; dense is cheaper
        self.halo_plan = plan
        log("Halo: " + (
            f"boundary exchange ({plan.halo_size} rows/shard vs "
            f"{pg.padded_num_nodes} all_gather)" if plan is not None
            else "all_gather"))
        impl = train_config.impl
        tiles = ov = ov_tiles = None
        fused = impl in ("pallas", "sell")
        if fused and not (overlap and plan is not None):
            tiles = (prepare_partitioned_tiles(pg, halo_plan=plan)
                     if impl == "pallas"
                     else prepare_partitioned_sell_tiles(pg, halo_plan=plan))
        if overlap:
            if plan is None:
                log("Overlap: unavailable (needs a boundary halo plan); "
                    "using the single-pass layer")
            else:
                split = overlap_split_plan(pg, plan)
                log("Overlap: two-pass local/halo attention "
                    f"({split.local_src.shape[1]} local + "
                    f"{split.halo_src.shape[1]} halo edges/shard)")
                if impl == "pallas":
                    ov_tiles = prepare_overlap_tiles(pg, plan, split)
                elif impl == "sell":
                    try:
                        ov_tiles = prepare_overlap_sell_tiles(pg, plan, split)
                    except ValueError as e:
                        # hub-heavy partitions: the merged-softmax layer
                        # needs unsplit layouts — the single-pass SELL
                        # layer splits hub rows
                        log(f"Overlap: unavailable ({e}); single-pass")
                        tiles = prepare_partitioned_sell_tiles(
                            pg, halo_plan=plan)
                else:
                    ov = split
        self.overlap_split = ov
        self.overlap_tiles = ov_tiles
        shard = mesh.graph_index
        self.layout = shard_layout(pg, shard, dev, halo_plan=plan,
                                   overlap_split=ov, edge_tiles=tiles,
                                   overlap_tiles=ov_tiles)
        seed = train_config.seed
        if seed is None:
            seed = broadcast_seed(int(time.time()), mesh)
        self._params = shard_params(
            init_params_for_variant(model_config,
                                    torch.Generator().manual_seed(seed)),
            model_config, mesh).to(dev)
        self.opt_state = optim.init_opt_state(self._params,
                                              train_config.optimizer)
        self.epoch = 0
        rows = pg.shard_rows(shard)
        self.features = torch.as_tensor(pg.features[rows], device=dev)
        labels = pg.labels
        num_loss_nodes = pg.num_real_nodes
        self._split_eval = None
        if splits is not None:
            # loss masked to train nodes; denominator = train-node count
            labels = pg.scatter_nodes(splits.masked_labels(graph.labels,
                                                           "train"), -1)
            num_loss_nodes = int(splits.train.sum())
            as_t = lambda x: torch.as_tensor(x[rows], device=dev)
            self._eval_labels = as_t(pg.scatter_nodes(graph.labels, -1))
            self._masks = tuple(as_t(pg.scatter_nodes(m, False)) for m in (
                splits.train, splits.val, splits.test))
            self._split_eval = make_sharded_split_eval_step(
                model_config, mesh, impl=impl, layout=self.layout)
        self.labels = torch.as_tensor(labels[rows], device=dev)
        self._step = make_sharded_train_step(
            model_config, train_config, mesh, num_loss_nodes,
            layout=self.layout)

    @property
    def params(self) -> GATv2:
        return self._params

    @params.setter
    def params(self, full: GATv2) -> None:
        self._params = shard_params(full.to(self.device), self.model_config,
                                    self.mesh)

    def full_params(self) -> GATv2:
        """The full model (a collective over 'head')."""
        return gather_params(self._params, self.model_config, self.mesh)

    def full_opt_state(self) -> dict:
        """The optimizer state of the full model (a collective)."""
        return {k: gather_leaves(v, self.model_config, self.mesh)
                for k, v in self.opt_state.items()}

    def load_full_state(self, params: GATv2, opt_state: dict) -> None:
        """Shard a full model and its optimizer state onto this rank."""
        self.params = params
        mask = _sharded_leaf_mask(self.model_config, self.mesh)
        hs, hi = self.mesh.head_size, self.mesh.head_index

        def local(t, sharded):
            t = t.to(self.device)
            if not sharded:
                return t.clone()
            per = t.shape[0] // hs
            return t[hi * per:(hi + 1) * per].clone()

        self.opt_state = {k: [local(t, sh) for t, sh in zip(v, mask)]
                          for k, v in opt_state.items()}

    def evaluate(self) -> dict[str, float]:
        """Accuracy on the train/val/test splits from one sharded forward."""
        if self._split_eval is None:
            raise ValueError("ShardedTrainer built without splits")
        accs = self._split_eval(self._params, self.features,
                                self._eval_labels, *self._masks)
        return {k: float(v) for k, v in zip(("train", "val", "test"), accs)}

    def run(self, epochs: int | None = None) -> dict:
        epochs = epochs if epochs is not None else self.train_config.epochs
        last = {}
        for _ in range(epochs):
            self.epoch += 1
            t0 = time.perf_counter()
            loss, acc = self._step(
                self._params, self.opt_state,
                optim.step_count(self.epoch, self.device), self.features,
                self.labels)
            loss, acc = float(loss), float(acc)
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.log(f"Epoch {self.epoch}")
            self.log(
                f"Avg Loss: {loss:.6f}, Accuracy: {acc * 100.0:.2f}%  "
                f"total time: {dt_ms:.2f} ms")
            last = {"epoch": self.epoch, "loss": loss, "accuracy": acc,
                    "ms": dt_ms}
            if self._split_eval is not None:
                accs = self.evaluate()
                self.log(
                    f"Train/Val/Test Accuracy: {accs['train'] * 100:.2f}% / "
                    f"{accs['val'] * 100:.2f}% / {accs['test'] * 100:.2f}%")
                last.update({f"{k}_accuracy": v for k, v in accs.items()})
            if self.metrics_sink is not None:
                self.metrics_sink.write(last)
        return last
