"""The port's multi-GPU training (parallel/sharded.py, train/minibatch.py
DataParallelMinibatchTrainer, the --mesh CLI) against the JAX package, on
gloo ranks on the CPU, where every kernel wrapper runs its plain twin.

One pool of 4 ranks (parallel/multihost.RankPool) serves every check of
this file, so the ranks start and meet once; a check on a smaller mesh
leaves the other ranks idle. The JAX references run in this process on
the virtual CPU devices of tests/conftest.py (Pallas in interpret mode).
The rank-side functions live at module level and import no JAX: the ranks
import this module to run them.

Tolerances (tests/test_sharding.py's, for the same checks): sharded loss
1e-5 relative and accuracy 1e-6 against a single device, gradients rtol
5e-4 / atol 1e-6 (2e-6 on the fused routes); halo against all_gather
1e-6 and 1e-5 / 1e-7; each overlap route against its single pass 1e-5
and 1e-4 / 1e-6; data-parallel minibatch losses 1e-5 relative; the
overlap layer's asynchronous exchange against a synchronous one 1e-6
relative. Both reference variants ('edge', 'node') run on the mesh.
"""

import contextlib
import dataclasses
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from gatv2_tpu_torch import config as tconfig
from gatv2_tpu_torch.data import synthetic as tsyn
from gatv2_tpu_torch.data.splits import random_splits
from gatv2_tpu_torch.models.params_io import params_from_numpy
from gatv2_tpu_torch.ops import fused
from gatv2_tpu_torch.ops import segment as tseg
from gatv2_tpu_torch.parallel import collectives as cc
from gatv2_tpu_torch.parallel import partition as tpart
from gatv2_tpu_torch.parallel import sharded as tsh
from gatv2_tpu_torch.parallel.mesh import make_mesh
from gatv2_tpu_torch.parallel.multihost import RankPool
from gatv2_tpu_torch.train import checkpoint as tckpt
from gatv2_tpu_torch.train import optim as toptim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
GRAPH = dict(num_nodes=200, num_edges=800, feature_dim=32, num_classes=4,
             seed=0, planted_signal=2.0)  # conftest's learnable_graph
ARCH = dict(num_layers=2, heads=(2, 2), out_dims=(8, 6))


def _graph():
    return tsyn.random_graph(**GRAPH)


def _config(g, variant="edge", **kw):
    return tconfig.ModelConfig(**ARCH, num_classes=g.num_classes,
                               in_dim=g.feature_dim, variant=variant, **kw)


# ---------------------------------------------------------------------------
# rank-side functions (run on every rank of the pool)
# ---------------------------------------------------------------------------


def _layout(pg, mesh, route, impl):
    """This rank's ShardLayout for a route: 'dense' (all_gather), 'halo',
    or 'overlap' (the two-pass layer of the impl)."""
    plan = tpart.halo_exchange_plan(pg) if route != "dense" else None
    kw = dict(halo_plan=plan)
    if route == "overlap":
        split = tpart.overlap_split_plan(pg, plan)
        if impl == "torch":
            kw["overlap_split"] = split
        elif impl == "pallas":
            kw["overlap_tiles"] = tpart.prepare_overlap_tiles(pg, plan, split)
        else:
            kw["overlap_tiles"] = tpart.prepare_overlap_sell_tiles(
                pg, plan, split)
    elif impl == "pallas":
        kw["edge_tiles"] = tpart.prepare_partitioned_tiles(pg, halo_plan=plan)
    elif impl == "sell":
        kw["edge_tiles"] = tpart.prepare_partitioned_sell_tiles(
            pg, halo_plan=plan)
    return tsh.shard_layout(pg, mesh.graph_index, "cpu", **kw)


def _mesh_loss_and_grads(config, mesh, pg, layout, params_np, impl):
    """(loss, accuracy, full gradients, this rank's params) of one sharded
    step from the given full parameters."""
    params = tsh.shard_params(params_from_numpy(params_np), config, mesh)
    loss_fn = tsh.make_sharded_loss_fn(config, mesh, pg.num_real_nodes,
                                       impl=impl, layout=layout)
    rows = pg.shard_rows(mesh.graph_index)
    loss, acc = loss_fn(params, torch.as_tensor(pg.features[rows]),
                        torch.as_tensor(pg.labels[rows]))
    grads = tsh.sharded_gradients(loss, params, config, mesh)
    mask = tsh._sharded_leaf_mask(config, mesh)
    full = [tsh._gather_leaf(gr, m, mesh).numpy()
            for gr, m in zip(grads, mask)]
    return float(loss.detach()), float(acc), full, params


def rank_loss_and_grads(info, params_np, ranks, head_shards, impl, route,
                        remat=False, variant="edge"):
    """The mesh's loss, accuracy and full gradients (head shards gathered)
    from the given full parameters; the eval step's loss must be the
    training loss's value."""
    g = _graph()
    config = _config(g, variant=variant, remat=remat)
    mesh = make_mesh(ranks, head_shards=head_shards, device="cpu")
    if mesh is None:
        return None
    pg = tpart.partition_graph(g, mesh.graph_size)
    layout = _layout(pg, mesh, route, impl)
    loss, acc, full, params = _mesh_loss_and_grads(config, mesh, pg, layout,
                                                   params_np, impl)
    rows = pg.shard_rows(mesh.graph_index)
    eval_loss, eval_acc = tsh.make_sharded_eval_step(
        config, mesh, pg.num_real_nodes, impl=impl, layout=layout)(
        params, torch.as_tensor(pg.features[rows]),
        torch.as_tensor(pg.labels[rows]))
    assert (float(eval_loss), float(eval_acc)) == (loss, acc)
    return loss, acc, full


def _sync_merge(family, zs_loc, send, zd, a, n, *, group, negative_slope,
                layouts):
    """The fused overlap op with the exchange finished before either pass:
    a synchronous all_to_all, then the plain merge of both parts."""
    halo = cc.all_to_all(send, group).reshape(-1, *zs_loc.shape[1:])
    return fused.merged_attention(family, (zs_loc, halo), zd, a, n,
                                  negative_slope=negative_slope,
                                  layouts=layouts)


def _sync_overlap_torch(zs_loc, zd_loc, a, lay, group, slope):
    """The 'torch' overlap layer with the exchange finished before either
    pass (the JAX package's arithmetic, term for term)."""
    n_loc = zs_loc.shape[0]
    nh, hdim = a.shape
    halo = tsh._halo_all_to_all(zs_loc, lay.send_ids, group)
    zs3, zd3 = zs_loc.view(n_loc, nh, hdim), zd_loc.view(n_loc, nh, hdim)
    l_src, l_dst, h_src, h_dst = (t.long() for t in lay.overlap)

    def edge_scores(space, src_idx, dst_idx):
        zs_e = space[src_idx]
        s = torch.nn.functional.leaky_relu(zs_e + zd3[dst_idx], slope)
        return torch.einsum("ehd,hd->eh", s, a), zs_e

    e1, zs1 = edge_scores(zs3, l_src, l_dst)
    e2, zs2 = edge_scores(halo.view(-1, nh, hdim), h_src, h_dst)
    m_all = torch.maximum(tseg.segment_max(e1, l_dst, n_loc),
                          tseg.segment_max(e2, h_dst, n_loc))
    m_all = torch.where(torch.isfinite(m_all), m_all, 0.0)

    def pass_sums(e_k, zs_k, dst_k):
        w = torch.exp(torch.clamp(e_k - m_all[dst_k], min=tseg.EXP_CLAMP))
        return (tseg.segment_sum(w[:, :, None] * zs_k, dst_k, n_loc),
                tseg.segment_sum(w, dst_k, n_loc))

    u1, l1 = pass_sums(e1, zs1, l_dst)
    u2, l2 = pass_sums(e2, zs2, h_dst)
    return (u1 + u2) / (l1 + l2 + tseg.SOFTMAX_EPS)[:, :, None]


@contextlib.contextmanager
def _patched(*triples):
    """(module, name, value): each attribute set for the with block."""
    with contextlib.ExitStack() as stack:
        for mod, name, value in triples:
            stack.enter_context(mock.patch.object(mod, name, value))
        yield


def rank_overlap_order(info, params_np, impl):
    """One step of the overlap layer of `impl` on a 4-rank 'graph' mesh,
    with the exchange's start and wait and the passes recorded in host
    order: the fused routes' forward_raw / backward per pass (local or
    halo, told apart by a leaf of the pass's layout), the 'torch' route's
    segment_max over the local or the halo edges. Then the same step with
    the exchange finished before either pass (_sync_merge,
    _sync_overlap_torch). Returns (the record, the overlap step's loss,
    accuracy and gradients, the synchronous step's)."""
    g = _graph()
    config = _config(g)
    mesh = make_mesh(4, device="cpu")
    pg = tpart.partition_graph(g, mesh.graph_size)
    layout = _layout(pg, mesh, "overlap", impl)
    log = []

    class Pending:
        def __init__(self, pending):
            self._pending, self.group = pending, pending.group

        def wait(self):
            out = self._pending.wait()
            log.append("wait")
            return out

    start = cc.all_to_all_start

    def logged_start(x, group):
        log.append("start")
        return Pending(start(x, group))

    patches = [(cc, "all_to_all_start", logged_start)]
    if impl == "torch":
        n_local = layout.overlap[0].shape[0]
        seg_max = tsh.segment_max

        def logged_max(e, ids, n):
            log.append("max " + ("local" if e.shape[0] == n_local
                                 else "halo"))
            return seg_max(e, ids, n)

        patches.append((tsh, "segment_max", logged_max))
        sync = [(tsh, "_overlap_attention_torch", _sync_overlap_torch)]
    else:
        fwd, bwd = fused.forward_raw, fused.backward
        leaf = (lambda t: t.ell_perm) if impl == "sell" else (lambda t: t.src)
        local_leaf = leaf(layout.overlap_tiles[0])
        which = lambda lay: "local" if leaf(lay) is local_leaf else "halo"

        def logged_fwd(family, zs2, zd2, a, lay, slope):
            out = fwd(family, zs2, zd2, a, lay, slope)
            log.append("fwd " + which(lay))
            return out

        def logged_bwd(*args):
            out = bwd(*args)
            log.append("bwd " + which(args[7]))
            return out

        patches += [(fused, "forward_raw", logged_fwd),
                    (fused, "backward", logged_bwd)]
        sync = [(tsh, "merged_attention_exchange", _sync_merge)]
    with _patched(*patches):
        got = _mesh_loss_and_grads(config, mesh, pg, layout, params_np,
                                   impl)[:3]
    with _patched(*sync):
        want = _mesh_loss_and_grads(config, mesh, pg, layout, params_np,
                                    impl)[:3]
    return log, got, want


def rank_trainer(info, ranks, head_shards, impl, epochs, overlap, graph_kw,
                 params_np, splits_seed):
    """ShardedTrainer's log lines and per-epoch losses."""
    if info.rank >= ranks:
        # outside the mesh: take part in creating its groups, then idle
        make_mesh(ranks, head_shards=head_shards, device="cpu")
        return None
    g = (tsyn.powerlaw_graph(**graph_kw) if graph_kw else _graph())
    config = _config(g)
    tc = tconfig.TrainConfig(optimizer="adam", lr=0.02, clip=True, seed=0,
                             epochs=0, impl=impl)
    splits = (random_splits(g.num_nodes, (0.6, 0.2, 0.2), seed=splits_seed)
              if splits_seed is not None else None)
    logs, losses = [], []
    tr = tsh.ShardedTrainer(g, config, tc, ranks, log_fn=logs.append,
                            splits=splits, overlap=overlap,
                            head_shards=head_shards, device="cpu")
    if params_np is not None:
        tr.params = params_from_numpy(params_np)
    for _ in range(epochs):
        losses.append(tr.run(1)["loss"])
    accs = tr.evaluate() if splits is not None else None
    return logs, losses, accs


def rank_runner(info, ranks, impl, overlap, epochs, params_np):
    """The sharded multi-epoch runner against as many ShardedTrainer steps
    from the same weights: (runner losses, runner accuracies, the steps'
    losses, their accuracies, whether parameters and Adam moments end
    bit-equal)."""
    if info.rank >= ranks:
        make_mesh(ranks, device="cpu")  # take part in creating its groups
        return None
    g = _graph()
    config = _config(g)
    tc = tconfig.TrainConfig(optimizer="adam", lr=0.02, clip=True, seed=0,
                             epochs=0, impl=impl)
    tr = tsh.ShardedTrainer(g, config, tc, ranks, overlap=overlap,
                            log_fn=lambda _: None, device="cpu")
    tr.params = params_from_numpy(params_np)
    params = tsh.shard_params(params_from_numpy(params_np), config, tr.mesh)
    opt = toptim.init_opt_state(params, "adam")
    run = tsh.make_sharded_multi_epoch_runner(
        config, tc, tr.mesh, tr.pg.num_real_nodes, epochs, layout=tr.layout)
    out = run(params, opt, 0, tr.features, tr.labels)
    assert out[0] is params and out[1] is opt
    steps = [tr.run(1) for _ in range(epochs)]
    same = all(torch.equal(a, b) for a, b in zip(
        toptim.param_leaves(params) + tckpt.opt_leaves(opt),
        toptim.param_leaves(tr.params) + tckpt.opt_leaves(tr.opt_state)))
    return (out[2].tolist(), out[3].tolist(), [s["loss"] for s in steps],
            [s["accuracy"] for s in steps], same)


def rank_resume(info, ckpt_dir):
    """Train a 2 x 2 (head-sharded) ShardedTrainer 2 epochs and save it;
    restore into a fresh one (re-sharded), compare, train one more; and
    the rank-0 checkpoint restores into a single-device Trainer."""
    from gatv2_tpu_torch.train.loop import Trainer

    g = _graph()
    config = _config(g)
    tc = tconfig.TrainConfig(optimizer="adam", lr=0.02, seed=0, epochs=0)
    t1 = tsh.ShardedTrainer(g, config, tc, 4, head_shards=2, device="cpu",
                            log_fn=lambda _: None)
    t1.run(2)
    tckpt.save_trainer(ckpt_dir, t1, meta=tckpt.run_meta(config, tc))
    t2 = tsh.ShardedTrainer(g, config, tc, 4, head_shards=2, device="cpu",
                            log_fn=lambda _: None)
    assert tckpt.restore_into(ckpt_dir, t2,
                              expect_meta=tckpt.run_meta(config, tc))
    assert t2.epoch == 2
    same = all(torch.equal(a, b) for a, b in zip(
        toptim.param_leaves(t1.params), toptim.param_leaves(t2.params)))
    same_opt = all(torch.equal(a, b) for a, b in zip(
        tckpt.opt_leaves(t1.opt_state), tckpt.opt_leaves(t2.opt_state)))
    heads = [tuple(l.w_src.shape) for l in t2.params.layers]
    l1, l2 = t1.run(1)["loss"], t2.run(1)["loss"]
    single = Trainer(g, config, tc, device="cpu", log_fn=lambda _: None)
    assert tckpt.restore_into(ckpt_dir, single)
    full = [p.detach().numpy() for p in toptim.param_leaves(single.params)]
    return same, same_opt, heads, (l1, l2), full, t2.epoch


def rank_dp(info, graph_kw, impl, engine, params_np, epochs):
    """DataParallelMinibatchTrainer's per-epoch losses on 2 ranks."""
    from gatv2_tpu_torch.data import io as tio
    from gatv2_tpu_torch.train.minibatch import DataParallelMinibatchTrainer

    if make_mesh(2, device="cpu") is None:
        return None
    g = tio.load_dataset("karate", DATA)
    config = tconfig.ModelConfig(num_layers=2, heads=(2, 1), out_dims=(8, 4),
                                 num_classes=g.num_classes,
                                 in_dim=g.feature_dim)
    tc = tconfig.TrainConfig(epochs=epochs, optimizer="adam", lr=0.01,
                             clip=True, seed=0, batch_size=8, fanouts=(3, 3),
                             sampler_engine=engine, impl=impl)
    tr = DataParallelMinibatchTrainer(g, config, tc, 2, device="cpu",
                                      log_fn=lambda _: None)
    tr.params = params_from_numpy(params_np)
    tr.opt_state = toptim.init_opt_state(tr.params, "adam")
    losses = [tr.run(1)["loss"] for _ in range(epochs)]
    tr.sync_step_count()
    return losses, tr.step_count


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu", threads=1, timeout_s=120) as p:
        yield p


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------


def _jax_setup(key, variant="edge"):
    """The JAX graph, config and parameters (the 'node' variant's from
    init_params_for_variant, its draw order)."""
    import jax

    from gatv2_tpu.config import ModelConfig
    from gatv2_tpu.data import synthetic as jsyn
    from gatv2_tpu.models.gatv2 import init_params, init_params_for_variant

    g = jsyn.random_graph(**GRAPH)
    config = ModelConfig(**ARCH, num_classes=g.num_classes,
                         in_dim=g.feature_dim, variant=variant)
    init = init_params if variant == "edge" else init_params_for_variant
    params = init(config, jax.random.PRNGKey(key))
    return g, config, params, jax.tree.map(np.asarray, params)


def _jax_single_device(g, config, params):
    import jax
    import jax.numpy as jnp

    from gatv2_tpu.models.gatv2 import loss_fn

    pe = g.padded_edges(128)
    args = (jnp.asarray(g.features), jnp.asarray(pe.src),
            jnp.asarray(pe.dst), jnp.asarray(g.labels), config)
    loss, acc = loss_fn(params, *args)
    grads = jax.grad(lambda p: loss_fn(p, *args)[0])(params)
    return float(loss), float(acc), [np.asarray(x)
                                     for x in jax.tree.leaves(grads)]


def _assert_grads(got, want, rtol=5e-4, atol=1e-6):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _case(*args, variant="edge", route=None):
    """A case whose id is its values (the 'edge' single-pass cases keep
    their plain ids)."""
    tail = [x for x in (variant if variant != "edge" else None, route) if x]
    return pytest.param(*args, variant, route,
                        id="-".join(map(str, (*args, *tail))))


@pytest.mark.parametrize("ranks,head_shards,impl,remat,variant,route", [
    _case(2, 1, "torch", False), _case(4, 1, "torch", False),
    _case(4, 2, "torch", False), _case(4, 2, "sell", False),
    _case(4, 2, "pallas", False), _case(4, 1, "sell", False),
    _case(4, 1, "pallas", False), _case(2, 1, "sell", True),
    _case(4, 2, "torch", True), _case(2, 1, "sell", True, route="overlap"),
    _case(4, 1, "torch", False, variant="node"),
    _case(4, 2, "sell", False, variant="node"),
    _case(4, 1, "pallas", False, variant="node"),
])
def test_sharded_loss_and_grads_match_jax_single_device(
        pool, ranks, head_shards, impl, remat, variant, route):
    """Mesh 2 and 4 over 'graph', and 2 x 2 with head parallelism (layer
    heads (2, 2): both layers head-sharded), on the dense all_gather
    ('torch') or the fused kernels' twins on per-shard layouts with the
    halo plan, or (route 'overlap') the two-pass layer with its
    asynchronous exchange; remat recomputes each layer, collectives
    included, in the backward; both reference variants."""
    g, config, params, params_np = _jax_setup(3, variant)
    loss_ref, acc_ref, grads_ref = _jax_single_device(g, config, params)
    route = route or ("dense" if impl == "torch" else "halo")
    loss, acc, grads = pool.run(rank_loss_and_grads, params_np, ranks,
                                head_shards, impl, route, remat, variant)[0]
    assert loss == pytest.approx(loss_ref, rel=1e-5)
    assert acc == pytest.approx(acc_ref, abs=1e-6)
    _assert_grads(grads, grads_ref, atol=1e-6 if impl == "torch" else 2e-6)


@pytest.mark.parametrize("impl", ["torch", "pallas"])
def test_halo_exchange_matches_all_gather(pool, impl):
    _, _, _, params_np = _jax_setup(5)
    dense = pool.run(rank_loss_and_grads, params_np, 4, 1, impl, "dense")[0]
    halo = pool.run(rank_loss_and_grads, params_np, 4, 1, impl, "halo")[0]
    assert halo[0] == pytest.approx(dense[0], rel=1e-6)
    assert halo[1] == pytest.approx(dense[1], abs=1e-6)
    _assert_grads(halo[2], dense[2], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl,variant", [
    pytest.param(impl, variant, id=impl + ("-node" if variant == "node"
                                            else ""))
    for variant in ("edge", "node") for impl in ("torch", "sell", "pallas")])
def test_overlap_routes_match_single_pass(pool, impl, variant):
    """The two-pass local/halo layer of each impl (the 'torch' stats
    merge, the family's fused.merged_attention_exchange) against the
    impl's single-pass halo layer, and against the JAX single device, in
    both variants."""
    g, config, params, params_np = _jax_setup(9, variant)
    single = pool.run(rank_loss_and_grads, params_np, 4, 1, impl, "halo",
                      False, variant)[0]
    two = pool.run(rank_loss_and_grads, params_np, 4, 1, impl, "overlap",
                   False, variant)[0]
    assert two[0] == pytest.approx(single[0], rel=1e-5)
    assert two[1] == pytest.approx(single[1], abs=1e-6)
    _assert_grads(two[2], single[2], rtol=1e-4, atol=1e-6)
    loss_ref, _, grads_ref = _jax_single_device(g, config, params)
    assert two[0] == pytest.approx(loss_ref, rel=1e-5)
    _assert_grads(two[2], grads_ref, atol=2e-6)


@pytest.mark.parametrize("impl", ["sell", "pallas", "torch"])
def test_overlap_exchange_runs_under_the_local_pass(pool, impl):
    """On every rank and in every layer, the overlap layer's host order:
    forward, exchange started -> local pass -> wait -> halo pass (on
    'torch', the max over the local edges, then over the halo edges);
    backward on the fused routes, halo pass -> reverse exchange started ->
    local pass -> wait. Loss and gradients equal those of the same step
    with a synchronous exchange to 1e-6."""
    _, _, _, params_np = _jax_setup(6)
    if impl == "torch":
        fwd, bwd = ["start", "max local", "wait", "max halo"], []
    else:
        fwd = ["start", "fwd local", "wait", "fwd halo"]
        bwd = ["bwd halo", "start", "bwd local", "wait"]
    layers = ARCH["num_layers"]
    for log, got, want in pool.run(rank_overlap_order, params_np, impl):
        assert log == fwd * layers + bwd * layers
        assert got[0] == pytest.approx(want[0], rel=1e-6)
        assert got[1] == want[1]
        _assert_grads(got[2], want[2], rtol=1e-6, atol=0)


def test_torchrun_start_matches_rankpool_start():
    """python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    gatv2_tpu_torch.train --mesh 2 --overlap --device cpu (each process
    joins from torchrun's environment: multihost.is_multihost_env,
    initialize) prints the lines of the same command started without
    torchrun (its RankPool), losses to 6 decimals included, with the
    epoch times masked; rank 1 prints nothing of its own."""
    argv = ["-m", "gatv2_tpu_torch.train", "--dataset", "karate",
            "--data-root", "./data", "--mesh", "2", "--impl", "sell",
            "--overlap", "--device", "cpu", "--epochs", "3", "--seed", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = []
    for cmd in ([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "2", *argv],
                [sys.executable, *argv]):
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append([re.sub(r"total time: \S+ ms", "total time: - ms", l)
                     for l in r.stdout.splitlines()])
    torchrun, pool_start = outs
    assert torchrun == pool_start
    losses = [l for l in torchrun if l.startswith("Avg Loss: ")]
    assert len(losses) == 3
    assert "Transport: gloo, 2 ranks on the CPU" in torchrun
    assert any(l.startswith("Overlap: two-pass") for l in torchrun)


def test_sharded_trainer_matches_jax_trainer(pool):
    """ShardedTrainer(mesh 2, impl 'sell', --overlap, splits) against the
    JAX package's ShardedTrainer from the same parameters: its console
    lines and per-epoch losses, the split accuracies; and it learns."""
    from gatv2_tpu.config import TrainConfig
    from gatv2_tpu.data.splits import random_splits as jsplits
    from gatv2_tpu.parallel.sharded import ShardedTrainer

    g, config, params, params_np = _jax_setup(0)
    tc = TrainConfig(optimizer="adam", lr=0.02, clip=True, seed=0, epochs=0,
                     impl="sell")
    jlogs = []
    jt = ShardedTrainer(g, config, tc, 2, log_fn=jlogs.append,
                        splits=jsplits(g.num_nodes, (0.6, 0.2, 0.2), seed=1),
                        overlap=True)
    jt.params = params
    j_losses = [jt.run(1)["loss"] for _ in range(4)]
    results = pool.run(rank_trainer, 2, 1, "sell", 4, True, None, params_np,
                       1)
    logs, losses, accs = results[0]
    assert results[1][0] == [] and results[2] is None  # rank 0 logs alone
    lines = lambda ls, key: [l for l in ls if l.startswith(key)]
    for key in ("Partition:", "Halo:", "Overlap:"):
        assert lines(logs, key) == lines(jlogs, key), key
    assert lines(logs, "Overlap:")[0].startswith("Overlap: two-pass")
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    j_accs = jt.evaluate()
    for k in ("train", "val", "test"):
        assert accs[k] == pytest.approx(j_accs[k], abs=1e-6)
    assert len(lines(logs, "Train/Val/Test Accuracy")) == 4
    assert all(re.fullmatch(
        r"Avg Loss: \d+\.\d{6}, Accuracy: \d+\.\d{2}%  total time: "
        r"\d+\.\d{2} ms", l) for l in lines(logs, "Avg Loss"))


def test_sharded_runner_matches_trainer_and_jax_runner(pool):
    """make_sharded_multi_epoch_runner (mesh 2, impl 'sell', --overlap, 4
    epochs) against 4 ShardedTrainer steps from the same weights bit for
    bit, and against the JAX package's make_sharded_multi_epoch_runner on
    the JAX ShardedTrainer's layouts (Pallas interpret mode)."""
    import jax.numpy as jnp

    from gatv2_tpu.config import TrainConfig
    from gatv2_tpu.parallel import make_sharded_multi_epoch_runner
    from gatv2_tpu.parallel.sharded import ShardedTrainer

    g, config, params, params_np = _jax_setup(4)
    tc = TrainConfig(optimizer="adam", lr=0.02, clip=True, seed=0, epochs=0,
                     impl="sell")
    jt = ShardedTrainer(g, config, tc, 2, log_fn=lambda _: None,
                        overlap=True)
    assert jt.overlap_tiles is not None  # the two-pass layer, no tiles
    jt.params = params
    jrun = make_sharded_multi_epoch_runner(
        config, tc, jt.mesh, jt.pg.num_real_nodes, 4,
        halo_plan=jt.halo_plan, overlap_tiles=jt.overlap_tiles)
    _, _, j_losses, j_accs = jrun(jt.params, jt.opt_state,
                                  jnp.asarray(0, jnp.int32), *jt.data)
    results = pool.run(rank_runner, 2, "sell", True, 4, params_np)
    assert results[2] is None and results[3] is None
    for losses, accs, step_losses, step_accs, same in results[:2]:
        assert losses == step_losses and accs == step_accs and same
    assert results[1][:2] == results[0][:2]
    np.testing.assert_allclose(results[0][0], np.asarray(j_losses),
                               rtol=1e-5)
    np.testing.assert_allclose(results[0][1], np.asarray(j_accs), atol=1e-6)


def test_sharded_trainer_learns_and_falls_back_on_hubs(pool):
    """Mesh 4 with head parallelism learns (its own seed); on a hub-heavy
    power-law graph the SELL overlap gives way to the single pass with
    the JAX package's log line, and matches the JAX trainer's losses."""
    from gatv2_tpu.config import TrainConfig
    from gatv2_tpu.data import synthetic as jsyn
    from gatv2_tpu.parallel.sharded import ShardedTrainer

    logs, losses, _ = pool.run(rank_trainer, 4, 2, "torch", 10, False, None,
                               None, None)[0]
    assert losses[-1] < losses[0]
    assert sum(l.startswith("Epoch ") for l in logs) == 10

    graph_kw = dict(num_nodes=600, num_edges=9000, feature_dim=16,
                    num_classes=4, seed=12, alpha=1.2)
    import jax

    from gatv2_tpu.config import ModelConfig
    from gatv2_tpu.models.gatv2 import init_params

    jg = jsyn.powerlaw_graph(**graph_kw)
    config = ModelConfig(**ARCH, num_classes=jg.num_classes,
                         in_dim=jg.feature_dim)
    params = init_params(config, jax.random.PRNGKey(4))
    params_np = jax.tree.map(np.asarray, params)  # the JAX step donates
    jlogs = []
    jt = ShardedTrainer(jg, config,
                        TrainConfig(optimizer="adam", lr=0.02, clip=True,
                                    seed=0, epochs=0, impl="sell"),
                        4, log_fn=jlogs.append, overlap=True)
    jt.params = params
    j_losses = [jt.run(1)["loss"] for _ in range(2)]
    logs, losses, _ = pool.run(rank_trainer, 4, 1, "sell", 2, True, graph_kw,
                               params_np, None)[0]
    fallback = [l for l in logs if l.startswith("Overlap: unavailable")]
    assert fallback and fallback == [l for l in jlogs
                                     if l.startswith("Overlap: unavailable")]
    assert "single-pass" in fallback[0]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)


def test_sharded_resume_reshards(pool, tmp_path):
    same, same_opt, heads, (l1, l2), full, epoch = pool.run(
        rank_resume, str(tmp_path))[0]
    assert same and same_opt and epoch == 3
    assert heads == [(1, 8, 32), (1, 6, 16)]  # 2 heads / 2 head ranks
    assert l2 == pytest.approx(l1, rel=1e-6)
    # the checkpoint holds the full model: layer 0's w_src [2, 8, 32]
    assert full[2].shape == (2, 8, 32)
    assert tckpt.latest_path(tmp_path).name == "ckpt_00000002.npz"


@pytest.mark.parametrize("impl", ["pallas", "sell"])
def test_dp_minibatch_matches_jax(pool, impl):
    """Data-parallel minibatch on 2 ranks (python engine: the JAX
    package's batches byte for byte; batch 8 of 34 nodes, so the last
    super-step is padded with a zero-seed batch) against the JAX
    package's DataParallelMinibatchTrainer on 2 virtual devices."""
    import jax

    from gatv2_tpu import config as jconfig
    from gatv2_tpu.data import io as jio
    from gatv2_tpu.train.minibatch import DataParallelMinibatchTrainer

    jg = jio.load_dataset("karate", DATA)
    mc = jconfig.ModelConfig(num_layers=2, heads=(2, 1), out_dims=(8, 4),
                             num_classes=jg.num_classes,
                             in_dim=jg.feature_dim)
    tc = jconfig.TrainConfig(epochs=2, optimizer="adam", lr=0.01, clip=True,
                             seed=0, batch_size=8, fanouts=(3, 3),
                             sampler_engine="python", impl=impl)
    jt = DataParallelMinibatchTrainer(jg, mc, tc, 2, log_fn=lambda _: None)
    params_np = jax.tree.map(np.asarray, jt.params)
    j_losses = [jt.run(1)["loss"] for _ in range(2)]
    jt.sync_step_count()
    results = pool.run(rank_dp, None, impl, "python", params_np, 2)
    losses, steps = results[0]
    assert results[1] == results[0] and results[2] is None
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert steps == jt.step_count == 6  # 5 batches -> 3 super-steps


@pytest.mark.parametrize("engine", ["python", "native"])
def test_iter_groups_is_the_batch_stream(engine):
    """Rank r of N gets batch g*N + r of the stream __iter__ walks, and the
    group's first batch where the epoch has none left for it."""
    from gatv2_tpu_torch.data import io as tio
    from gatv2_tpu_torch.data.sampling import NeighborSampler

    g = tio.load_dataset("karate", DATA)

    def sampler():
        return NeighborSampler(g, 8, (3, 3), seed=2, engine=engine)

    ref, streams = sampler(), [sampler() for _ in range(3)]
    for _epoch in range(2):
        want = list(ref)
        got = [list(s.iter_groups(3, r)) for r, s in enumerate(streams)]
        for r in range(3):
            assert len(got[r]) == 2
            for gi, (own, first) in enumerate(got[r]):
                i = gi * 3 + r
                b = own if i < len(want) else first
                w = want[i] if i < len(want) else want[gi * 3]
                assert (own is None) == (i >= len(want))
                for f in ("src", "dst", "labels", "node_ids"):
                    np.testing.assert_array_equal(getattr(b, f),
                                                  getattr(w, f))


def test_train_cli_mesh_matches_jax_train_py(tmp_path):
    """python -m gatv2_tpu_torch.train --mesh 2 --device cpu (2 gloo ranks
    started by the command) prints the JAX CLI's lines plus Transport:,
    and its per-epoch losses equal root train.py --mesh 2's from the same
    text-dumped weights; a checkpoint is written by rank 0."""
    from gatv2_tpu.models.params_io import save_params_txt as jsave

    import jax

    from gatv2_tpu.config import ModelConfig
    from gatv2_tpu.models.gatv2 import init_params

    cfg = ModelConfig(num_layers=2, heads=(2, 1), out_dims=(8, 4),
                      num_classes=2, in_dim=34)
    jsave(tmp_path / "w", init_params(cfg, jax.random.PRNGKey(5)))
    argv = ["--dataset", "karate", "--data-root", DATA, "--num-layers", "2",
            "--heads", "2,1", "--outdims", "8,4", "--epochs", "3",
            "--optimizer", "adam", "--lr", "0.01", "--clip", "--seed", "1",
            "--load-weights", str(tmp_path / "w"), "--mesh", "2"]
    r = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.train", *argv, "--device",
         "cpu", "--overlap", "--checkpoint-dir", str(tmp_path / "ck")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert "Transport: gloo, 2 ranks on the CPU" in out
    assert "Sharded mode: edge-partitioned over 2 devices" in out
    assert any(l.startswith("Partition: ") for l in out)
    assert any(l.startswith("Halo: boundary exchange") for l in out)
    assert any(l.startswith("Overlap: two-pass") for l in out)
    assert sum(l.startswith("Epoch ") for l in out) == 3  # rank 0 only
    assert tckpt.latest_path(tmp_path / "ck").name == "ckpt_00000003.npz"
    from gatv2_tpu.parallel.sharded import ShardedTrainer
    from gatv2_tpu.config import TrainConfig
    from gatv2_tpu.data import io as jio
    from gatv2_tpu.data.splits import load_split_files
    from gatv2_tpu.models.params_io import load_params_txt

    jg = jio.load_dataset("karate", DATA)
    jcfg = dataclasses.replace(cfg, num_classes=jg.num_classes,
                               in_dim=jg.feature_dim)
    jt = ShardedTrainer(
        jg, jcfg, TrainConfig(optimizer="adam", lr=0.01, clip=True, seed=1,
                              epochs=3), 2, log_fn=lambda _: None,
        splits=load_split_files(os.path.join(DATA, "karate"), jg.num_nodes),
        overlap=True)
    jt.params = load_params_txt(str(tmp_path / "w"), jcfg)
    want = [jt.run(1)["loss"] for _ in range(3)]
    got = [float(re.search(r"Avg Loss: (\S+),", l).group(1))
           for l in out if l.startswith("Avg Loss: ")]
    np.testing.assert_allclose(got, want, atol=2e-6)
