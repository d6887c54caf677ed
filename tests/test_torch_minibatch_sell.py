"""Sampled-minibatch training on per-batch SELL layouts (impl='sell' with
--batch-size) in the port against the JAX package, on the CPU: the fixed
geometry, prepare_sell_tiles' fixed= and force_split= options,
prepare_minibatch_sell_tiles, the native emit_sell_tiles through
sell_tiles_from_native, and NeighborSampler(emit_tiles='sell'), all byte-
equal to the JAX package's; then the loss of one sampled batch through the
twins of K1-K3 against the JAX package's impl='sell' and 'xla' losses (to
1e-5 relative: both fp32, sums in another order), with its gradients
against the port's torch path.

Whole trainers (MinibatchTrainer(impl='sell') step by step against the JAX
package's) are cases of tests/test_torch_minibatch.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu import config as jconfig
from gatv2_tpu.data import sampling as jsampling
from gatv2_tpu.data.synthetic import random_graph as jrandom_graph
from gatv2_tpu.models import gatv2 as jmodel
from gatv2_tpu.ops import sell_attention as jsa
from gatv2_tpu_torch import config as tconfig
from gatv2_tpu_torch.data import sampling as tsampling
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models import gatv2 as tmodel
from gatv2_tpu_torch.models import params_io as tpio
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.train import optim as toptim
from gatv2_tpu_torch.utils import native_loader as tnative
from test_torch_sampling import (  # noqa: F401  (jax_native is a fixture)
    GRAPH,
    _assert_batches_equal,
    _need_gxx,
    jax_native,
)
from test_torch_sell import assert_same_sell_layout

LOSS_RTOL = 1e-5
# the port's sell and torch paths on one batch, both fp32: sums in another
# order (per-row online softmax against index_add_)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _uniform():
    g = random_graph(500, 2300, 8, 3, seed=11)
    return g.row_ptr, g.col_idx, g.num_nodes


def _power_law():
    g = powerlaw_graph(600, 5000, 4, 3, seed=4, alpha=1.2)
    return g.row_ptr, g.col_idx, g.num_nodes


def _roomy_fixed(n, e):
    """A fixed tuple above what the layout needs, uneven between sides."""
    cols_d, cols_s, tiles_d, tiles_s = tsa.sell_minibatch_geometry(n, e)
    return cols_d + 5, cols_s + 9, tiles_d + 2, tiles_s + 3


@pytest.mark.parametrize("max_nodes,max_edges", [
    (1, 1), (256, 512), (4096, 300), (500_096, 1_136_640)])
def test_sell_minibatch_geometry_matches_jax(max_nodes, max_edges):
    assert tsa.sell_minibatch_geometry(max_nodes, max_edges) == \
        jsa.sell_minibatch_geometry(max_nodes, max_edges)


# (graph, prepare_sell_tiles options with a roomy fixed tuple as "fixed")
FIXED_CASES = {
    "fixed": (_uniform, dict(fixed=True)),
    "force-split": (_uniform, dict(force_split=(True, True))),
    "fixed-and-force-split": (_uniform, dict(fixed=True,
                                             force_split=(True, True))),
    "fixed-num-chunks-2": (_uniform, dict(fixed=True, num_chunks=2)),
    "power-law-fixed-src-forced": (_power_law, dict(
        fixed=True, force_split=(False, True))),
}


@pytest.mark.parametrize("case", sorted(FIXED_CASES))
def test_fixed_and_force_split_layouts_byte_equal(case):
    make, opts = FIXED_CASES[case]
    row_ptr, col_idx, n = make()
    kw = dict(opts)
    if kw.get("fixed"):
        kw["fixed"] = _roomy_fixed(n, int(row_ptr[-1]))
    got = tsa.prepare_sell_tiles(row_ptr, col_idx, n, **kw)
    want = jsa.prepare_sell_tiles(row_ptr, col_idx, n, as_numpy=True, **kw)
    assert_same_sell_layout(got, want)
    if "fixed" in kw:
        assert got.num_edges == -1 and got.pad_overhead == 0.0
        assert got.e_ell == kw["fixed"][0] * tsa.TILE_N
    if kw.get("force_split", (False, False))[1]:
        assert got.srcs.split


def test_fixed_too_small_raises_as_jax():
    row_ptr, col_idx, n = _uniform()
    e = int(row_ptr[-1])
    cols, _, tiles, _ = tsa.sell_minibatch_geometry(n, e)
    for fixed, match in (((cols, cols, 1, tiles), "fixed tiles=1 too small"),
                         ((2, cols, tiles, tiles), "fixed_cols=2 too small")):
        for mod, kw in ((tsa, {}), (jsa, dict(as_numpy=True))):
            with pytest.raises(ValueError, match=match):
                mod.prepare_sell_tiles(row_ptr, col_idx, n, fixed=fixed, **kw)


def _hub_batch(max_nodes=256, max_edges=512):
    """Every edge into node 0 (its dst row splits into two virtual rows)."""
    return (np.arange(max_edges, dtype=np.int32) % max_nodes,
            np.zeros(max_edges, np.int32), max_edges)


def _flat_batch(max_nodes=256, max_edges=512):
    """One edge into each node, twice around, sorted by dst."""
    src = np.zeros(max_edges, np.int32)
    dst = np.arange(max_edges, dtype=np.int32) % max_nodes
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order], max_edges


def _empty_batch(max_nodes=256, max_edges=512):
    return (np.zeros(max_edges, np.int32),
            np.full(max_edges, max_nodes, np.int32), 0)


BATCHES = {"hub": _hub_batch, "flat": _flat_batch, "zero-edge": _empty_batch}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_minibatch_sell_tiles_byte_equal(case):
    """prepare_minibatch_sell_tiles on the JAX package's adversarial batches
    (tests/test_minibatch_sell.py): the same leaves, one shape for all."""
    max_nodes, max_edges = 256, 512
    fixed = tsa.sell_minibatch_geometry(max_nodes, max_edges)
    src, dst, e = BATCHES[case](max_nodes, max_edges)
    got = tsa.prepare_minibatch_sell_tiles(src, dst, e, max_nodes, fixed)
    want = jsa.prepare_minibatch_sell_tiles(src, dst, e, max_nodes, fixed)
    assert_same_sell_layout(got, want)
    ref = tsa.prepare_minibatch_sell_tiles(*_hub_batch(max_nodes, max_edges),
                                           max_nodes, fixed)
    for side in ("dst", "srcs"):
        assert getattr(got, side).split
        for f in tsa._SIDE_ARRAYS:
            assert getattr(getattr(got, side), f).shape == \
                getattr(getattr(ref, side), f).shape, (side, f)


def test_minibatch_sell_tiles_reject_unsorted_dst():
    fixed = tsa.sell_minibatch_geometry(256, 512)
    src, dst, e = _flat_batch()
    with pytest.raises(ValueError, match="sorted by dst"):
        tsa.prepare_minibatch_sell_tiles(src, dst[::-1].copy(), e, 256, fixed)


def test_native_sell_emission_byte_equal():
    """The port's native emit_sell_tiles, through sell_tiles_from_native,
    equals its numpy build and the JAX package's on a sampled batch and on
    the hub, flat and zero-edge batches; it raises where the numpy build
    does (unsorted dst, a geometry too small), and sell_tiles_from_native
    rejects an array of the wrong length."""
    _need_gxx()
    s = tsampling.NeighborSampler(random_graph(**GRAPH), 16, (4, 4), seed=1,
                                  engine="python")
    b = s.sample(np.arange(16))
    fixed = tsa.sell_minibatch_geometry(s.max_nodes, s.max_edges)
    cases = [(b.src, b.dst, b.num_edges, s.max_nodes, fixed)]
    fixed256 = tsa.sell_minibatch_geometry(256, 512)
    cases += [(*make(), 256, fixed256) for make in BATCHES.values()]
    for src, dst, e, max_nodes, fx in cases:
        raw = tnative.emit_sell_tiles(src, dst, e, max_nodes,
                                      tsa.DEFAULT_SPLIT_CAP, fx)
        nat = tsa.sell_tiles_from_native(raw, max_nodes, fx)
        assert_same_sell_layout(
            nat, tsa.prepare_minibatch_sell_tiles(src, dst, e, max_nodes, fx))
        assert_same_sell_layout(
            nat, jsa.prepare_minibatch_sell_tiles(src, dst, e, max_nodes, fx))
    src, dst, e = _flat_batch()
    with pytest.raises(ValueError, match="emit_sell_tiles"):
        tnative.emit_sell_tiles(src, dst[::-1].copy(), e, 256,
                                tsa.DEFAULT_SPLIT_CAP, fixed256)
    with pytest.raises(ValueError, match="emit_sell_tiles"):
        tnative.emit_sell_tiles(*_hub_batch(), 256, tsa.DEFAULT_SPLIT_CAP,
                                (3, 3, 1, 1))
    raw = tnative.emit_sell_tiles(*_hub_batch(), 256, tsa.DEFAULT_SPLIT_CAP,
                                  fixed256)
    raw["cnt_s"] = raw["cnt_s"][:-1]
    with pytest.raises(ValueError, match="cnt_s"):
        tsa.sell_tiles_from_native(raw, 256, fixed256)


def test_emit_sell_tiles_missing_symbol_only_fails_itself(monkeypatch):
    """A library without emit_sell_tiles keeps the other native paths; the
    SELL emission alone raises."""
    _need_gxx()

    class Lib:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            if name == "emit_sell_tiles":
                raise AttributeError(name)
            return getattr(self._lib, name)

    monkeypatch.setattr(tnative, "_lib", Lib(tnative._get_lib()))
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert np.array_equal(
        tnative.gather_rows(table, np.array([2, 0], np.int32), 2),
        table[[2, 0]])
    with pytest.raises(RuntimeError, match="no emit_sell_tiles"):
        tnative.emit_sell_tiles(*_hub_batch(), 256, tsa.DEFAULT_SPLIT_CAP,
                                tsa.sell_minibatch_geometry(256, 512))


def _sampler_pair(engine, **kw):
    tg, jg = random_graph(**GRAPH), jrandom_graph(**GRAPH)
    kw = dict(dict(batch_size=48, fanouts=(4, 3), seed=5, engine=engine,
                   emit_tiles="sell"), **kw)
    return (tsampling.NeighborSampler(tg, **kw),
            jsampling.NeighborSampler(jg, **kw))


@pytest.mark.parametrize("engine,budget", [("python", "auto"),
                                           ("python", "probe"),
                                           ("native", "auto")])
def test_sell_sampler_stream_byte_identical(request, engine, budget):
    """NeighborSampler(emit_tiles='sell') gives the JAX sampler's batch
    stream (ids, labels, seeds and tiles) on both engines, in one tile
    shape with both sides split."""
    if engine == "native":
        request.getfixturevalue("jax_native")
    ts, js = _sampler_pair(engine, budget=budget, gather_features=True)
    assert ts.engine == js.engine == engine
    assert ts._sell_fixed == js._sell_fixed
    tbs = [b for _ in range(2) for b in ts]
    jbs = [b for _ in range(2) for b in js]
    assert len(tbs) == len(jbs) == 2 * ts.batches_per_epoch()
    shapes = set()
    for tb, jb in zip(tbs, jbs):
        _assert_batches_equal(tb, jb)
        assert tb.tiles.dst.split and tb.tiles.srcs.split
        shapes.add(tuple(getattr(getattr(tb.tiles, side), f).shape
                         for side in ("dst", "srcs")
                         for f in tsa._SIDE_ARRAYS))
    assert len(shapes) == 1


def _config(g, **kw):
    return dict(num_layers=2, heads=(2, 1), out_dims=(8, 8),
                num_classes=g.num_classes, in_dim=g.feature_dim, **kw)


def test_sell_minibatch_loss_matches_jax():
    """One sampled batch's loss: the port's impl='sell' (the twins of
    K1-K3 on the batch's SellTiles) against the JAX package's impl='sell'
    and 'xla'; its gradients against the port's torch path."""
    ts, js = _sampler_pair("python", batch_size=64, fanouts=(4, 4),
                           seed=0, gather_features=True)
    tb, jb = next(iter(ts)), next(iter(js))
    _assert_batches_equal(tb, jb)
    jcfg = jconfig.ModelConfig(**_config(ts.graph))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jargs = (jnp.asarray(jb.features), jnp.asarray(jb.src),
             jnp.asarray(jb.dst), jnp.asarray(jb.labels))
    # jitted: the JAX package's SELL kernels run in interpret mode here
    loss = jax.jit(jmodel.loss_fn, static_argnames=("config", "impl"))
    want = {impl: float(loss(
        jparams, *jargs, jcfg, impl=impl, num_valid=jb.num_seeds,
        edge_tiles=jb.tiles if impl == "sell" else None)[0])
        for impl in ("sell", "xla")}

    tcfg = tconfig.ModelConfig(**_config(ts.graph))
    params = tpio.params_from_numpy(jax.tree.map(np.asarray, jparams))
    feats, labels = torch.as_tensor(tb.features), torch.as_tensor(tb.labels)
    e = tb.num_edges
    runs = {}
    for impl, src, dst, tiles in (
            ("sell", None, None, tb.tiles),
            ("torch", torch.as_tensor(tb.src[:e]),
             torch.as_tensor(tb.dst[:e]), None)):
        loss, _ = tmodel.loss_fn(params, feats, src, dst, labels, tcfg,
                                 impl=impl, edge_tiles=tiles,
                                 num_valid=tb.num_seeds)
        runs[impl] = (float(loss.detach()), toptim.gradients(loss, params))
    for impl, w in want.items():
        np.testing.assert_allclose(runs["sell"][0], w, rtol=LOSS_RTOL,
                                   err_msg=impl)
    for name, g_sell, g_torch in zip(toptim.param_names(params),
                                     runs["sell"][1], runs["torch"][1]):
        torch.testing.assert_close(g_sell, g_torch, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=name)
