"""The port's edge-tile layout (ops/pallas_attention.py host side) against
the JAX package's: every EdgeTiles leaf byte-equal (dtype, shape, values)
for unchunked, chunked, fixed-budget and bipartite layouts; the native
emitter through the port's library equal to the port's numpy layout; and
the chunk policy (suggest_num_chunks, setup_full_graph) deciding alike."""

import shutil

import jax
import numpy as np
import pytest

from gatv2_tpu.ops import pallas_attention as jpa
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.ops import pallas_attention as tpa


def _leaves(et):
    """The port's leaves in the JAX pytree's flatten order."""
    return [et.src, et.dst, et.tile_offsets, et.src_sorted_ids,
            et.gather_perm, et.src_tile_offsets,
            *(getattr(side, f) for side in (et.dst_side, et.src_side)
              for f in ("ids_grp", "other_grp", "rel_offsets"))]


def _assert_same_layout(t_et, j_et):
    j_leaves = [np.asarray(x) for x in jax.tree.leaves(j_et)]
    t_leaves = _leaves(t_et)
    assert len(t_leaves) == len(j_leaves)
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        assert isinstance(t, np.ndarray), i
        assert t.dtype == j.dtype and t.shape == j.shape, (i, t.shape, j.shape)
        assert np.array_equal(t, j), i
    for f in ("num_nodes", "num_node_tiles", "tile_e", "num_chunks",
              "tiles_per_chunk", "num_src_nodes", "src_tiles_per_chunk",
              "padded_num_nodes", "padded_src_nodes", "padded_num_edges"):
        assert getattr(t_et, f) == getattr(j_et, f), f


def _graph(case):
    if case == "uniform":
        return random_graph(700, 3500, 4, 3, seed=3)
    if case == "power-law":  # hubs: several edge tiles in one node tile
        return powerlaw_graph(600, 5000, 4, 3, seed=4, alpha=1.2)
    # isolated nodes and whole node tiles without an edge
    n = 520
    deg = np.zeros(n, np.int64)
    deg[:60] = 3
    deg[300:330] = 9
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col = np.random.default_rng(5).integers(0, n, size=int(row_ptr[-1]))
    return row_ptr, col.astype(np.int32), n


def _csr(case):
    g = _graph(case)
    if isinstance(g, tuple):
        return g
    return g.row_ptr, g.col_idx, g.num_nodes


@pytest.mark.parametrize("case", ["uniform", "power-law", "sparse"])
@pytest.mark.parametrize("opts", [
    dict(), dict(num_chunks=2), dict(num_chunks=3, tile_e=256),
    dict(tile_e=128, fixed_edge_tiles=80), dict(max_hd=1024),
])
def test_layout_leaves_byte_equal(case, opts):
    row_ptr, col_idx, n = _csr(case)
    _assert_same_layout(tpa.prepare_edge_tiles(row_ptr, col_idx, n, **opts),
                        jpa.prepare_edge_tiles(row_ptr, col_idx, n, **opts))


def test_bipartite_layout_byte_equal():
    """Local destinations, global sources (the sharded layers' layout)."""
    rng = np.random.default_rng(2)
    n_dst, n_src = 150, 410
    deg = rng.integers(0, 7, size=n_dst)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col = rng.integers(0, n_src, size=int(row_ptr[-1])).astype(np.int32)
    for chunks in (1, 2):
        _assert_same_layout(
            tpa.prepare_edge_tiles(row_ptr, col, n_dst, num_chunks=chunks,
                                   num_src_nodes=n_src),
            jpa.prepare_edge_tiles(row_ptr, col, n_dst, num_chunks=chunks,
                                   num_src_nodes=n_src))


def test_auto_tile_e_picks_as_jax():
    """A graph dense enough for wider edge tiles picks the same tile_e."""
    g = random_graph(256, 60_000, 4, 3, seed=1)
    t = tpa.prepare_edge_tiles(g.row_ptr, g.col_idx, g.num_nodes)
    j = jpa.prepare_edge_tiles(g.row_ptr, g.col_idx, g.num_nodes)
    assert t.tile_e == j.tile_e > 128
    _assert_same_layout(t, j)


def test_fixed_budget_too_small_raises():
    row_ptr, col_idx, n = _csr("uniform")
    with pytest.raises(ValueError, match="too small"):
        tpa.prepare_edge_tiles(row_ptr, col_idx, n, tile_e=128,
                               fixed_edge_tiles=3)
    with pytest.raises(ValueError, match="num_chunks == 1"):
        tpa.prepare_edge_tiles(row_ptr, col_idx, n, num_chunks=2,
                               fixed_edge_tiles=80)


def test_native_emitter_equals_numpy_layout():
    """edge_tiles_from_native over the port's native emit_tiles equals the
    port's prepare_edge_tiles(fixed_edge_tiles=...) on a dst-sorted batch,
    isolated nodes and empty tiles included."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native library cannot be built")
    from gatv2_tpu_torch.utils import native_loader

    rng = np.random.default_rng(9)
    max_nodes, budget = 640, 40
    num_edges = 1700
    dst = np.sort(rng.integers(0, 300, size=num_edges)).astype(np.int32)
    src = rng.integers(0, 500, size=num_edges).astype(np.int32)
    pad = 2000
    src_p = np.concatenate([src, np.zeros(pad - num_edges, np.int32)])
    dst_p = np.concatenate([dst, np.full(pad - num_edges, max_nodes,
                                         np.int32)])
    raw = native_loader.emit_tiles(src_p, dst_p, num_edges, max_nodes, 128,
                                   budget)
    nat = tpa.edge_tiles_from_native(raw, max_nodes, 128, budget)
    row_ptr = np.zeros(max_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=max_nodes), out=row_ptr[1:])
    py = tpa.prepare_edge_tiles(row_ptr, src, max_nodes, tile_e=128,
                                fixed_edge_tiles=budget)
    for a, b in zip(_leaves(nat), _leaves(py)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="does not fit"):
        native_loader.emit_tiles(src_p, dst_p, num_edges, max_nodes, 128, 5)


@pytest.mark.parametrize("num_edges,max_hd,budget", [
    (1_000, 128, 4 << 30), (2_000_000, 256, 4 << 30),
    (8_000_000, 256, 20 << 30), (62_000_000, 512, 2 << 30),
    (300_000, 384, 100_000_000),
])
def test_suggest_num_chunks_agrees(num_edges, max_hd, budget):
    assert tpa.suggest_num_chunks(num_edges, max_hd, budget_bytes=budget) \
        == jpa.suggest_num_chunks(num_edges, max_hd, budget_bytes=budget)


def test_setup_full_graph_agrees():
    """The same chunk count, layout and padded features/labels, with the
    budget given and with the CPU default (the JAX package's policy)."""
    g = random_graph(900, 5000, 6, 4, seed=8)
    from gatv2_tpu.data.synthetic import random_graph as jrandom_graph

    jg = jrandom_graph(900, 5000, 6, 4, seed=8)
    labels = np.where(np.arange(900) % 3 == 0, g.labels, -1).astype(np.int32)
    for budget in (None, 2_000_000):
        kw = {} if budget is None else dict(budget_bytes=budget)
        t = tpa.setup_full_graph(g, (4, 20), (16, 8), device="cpu",
                                 labels=labels, **kw)
        j = jpa.setup_full_graph(jg, (4, 20), (16, 8), labels=labels, **kw)
        _assert_same_layout(t[0], j[0])
        assert (t[0].num_chunks > 1) == (budget is not None)
        for a, b in zip(t[1:3], j[1:3]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert t[3] == j[3]
