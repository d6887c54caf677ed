"""The port's graph partitioning (parallel/partition.py) against the JAX
package's, on the same graphs: every array of the PartitionedGraph, the
HaloPlan and the OverlapSplit, and each shard's pallas and SELL layouts
(single-pass, chunked, and the overlap pairs) must be byte-equal to shard
r's slice of the JAX package's stacked layouts — padding sentinels of the
cross-shard padding included. No process group is needed: the layouts are
numpy."""

import dataclasses

import numpy as np
import pytest

from gatv2_tpu.data import synthetic as jsyn
from gatv2_tpu.parallel import partition as jpart
from gatv2_tpu_torch.data import synthetic as tsyn
from gatv2_tpu_torch.parallel import partition as tpart


def _graphs(name):
    if name == "learnable":
        kw = dict(num_nodes=200, num_edges=800, feature_dim=32,
                  num_classes=4, seed=0, planted_signal=2.0)
        return tsyn.random_graph(**kw), jsyn.random_graph(**kw)
    kw = dict(seed=12, alpha=1.2)
    return (tsyn.powerlaw_graph(600, 9000, 16, 4, **kw),
            jsyn.powerlaw_graph(600, 9000, 16, 4, **kw))


def _assert_layout_equal(port, jax_stacked, shard, path="tiles"):
    """Every array of the port's layout equals the shard's slice of the JAX
    package's stacked one; every other field is equal."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(jax_stacked, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(got):
            _assert_layout_equal(got, want, shard, where)
        elif isinstance(got, np.ndarray):
            want = np.asarray(want)[shard]
            assert got.dtype == want.dtype, where
            np.testing.assert_array_equal(got, want, err_msg=where)
        else:
            assert got == want, where


def _assert_fields_equal(port, ref, names):
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(port, n)),
                                      np.asarray(getattr(ref, n)), err_msg=n)


@pytest.mark.parametrize("graph", ["learnable", "power-law"])
@pytest.mark.parametrize("shards", [2, 4])
def test_partition_plans_and_tiles_byte_equal(graph, shards):
    tg, jg = _graphs(graph)
    tpg = tpart.partition_graph(tg, shards)
    jpg = jpart.partition_graph(jg, shards)
    _assert_fields_equal(tpg, jpg, ("features", "labels", "src", "dst_local",
                                    "node_bounds", "edge_counts"))
    for f in ("num_shards", "nodes_per_shard", "edges_per_shard",
              "num_real_nodes", "num_real_edges"):
        assert getattr(tpg, f) == getattr(jpg, f), f
    assert tpg.balance_report() == jpg.balance_report()
    tplan, jplan = tpart.halo_exchange_plan(tpg), jpart.halo_exchange_plan(jpg)
    _assert_fields_equal(tplan, jplan, ("send_ids", "src_halo"))
    assert (tplan.halo_size, tplan.m_per_pair, tplan.space_size) == (
        jplan.halo_size, jplan.m_per_pair, jplan.space_size)
    tsplit = tpart.overlap_split_plan(tpg, tplan)
    jsplit = jpart.overlap_split_plan(jpg, jplan)
    _assert_fields_equal(tsplit, jsplit, ("local_src", "local_dst",
                                          "halo_src", "halo_dst"))

    builds = [
        ("pallas", lambda p, pg, plan: p.prepare_partitioned_tiles(pg)),
        ("pallas-halo", lambda p, pg, plan: p.prepare_partitioned_tiles(
            pg, halo_plan=plan)),
        ("pallas-chunked", lambda p, pg, plan: p.prepare_partitioned_tiles(
            pg, num_chunks=2)),
        ("sell", lambda p, pg, plan: p.prepare_partitioned_sell_tiles(pg)),
        ("sell-halo", lambda p, pg, plan: p.prepare_partitioned_sell_tiles(
            pg, halo_plan=plan)),
        ("sell-chunked", lambda p, pg, plan:
         p.prepare_partitioned_sell_tiles(pg, num_chunks=2)),
    ]
    for name, build in builds:
        port = build(tpart, tpg, tplan)
        ref = build(jpart, jpg, jplan)
        assert len(port) == shards
        for r in range(shards):
            _assert_layout_equal(port[r], ref, r, name)

    t_pairs = tpart.prepare_overlap_tiles(tpg, tplan, tsplit)
    j_pairs = jpart.prepare_overlap_tiles(jpg, jplan, jsplit)
    for port, ref, name in zip(t_pairs, j_pairs, ("local", "halo")):
        for r in range(shards):
            _assert_layout_equal(port[r], ref, r, f"overlap-{name}")
    if graph == "power-law":
        # hub-heavy: both packages refuse the unsplit SELL overlap layouts
        # with the same message (the trainer then runs the single pass)
        with pytest.raises(ValueError) as te:
            tpart.prepare_overlap_sell_tiles(tpg, tplan, tsplit)
        with pytest.raises(ValueError) as je:
            jpart.prepare_overlap_sell_tiles(jpg, jplan, jsplit)
        assert str(te.value) == str(je.value)
        assert "hub-heavy" in str(te.value)
    else:
        t_pairs = tpart.prepare_overlap_sell_tiles(tpg, tplan, tsplit)
        j_pairs = jpart.prepare_overlap_sell_tiles(jpg, jplan, jsplit)
        for port, ref, name in zip(t_pairs, j_pairs, ("local", "halo")):
            for r in range(shards):
                _assert_layout_equal(port[r], ref, r, f"overlap-sell-{name}")


def test_auto_chunked_sell_tiles_and_node_balance_byte_equal():
    """prepare_partitioned_sell_tiles(num_chunks=None) picks the JAX
    package's chunk count from the widths and budget; balance='nodes' the
    JAX package's equal blocks."""
    tg, jg = _graphs("power-law")
    tpg = tpart.partition_graph(tg, 2, balance="nodes")
    jpg = jpart.partition_graph(jg, 2, balance="nodes")
    _assert_fields_equal(tpg, jpg, ("src", "dst_local", "node_bounds"))
    kw = dict(num_chunks=None, heads=(4, 1), out_dims=(64, 16),
              budget_bytes=1 << 20)
    port = tpart.prepare_partitioned_sell_tiles(tpg, **kw)
    ref = jpart.prepare_partitioned_sell_tiles(jpg, **kw)
    assert port[0].num_chunks == ref.num_chunks > 1
    for r in range(2):
        _assert_layout_equal(port[r], ref, r, "sell-auto")
    # the slot map and scatter round-trip as in the JAX package
    vals = np.arange(tg.num_nodes, dtype=np.int32)
    np.testing.assert_array_equal(tpg.scatter_nodes(vals, -1),
                                  jpg.scatter_nodes(vals, -1))
    np.testing.assert_array_equal(tpg.slot_of(vals), jpg.slot_of(vals))
    with pytest.raises(ValueError, match="balance must be"):
        tpart.partition_graph(tg, 2, balance="random")
