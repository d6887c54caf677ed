"""The replay driver: the window calls no sampler, one seed draws the
same pool, and the batch budget that decides remat."""

import numpy as np

from benchmark.drivers import common, replay
from benchmark.tests.tiny import tiny_context  # noqa: F401 (fixture)


def test_window_makes_no_sampler_call(tiny_context, monkeypatch):
    from gatv2_tpu_torch.data.sampling import NeighborSampler

    in_window, calls = [False], []
    sample, timed = NeighborSampler.sample, common.timed

    def counted_sample(self, seeds):
        calls.append(in_window[0])
        return sample(self, seeds)

    def flagged_timed(seconds, step):
        in_window[0] = True
        try:
            return timed(seconds, step)
        finally:
            in_window[0] = False

    monkeypatch.setattr(NeighborSampler, "sample", counted_sample)
    monkeypatch.setattr(common, "timed", flagged_timed)
    ctx = tiny_context("ogbn-products.sampled-step", seconds=1.0)
    record = replay.run(ctx)
    assert calls == [False] * ctx.traffic["pool"]
    # the window went round the pool more than once
    assert record["steps"] > ctx.traffic["pool"]
    assert record["batches_checked"] == ctx.traffic["pool"]
    assert record["remat"] is False


def test_one_seed_draws_the_same_pool(tiny_context):
    from gatv2_tpu_torch.data.sampling import NeighborSampler

    ctx = tiny_context("ogbn-products.sampled-step")
    graph, _ = common.inputs(ctx)
    tr = ctx.traffic

    def pool(seed):
        sampler = NeighborSampler(
            common.host_graph(graph), tr["batch_size"], tr["fanouts"],
            seed=seed, engine=tr["sampler_engine"], emit_tiles="pallas")
        return replay.draw_pool(sampler, tr["pool"])[0]

    a, b, c = pool(ctx.seed), pool(ctx.seed), pool(ctx.seed + 1)
    for x, y in zip(a, b, strict=True):
        assert x.num_edges == y.num_edges
        for key in ("node_ids", "src", "dst", "labels"):
            assert np.array_equal(getattr(x, key), getattr(y, key))
    assert not np.array_equal(a[0].node_ids, c[0].node_ids)


def test_batch_edges_by_hand():
    tr = {"batch_size": 1024, "fanouts": [10, 10, 10]}
    # 1024 * (10 + 100 + 1000) edges, under products' 123.7 M
    assert replay.batch_edges(tr, 123718280) == 1136640
    assert replay.batch_edges(tr, 5000) == 5000
