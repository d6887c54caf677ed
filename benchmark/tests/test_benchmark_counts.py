"""The copied FLOP count and the attention roofline's counts against
hand sums."""

import math

from benchmark import flops


def test_model_flops_by_hand():
    # N=10, E=30, F=5, C=3, heads (2, 1), dims (4, 3)
    # layer 0: zs, zd: 2 * 2*10*5*8 = 1600; edges 30*2*(24+10) = 2040
    # layer 1: 2 * 2*10*8*3 = 960; edges 30*1*(18+10) = 840
    # classifier 2*10*3*3 = 180; a step is 3x the forward
    want = 3 * (1600 + 2040 + 960 + 840 + 180)
    assert flops.model_flops(10, 30, 5, 3, (2, 1), (4, 3)) == want


def test_products_epoch_is_the_bench_count():
    """The port bench's products-full-4h epoch (OGB's 61.9 M undirected
    edges): 1,368.8 GFLOP, as the bench counts it."""
    got = flops.model_flops(2449029, 61859140, 100, 47, (4, 1, 1),
                            (64, 32, 16))
    assert math.isclose(got / 1e9, 1368.816, rel_tol=1e-6)


def test_attention_bytes_and_bound_by_hand():
    # N=100, E=1000, H*D=8: f32 (6*100*8 + 2*8) + i32 (1000 + 101)
    assert flops.attention_bytes(100, 1000, 8) == 4 * 4816 + 4 * 1101
    # layer 0 of products: bytes 15.30 GB over 3.35 TB/s = 4.57 ms
    # against 292.7 GFLOP over 67 TFLOP/s = 4.37 ms
    b = flops.attention_bound_s(2449029, 61859140, 4, 64)
    by_bytes = (4 * (6 * 2449029 * 256 + 512)
                + 4 * (61859140 + 2449030)) / 3.35e12
    by_ops = 3 * 61859140 * 4 * (6 * 64 + 10) / 67e12
    assert by_bytes > by_ops
    assert math.isclose(b, by_bytes)
    assert math.isclose(by_bytes * 1e3, 4.5684, rel_tol=1e-4)
