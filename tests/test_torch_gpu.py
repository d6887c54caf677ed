"""Card-only tests of the port: the CUDA kernels K1-K4 (SELL, also on
per-batch minibatch layouts) and K5-K8 (edge tiles) against their plain
twins, K2's and K6's launches without packets (chunked layouts) against
their launches with them, K5 with normalize=False and the merged-softmax
ops of the overlap layer, a model forward, a training step, the
multi-epoch runner (which must not wait for the device) and minibatch
steps (edge tiles and SELL) that go through them. They
carry the `gpu` marker and skip without a CUDA device. Run them on the
machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against the port's twin, which the CPU tests hold
against JAX.
"""

import copy
import dataclasses

import jax  # noqa: F401  (test files import both packages)
import numpy as np
import pytest
import torch

from gatv2_tpu_torch.config import ModelConfig, TrainConfig
from gatv2_tpu_torch.data.sampling import NeighborSampler
from gatv2_tpu_torch.data.synthetic import powerlaw_graph, random_graph
from gatv2_tpu_torch.models.gatv2 import init_params, model_forward
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.ops.pallas_bwd_dst import (
    pallas_bwd_dst,
    pallas_bwd_dst_plain,
)
from gatv2_tpu_torch.ops.pallas_bwd_src import (
    pallas_bwd_src,
    pallas_bwd_src_plain,
)
from gatv2_tpu_torch.ops.pallas_fwd import pallas_fwd, pallas_fwd_plain
from gatv2_tpu_torch.ops.pallas_segsum import pallas_segsum, pallas_segsum_plain
from gatv2_tpu_torch.ops.sell_bwd_dst import sell_bwd_dst, sell_bwd_dst_plain
from gatv2_tpu_torch.ops.sell_bwd_src import sell_bwd_src, sell_bwd_src_plain
from gatv2_tpu_torch.ops.sell_fwd import TILE_N, sell_fwd, sell_fwd_plain
from gatv2_tpu_torch.ops.sell_segsum import sell_segsum, sell_segsum_plain
from gatv2_tpu_torch.train import optim
from gatv2_tpu_torch.train.loop import Trainer
from gatv2_tpu_torch.train.minibatch import MinibatchTrainer
from test_torch_row_ranges import k7_mirror

SLOPE = 0.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _hub_and_isolated(n=260):
    rng = np.random.default_rng(7)
    deg = np.zeros(n, np.int64)
    deg[0] = 200
    deg[51:] = rng.integers(0, 4, size=n - 51)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return row_ptr, rng.integers(0, n, size=int(row_ptr[-1])), n


def _csr_of(deg, col):
    row_ptr = np.zeros(deg.size + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return row_ptr, col.astype(np.int32), deg.size


def _hubs(n=2000):
    """In-degree hubs beside short rows: node 0 has 12,000 in-edges, nodes
    1-3 have 257, 256 and 300 (around K5's split threshold), all in node
    tile 0; the rest 0-4."""
    rng = np.random.default_rng(12)
    deg = rng.integers(0, 5, size=n)
    deg[:4] = (12_000, 257, 256, 300)
    return _csr_of(deg, rng.integers(0, n, size=int(deg.sum())))


def _src_hubs(n=2000):
    """Out-degree hubs beside short rows: node 0 is the source of 12,000
    edges, nodes 1-3 of 256, 257 and 300 (around K8's split thresholds),
    all in source tile 0; the other edges are random among nodes 4.."""
    rng = np.random.default_rng(16)
    dst = [rng.integers(0, n, size=6 * n)]
    src = [rng.integers(4, n, size=6 * n)]
    for node, count in ((0, 12_000), (1, 256), (2, 257), (3, 300)):
        dst.append(rng.integers(0, n, size=count))
        src.append(np.full(count, node))
    dst, src = np.concatenate(dst), np.concatenate(src)
    order = np.argsort(dst, kind="stable")
    return _csr_of(np.bincount(dst, minlength=n), src[order])


def _fan_out(n=1000):
    """Node 0 is the source of 300 edges (one per destination 0..299), far
    longer than K4's ring of slots in flight; other edges are random."""
    rng = np.random.default_rng(13)
    deg = rng.integers(0, 6, size=n)
    deg[:300] += 1
    col = rng.integers(1, n, size=int(deg.sum()))
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    col[starts[:300]] = 0
    return _csr_of(deg, col)


def _sparse_src(n=600):
    """Only nodes 0..202 are sources: the SELL source side's last slices
    hold no edge at all, and its second slice ends mid-warp with rows
    without an edge."""
    rng = np.random.default_rng(14)
    deg = rng.integers(0, 9, size=n)
    return _csr_of(deg, rng.integers(0, 203, size=int(deg.sum())))


def _sparse_dst(n=600):
    """In-edges only into nodes 0..202: the SELL destination side's last
    slices hold no edge at all, and its second slice ends mid-warp with
    rows without an edge."""
    rng = np.random.default_rng(15)
    deg = np.zeros(n, np.int64)
    deg[:203] = rng.integers(0, 9, size=203)
    return _csr_of(deg, rng.integers(0, n, size=int(deg.sum())))


def _layout(case):
    if case == "uniform":
        g = random_graph(2000, 14000, 8, 3, seed=11)
    elif case == "zipf-split":
        g = powerlaw_graph(3000, 40000, 8, 3, seed=17)
    elif case == "isolated":
        return _hub_and_isolated()
    elif case == "hubs":
        return _hubs()
    elif case == "fan-out":
        return _fan_out()
    elif case == "src-hubs":
        return _src_hubs()
    elif case == "sparse-src":
        return _sparse_src()
    elif case == "sparse-dst":
        return _sparse_dst()
    else:  # zero-edge
        return np.zeros(11, np.int64), np.zeros(0, np.int32), 10
    return g.row_ptr, g.col_idx, g.num_nodes


LAYOUT_CASES = [
    ("uniform", 4, 64), ("uniform", 1, 32), ("uniform", 1, 16),
    ("uniform", 20, 8), ("zipf-split", 4, 64), ("zipf-split", 3, 24),
    ("isolated", 2, 16), ("zero-edge", 3, 24),
    # K1's and K2's lane groups: a width that is not a multiple of 4 (4-byte
    # loads), H*D = 512 in one head and in 32, split virtual rows
    # (normalize=False) of a 12,000-edge hub and rows of 256, 257 and 300
    # edges around the split cap, and 8 rows a warp over slices whose last
    # rows (and whole last slices) hold no edge
    ("uniform", 3, 7), ("uniform", 1, 512), ("uniform", 32, 16),
    ("hubs", 1, 16), ("hubs", 4, 64), ("hubs", 3, 7),
    ("sparse-dst", 1, 16), ("sparse-dst", 3, 7),
]


def _close_by_row(x, y, rtol=1e-5, atol=1e-5):
    """Within atol + rtol * the row's largest |y| (see chip_smoke)."""
    scale = y.abs().amax(dim=-1, keepdim=True)
    return bool(((x - y).abs() <= atol + rtol * scale).all())


def _close_f64(x, twin, ref64, factor=10.0, floor=1e-6):
    """x (a kernel's fp32 result) at most `factor` times further from the
    float64 evaluation ref64 than the fp32 twin is, or within `floor` times
    ref64's largest |value| (see chip_smoke's F64_FACTOR)."""
    e_x = float((x.double() - ref64).abs().max())
    e_twin = float((twin.double() - ref64).abs().max())
    return e_x <= max(factor * e_twin, floor * float(ref64.abs().max()))


def _real_slots(cnt):
    """[Ec] bool: the ELL slots that hold an edge (row < the column's cnt)."""
    lane = torch.arange(TILE_N, device=cnt.device)
    return (lane[None, :] < cnt[:, None].long()).reshape(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", LAYOUT_CASES)
def test_k1_kernel_matches_twin(cuda, case, h, d):
    row_ptr, col_idx, n = _layout(case)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n).to(cuda)
    rng = np.random.default_rng(4)
    zs, zd = (torch.from_numpy(rng.normal(size=(n, h * d)).astype(np.float32))
              .to(cuda) for _ in range(2))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    side = st.dst
    args = (zs, zd, a, side.perm, side.gather_ids, side.cnt, side.col_off)
    kw = dict(negative_slope=SLOPE, normalize=not side.split)
    before = sell_fwd.launches
    got = sell_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert sell_fwd.launches == before + 1
    for x, y in zip(got, sell_fwd_plain(*args, **kw)):
        assert _close_by_row(x, y)
    empty = torch.as_tensor(np.diff(row_ptr) == 0, device=cuda)
    out, _ = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                              sell_tiles=st)
    assert bool((out[empty] == 0).all())


@pytest.mark.gpu
def test_model_forward_uses_kernel(cuda):
    g = random_graph(1000, 6000, 16, 4, seed=1)
    config = ModelConfig(num_layers=2, heads=(4, 1), out_dims=(16, 8),
                         num_classes=4, in_dim=16)
    model = init_params(config, torch.Generator().manual_seed(0))
    st, feats, _, _ = tsa.setup_full_graph_sell(g, (4, 1), (16, 8),
                                                device=cuda)
    before = sell_fwd.launches
    with torch.inference_mode():
        got = model_forward(model, feats, None, None, config, impl="sell",
                            edge_tiles=st, device=cuda)[: g.num_nodes]
        want = model_forward(model, g.features, g.src, g.dst, config,
                             impl="torch", device=cuda)
    assert sell_fwd.launches - before == 2
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _bwd_inputs(cuda, case, h, d):
    """A layout on the card and K2's inputs: random zs, zd, g, a; sigma
    and r as the op computes them from K1's forward."""
    row_ptr, col_idx, n = _layout(case)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n).to(cuda)
    rng = np.random.default_rng(5)
    zs, zd, g = (torch.from_numpy(rng.normal(size=(n, h * d))
                                  .astype(np.float32)).to(cuda)
                 for _ in range(3))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    out, sigma = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                                  sell_tiles=st)
    r = (g * out).view(n, h, d).sum(-1)
    return st, (zs, zd, g, sigma, r, a)


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", LAYOUT_CASES)
def test_k2_k3_kernels_match_twins(cuda, case, h, d):
    st, tensors = _bwd_inputs(cuda, case, h, d)
    side = st.dst
    args = (*tensors, side.perm, side.gather_ids, side.cnt, side.col_off)
    before = (sell_bwd_dst.launches, sell_segsum.launches)
    dzd, da, c1 = sell_bwd_dst(*args, negative_slope=SLOPE)
    torch.cuda.synchronize()
    w_dzd, w_da, w_c1 = sell_bwd_dst_plain(*args, negative_slope=SLOPE)
    w64 = sell_bwd_dst_plain(*(t.double() for t in args[:6]), *args[6:],
                             negative_slope=SLOPE)
    real = _real_slots(side.cnt)
    # c1 is per edge, like K1's output. dzd and d_a sum terms
    # de = alpha * (dalpha - r) that cancel (over a node's edges sum(de) = 0
    # per head), so their fp32 rounding can be as large as the result: they
    # are held against float64, as chip_smoke holds them. So is c1 in one
    # head of 512: its de carries the rounding of two 512-term fp32 dot
    # products (dalpha and r) that cancel, which the row rule does not allow
    if d == 512:
        assert _close_f64(c1[real], w_c1[real], w64[2][real])
    else:
        assert _close_by_row(c1[real], w_c1[real])
    assert _close_f64(dzd, w_dzd, w64[0])
    assert _close_f64(da, w_da, w64[1])
    # K3 skips padding slots by count: NaN there must not reach dzs
    c1[~real] = float("nan")
    k3_args = (c1, st.ell_perm, st.srcs.cnt, st.srcs.col_off)
    dzs = sell_segsum(*k3_args)
    torch.cuda.synchronize()
    assert (sell_bwd_dst.launches, sell_segsum.launches) == (
        before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(dzs).all())
    assert _close_f64(dzs, sell_segsum_plain(*k3_args),
                      sell_segsum_plain(c1.double(), *k3_args[1:]))


@pytest.mark.gpu
def test_sell_training_step_matches_torch_path(cuda):
    """One SGD step with clipping through K1-K3 against the torch path,
    from the same weights: loss and updated weights. (SGD moves each weight
    by lr * its gradient; Adam's first step moves it by about lr * the
    gradient's sign, which flips on gradients near 0.)"""
    g = random_graph(1500, 9000, 16, 4, seed=3)
    mc = ModelConfig(num_layers=2, heads=(4, 1), out_dims=(16, 8),
                     num_classes=g.num_classes, in_dim=g.feature_dim)
    tc = dict(epochs=1, optimizer="sgd", lr=0.5, clip=True, seed=0)
    start = init_params(mc, torch.Generator().manual_seed(2))
    counters = (sell_fwd, sell_bwd_dst, sell_segsum)
    before = [k.launches for k in counters]
    runs = {}
    for impl in ("sell", "torch"):
        tr = Trainer(g, mc, TrainConfig(impl=impl, **tc), log_fn=lambda _: None,
                     device=cuda)
        tr.params = copy.deepcopy(start)
        runs[impl] = (tr.run()["loss"], optim.param_leaves(tr.params))
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(counters, before)]
    assert launched == [2, 2, 2]  # one launch per layer each
    assert abs(runs["sell"][0] - runs["torch"][0]) < 1e-5
    for p, q in zip(runs["sell"][1], runs["torch"][1]):
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_remat_launches_k1_once_on_a_chunked_layout(cuda):
    """One step's gradients on a 5-chunk SELL layout with remat on and
    off, from the same weights: K1, K2 and K4 launch as often in both (the
    recompute takes the forward's result: `reused` counts one per layer
    and head group), and the gradients are equal bit for bit."""
    from gatv2_tpu_torch.models.gatv2 import loss_fn

    g = random_graph(1500, 9000, 16, 4, seed=3)
    mc = ModelConfig(num_layers=2, heads=(4, 1), out_dims=(16, 8),
                     num_classes=g.num_classes, in_dim=g.feature_dim)
    st, feats, labels, num_valid = tsa.setup_full_graph_sell(
        g, mc.heads, mc.out_dims, device=cuda, budget_bytes=1 << 21)
    assert st.num_chunks == 5
    st = st.to(cuda)
    feats, labels = (torch.as_tensor(x, device=cuda) for x in (feats, labels))
    model = init_params(mc, torch.Generator().manual_seed(2)).to(cuda)

    def counts():
        return [sell_fwd.launches, sell_bwd_dst.launches,
                sell_bwd_src.launches, tsa.sell_attention.reused]

    launched, grads = [], []
    for remat in (False, True):
        before = counts()
        loss, _ = loss_fn(model, feats, None, None, labels,
                          dataclasses.replace(mc, remat=remat), impl="sell",
                          edge_tiles=st, num_valid=num_valid)
        grads.append(torch.autograd.grad(loss, optim.param_leaves(model)))
        launched.append([n - b for n, b in zip(counts(), before)])
    # per layer: K1 and K2 once per chunk, K4 once per chunk; one group
    assert launched[0] == [10, 10, 10, 0]
    assert launched[1] == [10, 10, 10, 2]
    for p, q in zip(*grads):
        assert torch.equal(p, q)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["sell", "pallas"])
def test_runner_does_not_block_the_host(cuda, impl):
    """3 epochs of make_multi_epoch_runner (Adam with clipping) through
    K1-K3 (sell) or K5-K7 (pallas) under torch.cuda.set_sync_debug_mode
    ("error"), which raises at any wait for the device; their losses,
    accuracies and weights against 3 Trainer.step calls from the same
    start (the same body on the same card: bit for bit), and each kernel's
    launches three times one epoch's."""
    from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

    g = random_graph(1500, 9000, 16, 4, seed=3)
    mc = ModelConfig(num_layers=2, heads=(4, 1), out_dims=(16, 8),
                     num_classes=g.num_classes, in_dim=g.feature_dim)
    tc = TrainConfig(epochs=3, optimizer="adam", lr=0.01, clip=True, seed=0,
                     impl=impl)
    tr = Trainer(g, mc, tc, log_fn=lambda _: None, device=cuda)
    tr.params = init_params(mc, torch.Generator().manual_seed(2))
    params, opt = copy.deepcopy(tr.params), copy.deepcopy(tr.opt_state)
    run = make_multi_epoch_runner(mc, tc, 3, edge_tiles=tr.edge_tiles,
                                  num_valid=tr.num_valid)
    counters = ((sell_fwd, sell_bwd_dst, sell_segsum) if impl == "sell"
                else (pallas_fwd, pallas_bwd_dst, pallas_segsum))
    run(copy.deepcopy(params), copy.deepcopy(opt), 0, tr.features, tr.src,
        tr.dst, tr.labels)  # the kernels' first launches build them
    torch.cuda.synchronize()
    before = [k.launches for k in counters]
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, losses, accs = run(params, opt, 0, tr.features, tr.src, tr.dst,
                                 tr.labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = [k.launches - b for k, b in zip(counters, before)]
    assert launched == [6, 6, 6]  # one launch per layer and epoch each
    want = []
    for _ in range(3):
        tr.epoch += 1
        want.append(tr.step())
    assert losses.tolist() == [l for l, _ in want]
    assert accs.tolist() == [a for _, a in want]
    for p, q in zip(optim.param_leaves(params), optim.param_leaves(tr.params)):
        assert torch.equal(p, q)


PALLAS_CASES = [
    ("uniform", 4, 64), ("uniform", 16, 8), ("uniform", 1, 16),
    ("zipf-split", 2, 24), ("isolated", 4, 16), ("minibatch", 3, 16),
    ("zero-edge", 2, 8),
    # K5's lane groups and split hub rows: a width that is not a multiple
    # of 4, H*D = 512, 8 rows a warp over tiles without an edge, rows of
    # 256, 257, 300 and 12,000 in-edges (longer than the ring of edges in
    # flight, and split over the block)
    ("uniform", 3, 7), ("uniform", 8, 64), ("minibatch", 1, 16),
    ("hubs", 1, 16), ("hubs", 4, 64), ("hubs", 3, 7),
]


def _pallas_layout(case):
    """(EdgeTiles, row_ptr): the graphs of LAYOUT_CASES, or a sampled
    batch's fixed-budget layout with node tiles that hold no edge."""
    if case == "minibatch":
        rng = np.random.default_rng(8)
        dst = np.sort(rng.integers(0, 180, size=900)).astype(np.int32)
        src = rng.integers(0, 290, size=900).astype(np.int32)
        row_ptr = np.zeros(641, np.int64)
        np.cumsum(np.bincount(dst, minlength=640), out=row_ptr[1:])
        return tpa.prepare_edge_tiles(row_ptr, src, 640, tile_e=128,
                                      fixed_edge_tiles=30), row_ptr
    row_ptr, col_idx, n = _layout(case)
    return tpa.prepare_edge_tiles(row_ptr, col_idx, n), row_ptr


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", PALLAS_CASES)
def test_k5_k6_k7_kernels_match_twins(cuda, case, h, d):
    et_host, row_ptr = _pallas_layout(case)
    et = et_host.to(cuda)
    n = et.num_nodes
    rng = np.random.default_rng(6)
    zs, zd, g = (torch.from_numpy(rng.normal(size=(n, h * d))
                                  .astype(np.float32)).to(cuda)
                 for _ in range(3))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    side = et.dst_side
    lay = (side.ids_grp[0], side.other_grp[0], side.rel_offsets[0],
           et.tile_e)
    before = [k.launches for k in (pallas_fwd, pallas_bwd_dst, pallas_segsum)]
    out, m, l = pallas_fwd(zs, zd, a, *lay, negative_slope=SLOPE)
    torch.cuda.synchronize()
    w_out, w_m, w_l = pallas_fwd_plain(zs, zd, a, *lay, negative_slope=SLOPE)
    # out and l sum one term per in-edge, thousands on a hub row, which the
    # twin adds with index_add_ in any order: held against float64
    w64 = pallas_fwd_plain(zs.double(), zd.double(), a.double(), *lay,
                           negative_slope=SLOPE)
    assert _close_by_row(m, w_m)
    assert _close_f64(out, w_out, w64[0])
    assert _close_f64(l, w_l, w64[2])
    no_in = torch.as_tensor(np.diff(row_ptr) == 0, device=cuda)
    assert bool((out[:n][no_in] == 0).all())
    assert bool((l[:n][no_in] == 0).all())
    # K6 on the op's backward stats: sigma = m + log(l + 1e-8), r = <g, out>
    r = (g * out[:n]).view(n, h, d).sum(-1)
    sr = tpa.sigma_r_table(m + torch.log(l + 1e-8), r)
    args = (zs, zd, g, sr, a, *lay)
    dzd, da, c1 = pallas_bwd_dst(*args, negative_slope=SLOPE)
    torch.cuda.synchronize()
    w_dzd, w_da, w_c1 = pallas_bwd_dst_plain(*args, negative_slope=SLOPE)
    w64 = pallas_bwd_dst_plain(*(t.double() for t in args[:5]), *lay,
                               negative_slope=SLOPE)
    real = side.ids_grp[0] < et.tiles_per_chunk * TILE_N
    assert _close_by_row(c1[real], w_c1[real])
    assert _close_f64(dzd, w_dzd, w64[0])
    assert _close_f64(da, w_da, w64[1])
    # K7 skips padding entries by id: NaN there must not reach dzs
    c1[~real] = float("nan")
    k7_args = (c1, et.gather_perm, et.src_sorted_ids, et.src_tile_offsets,
               et.tile_e)
    dzs = pallas_segsum(*k7_args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dzs).all())
    assert _close_f64(dzs, pallas_segsum_plain(*k7_args),
                      pallas_segsum_plain(c1.double(), *k7_args[1:]))
    launched = [k.launches - b for k, b in
                zip((pallas_fwd, pallas_bwd_dst, pallas_segsum), before)]
    assert launched == [1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", [
    ("src-hubs", 1, 16), ("src-hubs", 4, 64), ("src-hubs", 3, 7),
    ("src-hubs", 2, 256), ("uniform", 1, 512),
])
def test_k7_kernel_matches_twin_on_source_hubs(cuda, case, h, d):
    """K7 on an unchunked layout with sources of 12,000, 256, 257 and 300
    out-edges (split over the block and over segment blocks) and H*D up to
    512, on seeded packets with NaN in the padding slots K6 leaves
    unwritten: against its twin and float64, equal bit for bit to a second
    launch and to the numpy mirror of its summation order
    (tests/test_torch_row_ranges.py); rows without an out-edge give 0."""
    row_ptr, col_idx, n = _layout(case)
    et = tpa.prepare_edge_tiles(row_ptr, col_idx, n)
    rng = np.random.default_rng(10)
    c1 = rng.standard_normal((et.dst_side.ids_grp[0].size, h * d),
                             dtype=np.float32)
    c1[et.dst_side.ids_grp[0] >= et.tiles_per_chunk * TILE_N] = np.nan
    lay = (et.gather_perm, et.src_sorted_ids, et.src_tile_offsets)
    args = (torch.as_tensor(c1, device=cuda),
            *(torch.as_tensor(x, device=cuda) for x in lay), et.tile_e)
    before = pallas_segsum.launches
    dzs = pallas_segsum(*args)
    again = pallas_segsum(*args)
    torch.cuda.synchronize()
    assert pallas_segsum.launches == before + 2
    assert torch.equal(dzs, again)
    assert bool(torch.isfinite(dzs).all())
    assert _close_f64(dzs, pallas_segsum_plain(*args),
                      pallas_segsum_plain(args[0].double(), *args[1:]))
    assert np.array_equal(dzs.cpu().numpy(),
                          k7_mirror(c1, *lay, et.tile_e))
    no_out = np.bincount(col_idx, minlength=dzs.shape[0]) == 0
    assert bool((dzs[torch.as_tensor(no_out, device=cuda)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", [
    ("uniform", 1, 512), ("hubs", 1, 512), ("hubs", 2, 256),
])
def test_k5_wide_heads_match_twin(cuda, case, h, d):
    """K5 at H*D = 512 in one or two heads (16 vectors of 4 a lane, 32
    lanes a head), a split hub row included, against its twin and float64;
    then K6 there, with its c1 held to float64 too (a 512-term fp32 dot
    product misses the row rule that test_k5_k6_k7_kernels_match_twins
    holds c1 to at H*D = 512 in 8 heads)."""
    et_host, row_ptr = _pallas_layout(case)
    et = et_host.to(cuda)
    n = et.num_nodes
    rng = np.random.default_rng(9)
    zs, zd = (torch.from_numpy(rng.normal(size=(n, h * d))
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    side = et.dst_side
    lay = (side.ids_grp[0], side.other_grp[0], side.rel_offsets[0],
           et.tile_e)
    before = pallas_fwd.launches
    out, m, l = pallas_fwd(zs, zd, a, *lay, negative_slope=SLOPE)
    torch.cuda.synchronize()
    assert pallas_fwd.launches == before + 1
    w_out, w_m, w_l = pallas_fwd_plain(zs, zd, a, *lay, negative_slope=SLOPE)
    w64 = pallas_fwd_plain(zs.double(), zd.double(), a.double(), *lay,
                           negative_slope=SLOPE)
    assert _close_by_row(m, w_m)
    assert _close_f64(out, w_out, w64[0])
    assert _close_f64(l, w_l, w64[2])
    no_in = torch.as_tensor(np.diff(row_ptr) == 0, device=cuda)
    assert bool((out[:n][no_in] == 0).all())
    assert bool((l[:n][no_in] == 0).all())
    g = torch.from_numpy(rng.normal(size=(n, h * d)).astype(np.float32)).to(
        cuda)
    r = (g * out[:n]).view(n, h, d).sum(-1)
    sr = tpa.sigma_r_table(m + torch.log(l + 1e-8), r)
    args = (zs, zd, g, sr, a, *lay)
    before = pallas_bwd_dst.launches
    dzd, da, c1 = pallas_bwd_dst(*args, negative_slope=SLOPE)
    torch.cuda.synchronize()
    assert pallas_bwd_dst.launches == before + 1
    w_dzd, w_da, w_c1 = pallas_bwd_dst_plain(*args, negative_slope=SLOPE)
    w64 = pallas_bwd_dst_plain(*(t.double() for t in args[:5]), *lay,
                               negative_slope=SLOPE)
    real = side.ids_grp[0] < et.tiles_per_chunk * TILE_N
    assert _close_f64(c1[real], w_c1[real], w64[2][real])
    assert _close_f64(dzd, w_dzd, w64[0])
    assert _close_f64(da, w_da, w64[1])


@pytest.mark.gpu
def test_pallas_op_head_groups_match_cpu(cuda):
    """20 heads run as two launches of <= 16 heads: the op's output and
    gradients on the card against the op on the CPU (the twins)."""
    et, _ = _pallas_layout("uniform")
    n, h, d = et.num_nodes, 20, 8
    rng = np.random.default_rng(2)
    zs, zd, w = (rng.normal(size=(n, h * d)).astype(np.float32)
                 for _ in range(3))
    a = rng.normal(size=(h, d)).astype(np.float32)
    res = []
    for where in (cuda, torch.device("cpu")):
        x = [torch.as_tensor(v, device=where).requires_grad_()
             for v in (zs, zd, a)]
        out = tpa.edge_attention_pallas(*x, n, negative_slope=SLOPE,
                                        edge_tiles=et.to(where))
        (out * torch.as_tensor(w, device=where)).sum().backward()
        res.append([out.detach().cpu()] + [v.grad.cpu() for v in x])
    assert _close_by_row(res[0][0], res[1][0])
    for got, want in zip(res[0][1:], res[1][1:]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


def _minibatch_steps_against_torch(cuda, impl, counters):
    """Two SGD minibatch steps through `impl`'s kernels against
    impl='torch' on the same batches from the same weights, with the
    launches counted (one of each kernel per layer and step)."""
    g = random_graph(3000, 24000, 16, 4, seed=9)
    mc = ModelConfig(num_layers=2, heads=(4, 1), out_dims=(16, 8),
                     num_classes=g.num_classes, in_dim=g.feature_dim)
    start = init_params(mc, torch.Generator().manual_seed(4))
    losses = {}
    for run in (impl, "torch"):
        tc = TrainConfig(epochs=1, optimizer="sgd", lr=0.5, clip=True, seed=0,
                         batch_size=256, fanouts=(5, 5), impl=run)
        tr = MinibatchTrainer(g, mc, tc, log_fn=lambda _: None, device=cuda)
        tr.params = copy.deepcopy(start)
        batches = iter(tr.sampler)
        before = [k.launches for k in counters]
        losses[run] = [tr.train_step(next(batches))[0] for _ in range(2)]
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(counters, before)]
        assert launched == ([4, 4, 4] if run == impl else [0, 0, 0])
    np.testing.assert_allclose(losses[impl], losses["torch"], rtol=1e-5)


@pytest.mark.gpu
def test_minibatch_step_matches_torch_path(cuda):
    """Two SGD minibatch steps through K5-K7 against impl='torch'."""
    _minibatch_steps_against_torch(
        cuda, "pallas", (pallas_fwd, pallas_bwd_dst, pallas_segsum))


@pytest.mark.gpu
def test_sell_minibatch_step_matches_torch_path(cuda):
    """Two SGD minibatch steps through K1-K3 on per-batch SELL layouts
    against impl='torch'."""
    _minibatch_steps_against_torch(
        cuda, "sell", (sell_fwd, sell_bwd_dst, sell_segsum))


def _minibatch_sell_layout(case):
    """(SellTiles, node count) of a per-batch SELL layout: both sides
    split, the fixed geometry's tail columns and empty slices. 'sampled':
    a sampled batch; 'hub', 'flat', 'zero-edge': the JAX package's
    adversarial batches (tests/test_minibatch_sell.py); 'src-hub': a
    batch whose source 0 has 600 out-edges (three virtual source rows,
    the last with 88) beside random edges."""
    if case == "sampled":
        s = NeighborSampler(random_graph(3000, 24000, 8, 3, seed=9), 256,
                            (5, 5), seed=0, engine="python",
                            emit_tiles="sell")
        return next(iter(s)).tiles, s.max_nodes
    n, e = (1024, 2048) if case == "src-hub" else (256, 512)
    fixed = tsa.sell_minibatch_geometry(n, e)
    if case == "hub":
        src, dst, num = np.arange(e) % n, np.zeros(e), e
    elif case == "flat":
        src, dst, num = np.zeros(e), np.sort(np.arange(e) % n), e
    elif case == "zero-edge":
        src, dst, num = np.zeros(e), np.full(e, n), 0
    else:
        rng = np.random.default_rng(21)
        src = np.concatenate([np.zeros(600), rng.integers(1, n, e - 600)])
        dst = rng.integers(0, n, e)
        order = np.argsort(dst, kind="stable")
        src, dst, num = src[order], dst[order], e
    st = tsa.prepare_minibatch_sell_tiles(
        src.astype(np.int32), dst.astype(np.int32), num, n, fixed)
    return st, n


MINIBATCH_SELL_CASES = [
    ("sampled", 4, 64), ("sampled", 1, 16), ("hub", 2, 16), ("flat", 1, 16),
    ("zero-edge", 3, 24), ("src-hub", 4, 16), ("src-hub", 1, 32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", MINIBATCH_SELL_CASES)
def test_k1_k2_k3_on_minibatch_sell_layouts(cuda, case, h, d):
    """K1, K2 (with packets) and K3 on forced-split fixed layouts against
    their twins, the cancelling sums and K3 against float64; K3 never
    reads a padding packet (poisoned with NaN), also past col_off[-1]."""
    st_host, n = _minibatch_sell_layout(case)
    st = st_host.to(cuda)
    assert st.dst.split and st.srcs.split and st.num_edges == -1
    rng = np.random.default_rng(6)
    zs, zd, g = (torch.from_numpy(rng.normal(size=(n, h * d))
                                  .astype(np.float32)).to(cuda)
                 for _ in range(3))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    side = st.dst
    lay = (side.perm, side.gather_ids, side.cnt, side.col_off)
    kw = dict(negative_slope=SLOPE, normalize=False)
    before = [k.launches for k in (sell_fwd, sell_bwd_dst, sell_segsum)]
    got = sell_fwd(zs, zd, a, *lay, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, sell_fwd_plain(zs, zd, a, *lay, **kw)):
        assert _close_by_row(x, y)
    out, sigma = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                                  sell_tiles=st)
    r = (g * out).view(n, h, d).sum(-1)
    args = (zs, zd, g, sigma, r, a, *lay)
    dzd, da, c1 = sell_bwd_dst(*args, negative_slope=SLOPE)
    torch.cuda.synchronize()
    w_dzd, w_da, w_c1 = sell_bwd_dst_plain(*args, negative_slope=SLOPE)
    w64 = sell_bwd_dst_plain(*(t.double() for t in args[:6]), *args[6:],
                             negative_slope=SLOPE)
    real = _real_slots(side.cnt)
    assert c1.shape[0] == st.e_ell  # the fixed tail included
    assert _close_by_row(c1[real], w_c1[real])
    assert _close_f64(dzd, w_dzd, w64[0])
    assert _close_f64(da, w_da, w64[1])
    c1[~real] = float("nan")
    k3_args = (c1, st.ell_perm, st.srcs.cnt, st.srcs.col_off)
    dzs = sell_segsum(*k3_args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dzs).all())
    assert _close_f64(dzs, sell_segsum_plain(*k3_args),
                      sell_segsum_plain(c1.double(), *k3_args[1:]))
    launched = [k.launches - b for k, b in
                zip((sell_fwd, sell_bwd_dst, sell_segsum), before)]
    assert launched == [2, 1, 1]  # K1 once more inside sell_forward


CHUNKED_CASES = [
    ("uniform", 4, 64), ("uniform", 1, 16), ("uniform", 20, 8),
    ("zipf-split", 3, 24), ("isolated", 2, 16), ("zero-edge", 3, 24),
    # K4's lane groups: a width that is not a multiple of 4, H*D = 512 in
    # one head and in 32, a source row of 300 out-edges (longer than the
    # ring of slots in flight), 8 rows a warp over slices whose last rows
    # (and whole last slices) hold no edge
    ("uniform", 3, 7), ("uniform", 1, 512), ("uniform", 32, 16),
    ("fan-out", 1, 16), ("fan-out", 2, 64), ("sparse-src", 1, 16),
    ("sparse-src", 3, 7),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", CHUNKED_CASES)
def test_k4_kernel_matches_twin_and_k2_without_packets(cuda, case, h, d):
    """On a 3-chunk layout: K4 on every src chunk against its twin, held
    against float64 (dzs sums packets whose terms cancel); K2 on every dst
    chunk without packets gives dzd and d_a equal to its launch with
    them."""
    row_ptr, col_idx, n = _layout(case)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=3).to(cuda)
    rng = np.random.default_rng(7)
    zs, zd, g = (torch.from_numpy(rng.normal(size=(n, h * d))
                                  .astype(np.float32)).to(cuda)
                 for _ in range(3))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    out, sigma = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                                  sell_tiles=st)
    r = (g * out).view(n, h, d).sum(-1)
    tables = (zs, zd, g, sigma, r, a)

    def chunk(side, spc, c):
        rows_c = spc * TILE_N
        return (side.perm[c * rows_c: (c + 1) * rows_c], side.ids_grp[c],
                side.cnt_grp[c], side.rel_off[c])

    before = (sell_bwd_dst.launches, sell_bwd_src.launches)
    for c in range(3):
        lay = chunk(st.dst, st.spc_dst, c)
        dzd, da, c1 = sell_bwd_dst(*tables, *lay, negative_slope=SLOPE)
        dzd0, da0, none = sell_bwd_dst(*tables, *lay, negative_slope=SLOPE,
                                       emit_c1=False)
        torch.cuda.synchronize()
        assert none is None and c1 is not None
        assert torch.equal(dzd0, dzd) and torch.equal(da0, da)
        lay = chunk(st.srcs, st.spc_src, c)
        dzs = sell_bwd_src(*tables, *lay, negative_slope=SLOPE)
        torch.cuda.synchronize()
        w64 = sell_bwd_src_plain(*(t.double() for t in tables), *lay,
                                 negative_slope=SLOPE)
        assert _close_f64(dzs, sell_bwd_src_plain(
            *tables, *lay, negative_slope=SLOPE), w64)
    assert (sell_bwd_dst.launches, sell_bwd_src.launches) == (
        before[0] + 6, before[1] + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", [
    ("uniform", 4, 64), ("uniform", 16, 8), ("uniform", 1, 16),
    ("zipf-split", 2, 24), ("isolated", 4, 16), ("zero-edge", 2, 8),
    # K6's and K8's lane groups and hub splits: a width that is not a
    # multiple of 4, H*D = 512, a source of 12,000 edges and sources of
    # 256, 257 and 300 (K8), a destination of 12,000 edges and destinations
    # of 256, 257 and 300 (K6), split over the block or over segments
    ("uniform", 3, 7), ("uniform", 1, 512), ("src-hubs", 1, 16),
    ("src-hubs", 4, 64), ("src-hubs", 3, 7), ("src-hubs", 2, 256),
    ("hubs", 1, 16), ("hubs", 3, 7), ("hubs", 8, 64),
])
def test_k8_kernel_matches_twin_and_k6_without_packets(cuda, case, h, d):
    """On a 3-chunk edge-tile layout: K8 on every src chunk against its
    twin, held against float64; K6 on every dst chunk without packets
    gives dzd and d_a equal to its launch with them, and its c1 matches
    its twin on the real slots (held to float64 at H*D = 512, where a
    512-term fp32 dot product misses the row rule)."""
    row_ptr, col_idx, n = _layout(case)
    et = tpa.prepare_edge_tiles(row_ptr, col_idx, n,
                                num_chunks=3).to(cuda)
    rng = np.random.default_rng(8)
    zs, zd, g = (torch.from_numpy(rng.normal(size=(n, h * d))
                                  .astype(np.float32)).to(cuda)
                 for _ in range(3))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    out, m, l = tpa.pallas_forward(zs, zd, a, et, n, SLOPE)
    r = (g * out).view(n, h, d).sum(-1)
    sr = tpa.sigma_r_table(m + torch.log(l + 1e-8), r)
    before = (pallas_bwd_dst.launches, pallas_bwd_src.launches)
    rows_c = et.tiles_per_chunk * TILE_N
    rows_cs = et.padded_src_nodes // et.num_chunks
    for c in range(et.num_chunks):
        side = et.dst_side
        lo = c * rows_c
        args = (zs, zd[lo:], g[lo:], sr[lo:], a, side.ids_grp[c],
                side.other_grp[c], side.rel_offsets[c], et.tile_e)
        dzd, da, c1 = pallas_bwd_dst(*args, negative_slope=SLOPE)
        dzd0, da0, none = pallas_bwd_dst(*args, negative_slope=SLOPE,
                                         emit_c1=False)
        torch.cuda.synchronize()
        assert none is None and c1 is not None
        assert torch.equal(dzd0, dzd) and torch.equal(da0, da)
        w_dzd, w_da, w_c1 = pallas_bwd_dst_plain(*args, negative_slope=SLOPE)
        w64 = pallas_bwd_dst_plain(*(t.double() for t in args[:5]),
                                   *args[5:], negative_slope=SLOPE)
        real = side.ids_grp[c] < rows_c
        if h * d == 512:
            assert _close_f64(c1[real], w_c1[real], w64[2][real])
        else:
            assert _close_by_row(c1[real], w_c1[real])
        assert _close_f64(dzd, w_dzd, w64[0])
        assert _close_f64(da, w_da, w64[1])
        side = et.src_side
        lay = (side.ids_grp[c], side.other_grp[c], side.rel_offsets[c],
               et.tile_e)
        tables = (zs[c * rows_cs:], zd, g, sr, a)
        dzs = pallas_bwd_src(*tables, *lay, negative_slope=SLOPE)
        torch.cuda.synchronize()
        w64 = pallas_bwd_src_plain(*(t.double() for t in tables), *lay,
                                   negative_slope=SLOPE)
        assert _close_f64(dzs, pallas_bwd_src_plain(
            *tables, *lay, negative_slope=SLOPE), w64)
    k = et.num_chunks
    assert (pallas_bwd_dst.launches, pallas_bwd_src.launches) == (
        before[0] + 2 * k, before[1] + k)


@pytest.mark.gpu
@pytest.mark.parametrize("case,h,d", [
    ("uniform", 4, 64), ("hubs", 1, 16), ("hubs", 4, 64), ("isolated", 3, 7),
    ("minibatch", 1, 16),
])
def test_k5_unnormalised_matches_twin(cuda, case, h, d):
    """K5 with normalize=False (each pass of edge_attention_pallas_merge):
    the raw accumulator, m and l against its twin and float64, hub rows
    split over the block merged before the skipped division; rows without
    an in-edge give 0, -1e30, 0; dividing the raw accumulator by l + 1e-8
    gives the normalize=True launch."""
    et_host, row_ptr = _pallas_layout(case)
    et = et_host.to(cuda)
    n = et.num_nodes
    rng = np.random.default_rng(13)
    zs, zd = (torch.from_numpy(rng.normal(size=(n, h * d))
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    side = et.dst_side
    lay = (side.ids_grp[0], side.other_grp[0], side.rel_offsets[0],
           et.tile_e)
    before = (pallas_fwd.launches, pallas_fwd.raw_launches)
    u, m, l = pallas_fwd(zs, zd, a, *lay, negative_slope=SLOPE,
                         normalize=False)
    out, _, _ = pallas_fwd(zs, zd, a, *lay, negative_slope=SLOPE)
    torch.cuda.synchronize()
    assert (pallas_fwd.launches, pallas_fwd.raw_launches) == (
        before[0] + 2, before[1] + 1)
    w_u, w_m, w_l = pallas_fwd_plain(zs, zd, a, *lay, negative_slope=SLOPE,
                                     normalize=False)
    w64 = pallas_fwd_plain(zs.double(), zd.double(), a.double(), *lay,
                           negative_slope=SLOPE, normalize=False)
    assert _close_by_row(m, w_m)
    assert _close_f64(u, w_u, w64[0])
    assert _close_f64(l, w_l, w64[2])
    no_in = torch.as_tensor(np.diff(row_ptr) == 0, device=cuda)
    assert bool((u[:n][no_in] == 0).all())
    assert bool((m[:n][no_in] == -1e30).all())
    assert bool((l[:n][no_in] == 0).all())
    assert _close_by_row(out, u / (l.repeat_interleave(d, 1) + 1e-8))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sell", "pallas"])
def test_merge_ops_on_the_card_match_the_cpu(cuda, kind):
    """sell_attention_merge / edge_attention_pallas_merge on the card (K1
    or K5 with normalize=False per pass, K2 + K3 or K6 + K7 per pass in the
    backward) against the same op on the CPU (the twins, which the CPU
    tests hold to JAX): output and the gradients of every input."""
    from test_torch_merge import _inputs, _layouts, _passes

    n, m = 300, 90
    passes = _passes(n, m, seed=4)
    inputs = _inputs(n, m, 4, 8, seed=4)
    lay = _layouts(kind, passes, n, tsa if kind == "sell" else tpa)
    op = (tsa.sell_attention_merge if kind == "sell"
          else tpa.edge_attention_pallas_merge)
    key = "sell_tiles_parts" if kind == "sell" else "edge_tiles_parts"
    fwd = sell_fwd if kind == "sell" else pallas_fwd

    def run(dev):
        x = [torch.tensor(v, device=dev, requires_grad=True)
             for v in inputs[:4]]
        layouts = [t.to(dev) for t in lay]
        out = op(x[:2], x[2], x[3], n, negative_slope=SLOPE,
                 **{key: layouts})
        torch.sin(out + torch.as_tensor(inputs[4], device=dev)).sum() \
            .backward()
        return [out.detach().cpu()] + [v.grad.cpu() for v in x]

    before = fwd.raw_launches
    got = run(cuda)
    assert fwd.raw_launches == before + 2  # one unnormalised pass each
    want = run(torch.device("cpu"))
    for name, g, w in zip(("out", "dzs_loc", "dzs_halo", "dzd", "da"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


EDGE_CASES = [
    # the edge-feature variants of K1, K2 and K4: the ogbn-proteins width
    # (6 heads of 80, 5 vectors a lane), a narrow width, 4-byte loads (a
    # width that is not a multiple of 4), split rows, no edges at all, and
    # rows without an edge beside a hub
    ("uniform", 6, 80), ("uniform", 4, 12), ("uniform", 3, 7),
    ("zipf-split", 2, 24), ("zero-edge", 2, 8), ("isolated", 6, 80),
]


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("case,h,d", EDGE_CASES)
def test_edge_feature_kernels_match_twins(cuda, case, h, d, chunks):
    """With 8-dim edge features, on one and on 3 chunks: K1 per dst chunk,
    K2 per dst chunk (with packets unchunked, and its dW_e partials added
    over the chunks) and K4 per src chunk against their twins, each held
    against float64."""
    row_ptr, col_idx, n = _layout(case)
    rng = np.random.default_rng(9)
    e, k = len(col_idx), 8
    ef = rng.normal(size=(e, k)).astype(np.float32)
    st = tsa.prepare_sell_tiles(row_ptr, col_idx, n, num_chunks=chunks,
                                edge_features=ef).to(cuda)
    zs, zd, g = (torch.from_numpy(rng.normal(size=(n, h * d))
                                  .astype(np.float32)).to(cuda)
                 for _ in range(3))
    a = torch.from_numpy(rng.normal(size=(h, d)).astype(np.float32)).to(cuda)
    w_e = torch.from_numpy((0.3 * rng.normal(size=(h, d, k)))
                           .astype(np.float32)).to(cuda)
    out, sigma = tsa.sell_forward(zs, zd, a, n, negative_slope=SLOPE,
                                  sell_tiles=st, w_e=w_e)
    r = (g * out).view(n, h, d).sum(-1)
    tables = (zs, zd, g, sigma, r, a)

    def chunk(side, spc, c):
        rows_c = spc * TILE_N
        return (side.perm[c * rows_c: (c + 1) * rows_c], side.ids_grp[c],
                side.cnt_grp[c], side.rel_off[c])

    def f64(ts):
        return [t.double() for t in ts]

    part = None
    twin_dwe = twin64 = 0
    for c in range(chunks):
        lay = chunk(st.dst, st.spc_dst, c)
        ekw = dict(edge_feat=st.dst.edge_feat[c], w_e=w_e)
        o, m, l = sell_fwd(zs, zd, a, *lay, negative_slope=SLOPE,
                           normalize=not st.dst.split, **ekw)
        w = sell_fwd_plain(zs, zd, a, *lay, negative_slope=SLOPE,
                           normalize=not st.dst.split, **ekw)
        w64 = sell_fwd_plain(*f64((zs, zd, a)), *lay, negative_slope=SLOPE,
                             normalize=not st.dst.split,
                             edge_feat=ekw["edge_feat"].double(),
                             w_e=w_e.double())
        torch.cuda.synchronize()
        assert _close_by_row(m, w[1], rtol=1e-4, atol=1e-4)
        assert _close_f64(o, w[0], w64[0])
        emit = chunks == 1
        dzd, da, c1, part = sell_bwd_dst(*tables, *lay, negative_slope=SLOPE,
                                         emit_c1=emit, dwe_part=part, **ekw)
        wd = sell_bwd_dst_plain(*tables, *lay, negative_slope=SLOPE,
                                emit_c1=emit, **ekw)
        wd64 = sell_bwd_dst_plain(*f64(tables), *lay, negative_slope=SLOPE,
                                  emit_c1=emit,
                                  edge_feat=ekw["edge_feat"].double(),
                                  w_e=w_e.double())
        torch.cuda.synchronize()
        assert _close_f64(dzd, wd[0], wd64[0])
        assert _close_f64(da, wd[1], wd64[1])
        real = _real_slots(lay[2])
        if emit and bool(real.any()):
            assert _close_f64(c1[real], wd[2][real], wd64[2][real])
        twin_dwe = twin_dwe + wd[3].sum(0)
        twin64 = twin64 + wd64[3].sum(0)
        if chunks > 1:
            lay = chunk(st.srcs, st.spc_src, c)
            ekw = dict(edge_feat=st.srcs.edge_feat[c], w_e=w_e)
            dzs = sell_bwd_src(*tables, *lay, negative_slope=SLOPE, **ekw)
            ws = sell_bwd_src_plain(*tables, *lay, negative_slope=SLOPE,
                                    **ekw)
            ws64 = sell_bwd_src_plain(*f64(tables), *lay,
                                      negative_slope=SLOPE,
                                      edge_feat=ekw["edge_feat"].double(),
                                      w_e=w_e.double())
            torch.cuda.synchronize()
            assert _close_f64(dzs, ws, ws64)
    assert _close_f64(part.sum(0), twin_dwe, twin64)


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [1, 3])
def test_edge_feature_op_matches_torch_path(cuda, chunks):
    """sell_attention with w_e on the card (K1, K2, and K3 or K4) against
    the 'torch' edge attention on the card: the output and the gradients
    of zs, zd, a and w_e, at the ogbn-proteins head width."""
    from gatv2_tpu_torch.ops.attention import edge_attention

    g = random_graph(1500, 12000, 8, 3, seed=21)
    n, h, d, k = g.num_nodes, 6, 80, 8
    rng = np.random.default_rng(10)
    ef = rng.normal(size=(g.num_edges, k)).astype(np.float32)
    st = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, n, num_chunks=chunks,
                                edge_features=ef).to(cuda)
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * c)
              .to(cuda) for s, c in (((n, h * d), 1.0), ((n, h * d), 1.0),
                                     ((h, d), 0.2), ((h, d, k), 0.2))]
    up = torch.from_numpy(rng.normal(size=(n, h * d)).astype(np.float32)) \
        .to(cuda)
    src = torch.as_tensor(g.src, device=cuda)
    dst = torch.as_tensor(g.dst, device=cuda)
    eft = torch.as_tensor(ef, device=cuda)

    def run(impl):
        x = [t.clone().requires_grad_(True) for t in leaves]
        zs, zd = x[0], x[1]
        if impl == "torch":
            zs, zd = zs.view(n, h, d), zd.view(n, h, d)
        out = edge_attention(zs, zd, x[2], src, dst, n, negative_slope=SLOPE,
                             impl=impl, edge_tiles=st, edge_feat=eft,
                             w_e=x[3]).reshape(n, h * d)
        (out * up).sum().backward()
        return [out.detach()] + [t.grad for t in x]

    got, want = run("sell"), run("torch")
    for name, a_, b_ in zip(("out", "dzs", "dzd", "da", "dw_e"), got, want):
        scale = float(b_.abs().max())
        assert float((a_ - b_).abs().max()) <= 1e-4 * scale + 1e-5, name
