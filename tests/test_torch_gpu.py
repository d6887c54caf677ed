"""Card-only tests of the port: the CUDA kernels K1-K4 (SELL) and K5-K8
(edge tiles) against their plain twins, K2's and K6's launches without
packets (chunked layouts) against their launches with them, a model
forward, a training step and a minibatch step that go through them. They
carry the `gpu` marker and skip without a CUDA device. Run them on the
machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against the port's twin, which the CPU tests hold
against JAX.
"""

import copy

import jax  # noqa: F401  (test files import both packages)
import numpy as np
import pytest
import torch

from gatv2_tpu_torch.config import ModelConfig, TrainConfig
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
    elif case == "sparse-src":
        return _sparse_src()
    else:  # zero-edge
        return np.zeros(11, np.int64), np.zeros(0, np.int32), 10
    return g.row_ptr, g.col_idx, g.num_nodes


LAYOUT_CASES = [
    ("uniform", 4, 64), ("uniform", 1, 32), ("uniform", 1, 16),
    ("uniform", 20, 8), ("zipf-split", 4, 64), ("zipf-split", 3, 24),
    ("isolated", 2, 16), ("zero-edge", 3, 24),
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
    # are held against float64, as chip_smoke holds them
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
    ("uniform", 1, 512), ("hubs", 1, 512), ("hubs", 2, 256),
])
def test_k5_wide_heads_match_twin(cuda, case, h, d):
    """K5 alone at H*D = 512 in one or two heads (16 vectors of 4 a lane,
    32 lanes a head), a split hub row included, against its twin and
    float64. (K6's c1 is held to its twin by row, which a 512-term fp32
    dot product does not meet; test_k5_k6_k7_kernels_match_twins covers
    H*D = 512 in 8 heads.)"""
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


@pytest.mark.gpu
def test_minibatch_step_matches_torch_path(cuda):
    """Two SGD minibatch steps through K5-K7 against impl='torch' on the
    same batches from the same weights, with the launches counted."""
    g = random_graph(3000, 24000, 16, 4, seed=9)
    mc = ModelConfig(num_layers=2, heads=(4, 1), out_dims=(16, 8),
                     num_classes=g.num_classes, in_dim=g.feature_dim)
    start = init_params(mc, torch.Generator().manual_seed(4))
    counters = (pallas_fwd, pallas_bwd_dst, pallas_segsum)
    losses = {}
    for impl in ("pallas", "torch"):
        tc = TrainConfig(epochs=1, optimizer="sgd", lr=0.5, clip=True, seed=0,
                         batch_size=256, fanouts=(5, 5), impl=impl)
        tr = MinibatchTrainer(g, mc, tc, log_fn=lambda _: None, device=cuda)
        tr.params = copy.deepcopy(start)
        batches = iter(tr.sampler)
        before = [k.launches for k in counters]
        losses[impl] = [tr.train_step(next(batches))[0] for _ in range(2)]
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(counters, before)]
        assert launched == ([4, 4, 4] if impl == "pallas" else [0, 0, 0])
    np.testing.assert_allclose(losses["pallas"], losses["torch"], rtol=1e-5)


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
])
def test_k8_kernel_matches_twin_and_k6_without_packets(cuda, case, h, d):
    """On a 3-chunk edge-tile layout: K8 on every src chunk against its
    twin, held against float64; K6 on every dst chunk without packets
    gives dzd and d_a equal to its launch with them."""
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
