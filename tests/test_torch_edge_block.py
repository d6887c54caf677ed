"""The edge-conditioned GATv2 block (ModelConfig edge_dim, residual, norm,
loss; the ogbn-proteins configuration) on the CPU, held to the plain
reference gatv2_tpu_torch/reference/gatv2_edge.py: impl 'torch' and impl
'sell' through the twins of K1, K2 and K4 (and K3 unchunked) on
unchunked, chunked and split-row layouts; the runner's Adam steps;
BatchNorm over the real nodes only; remat with the kept result; the
benchmark's faults of the block; the paths that take no edge features;
state, data and tools.

Tolerances. The reference and the port compute in fp32 in different
orders (the reference sums edge blocks with index_add_, the port column
by column per SELL slice; the edge term is a matmul in one, a loop in the
other), so agreement is to fp32 rounding amplified by six-step chains:
relative 2e-5 on the loss and 1e-4 on each leaf's gradient norm gap
(measured up to 2e-6). After 3 Adam steps each leaf's distance from the
reference's is held to 5e-2 of the reference's change: Adam moves every
element with a nonzero gradient by about lr, so an element whose gradient
is at the rounding level can move the other way (measured: 1.4e-2 on the
'torch' path's hidden layers, 2.5e-5 on SELL). Equalities are exact where
the same arithmetic runs on the same values."""

import dataclasses
import importlib.util
import math
import pathlib
import subprocess
import sys
import time

import jax  # noqa: F401  (test files import both packages)
import numpy as np
import pytest
import torch

from gatv2_tpu_torch.config import ModelConfig, TrainConfig
from gatv2_tpu_torch.data.graph import Graph
from gatv2_tpu_torch.data.synthetic import random_graph
from gatv2_tpu_torch.models import gatv2 as model
from gatv2_tpu_torch.models import params_io
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.reference import gatv2_edge as ref
from gatv2_tpu_torch.train import checkpoint as ckpt
from gatv2_tpu_torch.train import loop, optim

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, E, F, K, C = 300, 4000, 12, 8, 5
HEADS, DIMS = (2, 2, 3), (12, 8, 6)  # H*D up to 24; D = 12 and 6
LOSS_RTOL, GRAD_RTOL, CHANGE_RTOL = 2e-5, 1e-4, 5e-2


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One summation order for the CPU GEMMs (tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph(seed=3):
    g = random_graph(N, E, F, 2, seed=seed)
    rng = np.random.default_rng(seed)
    return Graph(g.features, g.row_ptr, g.col_idx,
                 (rng.random((N, C)) < 0.5).astype(np.int32),
                 edge_features=rng.standard_normal((E, K)).astype(np.float32))


def _config(**kw):
    return ModelConfig(num_layers=3, heads=HEADS, out_dims=DIMS,
                       num_classes=C, in_dim=F, negative_slope=0.2,
                       edge_dim=K, residual=True, norm="batch", loss="bce",
                       **kw)


def _params(mc, seed=0):
    return model.init_params(mc, torch.Generator().manual_seed(seed))


def _reference(g, leaves):
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    with ref.fp32_exact():
        loss = ref.bce(ref.forward(
            ps, torch.tensor(g.features), torch.tensor(g.src).long(),
            torch.tensor(g.dst).long(), torch.tensor(g.edge_features),
            HEADS, DIMS), torch.tensor(g.labels))
        grads = torch.autograd.grad(loss, ps)
    return float(loss), grads


# (impl, chunks, split cap): unchunked, chunked, split rows, both
LAYOUTS = [("torch", 0, None), ("sell", 1, 256), ("sell", 3, 256),
           ("sell", 1, 8), ("sell", 3, 8)]


def _program_inputs(g, impl, chunks, cap):
    """(features, labels, num_valid, edge_tiles, edge_feat) of a layout."""
    if impl == "torch":
        return (torch.tensor(g.features), torch.tensor(g.labels), None, None,
                torch.tensor(g.edge_features))
    st = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, N, num_chunks=chunks,
                                split_cap=cap, edge_features=g.edge_features)
    n_pad = st.padded_num_nodes
    feats = torch.zeros(n_pad, F)
    feats[:N] = torch.tensor(g.features)
    labels = torch.full((n_pad, C), -1, dtype=torch.int32)
    labels[:N] = torch.tensor(g.labels)
    return feats, labels, (N if n_pad != N else None), st, None


@pytest.mark.parametrize("impl,chunks,cap", LAYOUTS)
def test_forward_and_every_gradient_match_the_reference(impl, chunks, cap):
    g = _graph()
    mc = _config()
    params = _params(mc)
    leaves = optim.param_leaves(params)
    want_loss, want = _reference(g, leaves)
    feats, labels, nv, st, ef = _program_inputs(g, impl, chunks, cap)
    if st is not None:
        assert st.dst.split == (cap == 8) and st.num_chunks == chunks
    loss, _ = model.loss_fn(params, feats, torch.tensor(g.src),
                            torch.tensor(g.dst), labels, mc, impl=impl,
                            edge_tiles=st, num_valid=nv, edge_feat=ef)
    got = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    names = optim.param_names(params)
    assert {n.split(".")[-1] for n in names} >= {
        "w_e", "w_res", "bn_g", "bn_b"}
    for name, a, b in zip(names, got, want):
        gap = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert gap <= GRAD_RTOL, (name, gap)


@pytest.mark.parametrize("impl,chunks,cap", [LAYOUTS[0], LAYOUTS[2]])
def test_three_adam_steps_of_the_runner_match_the_reference(impl, chunks,
                                                            cap):
    g = _graph(seed=5)
    mc = _config()
    params = _params(mc, seed=1)
    w0 = [p.detach().clone() for p in optim.param_leaves(params)]
    feats, labels, nv, st, ef = _program_inputs(g, impl, chunks, cap)
    tc = TrainConfig(optimizer="adam", lr=0.01, impl=impl)
    runner = loop.make_multi_epoch_runner(mc, tc, 3, edge_tiles=st,
                                          num_valid=nv, edge_feat=ef)
    opt = optim.init_opt_state(params, "adam")
    _, _, losses, _ = runner(params, opt, 0, feats, torch.tensor(g.src),
                             torch.tensor(g.dst), labels)
    step = (torch.tensor(g.features), torch.tensor(g.src).long(),
            torch.tensor(g.dst).long(), torch.tensor(g.edge_features),
            torch.tensor(g.labels))
    want = ref.train(w0, [step] * 3, HEADS, DIMS, lr=0.01)
    np.testing.assert_allclose(losses.numpy(), want["losses"],
                               rtol=LOSS_RTOL)
    for name, p, w, p0 in zip(optim.param_names(params),
                              optim.param_leaves(params), want["params"],
                              w0):
        gap = float((p.detach() - w).norm() / (w - p0).norm())
        assert gap <= CHANGE_RTOL, (name, gap)


@pytest.mark.parametrize("remat", [False, True])
def test_float64_torch_path_matches_the_float64_reference(remat):
    """The 'torch' path in float64, Adam's step count in float64 too (the
    runner's is fp32, as in the JAX package), against the reference in
    float64 over 3 Adam steps: without fp32 rounding the two compute one
    function (BatchNorm, residual, edge term, loss, Adam), so what the fp32
    tests allow is rounding. Tolerances: float64 rounding grown by the
    chain and Adam's division by sqrt(v) (measured 1.4e-11 on the loss,
    1.6e-8 on a leaf's distance over the reference's change)."""
    g = _graph(seed=5)
    mc = _config(remat=remat)
    f64 = torch.float64
    params = _params(mc, seed=1).to(f64)
    w0 = [p.detach().clone() for p in optim.param_leaves(params)]
    tc = TrainConfig(optimizer="adam", lr=0.01, impl="torch")
    opt = optim.init_opt_state(params, "adam")
    src, dst = torch.tensor(g.src), torch.tensor(g.dst)
    feats = torch.tensor(g.features).to(f64)
    ef = torch.tensor(g.edge_features).to(f64)
    labels = torch.tensor(g.labels)
    losses = [float(loop.train_epoch(params, opt, torch.tensor(t, dtype=f64),
                                     feats, src, dst, labels, mc, tc,
                                     edge_feat=ef)[0])
              for t in (1.0, 2.0, 3.0)]
    step = (feats, src.long(), dst.long(), ef, labels)
    want = ref.train(w0, [step] * 3, HEADS, DIMS, lr=0.01)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-9)
    for name, p, w, p0 in zip(optim.param_names(params),
                              optim.param_leaves(params), want["params"],
                              w0):
        gap = float((p.detach() - w).norm() / (w - p0).norm())
        assert gap <= 1e-6, (name, gap)


def test_padding_rows_leave_batchnorm_statistics_unchanged():
    """On the SELL node grid, rows past the real nodes (here filled with
    large values) move neither BatchNorm's statistics nor any gradient:
    the running statistics and the gradients equal those of the 'torch'
    path on the real nodes alone."""
    g = _graph(seed=7)
    mc = _config()
    feats, labels, nv, st, _ = _program_inputs(g, "sell", 3, 256)
    assert feats.shape[0] > N
    feats[N:] = 1e3
    runs = {}
    for impl in ("sell", "torch"):
        params = _params(mc, seed=2)
        kw = (dict(edge_tiles=st, num_valid=nv) if impl == "sell" else
              dict(edge_feat=torch.tensor(g.edge_features)))
        loss, _ = model.loss_fn(
            params, feats if impl == "sell" else feats[:N],
            torch.tensor(g.src), torch.tensor(g.dst),
            labels if impl == "sell" else labels[:N], mc, impl=impl, **kw)
        grads = torch.autograd.grad(loss, optim.param_leaves(params))
        runs[impl] = (grads, [b.clone() for b in params.buffers()])
    for a, b in zip(runs["sell"][0], runs["torch"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    for a, b in zip(runs["sell"][1], runs["torch"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert any(float((b - 1).abs().max()) > 1e-3 for b in runs["sell"][1])


def test_remat_keeps_the_result_and_moves_the_statistics_once():
    """remat on the chunked SELL layout: the gradients and the running
    statistics equal those without remat, and the recompute takes the
    attention's result from the holder for every layer."""
    g = _graph(seed=9)
    feats, labels, nv, st, _ = _program_inputs(g, "sell", 3, 256)
    out = {}
    for remat in (False, True):
        mc = _config(remat=remat)
        params = _params(mc, seed=3)
        reused = tsa.sell_attention.reused
        loss, _ = model.loss_fn(params, feats, None, None, labels, mc,
                                impl="sell", edge_tiles=st, num_valid=nv)
        grads = torch.autograd.grad(loss, optim.param_leaves(params))
        out[remat] = (grads, list(params.buffers()),
                      tsa.sell_attention.reused - reused)
    assert out[False][2] == 0 and out[True][2] == len(HEADS)
    for a, b in zip([*out[True][0], *out[True][1]],
                    [*out[False][0], *out[False][1]]):
        assert torch.equal(a, b)


def test_defaults_are_the_plain_model():
    """At their defaults the block's fields add no leaf, buffer or layout
    table, and the model's forward is the plain one."""
    g = random_graph(200, 1500, 6, 3, seed=1)
    mc = ModelConfig(num_layers=2, heads=(2, 1), out_dims=(4, 4),
                     num_classes=3, in_dim=6)
    assert not mc.extended
    params = _params(mc)
    assert optim.param_names(params) == [
        "layers.0.a", "layers.0.w_dst", "layers.0.w_src", "layers.1.a",
        "layers.1.w_dst", "layers.1.w_src", "w_o"]
    assert list(params.buffers()) == []
    st = tsa.prepare_sell_tiles(g.row_ptr, g.col_idx, 200, num_chunks=2)
    assert type(st.dst) is type(st.srcs) is tsa._SellSide
    assert st.edge_dim == 0
    assert ckpt.run_meta(mc)["model_config"].keys().isdisjoint(
        {"edge_dim", "residual", "norm", "loss"})


@pytest.mark.parametrize("fault", [None, "edge_term_dropped",
                                   "zero_edge_grad"])
def test_the_cells_limits_catch_the_block_faults(fault):
    """The traffic driver of ogbn-proteins.fullgraph at a CPU size, held to
    the cell's limits: correct as it is, not correct with the edge term
    dropped or with dW_e zero."""
    from benchmark import correct, harness
    from benchmark.faults_edge import planted

    entry = harness.cell_entry(harness.spec(), "ogbn-proteins.fullgraph")
    cfg = dict(harness.config_of(harness.spec(), entry))
    cfg.update(num_nodes=N, num_edges=E, num_layers=3, heads=list(HEADS),
               out_dims=list(DIMS), num_classes=C)
    ctx = harness.Context(
        cell=entry["name"], config=cfg, traffic=harness.traffic_of(entry),
        limits=harness.limits_of(entry), seed=2**31 + 19, seconds=0.0,
        trace=False, device=torch.device("cpu"), t0=time.perf_counter(),
        check_only=True)
    if fault is None:
        record = harness.run_driver(ctx)
    else:
        with planted(fault):
            record = harness.run_driver(ctx)
    ok, compared = correct.judge(record["numbers"], ctx.limits)
    assert ok == (fault is None), compared


@pytest.mark.parametrize("path", ["impl pallas", "batch-size", "mesh",
                                  "variant node"])
def test_paths_without_edge_features_refuse_them(path):
    g = _graph()
    if path == "variant node":
        with pytest.raises(ValueError, match="variant"):
            _config(variant="node")
        return
    mc = _config()
    if path == "impl pallas":
        with pytest.raises(ValueError, match="--impl pallas"):
            loop.Trainer(g, mc, TrainConfig(impl="pallas"), device="cpu",
                         log_fn=lambda _: None)
    elif path == "batch-size":
        from gatv2_tpu_torch.train.minibatch import MinibatchTrainer

        with pytest.raises(ValueError, match="--batch-size"):
            MinibatchTrainer(g, mc, TrainConfig(batch_size=32,
                                                fanouts=(3, 3, 3)),
                             device="cpu", log_fn=lambda _: None)
    else:
        from gatv2_tpu_torch.parallel.sharded import ShardedTrainer

        with pytest.raises(ValueError, match="--mesh"):
            ShardedTrainer(g, mc, TrainConfig(), 2, device="cpu",
                           log_fn=lambda _: None)


def test_checkpoint_and_text_dump_carry_the_block(tmp_path):
    """Two epochs of a Trainer, then its checkpoint and its text dump:
    both restore every leaf and BatchNorm's running statistics, and
    inference (no autograd) normalises with the running statistics."""
    g = _graph(seed=11)
    mc = _config()
    tc = TrainConfig(optimizer="adam", lr=0.01, seed=4, impl="sell",
                     checkpoint_dir=str(tmp_path / "ck"))
    tr = loop.Trainer(g, mc, tc, device="cpu", log_fn=lambda _: None)
    tr.run(2)
    ckpt.save_trainer(tc.checkpoint_dir, tr, meta=ckpt.run_meta(mc, tc))
    params_io.save_params_txt(tmp_path / "w", tr.params)
    fresh = loop.Trainer(g, mc, dataclasses.replace(tc, seed=9), device="cpu",
                         log_fn=lambda _: None)
    assert ckpt.restore_into(tc.checkpoint_dir, fresh,
                             expect_meta=ckpt.run_meta(mc, tc))
    assert fresh.epoch == 2
    dumped = params_io.load_params_txt(tmp_path / "w", mc)
    want = list(tr.params.parameters()) + list(tr.params.buffers())
    assert len(list(tr.params.buffers())) == 2 * (len(HEADS) - 1)
    for other in (fresh.params, dumped):
        got = list(other.parameters()) + list(other.buffers())
        assert len(got) == len(want)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    with torch.no_grad():
        x = torch.randn(7, 2 * 12)
        layer = tr.params.layers[0]
        y = model.batch_norm(x, layer.bn_g, layer.bn_b, layer.bn_mean,
                             layer.bn_var, 7, training=False, update=False)
        manual = ((x - layer.bn_mean) / torch.sqrt(layer.bn_var + 1e-5)
                  * layer.bn_g + layer.bn_b)
        torch.testing.assert_close(y, manual)


def test_dataset_files_carry_edge_features_and_task_labels(tmp_path):
    from gatv2_tpu_torch.data import io

    g = _graph(seed=13)
    io.save_dataset(g, tmp_path / "d")
    back = io.load_dataset("d", str(tmp_path))
    assert back.labels.shape == (N, C) and back.num_classes == C
    assert np.array_equal(back.labels, g.labels)
    assert np.array_equal(back.edge_features, g.edge_features)
    assert back.edge_dim == K


def _write_csv_gz(path, arr, fmt):
    import gzip

    with gzip.open(path, "wt") as f:
        np.savetxt(f, arr, delimiter=",", fmt=fmt)


def test_convert_ogb_writes_proteins_edge_features_and_tasks(tmp_path):
    """tools/torch_convert_ogb.py on a fake ogbn-proteins raw directory
    (edges once, 8 edge features, 112 tasks, no node features): both
    directions carry the edge's features, nodes get the mean of their
    edges' features, and the dataset trains with the block."""
    rng = np.random.default_rng(2)
    n, e = 60, 240
    raw = tmp_path / "raw"
    (raw / "split" / "species").mkdir(parents=True)
    edges = rng.integers(0, n, size=(e, 2))
    efeat = rng.random((e, 8)).astype(np.float32)
    tasks = rng.integers(0, 2, size=(n, 112))
    _write_csv_gz(raw / "edge.csv.gz", edges, "%d")
    _write_csv_gz(raw / "edge-feat.csv.gz", efeat, "%.6f")
    _write_csv_gz(raw / "node-label.csv.gz", tasks, "%d")
    perm = rng.permutation(n)
    for name, idx in (("train", perm[:40]), ("valid", perm[40:50]),
                      ("test", perm[50:])):
        _write_csv_gz(raw / "split" / "species" / f"{name}.csv.gz",
                      idx.reshape(-1, 1), "%d")
    spec = importlib.util.spec_from_file_location(
        "torch_convert_ogb_tool", ROOT / "tools" / "torch_convert_ogb.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "data" / "proteins"
    assert tool.main(["--raw-dir", str(raw), "--out", str(out),
                      "--make-undirected"]) == 0
    from gatv2_tpu_torch.data import io

    g = io.load_dataset("proteins", str(tmp_path / "data"))
    assert g.num_edges == 2 * e and g.edge_dim == 8
    assert g.labels.shape == (n, 112) and np.array_equal(g.labels, tasks)
    read = np.loadtxt(raw / "edge-feat.csv.gz", delimiter=",",
                      dtype=np.float32)
    # every directed edge (s -> d) carries the features of its pair
    dst = g.dst
    want = {}
    for (s, d), f in zip(edges, read):
        want.setdefault((s, d), []).append(tuple(f))
        want.setdefault((d, s), []).append(tuple(f))
    for s, d, f in zip(g.src, dst, g.edge_features):
        assert tuple(f) in want[(s, d)]
    deg = np.diff(g.row_ptr)
    j = int(np.argmax(deg))
    np.testing.assert_allclose(
        g.features[j],
        g.edge_features[g.row_ptr[j]:g.row_ptr[j + 1]].mean(0), rtol=1e-5)
    flags = ["--dataset", "proteins", "--data-root", str(tmp_path / "data"),
             "--num-layers", "2", "--heads", "2,2", "--outdims", "8,8",
             "--device", "cpu", "--impl", "sell", "--edge-features",
             "--residual", "--norm", "batch", "--loss", "bce",
             "--checkpoint-dir", str(tmp_path / "ck")]
    r = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.train", *flags, "--epochs",
         "2", "--optimizer", "adam", "--lr", "0.01", "--seed", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Final Test Accuracy" in r.stdout
    losses = [float(line.split("Avg Loss: ")[1].split(",")[0])
              for line in r.stdout.splitlines() if "Avg Loss" in line]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    # predict from the checkpoint: BatchNorm's running statistics, one
    # line of 112 task predictions a node
    r = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.predict", *flags, "--out",
         str(tmp_path / "pred")], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    preds = np.loadtxt(tmp_path / "pred" / "predictions.txt")
    assert preds.shape == (n, 112) and set(np.unique(preds)) <= {0, 1}


def test_cli_flags_set_the_block_fields():
    from gatv2_tpu_torch import cli

    mc, _, args = cli.parse_args(["--residual", "--norm", "batch", "--loss",
                                  "bce", "--edge-features", "--device",
                                  "cpu"])
    assert (mc.residual, mc.norm, mc.loss, args.edge_features) == (
        True, "batch", "bce", True)
    mc, _, args = cli.parse_args(["--device", "cpu"])
    assert not mc.extended and not args.edge_features


def test_references_import_nothing_of_the_port():
    import ast

    path = ROOT / "gatv2_tpu_torch" / "reference" / "gatv2_edge.py"
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "torch"}, names
    frozen = ROOT / "benchmark" / "reference" / "gatv2_edge.py"
    assert frozen.read_text() == path.read_text()


def test_layout_spans_the_edge_feature_tables():
    """setup_full_graph_sell with edge features opens layout.edge_features
    inside setup.layout; without them the span is not opened."""
    from torch.profiler import ProfilerActivity, profile

    g = _graph(seed=15)
    for with_ef in (True, False):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tsa.setup_full_graph_sell(
                g, HEADS, DIMS, device="cpu",
                edge_features=g.edge_features if with_ef else None)
        names = [e.name for e in prof.events() if e.is_user_annotation]
        assert ("layout.edge_features" in names) == with_ef
        assert "setup.layout" in names
