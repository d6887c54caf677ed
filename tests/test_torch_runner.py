"""The port's multi-epoch runner (train/loop.py make_multi_epoch_runner) and
dataset writers (data/io.py save_dataset, data/splits.py save_split_files)
against the JAX package's, on the CPU, where every kernel wrapper runs its
plain twin; and tools/torch_run_accuracy.py: one cell, and its table.

Tolerances: K runner epochs equal K Trainer.step calls bit for bit (the
same epoch body on the same inputs); the runner's losses equal the JAX
runner's to 1e-6 absolute, as tests/test_torch_train.py holds the Trainers;
the writers' files are byte-equal to the JAX writers'."""

import copy
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatv2_tpu import config as jconfig
from gatv2_tpu.data import io as jio
from gatv2_tpu.data import splits as jsplits
from gatv2_tpu.data import synthetic as jsyn
from gatv2_tpu.models import gatv2 as jmodel
from gatv2_tpu.train import loop as jloop
from gatv2_tpu.train import optim as joptim
from gatv2_tpu_torch import config as tconfig
from gatv2_tpu_torch.data import io as tio
from gatv2_tpu_torch.data import splits as tsplits
from gatv2_tpu_torch.data.graph import Graph
from gatv2_tpu_torch.models import params_io as tpio
from gatv2_tpu_torch.ops import pallas_attention as tpa
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.train import loop as tloop
from gatv2_tpu_torch.train import optim as toptim

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = str(ROOT / "data")
LOSS_ATOL = 1e-6
ARCH = dict(num_layers=2, heads=(2, 1), out_dims=(8, 4))
EPOCHS = 5
# the chunk counts test_torch_train.test_chunked_trainer_matches_jax forces
# on digits (the first counts both packages' policies pick)
CHUNKS = {"sell": 4, "pallas": 3}


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One fixed summation order for the CPU GEMMs (see
    tests/test_torch_train.py): with several threads MKL splits a
    reduction by the machine's load, and Adam amplifies the rounding."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _start(dataset):
    """(graph, model config kwargs, split masks, JAX-initialised params)."""
    g = tio.load_dataset(dataset, DATA)
    model_kw = dict(ARCH, num_classes=g.num_classes, in_dim=g.feature_dim)
    splits = tsplits.load_split_files(tio.resolve_dataset_dir(dataset, DATA),
                                      g.num_nodes)
    start = jmodel.init_params_for_variant(jconfig.ModelConfig(**model_kw),
                                           jax.random.PRNGKey(5))
    return g, model_kw, splits, start


def _port_trainer(dataset, impl, clip, epochs=EPOCHS):
    g, model_kw, splits, start = _start(dataset)
    tc = tconfig.TrainConfig(epochs=epochs, optimizer="adam", lr=0.01,
                             clip=clip, seed=0, impl=impl)
    tr = tloop.Trainer(g, tconfig.ModelConfig(**model_kw), tc,
                       log_fn=lambda _: None, splits=splits, device="cpu")
    tr.params = tpio.params_from_numpy(jax.tree.map(np.asarray, start))
    return tr, start


def _runner_of(tr, num_epochs):
    return tloop.make_multi_epoch_runner(
        tr.model_config, tr.train_config, num_epochs,
        edge_tiles=tr.edge_tiles, num_valid=tr.num_valid)


def _run(tr, runner, params, opt_state, t0):
    return runner(params, opt_state, t0, tr.features, tr.src, tr.dst,
                  tr.labels)


def _state(params, opt_state):
    return [t.detach().clone() for t in toptim.param_leaves(params)] + [
        t.clone() for k in sorted(opt_state) for t in opt_state[k]]


def _assert_bits(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i}"


def _force_chunks(monkeypatch, dataset, impl):
    """Patch the port's default chunk budget so that `dataset`'s layout
    takes CHUNKS[impl] chunks (the budget search of test_torch_train)."""
    from test_torch_train import _budget_giving

    g = tio.load_dataset(dataset, DATA)
    heads, dims = ARCH["heads"], ARCH["out_dims"]
    if impl == "sell":
        def suggest(b):
            return tsa.suggest_chunks_for_graph(
                g.row_ptr, g.col_idx, g.num_nodes, heads, dims,
                budget_bytes=b)
        module = tsa
    else:
        hd = max(-(-h * d // 128) * 128 for h, d in zip(heads, dims))

        def suggest(b):
            return tpa.suggest_num_chunks(g.num_edges, hd, budget_bytes=b)
        module = tpa
    budget = _budget_giving(CHUNKS[impl], suggest)
    monkeypatch.setattr(module, "default_chunk_budget",
                        lambda device, num_edges=0: budget)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dataset,impl,chunked", [
    ("karate", "torch", False), ("karate", "sell", False),
    ("karate", "pallas", False), ("digits", "sell", True),
    ("digits", "pallas", True),
])
def test_runner_equals_trainer_steps(dataset, impl, chunked, clip,
                                     monkeypatch):
    """EPOCHS runner epochs against EPOCHS Trainer.step calls from the same
    start: losses, accuracies, parameters and Adam moments bit for bit.
    impl='sell' runs the twins of K1-K3 (chunked: K1, K2, K4), 'pallas'
    those of K5-K7 (chunked: K5, K6, K8)."""
    if chunked:
        _force_chunks(monkeypatch, dataset, impl)
    tr, _ = _port_trainer(dataset, impl, clip)
    if chunked:
        assert tr.edge_tiles.num_chunks == CHUNKS[impl]
    params, opt = copy.deepcopy(tr.params), copy.deepcopy(tr.opt_state)
    out = _run(tr, _runner_of(tr, EPOCHS), params, opt, 0)
    assert out[0] is params and out[1] is opt
    losses, accs = out[2], out[3]
    assert losses.shape == accs.shape == (EPOCHS,)
    assert losses.dtype == accs.dtype == torch.float32
    want = []
    for _ in range(EPOCHS):
        tr.epoch += 1
        want.append(tr.step())
    assert losses.tolist() == [l for l, _ in want]
    assert accs.tolist() == [a for _, a in want]
    _assert_bits(_state(params, opt), _state(tr.params, tr.opt_state))


def test_runner_continues_from_t0():
    """Two calls, t0 = 0 then t0 = 3 (Adam's t continues), equal one call
    of 6 epochs bit for bit."""
    tr, _ = _port_trainer("karate", "sell", True)
    p1, o1 = copy.deepcopy(tr.params), copy.deepcopy(tr.opt_state)
    p2, o2 = copy.deepcopy(tr.params), copy.deepcopy(tr.opt_state)
    _, _, first, _ = _run(tr, _runner_of(tr, 3), p1, o1, 0)
    _, _, second, _ = _run(tr, _runner_of(tr, 3), p1, o1, 3)
    _, _, whole, _ = _run(tr, _runner_of(tr, 6), p2, o2, 0)
    assert torch.equal(torch.cat([first, second]), whole)
    _assert_bits(_state(p1, o1), _state(p2, o2))


def test_runner_rejects_no_epochs():
    with pytest.raises(ValueError, match="num_epochs"):
        tloop.make_multi_epoch_runner(None, None, 0)


@pytest.mark.parametrize("impl,jax_impl", [("torch", "xla"),
                                           ("sell", "sell")])
def test_runner_matches_jax_runner(impl, jax_impl):
    """The runner against the JAX make_multi_epoch_runner from the same
    weights on karate (split-masked labels): 'torch' against 'xla', and
    'sell' through the twins of K1-K3 against 'sell' in Pallas interpret
    mode; per-epoch losses to 1e-6, accuracies to 1e-7."""
    tr, start = _port_trainer("karate", impl, True)
    _, model_kw, _, _ = _start("karate")
    jg = jio.load_dataset("karate", DATA)
    jcfg = jconfig.ModelConfig(**model_kw)
    jtc = jconfig.TrainConfig(epochs=EPOCHS, optimizer="adam", lr=0.01,
                              clip=True, seed=0, impl=jax_impl)
    jsp = jsplits.load_split_files(jio.resolve_dataset_dir("karate", DATA),
                                   jg.num_nodes)
    labels = jsp.masked_labels(jg.labels, "train")
    num_valid = int(jsp.train.sum())
    feats, et = jg.features, None
    src = dst = jnp.zeros(1, jnp.int32)
    if jax_impl == "sell":
        from gatv2_tpu.ops.sell_attention import setup_full_graph_sell

        et, feats, labels, _ = setup_full_graph_sell(
            jg, jcfg.heads, jcfg.out_dims, labels=labels)
    else:
        pe = jg.padded_edges(128)
        src, dst = jnp.asarray(pe.src), jnp.asarray(pe.dst)
    jrun = jloop.make_multi_epoch_runner(jcfg, jtc, EPOCHS, edge_tiles=et,
                                         num_valid=num_valid)
    _, _, jlosses, jaccs = jrun(start, joptim.init_opt_state(start, "adam"),
                                jnp.asarray(0, jnp.int32), jnp.asarray(feats),
                                src, dst, jnp.asarray(labels))
    _, _, losses, accs = _run(tr, _runner_of(tr, EPOCHS), tr.params,
                              tr.opt_state, 0)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), rtol=0,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the dataset writers
# ---------------------------------------------------------------------------


def _odd_graph():
    """A random_graph whose features hold negative values, subnormals and
    a negative zero."""
    g = jsyn.random_graph(60, 300, 6, 3, seed=4)
    f = g.features.copy()
    f[0, :4] = [-1e-40, 1e-45, -0.0, np.finfo(np.float32).tiny / 3]
    f[1] = -np.abs(f[1]) * 1e3
    return Graph(features=f, row_ptr=g.row_ptr, col_idx=g.col_idx,
                 labels=g.labels)


def _graph(name):
    return _odd_graph() if name == "odd" else tio.load_dataset(name, DATA)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("name", ["karate", "digits", "odd"])
def test_save_dataset_matches_jax(name, tmp_path):
    g = _graph(name)
    tio.save_dataset(g, tmp_path / "port")
    jio.save_dataset(g, tmp_path / "jax")
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == ["col_idx.txt", "features.txt", "labels.txt",
                           "row_ptr.txt"]
    assert got == want


@pytest.mark.parametrize("parser", ["numpy", "native"])
@pytest.mark.parametrize("name", ["karate", "digits", "odd"])
def test_saved_dataset_loads_back(name, parser, tmp_path):
    g = _graph(name)
    tio.save_dataset(g, tmp_path / name)
    h = tio.load_dataset(name, str(tmp_path), parser=parser)
    for f in ("features", "row_ptr", "col_idx", "labels"):
        a, b = getattr(h, f), getattr(g, f)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("name", ["karate", "digits", "random"])
def test_save_split_files_matches_jax(name, tmp_path):
    if name == "random":
        sp = tsplits.random_splits(101, (0.6, 0.2, 0.2), seed=3)
    else:
        g = tio.load_dataset(name, DATA)
        sp = tsplits.load_split_files(tio.resolve_dataset_dir(name, DATA),
                                      g.num_nodes)
    tsplits.save_split_files(sp, tmp_path / "port")
    jsplits.save_split_files(
        jsplits.Splits(train=sp.train, val=sp.val, test=sp.test),
        tmp_path / "jax")
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(tsplits.MASK_FILES)
    assert got == want
    back = tsplits.load_split_files(tmp_path / "port", sp.train.shape[0])
    for k in ("train", "val", "test"):
        assert np.array_equal(getattr(back, k), getattr(sp, k))


# ---------------------------------------------------------------------------
# tools/torch_run_accuracy.py
# ---------------------------------------------------------------------------


def test_accuracy_tool_single_cell_on_the_cpu():
    """One cell of the accuracy table on the CPU with the epochs cut: the
    tool parses its own row out of `python -m gatv2_tpu_torch.train`."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_run_accuracy.py"),
         "--device", "cpu", "--epochs", "3", "--single", "dataset=karate",
         "mode=torch"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["dataset"] == "karate" and row["mode"] == "torch"
    assert row["device"] == "cpu" and row["epochs"] == 3
    assert 0.0 <= row["test_acc_pct"] <= 100.0
    assert np.isfinite(row["final_train_loss"])


def test_accuracy_tool_table_names_cells_beyond_the_spread(tmp_path):
    """The table puts each cell beside its ACCURACY.md row, names the cells
    further from it than ACCURACY.md's cross-path spread, and replaces
    only the marked block of the file it writes."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import torch_run_accuracy as tool
    finally:
        sys.path.remove(str(ROOT / "tools"))
    rows, spread = tool.jax_rows()
    assert rows[("digits", "xla")] == 97.78 and spread["digits"] == 1.11
    cells = [dict(dataset="digits", mode=m, epochs=200, seed=0,
                  test_acc_pct=acc, final_train_loss=0.001, device="cpu")
             for m, acc in (("torch", 98.06), ("minibatch-pallas", 95.28))]
    text = tool.table(cells)
    assert "| digits | torch | 98.06% | 0.0010 | cpu | xla | 97.78% | " \
           "+0.28 pp |" in text
    assert text.splitlines()[-2].endswith(
        "spread: digits/minibatch-pallas (-2.50 pp).")
    doc = tmp_path / "PERF.md"
    doc.write_text(f"head\n{tool.BEGIN}\nold\n{tool.END}\ntail\n")
    tool.write_table(doc, text)
    assert doc.read_text() == f"head\n{text}\ntail\n"
