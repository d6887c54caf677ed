"""The port's training slice against the JAX package's, on the CPU: the
optimizer step, the Trainer's losses and console lines on karate and digits
(from the same parameters, carried across as numpy), the SELL path through
the twins of K1-K3, checkpoints that either package restores, resume, and
`python -m gatv2_tpu_torch.train`.

Tolerance: per-epoch losses equal to 1e-6 (absolute), as the JAX suite holds
its implementations to each other; one optimizer step to fp32 allclose with
rtol = atol = 1e-6."""

import dataclasses
import json
import pathlib
import re
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
from gatv2_tpu.models import gatv2 as jmodel
from gatv2_tpu.train import checkpoint as jckpt
from gatv2_tpu.train import loop as jloop
from gatv2_tpu.train import optim as joptim
from gatv2_tpu_torch import config as tconfig
from gatv2_tpu_torch.data import io as tio
from gatv2_tpu_torch.data import splits as tsplits
from gatv2_tpu_torch.data.synthetic import random_graph
from gatv2_tpu_torch.models import gatv2 as tmodel
from gatv2_tpu_torch.models import params_io as tpio
from gatv2_tpu_torch.ops import sell_attention as tsa
from gatv2_tpu_torch.train import __main__ as tmain
from gatv2_tpu_torch.train import checkpoint as tckpt
from gatv2_tpu_torch.train import loop as tloop
from gatv2_tpu_torch.train import optim as toptim
from test_torch_predict import DATA, ROOT

LOSS_ATOL = 1e-6
ARCH = dict(num_layers=2, heads=(2, 1), out_dims=(8, 4))


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """Run the port's CPU math on one thread. With several, MKL splits a
    GEMM's reduction by however many threads it takes under the machine's
    load, so its rounding changes from run to run; Adam turns the rounding
    of a gradient that is nearly 0 (layer 0's w_dst: the softmax Jacobian's
    terms cancel) into steps of about lr, and the trajectories compared
    below then depend on the load. One thread sums in one fixed order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_np(params):
    return [t.detach().numpy().copy() for t in toptim.param_leaves(params)]


# ---------------------------------------------------------------------------
# the optimizer step
# ---------------------------------------------------------------------------


def _random_tree(rng, scale):
    def arr(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"layers": ({"a": arr(2, 8), "w_dst": arr(2, 8, 12),
                        "w_src": arr(2, 8, 12)},
                       {"a": arr(1, 4), "w_dst": arr(1, 4, 16),
                        "w_src": arr(1, 4, 16)}),
            "w_o": arr(3, 4)}


@pytest.mark.parametrize("optimizer,t,clip", [
    ("sgd", 1, False), ("sgd", 1, True), ("adam", 1, False),
    ("adam", 1, True), ("adam", 7, True),
])
def test_optimizer_step_matches_jax(optimizer, t, clip):
    rng = np.random.default_rng(t)
    params = _random_tree(rng, 0.3)
    # large enough that the W group clips and the a group does not
    grads = _random_tree(rng, 1.0)
    grads["layers"] = tuple(dict(l, a=l["a"] * 0.1) for l in grads["layers"])
    cfg_kw = dict(optimizer=optimizer, lr=0.01, clip=clip)
    jcfg, tcfg = jconfig.TrainConfig(**cfg_kw), tconfig.TrainConfig(**cfg_kw)
    if optimizer == "adam":
        opt = {"m": _random_tree(rng, 0.1),
               "v": jax.tree_util.tree_map(np.abs, _random_tree(rng, 0.1))}
    else:
        opt = {}
    want_p, want_o = joptim.apply_updates(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, opt), jnp.asarray(t, jnp.int32),
        jcfg)

    model = tpio.params_from_numpy(params)
    leaves = toptim.param_leaves(model)
    t_grads = [torch.from_numpy(g.copy()) for g in jax.tree.leaves(grads)]
    t_opt = {k: [torch.from_numpy(x.copy()) for x in jax.tree.leaves(v)]
             for k, v in opt.items()}
    toptim.apply_updates(leaves, t_grads, t_opt, t, tcfg)
    for p, q in zip(leaves, jax.tree.leaves(want_p)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                   rtol=1e-6, atol=1e-6)
    for p, q in zip(tckpt.opt_leaves(t_opt), jax.tree.leaves(want_o)):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


class _Records(list):
    """A Trainer metrics sink: keeps each epoch's record (unrounded loss)."""

    def write(self, record):
        self.append(record)


def _losses(trainer):
    return [r["loss"] for r in trainer.metrics_sink]


def _trainers(dataset, impl, jax_impl, epochs, **train_kw):
    """The port's and the JAX package's Trainers on `dataset` (with its
    split masks), from the same JAX-initialised parameters, each logging
    into a list."""
    tg, jg = tio.load_dataset(dataset, DATA), jio.load_dataset(dataset, DATA)
    ddir = jio.resolve_dataset_dir(dataset, DATA)
    model_kw = dict(ARCH, num_classes=tg.num_classes, in_dim=tg.feature_dim)
    train_kw = dict(dict(epochs=epochs, optimizer="adam", lr=0.01,
                         clip=True, seed=0), **train_kw)
    jcfg = jconfig.ModelConfig(**model_kw)
    start = jmodel.init_params_for_variant(jcfg, jax.random.PRNGKey(5))
    logs = {"port": [], "jax": []}
    jt = jloop.Trainer(
        jg, jcfg, jconfig.TrainConfig(impl=jax_impl, **train_kw),
        log_fn=logs["jax"].append, metrics_sink=_Records(),
        splits=jsplits.load_split_files(ddir, jg.num_nodes))
    jt.params = start
    tt = tloop.Trainer(
        tg, tconfig.ModelConfig(**model_kw),
        tconfig.TrainConfig(impl=impl, **train_kw), log_fn=logs["port"].append,
        metrics_sink=_Records(),
        splits=tsplits.load_split_files(ddir, tg.num_nodes), device="cpu")
    tt.params = tpio.params_from_numpy(_np_tree(start))
    return tt, jt, logs


def _no_ms(lines):
    return [re.sub(r"total time: [0-9.]+ ms", "total time: <ms> ms", l)
            for l in lines]


def _adam_move_bound(lr, b1, b2, steps):
    """The largest distance Adam can move one weight in `steps` steps,
    whatever the gradients. With m_t = (1-b1) sum_k b1^(t-k) g_k and v_t =
    (1-b2) sum_k b2^(t-k) g_k^2, Cauchy-Schwarz on the terms
    (b1/sqrt(b2))^(t-k) * sqrt(b2)^(t-k) g_k gives
        |m_t| / sqrt(v_t) <= (1-b1)/sqrt(1-b2) * sqrt(sum_{j<t} (b1^2/b2)^j),
    so the bias-corrected step lr * m_hat / (sqrt(v_hat) + eps) is at most
        lr * (1-b1)/(1-b1^t) * sqrt((1-b2^t)/(1-b2))
           * sqrt(sum_{j<t} (b1^2/b2)^j)
    (lr at t = 1). Clipping only rescales g_k, which the bound does not
    see; eps only shortens the step. The bound is the sum over the run."""
    r = b1 * b1 / b2
    return lr * sum(
        (1 - b1) / (1 - b1 ** t) * np.sqrt((1 - b2 ** t) / (1 - b2))
        * np.sqrt(sum(r ** j for j in range(t)))
        for t in range(1, steps + 1))


ADAM_EPS = 1e-8  # Adam's eps in both packages (train/optim.py)
# how far past its rounding Adam's feedback carries a near-zero weight's
# m_hat (_check_final_params)
FEEDBACK = 32


def _check_final_params(tt, jt, epochs):
    """The final parameters of the port's Adam run against the reference's.

    Adam moves a weight by lr * m_hat / (sqrt(v_hat) + eps) a step,
    whatever the gradient's size: where the gradient is near 0 that ratio
    carries the gradient's fp32 rounding at full size, and the two packages
    round differently (MKL's and XLA's GEMMs sum in their own orders). On
    digits, 3 of layer 0's 1,024 w_dst weights (sqrt(v_hat) 5e-7 to 1.4e-6
    in the reference; m_hat 1.4e-7 to 1.1e-6, differing between the
    packages by ~1e-9) ended up to 2.1e-4 apart while every loss agreed to
    4e-7.

    Rounding level: a sum of fp32 terms errs by about eps32 times its
    largest terms. The terms of a gradient are as large as the largest
    gradient among the leaves that share its inputs: a layer's w_src and
    w_dst together (w_dst's gradient is what is left of terms as large as
    w_src's after the softmax's invariance to a shift per destination
    cancels them), every other leaf alone. So delta = eps32 * G, G the
    largest sqrt(v_hat) of that group in the reference.

    - Weights with a real gradient, sqrt(v_hat) >= tau = 4 * T * lr *
      delta / 1e-4, and those that never had one (v = 0: Adam leaves them
      where they started): held to 1e-4. At tau, a step's relative error
      delta / sqrt(v_hat), added up in one direction over T steps of lr,
      is a quarter of 1e-4 (the 4 covers rounding up to 2 delta, twice
      over).
    - The others (up to 68% of a w_dst leaf: its gradient is what the
      shift invariance leaves, through LeakyReLU's kink only): each held
      to its own b = 4 * T * lr * FEEDBACK * delta / (sqrt(v_hat) + eps),
      the same sum with the packages' m_hat apart by FEEDBACK * delta.
      That is Adam's feedback: a near-zero weight that moved apart moves
      the gradients of the others, so their m_hat end up further apart
      than rounding alone puts them. With FEEDBACK = 1 the largest
      distance was 6.2 b in 5 runs on 8 threads (digits, layer 0's w_dst,
      all in one output unit whose gradient fades to ~1e-7), 0.19 b with
      32. A weight that moved the wrong way or not at all is caught:
      reversing or freezing these weights of a w_dst leaf fails the check.
    - Those where b exceeds twice the largest move Adam allows a weight
      over the run (_adam_move_bound; both runs start from the same
      weights), where b says nothing: at most 1/5 of a leaf (14% of
      karate's layer-0 w_dst, 13% of digits'), held to that move."""
    cfg = jt.train_config
    eps32 = float(np.finfo(np.float32).eps)
    names = toptim.param_names(tt.params)
    got = _leaves_np(tt.params)
    want = [np.asarray(q) for q in jax.tree.leaves(jt.params)]
    v = [np.asarray(x) for x in jax.tree.leaves(jt.opt_state["v"])]
    sqrt_v = [np.sqrt(x / (1 - cfg.beta2 ** epochs)) for x in v]
    group = {}
    for name, s in zip(names, sqrt_v):
        key = name.rsplit(".", 1)[0] + ".w" if ".w_" in name else name
        group[key] = max(group.get(key, 0.0), float(s.max()))
    move = 2 * _adam_move_bound(cfg.lr, cfg.beta1, cfg.beta2, epochs)
    for name, p, q, s, vl in zip(names, got, want, sqrt_v, v):
        key = name.rsplit(".", 1)[0] + ".w" if ".w_" in name else name
        sum_lr_delta = 4 * epochs * cfg.lr * eps32 * group[key]
        real = (s >= sum_lr_delta / 1e-4) | (vl == 0)
        b = np.minimum(FEEDBACK * sum_lr_delta / (s + ADAM_EPS), move)
        loose = ~real & (b >= move)
        assert loose.sum() <= 0.2 * b.size, (name, loose.sum())
        np.testing.assert_allclose(p[real], q[real], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_array_less(np.abs(p[~real] - q[~real]), b[~real],
                                     err_msg=name)


def _check_sgd_params(tt, jt, start):
    """The final parameters of the port's SGD run to 1e-5, and each leaf's
    move from the start weights to 1e-4 of the reference's move, plus the
    rounding of the stored weights (2 eps32 of the leaf's norm): SGD adds
    no amplification, and the move holds the leaves whose gradient is near
    0 (w_dst), which move less than 1e-5 in 20 steps of lr 0.01, to what
    their gradients say."""
    eps32 = float(np.finfo(np.float32).eps)
    for name, p, q, p0 in zip(toptim.param_names(tt.params),
                              _leaves_np(tt.params),
                              jax.tree.leaves(jt.params), start):
        q = np.asarray(q)
        np.testing.assert_allclose(p, q, rtol=1e-5, atol=1e-5, err_msg=name)
        err = np.linalg.norm((p - p0) - (q - p0))
        assert err <= 1e-4 * np.linalg.norm(q - p0) + 2 * eps32 * \
            np.linalg.norm(q), (name, err)


@pytest.mark.parametrize("dataset,optimizer", [
    ("karate", "adam"), ("digits", "adam"), ("karate", "sgd"),
    ("digits", "sgd")], ids=["karate", "digits", "karate-sgd", "digits-sgd"])
def test_trainer_matches_jax(dataset, optimizer):
    """20 epochs with clipping: per-epoch losses to 1e-6, the console lines
    character for character apart from the epoch time, and the final
    parameters: with SGD, which adds no amplification, as
    _check_sgd_params sets out; with Adam, as _check_final_params does."""
    tt, jt, logs = _trainers(dataset, "torch", "xla", 20, optimizer=optimizer)
    start = _leaves_np(tt.params)
    tt.run()
    jt.run()
    got, want = _losses(tt), _losses(jt)
    assert len(got) == 20
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    # the 6-decimal print rounds each loss; a tie can flip the last digit,
    # so the lines are compared with the losses taken out
    def strip(lines):
        return [re.sub(r"Avg Loss: [0-9.]+", "Avg Loss: <loss>", l)
                for l in _no_ms(lines)]

    assert strip(logs["port"]) == strip(logs["jax"])
    assert any(l.startswith("Train/Val/Test Accuracy: ") for l in logs["port"])
    if optimizer == "sgd":
        _check_sgd_params(tt, jt, start)
    else:
        _check_final_params(tt, jt, 20)


def test_sell_trainer_matches_jax_sell():
    """impl='sell' through the twins of K1, K2 and K3 against the JAX
    package's impl='sell' (Pallas interpret mode) on karate."""
    tt, jt, logs = _trainers("karate", "sell", "sell", 5)
    tt.run()
    jt.run()
    got, want = _losses(tt), _losses(jt)
    assert len(got) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def _budget_giving(chunks, suggest):
    """The smallest chunk budget for which suggest(budget) (a package's
    chunk policy, non-increasing in the budget) picks at most `chunks`
    chunks; it must pick exactly that many."""
    lo, hi = 1, 1 << 40
    while lo < hi:
        mid = (lo + hi) // 2
        if suggest(mid) > chunks:
            lo = mid + 1
        else:
            hi = mid
    assert suggest(lo) == chunks
    return lo


@pytest.mark.parametrize("impl,chunks", [("sell", 4), ("pallas", 3)])
def test_chunked_trainer_matches_jax(impl, chunks, monkeypatch):
    """Full-graph training on a layout both packages' chunk policies split
    into `chunks` chunks (each package's chunk budget patched here only):
    the port's Trainer through the twins of K1, K2 and K4 (impl='sell') or
    K5, K6 and K8 (impl='pallas') against the JAX Trainer on the same
    chunking (Pallas interpret mode), 3 epochs on digits, losses to 1e-6.
    (At these widths the SELL policies jump from 1 chunk straight to 4 in
    the port, which counts real lanes, and to 2 in the JAX package, which
    counts 128-lane padded ones; 4 is the first count both pick.)"""
    from gatv2_tpu.ops import pallas_attention as jpa
    from gatv2_tpu.ops import sell_attention as jsa
    from gatv2_tpu_torch.ops import pallas_attention as tpa

    g = tio.load_dataset("digits", DATA)
    heads, dims = ARCH["heads"], ARCH["out_dims"]
    if impl == "sell":
        def port(b):
            return tsa.suggest_chunks_for_graph(
                g.row_ptr, g.col_idx, g.num_nodes, heads, dims,
                budget_bytes=b)

        def jax_(b):
            return jsa.suggest_chunks_for_graph(
                g.row_ptr, g.col_idx, g.num_nodes, heads, dims,
                budget_bytes=b)
        modules = (tsa, jsa)
    else:
        hd = max(-(-h * d // 128) * 128 for h, d in zip(heads, dims))

        def port(b):
            return tpa.suggest_num_chunks(g.num_edges, hd, budget_bytes=b)

        def jax_(b):
            return jpa.suggest_num_chunks(g.num_edges, hd, budget_bytes=b)
        modules = (tpa, jpa)
    port_b, jax_b = (_budget_giving(chunks, f) for f in (port, jax_))
    monkeypatch.setattr(modules[0], "default_chunk_budget",
                        lambda device, num_edges=0: port_b)
    monkeypatch.setattr(modules[1], "default_chunk_budget",
                        lambda num_edges: jax_b)
    tt, jt, _ = _trainers("digits", impl, impl, 3)
    assert tt.edge_tiles.num_chunks == chunks
    tt.run()
    jt.run()
    got, want = _losses(tt), _losses(jt)
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def test_console_lines_format():
    lines = []
    g = tio.load_dataset("karate", DATA)
    tr = tloop.Trainer(
        g, tconfig.ModelConfig(**ARCH, num_classes=g.num_classes,
                               in_dim=g.feature_dim),
        tconfig.TrainConfig(epochs=2, seed=1), log_fn=lines.append,
        device="cpu")
    tr.run()
    assert lines[0::2] == ["Epoch 1", "Epoch 2"]
    for l in lines[1::2]:
        assert re.fullmatch(
            r"Avg Loss: \d+\.\d{6}, Accuracy: \d+\.\d{2}%  total time: "
            r"\d+\.\d{2} ms", l), l


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------


def test_checkpoints_cross_restore(tmp_path):
    """A checkpoint the port saves restores in JAX, and one JAX saves
    restores in the port: every parameter and Adam moment, and the epoch."""
    tt, jt, _ = _trainers("karate", "torch", "xla", 3)
    tt.run()
    jt.run()
    meta = tckpt.run_meta(tt.model_config, tt.train_config)
    tckpt.save(tmp_path / "port", tt.params, tt.opt_state, tt.epoch,
               meta=meta)
    # the same fingerprint as the JAX package's for the same configs
    assert meta["config_hash"] == jckpt.run_meta(
        jt.model_config, jt.train_config)["config_hash"]
    jp, jo, epoch = jckpt.restore(jckpt.latest_path(tmp_path / "port"),
                                  jt.params, jt.opt_state)
    assert epoch == 3
    for p, q in zip(_leaves_np(tt.params), jax.tree.leaves(jp)):
        assert np.array_equal(p, np.asarray(q))
    for p, q in zip(tckpt.opt_leaves(tt.opt_state), jax.tree.leaves(jo)):
        assert np.array_equal(p.numpy(), np.asarray(q))

    jckpt.save(tmp_path / "jax", jt.params, jt.opt_state, jt.epoch)
    tt2, _, _ = _trainers("karate", "torch", "xla", 3)
    assert tckpt.restore_into(tmp_path / "jax", tt2)
    assert tt2.epoch == 3
    for p, q in zip(_leaves_np(tt2.params), jax.tree.leaves(jt.params)):
        assert np.array_equal(p, np.asarray(q))
    for p, q in zip(tckpt.opt_leaves(tt2.opt_state),
                    jax.tree.leaves(jt.opt_state)):
        assert np.array_equal(p.numpy(), np.asarray(q))


def test_resume_continues_adam_t(tmp_path):
    """3 epochs, a checkpoint, 3 more after a restore: the same losses as 6
    epochs in one run (Adam's bias correction continues at t = 4)."""
    whole, _, _ = _trainers("karate", "torch", "xla", 6)
    whole.run()
    first, _, _ = _trainers("karate", "torch", "xla", 6)
    first.run(3)
    meta = tckpt.run_meta(first.model_config, first.train_config)
    tckpt.save(tmp_path, first.params, first.opt_state, first.epoch,
               meta=meta)
    second, _, _ = _trainers("karate", "torch", "xla", 6)
    assert tckpt.restore_into(tmp_path, second, expect_meta=meta)
    assert second.epoch == 3
    second.run(3)
    assert _losses(first) + _losses(second) == _losses(whole)
    other = tckpt.run_meta(first.model_config, dataclasses.replace(
        first.train_config, optimizer="sgd"))
    with pytest.raises(tckpt.CheckpointMismatch, match="optimizer"):
        tckpt.restore_into(tmp_path, second, expect_meta=other)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_train_entry_point_cpu(tmp_path, capsys):
    """python -m gatv2_tpu_torch.train --device cpu on karate: the JAX
    package's console lines, a checkpoint, then predict from it; --overlap
    without --mesh warns and trains, --mesh without a card raises; --impl
    sell --batch-size trains (on the CPU through the twins of K1-K3) to
    finite losses."""
    common = ["--dataset", "karate", "--data-root", DATA, "--num-layers", "2",
              "--heads", "2,1", "--outdims", "8,4", "--device", "cpu"]
    ck = tmp_path / "ck"
    r = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.train", *common, "--epochs",
         "3", "--optimizer", "adam", "--lr", "0.01", "--clip", "--seed", "2",
         "--impl", "sell", "--checkpoint-dir", str(ck), "--log-file",
         str(tmp_path / "m.jsonl")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert "Using split masks from dataset directory" in lines
    assert sum(l.startswith("Avg Loss: ") for l in lines) == 3
    assert any(l.startswith("Final Test Accuracy: ") for l in lines)
    # the CPU runs the twins: no kernel is launched
    assert "K1 sell_fwd launches: 0, K2 sell_bwd_dst launches: 0, " \
        "K3 sell_segsum launches: 0" in lines
    assert tckpt.latest_path(ck).name == "ckpt_00000003.npz"
    records = [json.loads(l) for l in
               (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2, 3]
    assert all({"loss", "accuracy", "ms", "ts", "test_accuracy"} <= set(r)
               for r in records)
    r = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.predict", *common,
         "--checkpoint-dir", str(ck), "--out", str(tmp_path / "p")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Loaded checkpoint at epoch 3" in r.stdout
    assert np.loadtxt(tmp_path / "p" / "predictions.txt").shape == (34,)
    # --overlap without --mesh warns and is ignored, as root train.py does;
    # --mesh on a missing card raises rather than running on the CPU
    capsys.readouterr()
    assert tmain.main([*common, "--epochs", "1", "--overlap"]) == 0
    out, err = capsys.readouterr()
    assert "Warning: --overlap requires --mesh; ignored." in err
    assert len(_avg_losses(out)) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain.main([*[a for a in common if a not in ("--device", "cpu")],
                        "--mesh", "2"])
    assert tmain.main([*common, "--epochs", "2", "--seed", "2", "--impl",
                       "sell", "--batch-size", "8", "--fanouts", "3,3",
                       "--sampler-engine", "python"]) == 0
    losses = _avg_losses(capsys.readouterr().out)
    assert len(losses) == 2 and np.isfinite(losses).all()


def _avg_losses(out: str) -> list[float]:
    return [float(re.search(r"Avg Loss: (\S+),", l).group(1))
            for l in out.splitlines() if l.startswith("Avg Loss: ")]


def test_train_profile_writes_a_trace(tmp_path, capsys):
    """--profile DIR: a torch.profiler trace of the training run in DIR."""
    prof = tmp_path / "prof"
    assert tmain.main(["--dataset", "karate", "--data-root", DATA,
                       "--num-layers", "2", "--heads", "2,1", "--outdims",
                       "8,4", "--epochs", "1", "--seed", "1", "--device",
                       "cpu", "--impl", "sell", "--profile", str(prof)]) == 0
    assert f"Profiling to {prof}/" in capsys.readouterr().out.splitlines()
    traces = list(prof.iterdir())
    assert [t.name for t in traces] == ["trace.json"]
    assert "traceEvents" in json.loads(traces[0].read_text())


@pytest.mark.parametrize("mode", [
    [],
    ["--impl", "sell", "--batch-size", "8", "--fanouts", "3,3",
     "--sampler-engine", "python"],
], ids=["full-graph", "minibatch-sell"])
def test_debug_nans_raises_on_a_nan_feature(tmp_path, capsys, mode):
    """A copy of karate with one NaN feature on a train node: --debug-nans
    raises FloatingPointError naming the loss; without the flag the run
    prints its usual lines, with a NaN loss."""
    data = tmp_path / "data"
    (data / "karate").mkdir(parents=True)
    for f in (pathlib.Path(DATA) / "karate").iterdir():
        (data / "karate" / f.name).write_bytes(f.read_bytes())
    feats = np.loadtxt(data / "karate" / "features.txt", dtype=np.float32)
    feats[2, 0] = np.nan  # node 2 is in train_mask.txt
    np.savetxt(data / "karate" / "features.txt", feats, fmt="%g")
    argv = ["--dataset", "karate", "--data-root", str(data), "--num-layers",
            "2", "--heads", "2,1", "--outdims", "8,4", "--epochs", "2",
            "--seed", "1", "--device", "cpu", *mode]
    with pytest.raises(FloatingPointError, match="the loss"):
        tmain.main([*argv, "--debug-nans"])
    capsys.readouterr()
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert len(_avg_losses(out)) == 2 and np.isnan(_avg_losses(out)).any()
    assert "Final Test Accuracy: " in out


def test_debug_nans_in_the_backward():
    """optim.gradients(debug_nans=True) on finite losses: an infinite
    gradient raises FloatingPointError naming its parameter, a NaN made
    inside the backward one naming the autograd function (anomaly mode);
    without the flag both gradients come back as they are."""
    g = tio.load_dataset("karate", DATA)
    cfg = tconfig.ModelConfig(**ARCH, num_classes=g.num_classes,
                              in_dim=g.feature_dim)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(3))

    def loss(scale):
        every = sum(p.sum() for p in toptim.param_leaves(model)) * 0
        w = model.w_o[0, 0]
        # 0, with an infinite derivative
        return every + scale * torch.sqrt(w - w.detach())

    for scale, match in ((1, "the gradient of w_o"), (0, "SqrtBackward0")):
        assert torch.isfinite(loss(scale))
        grads = toptim.gradients(loss(scale), model)
        assert not torch.isfinite(grads[-1]).all()
        with pytest.raises(FloatingPointError, match=match):
            toptim.gradients(loss(scale), model, debug_nans=True)


def _remat_case(case, heads=ARCH["heads"], out_dims=ARCH["out_dims"]):
    """(config, graph inputs, impl) of one remat case on a 300-node graph
    (3 SELL slices of 128 rows): 'torch' on the real edges, 'sell' and
    'pallas' on their unchunked layouts, 'sell-chunked' on 3 chunks."""
    g = random_graph(num_nodes=300, num_edges=2400, feature_dim=12,
                     num_classes=4, seed=3)
    cfg = tconfig.ModelConfig(num_layers=len(heads), heads=heads,
                              out_dims=out_dims, num_classes=g.num_classes,
                              in_dim=g.feature_dim)
    impl = case.split("-")[0]
    if impl == "torch":
        return cfg, (g.features, g.labels, torch.as_tensor(g.src),
                     torch.as_tensor(g.dst), None, None), impl
    if impl == "sell":
        budget = 1 << 16 if case == "sell-chunked" else None
        st, feats, labels, num_valid = tsa.setup_full_graph_sell(
            g, heads, out_dims, device="cpu", budget_bytes=budget)
        assert (st.num_chunks > 1) == (case == "sell-chunked")
    else:
        from gatv2_tpu_torch.ops import pallas_attention as tpa

        st, feats, labels, num_valid = tpa.setup_full_graph(
            g, heads, out_dims, device="cpu")
    return cfg, (feats, labels, None, None, st, num_valid), impl


def _remat_grads(model, cfg, inputs, impl, remat):
    """The parameters' gradients of one loss, with remat on or off."""
    feats, labels, src, dst, st, num_valid = inputs
    loss, _ = tmodel.loss_fn(
        model, torch.as_tensor(feats), src, dst, torch.as_tensor(labels),
        dataclasses.replace(cfg, remat=remat), impl=impl, edge_tiles=st,
        num_valid=num_valid)
    return torch.autograd.grad(loss, toptim.param_leaves(model))


@pytest.mark.parametrize("impl",
                         ["torch", "sell", "sell-chunked", "pallas"])
def test_remat_gives_the_same_gradients(impl):
    """--remat recomputes each layer in the backward pass
    (torch.utils.checkpoint; sell and pallas keep the attention op's
    result from the forward): the gradients are the same numbers."""
    cfg, inputs, impl = _remat_case(impl)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(3))
    grads = [_remat_grads(model, cfg, inputs, impl, remat)
             for remat in (False, True)]
    for p, q in zip(*grads):
        assert torch.equal(p, q)


@pytest.mark.parametrize("case", ["torch", "sell", "sell-chunked", "pallas"])
def test_remat_runs_the_attention_forward_once(case, monkeypatch):
    """One training step's calls of the attention op's forward kernel (the
    K1 / K5 wrapper where the op module looks it up; the torch path's
    whole attention): with sell and pallas the same count with remat on
    as off, since the recompute takes the forward's result (`reused`
    counts one per layer and head group); with torch twice the count.
    Layer 0's 17 heads make two K5 head groups."""
    from gatv2_tpu_torch.ops import attention as tattn
    from gatv2_tpu_torch.ops import fused
    from gatv2_tpu_torch.ops import pallas_attention as tpa

    cfg, inputs, impl = _remat_case(case, heads=(17, 1), out_dims=(2, 3))
    module, name = {
        "torch": (tattn, "_edge_attention_torch"),
        "sell": (tsa, "sell_fwd"),
        "pallas": (tpa, "pallas_fwd"),
    }[impl]
    kernel, calls = getattr(module, name), [0]

    def counted(*args, **kw):
        calls[0] += 1
        return kernel(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(3))
    counts, reused, grads = [], [], []
    for remat in (False, True):
        calls[0] = 0
        before = fused.attention.reused
        grads.append(_remat_grads(model, cfg, inputs, impl, remat))
        counts.append(calls[0])
        reused.append(fused.attention.reused - before)
    for p, q in zip(*grads):
        assert torch.equal(p, q)
    assert counts[0] > 0
    if impl == "torch":
        assert counts[1] == 2 * counts[0] and reused == [0, 0]
        return
    groups = sum(len(fused.head_groups(tattn.family(impl), h, d))
                 for h, d in zip(cfg.heads, cfg.out_dims))
    assert groups == (2 if impl == "sell" else 3)
    assert counts[1] == counts[0]
    assert reused == [0, groups]


def test_metrics_utils(tmp_path):
    """JsonlSink writes the JAX package's records (with a timestamp); the
    memory report is empty without a CUDA device."""
    from gatv2_tpu.utils.metrics import JsonlSink as JaxSink
    from gatv2_tpu_torch.utils.metrics import JsonlSink, device_memory_report

    for cls, name in ((JsonlSink, "port"), (JaxSink, "jax")):
        sink = cls(str(tmp_path / name))
        sink.write({"epoch": 1, "loss": 0.5})
        sink.close()
        with pytest.raises(ValueError, match="closed"):
            sink.write({})
    port, jax_ = ([json.loads(l) for l in (tmp_path / n).read_text()
                   .splitlines()] for n in ("port", "jax"))
    assert [set(r) for r in port] == [set(r) for r in jax_]
    assert device_memory_report() == {}


def test_train_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    """With no CUDA device and no explicit CPU request, training raises
    before it reads the dataset: never a silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--dataset", "karate", "--data-root", DATA, "--epochs",
                    "1", "--checkpoint-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
