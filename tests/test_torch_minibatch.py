"""The port's minibatch training (train/minibatch.py) against the JAX
package's MinibatchTrainer, on the CPU: two epochs of impl='pallas' (the
port through the plain twins of K5, K6 and K7, the JAX package in Pallas
interpret mode) and of impl='sell' (the twins of K1, K2 and K3 on per-batch
SELL layouts) from the same parameters, carried across as numpy, on the
same python-engine batches; sampled and exact evaluation; and
`python -m gatv2_tpu_torch.train --batch-size ...`.

Tolerance: per-step losses within 1e-5 relative (both run fp32; sums run in
another order)."""

import copy
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gatv2_tpu import config as jconfig
from gatv2_tpu.data import io as jio
from gatv2_tpu.data import splits as jsplits
from gatv2_tpu.train import minibatch as jminibatch
from gatv2_tpu_torch import config as tconfig
from gatv2_tpu_torch.data import io as tio
from gatv2_tpu_torch.data import splits as tsplits
from gatv2_tpu_torch.models import params_io as tpio
from gatv2_tpu_torch.train import minibatch as tminibatch
from gatv2_tpu_torch.train import optim as toptim
from test_torch_predict import DATA, ROOT
# one CPU thread: Adam trajectories need one summation order (see there)
from test_torch_train import _one_cpu_thread  # noqa: F401

LOSS_RTOL = 1e-5
ARCH = dict(num_layers=2, heads=(2, 1), out_dims=(8, 4))


def _record_losses(trainer):
    """Wrap trainer._step so each step's loss is kept in the returned list."""
    losses, step = [], trainer._step

    def recorded(*args):
        out = step(*args)
        losses.append(float(out[2]))
        return out

    trainer._step = recorded
    return losses


def _trainers(dataset, batch_size, **train_kw):
    """The port's and the JAX package's MinibatchTrainers on `dataset`
    (with its split masks) from the JAX trainer's initial parameters."""
    tg, jg = tio.load_dataset(dataset, DATA), jio.load_dataset(dataset, DATA)
    ddir = jio.resolve_dataset_dir(dataset, DATA)
    model_kw = dict(ARCH, num_classes=tg.num_classes, in_dim=tg.feature_dim)
    train_kw = dict(dict(epochs=2, optimizer="adam", lr=0.01, clip=True,
                         seed=0, batch_size=batch_size, fanouts=(4, 4),
                         sampler_engine="python", impl="pallas"), **train_kw)
    jt = jminibatch.MinibatchTrainer(
        jg, jconfig.ModelConfig(**model_kw), jconfig.TrainConfig(**train_kw),
        log_fn=lambda _: None,
        splits=jsplits.load_split_files(ddir, jg.num_nodes))
    tt = tminibatch.MinibatchTrainer(
        tg, tconfig.ModelConfig(**model_kw), tconfig.TrainConfig(**train_kw),
        log_fn=lambda _: None,
        splits=tsplits.load_split_files(ddir, tg.num_nodes), device="cpu")
    tt.params = tpio.params_from_numpy(jax.tree.map(np.asarray, jt.params))
    return tt, jt


@pytest.mark.parametrize("dataset,batch_size,impl", [
    pytest.param("karate", 4, "pallas", id="karate-4"),
    pytest.param("digits", 256, "pallas", id="digits-256"),
    pytest.param("karate", 4, "sell", id="karate-4-sell"),
    pytest.param("digits", 256, "sell", id="digits-256-sell"),
])
def test_minibatch_trainer_matches_jax(dataset, batch_size, impl):
    """Two epochs of Adam (bias correction at the global step) with
    clipping: the same number of steps, per-step losses within 1e-5
    relative; then sampled and exact evaluation from the trained weights
    give the JAX package's accuracies. impl='pallas': edge tiles (the twins
    of K5-K7); impl='sell': per-batch SELL layouts (the twins of K1-K3),
    with exact evaluation on setup_full_graph_sell's layout."""
    tt, jt = _trainers(dataset, batch_size, impl=impl)
    t_losses, j_losses = _record_losses(tt), _record_losses(jt)
    t_last, j_last = tt.run(), jt.run()
    assert len(t_losses) == len(j_losses) == 2 * tt.sampler.batches_per_epoch()
    assert tt.step_count == jt.step_count == len(t_losses)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(t_last["loss"], j_last["loss"],
                               rtol=LOSS_RTOL)
    assert tt.evaluate("test") == pytest.approx(jt.evaluate("test"),
                                                abs=1e-6)
    got, want = tt.evaluate_exact(), jt.evaluate_exact()
    assert set(got) == {"train", "val", "test"}
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_minibatch_torch_impl_and_host_features():
    """impl='torch' on host-gathered features takes the same steps as
    impl='pallas' on device-gathered ones (the same batches), and a resumed
    trainer continues Adam at the global step."""
    tt, _ = _trainers("karate", 8, epochs=1)
    tr, _ = _trainers("karate", 8, epochs=1, impl="torch",
                      feature_residency="host")
    tr.params = copy.deepcopy(tt.params)
    a, b = _record_losses(tt), _record_losses(tr)
    tt.run()
    tr.run()
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=0)
    tr.epoch = 3
    tr.sync_step_count()
    assert tr.step_count == 3 * tr.sampler.batches_per_epoch()


def test_minibatch_step_uses_global_step():
    """make_minibatch_step passes t (the global step) to Adam: the same
    batch at t=1 and t=5 from the same state gives different updates."""
    tt, _ = _trainers("karate", 8)
    b = next(iter(tt.sampler))
    args = tt.batch_args(b)
    start = [p.detach().clone() for p in toptim.param_leaves(tt.params)]

    def step_delta(t):
        for p, s in zip(toptim.param_leaves(tt.params), start):
            p.data.copy_(s)
        tt.opt_state = toptim.init_opt_state(tt.params, "adam")
        tt._step(tt.params, tt.opt_state, t, args[0], args[1], args[2],
                 args[3], b.num_seeds, args[4])
        return [(p - s).clone() for p, s in
                zip(toptim.param_leaves(tt.params), start)]

    d1, d5 = step_delta(1), step_delta(5)
    assert not all(torch.allclose(x, y) for x, y in zip(d1, d5))


def test_minibatch_entry_point_cpu(tmp_path):
    """python -m gatv2_tpu_torch.train --device cpu --batch-size on karate
    prints the JAX package's console lines: the root train.py's, epoch times
    and losses aside."""
    common = ["--dataset", "karate", "--data-root", DATA, "--num-layers",
              "2", "--heads", "2,1", "--outdims", "8,4", "--epochs", "2",
              "--optimizer", "adam", "--lr", "0.01", "--clip", "--seed", "1",
              "--batch-size", "8", "--fanouts", "3,3", "--sampler-engine",
              "python"]
    port = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.train", *common, "--device",
         "cpu", "--impl", "pallas", "--eval-mode", "sampled"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-2000:]
    ref = subprocess.run(
        [sys.executable, "train.py", *common, "--impl", "xla",
         "--eval-mode", "sampled"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "GATV2_PLATFORM": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]

    def shape(out):
        lines = [l for l in out.splitlines()
                 if not l.startswith(("Device memory", "K1 ", "K5 "))]
        lines = [re.sub(r"total time: [0-9.]+ ms", "total time: <ms> ms", l)
                 for l in lines]
        lines = [re.sub(r"Avg Loss: [0-9.]+, Accuracy: [0-9.]+%",
                        "Avg Loss: <l>, Accuracy: <a>%", l) for l in lines]
        return [re.sub(r"Final Test Accuracy: [0-9.]+%",
                       "Final Test Accuracy: <a>%", l) for l in lines]

    assert shape(port.stdout) == shape(ref.stdout)
    assert "Minibatch mode: batch_size=8, fanouts=[3, 3], sampler=python" \
        in port.stdout.splitlines()
    assert "K5 pallas_fwd launches: 0, K6 pallas_bwd_dst launches: 0, " \
        "K7 pallas_segsum launches: 0" in port.stdout.splitlines()
