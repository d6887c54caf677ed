"""The port's multi-host smoke (tools/torch_multihost_smoke.py): two OS
processes, each one "host" with LOCAL_RANK 0 and LOCAL_WORLD_SIZE 1,
joining a gloo group on localhost through parallel/multihost.initialize.
Each mode's per-epoch losses must be equal across the processes and within
1e-5 relative of the JAX package's single-process run of the same program
(tools/multihost_smoke.py run_training / run_training_sell, 2 virtual
devices of tests/conftest.py) from the same weights, dumped in the text
format. The trainer mode (ShardedTrainer with splits) is held, losses and
split accuracies, to the JAX ShardedTrainer from those weights."""

import importlib.util
import json
import pathlib
import socket
import subprocess
import sys

import jax
import pytest

from gatv2_tpu.config import ModelConfig, TrainConfig
from gatv2_tpu.data.splits import random_splits
from gatv2_tpu.data.synthetic import random_graph
from gatv2_tpu.models import gatv2
from gatv2_tpu.models.params_io import load_params_txt, save_params_txt
from gatv2_tpu.parallel.sharded import ShardedTrainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMOKE = str(ROOT / "tools" / "torch_multihost_smoke.py")
EPOCHS = 4


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_multihost_smoke", ROOT / "tools" / "multihost_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_setup():
    g = random_graph(256, 2048, 16, 4, seed=11)
    mc = ModelConfig(num_layers=2, heads=(2, 2), out_dims=(8, 6),
                     num_classes=g.num_classes, in_dim=g.feature_dim)
    return g, mc


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX tool's run_training weights (PRNGKey(0)), dumped."""
    d = tmp_path_factory.mktemp("w")
    _, mc = _jax_setup()
    save_params_txt(str(d),
                    gatv2.init_params_for_variant(mc, jax.random.PRNGKey(0)))
    return str(d)


def _two_processes(mode, weights):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, SMOKE, str(i), "2", str(port), mode,
         "--load-weights", weights, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"smoke process failed:\n{err[-2000:]}"
            assert "Transport: gloo" in err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [o["process"] for o in outs] == [0, 1]
    # the all-reduced loss is identical on every process
    assert outs[0]["losses"] == outs[1]["losses"]
    assert len(outs[0]["losses"]) == EPOCHS
    return outs[0]["losses"]


@pytest.mark.parametrize("mode", ["step", "sell"])
def test_two_hosts_match_jax_run_training(weights, mode):
    jax_tool = _jax_tool()
    losses = _two_processes(mode, weights)
    ref = (jax_tool.run_training(2) if mode == "step"
           else jax_tool.run_training_sell(2))
    assert losses == pytest.approx(ref, rel=1e-5)
    assert losses[-1] < losses[0]


def test_two_hosts_sharded_trainer_matches_jax(weights):
    rows = _two_processes("trainer", weights)
    g, mc = _jax_setup()
    sp = random_splits(g.num_nodes, (0.6, 0.2, 0.2), seed=3)
    tc = TrainConfig(optimizer="adam", lr=0.02, seed=0, epochs=0)
    jt = ShardedTrainer(g, mc, tc, 2, log_fn=lambda s: None, splits=sp)
    jt.params = load_params_txt(weights, mc)
    for row in rows:
        last = jt.run(1)
        want = [last["loss"], last["train_accuracy"], last["val_accuracy"],
                last["test_accuracy"]]
        assert row[0] == pytest.approx(want[0], rel=1e-5)
        assert row[1:] == pytest.approx(want[1:], abs=1e-6)
    assert rows[-1][0] < rows[0][0]
