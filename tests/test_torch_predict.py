"""The port's entry points: predict against the JAX package's predict on
the same dumped weights, the CLI surface, the no-silent-CPU rule, and that
importing the port (and chip_smoke) pulls in neither JAX nor gatv2_tpu."""

import importlib.util
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gatv2_tpu import cli as jcli
from gatv2_tpu import config as jconfig
from gatv2_tpu.models import gatv2 as jmodel
from gatv2_tpu.models import params_io as jpio
from gatv2_tpu_torch import cli as tcli
from gatv2_tpu_torch import predict as tpredict
from gatv2_tpu_torch.config import ModelConfig
from gatv2_tpu_torch.data.io import load_dataset
from gatv2_tpu_torch.models.gatv2 import init_params, model_forward

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = str(ROOT / "data")
ARCH = ["--num-layers", "2", "--heads", "2,1", "--outdims", "8,4"]


def _jax_predict_main():
    spec = importlib.util.spec_from_file_location("jax_predict", ROOT / "predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def karate_weights(tmp_path_factory):
    g = load_dataset("karate", DATA)
    cfg = jconfig.ModelConfig(num_layers=2, heads=(2, 1), out_dims=(8, 4),
                              num_classes=g.num_classes, in_dim=g.feature_dim)
    d = tmp_path_factory.mktemp("w")
    jpio.save_params_txt(d, jmodel.init_params(cfg, jax.random.PRNGKey(11)))
    return d


def _last_line(text, out_dir):
    return text.strip().splitlines()[-1].replace(str(out_dir), "<out>")


@pytest.mark.parametrize("impl", ["sell", "torch"])
def test_predict_matches_jax(impl, karate_weights, tmp_path, capsys):
    common = ["--dataset", "karate", "--data-root", DATA,
              "--load-weights", str(karate_weights), *ARCH, "--save-probs"]
    assert _jax_predict_main()([*common, "--out", str(tmp_path / "jax")]) == 0
    want_line = _last_line(capsys.readouterr().out, tmp_path / "jax")
    assert tpredict.main([*common, "--out", str(tmp_path / "port"),
                          "--device", "cpu", "--impl", impl]) == 0
    out = capsys.readouterr().out
    assert _last_line(out, tmp_path / "port") == want_line
    assert ("K1 sell_fwd launches" in out) == (impl == "sell")
    for f in ("predictions.txt",):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / "probs.txt"),
                               np.loadtxt(tmp_path / "jax" / "probs.txt"),
                               rtol=1e-5, atol=2e-6)


def test_predict_checkpoint_dir_not_ported(tmp_path):
    """--checkpoint-dir restores now (tests/test_torch_train.py predicts
    from a trained checkpoint); a directory without one is an error, and so
    is giving neither weight source."""
    with pytest.raises(SystemExit, match="no checkpoint found"):
        tpredict.main(["--dataset", "karate", "--data-root", DATA,
                       "--checkpoint-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="required"):
        tpredict.main(["--dataset", "karate", "--data-root", DATA,
                       "--device", "cpu"])


def test_no_silent_cpu(monkeypatch, karate_weights, tmp_path):
    """With no CUDA device and no explicit CPU request, entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.main(["--dataset", "karate", "--data-root", DATA,
                       "--load-weights", str(karate_weights), *ARCH,
                       "--out", str(tmp_path)])
    g = load_dataset("karate", DATA)
    cfg = ModelConfig(num_layers=1, heads=(1,), out_dims=(4,),
                      num_classes=g.num_classes, in_dim=g.feature_dim)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_forward(model, g.features, g.src, g.dst, cfg)
    assert not (tmp_path / "predictions.txt").exists()


@pytest.mark.parametrize("argv,impl", [
    ([], "sell"), (["--device", "cpu"], "torch"),
    (["--device", "cpu", "--impl", "sell"], "sell"),
    (["--impl", "torch"], "torch"),
])
def test_cli_resolves_impl(argv, impl):
    _, tc, args = tcli.parse_args(argv)
    assert tc.impl == impl and args.device in ("cuda", "cpu")


def test_cli_matches_jax_surface(capsys):
    argv = ["--num-layers", "3", "--heads", "4,1,1", "--outdims", "64,32,16",
            "--optimizer", "adam", "--lr", "0.01", "--clip", "--epochs", "7",
            "--precision", "high", "--streams", "bf16", "--variant", "node",
            "--dataset", "karate", "--seed", "3", "--remat"]
    tm, tt, _ = tcli.parse_args([*argv, "--impl", "sell"])
    jm, jt, _ = jcli.parse_args([*argv, "--impl", "sell"])
    assert tcli.echo_config(tm, tt) == jcli.echo_config(jm, jt)
    for f in ("num_layers", "heads", "out_dims", "variant", "matmul_precision",
              "remat", "streams"):
        assert getattr(tm, f) == getattr(jm, f), f
    for f in ("epochs", "optimizer", "lr", "clip", "seed", "dataset",
              "data_root", "batch_size", "fanouts"):
        assert getattr(tt, f) == getattr(jt, f), f
    for bad in (["--heads", "1,1,1"], ["--num-layers", "0"],
                ["--optimizer", "adam", "--beta1", "1.5"]):
        with pytest.raises(SystemExit) as te:
            tcli.parse_args(bad)
        with pytest.raises(SystemExit) as je:
            jcli.parse_args(bad)
        assert str(te.value) == str(je.value)
    tcli.parse_args(["--streams", "bf16", "--impl", "torch"])
    assert "applies to the SELL kernels only" in capsys.readouterr().err
    # --impl auto resolves as in the JAX package on an accelerator: pallas
    # for minibatch training, sell full-graph; explicit pallas parses
    for argv in (["--batch-size", "8"], ["--impl", "pallas"], []):
        assert tcli.parse_args(argv)[1].impl == (
            "pallas" if argv else "sell")
    assert jcli.parse_args(["--batch-size", "8"])[1].impl == "pallas"
    assert tcli.parse_args(["--batch-size", "8", "--device", "cpu"])[1].impl \
        == "torch"
    # --impl sell with --batch-size parses as in the JAX package (minibatch
    # SELL); so do the multi-GPU flags --mesh and --overlap
    for cli in (tcli, jcli):
        tc = cli.parse_args(["--impl", "sell", "--batch-size", "8"])[1]
        assert (tc.impl, tc.batch_size) == ("sell", 8)
    mesh_argv = ["--mesh", "2", "--overlap", "--batch-size", "8"]
    ta, ja = tcli.parse_args(mesh_argv)[2], jcli.parse_args(mesh_argv)[2]
    assert (ta.mesh, ta.overlap) == (ja.mesh, ja.overlap) == (2, True)
    assert tcli.parse_args(mesh_argv)[1].impl == "pallas"
    assert ta.transport == "auto"
    assert tcli.parse_args(["--mesh", "2"])[1].impl == "sell"


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, imports without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gatv2_tpu_torch\n"
        "for m in pkgutil.walk_packages(gatv2_tpu_torch.__path__, "
        "'gatv2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gatv2_tpu' or m.startswith('gatv2_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'gatv2_tpu_torch.predict' in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
