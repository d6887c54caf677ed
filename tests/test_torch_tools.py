"""The port's counterparts of the JAX package's data and probe tools,
each held to the JAX tool on the same inputs at a small size:

  tools/torch_convert_ogb.py         byte-equal files to tools/convert_ogb.py
                                     on a synthetic OGB raw/ directory, then
                                     2 epochs of the port's train CLI;
  tools/torch_make_real_datasets.py  byte-equal files to
                                     tools/make_real_datasets.py run in the
                                     same environment (never compared with
                                     the committed data/digits, whose kNN
                                     ties depend on the sklearn version);
  tools/torch_plan_products_4h.py    the plan's lines equal, but for the
                                     memory table (the port's own);
  tools/torch_grad_error_at_scale.py --streams bf16: each rel_* within 1%
                                     of the JAX tool's; --precision high on
                                     the CPU exactly 0 (TF32 is a card
                                     mode), default finite and nonzero;
  tools/torch_bisect_sell_high.py    the probe's loss equal to the JAX
                                     tool's at --precision highest to 1e-5
                                     relative.

Every port tool runs with --device cpu (the kernels' plain twins)."""

import contextlib
import gzip
import importlib.util
import io
import json
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_tool", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(mod, argv, monkeypatch):
    """stdout of mod.main(argv); the JAX tools read sys.argv."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main() if mod.__name__.startswith("jax_") else mod.main(argv)
    assert rc in (0, None)
    return buf.getvalue()


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d: pathlib.Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


# ---------------------------------------------------------------------------
# convert_ogb
# ---------------------------------------------------------------------------

N, F, C, E = 90, 6, 4, 400  # tests/test_convert_ogb.py's raw directory


def _write_csv_gz(path, arr, fmt):
    with gzip.open(path, "wt") as f:
        np.savetxt(f, arr, delimiter=",", fmt=fmt)


@pytest.fixture
def raw_dir(tmp_path):
    rng = np.random.default_rng(11)
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_csv_gz(raw / "edge.csv.gz",
                  rng.integers(0, N, size=(E, 2)).astype(np.int64), "%d")
    _write_csv_gz(raw / "node-feat.csv.gz",
                  rng.standard_normal((N, F)).astype(np.float32), "%.6f")
    _write_csv_gz(raw / "node-label.csv.gz",
                  rng.integers(0, C, size=(N, 1)).astype(np.int64), "%d")
    split = raw / "split" / "time"
    split.mkdir(parents=True)
    perm = rng.permutation(N)
    for name, idx in (("train", perm[:60]), ("valid", perm[60:75]),
                      ("test", perm[75:])):
        _write_csv_gz(split / f"{name}.csv.gz", idx.reshape(-1, 1), "%d")
    return raw


@pytest.mark.parametrize("undirected", [True, False])
def test_convert_ogb_matches_jax_and_trains(raw_dir, tmp_path, monkeypatch,
                                            undirected):
    flags = ["--make-undirected"] if undirected else []
    out_t, out_j = tmp_path / "t" / "synthogb", tmp_path / "j" / "synthogb"
    said = _run_main(_load("torch_convert_ogb"),
                     ["--raw-dir", str(raw_dir), "--out", str(out_t), *flags],
                     monkeypatch)
    r = subprocess.run([sys.executable, "tools/convert_ogb.py", "--raw-dir",
                        str(raw_dir), "--out", str(out_j), *flags],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert said.replace(str(out_t), "") == r.stdout.replace(str(out_j), "")
    assert "with split masks" in said
    files = _files(out_t)
    assert set(files) == {"features.txt", "row_ptr.txt", "col_idx.txt",
                          "labels.txt", "train_mask.txt", "val_mask.txt",
                          "test_mask.txt"}
    assert files == _files(out_j)
    edges = int(files["row_ptr.txt"].split()[-1])
    assert edges == (2 * E if undirected else E)

    t = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.train", "--dataset",
         "synthogb", "--data-root", str(out_t.parent), "--num-layers", "2",
         "--heads", "2,1", "--outdims", "8,8", "--epochs", "2",
         "--optimizer", "adam", "--lr", "0.01", "--seed", "0", "--device",
         "cpu"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert t.returncode == 0, t.stderr[-2000:]
    losses = [float(x) for x in re.findall(r"Avg Loss: ([0-9.eE+-]+)",
                                           t.stdout)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def test_convert_ogb_needs_an_input_mode(tmp_path):
    mod = _load("torch_convert_ogb")
    with pytest.raises(SystemExit):
        mod.main(["--out", str(tmp_path / "x")])


# ---------------------------------------------------------------------------
# make_real_datasets
# ---------------------------------------------------------------------------


def test_make_real_datasets_matches_jax_in_the_same_run(tmp_path,
                                                        monkeypatch):
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    said = _run_main(_load("torch_make_real_datasets"),
                     ["--out", str(out_t)], monkeypatch)
    said_j = _run_main(_jax_tool("make_real_datasets"), ["--out", str(out_j)],
                       monkeypatch)
    assert said.replace(str(out_t), "") == said_j.replace(str(out_j), "")
    files = _files(out_t)
    assert len(files) == 14  # 2 datasets x (4 data + 3 mask files)
    assert files == _files(out_j)


def test_make_real_datasets_refuses_to_overwrite(tmp_path, capsys):
    mod = _load("torch_make_real_datasets")
    (tmp_path / "digits").mkdir()
    (tmp_path / "digits" / "labels.txt").write_text("kept")
    assert mod.main(["--out", str(tmp_path)]) == 2
    assert "refusing to overwrite" in capsys.readouterr().err
    assert (tmp_path / "digits" / "labels.txt").read_text() == "kept"
    assert not (tmp_path / "karate").exists()
    assert mod.main(["--out", str(tmp_path), "--force"]) == 0
    assert (tmp_path / "digits" / "labels.txt").read_text() != "kept"


def test_make_real_datasets_names_a_missing_package(monkeypatch):
    mod = _load("torch_make_real_datasets")
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError, match="needs networkx"):
        mod.make_karate()


# ---------------------------------------------------------------------------
# plan_products_4h
# ---------------------------------------------------------------------------


def _plan_lines(text):
    """The plan's lines: everything but the memory table."""
    return [ln for ln in text.splitlines()
            if ln and not ln.startswith(("  ", "per-shard"))]


def test_plan_products_4h_lines_match_jax(monkeypatch):
    argv = ["--scale", "0.001", "--shards", "2", "4"]
    port = _run_main(_load("torch_plan_products_4h"),
                     [*argv, "--device", "cpu", "--card-gib", "80"],
                     monkeypatch)
    jax_out = _run_main(_jax_tool("plan_products_4h"), argv, monkeypatch)
    lines = _plan_lines(port)
    assert lines == _plan_lines(jax_out)
    assert sum(ln.startswith("layer ") for ln in lines) == 6
    assert "phi = " in port


def test_plan_products_4h_memory_table(monkeypatch):
    out = _run_main(_load("torch_plan_products_4h"),
                    ["--scale", "0.001", "--shards", "1", "2", "--device",
                     "cpu", "--card-gib", "80"], monkeypatch)
    assert "one shard: nothing is exchanged" in out
    assert "v5e" not in out and "24 B/edge" not in out
    tables = out.split("per-shard device memory")[1:]
    assert len(tables) == 2
    for table in tables:
        rows = [ln for ln in table.splitlines() if ln.startswith("  ")]
        gib = [float(re.search(r"([0-9.]+) GiB", ln).group(1)) for ln in rows]
        assert rows[-1].lstrip().startswith("TOTAL")
        assert "card: 80.0 GiB" in rows[-1]
        assert sum(gib[:-1]) == pytest.approx(gib[-1], abs=4e-3)
        assert "chunk budget" in table and "20.000 GiB" in table
    with pytest.raises(SystemExit):  # the CPU has no card to read
        _load("torch_plan_products_4h").main(["--scale", "0.001",
                                              "--device", "cpu"])


# ---------------------------------------------------------------------------
# grad_error_at_scale and the bisect probe
# ---------------------------------------------------------------------------

SMALL = ["--nodes", "600", "--edges", "4000"]


def test_grad_error_streams_bf16_matches_jax(monkeypatch):
    port = json.loads(_run_main(_load("torch_grad_error_at_scale"),
                                [*SMALL, "--streams", "bf16", "--device",
                                 "cpu"], monkeypatch))
    ref = json.loads(_run_main(_jax_tool("grad_error_at_scale"),
                               [*SMALL, "--streams", "bf16"], monkeypatch))
    assert port["tier"] == ref["tier"] == "streams_bf16_vs_f32"
    for name in ("d_zs", "d_zd", "d_a"):
        for stat in ("rel_max", "rel_p9999", "rel_p99"):
            assert port[name][stat] == pytest.approx(ref[name][stat],
                                                     rel=1e-2), (name, stat)
    assert port["loss_rel_err"] == pytest.approx(ref["loss_rel_err"],
                                                 rel=1e-2)
    assert port["loss_highest"] == pytest.approx(ref["loss_highest"],
                                                 rel=1e-5)
    assert port["device"] == "cpu" and port["power_limit_w"] is None


@pytest.mark.parametrize("impl", ["sell", "pallas"])
def test_grad_error_precision_tiers_on_the_cpu(monkeypatch, impl):
    tool = _load("torch_grad_error_at_scale")
    high = json.loads(_run_main(tool, [*SMALL, "--impl", impl, "--device",
                                       "cpu"], monkeypatch))
    assert high["tier"] == "precision_high_vs_highest"
    for name in ("d_w_src", "d_w_dst", "d_a"):
        assert high[name] == {"rel_max": 0.0, "rel_p9999": 0.0,
                              "rel_p99": 0.0}
    assert high["loss_rel_err"] == 0.0
    low = json.loads(_run_main(tool, [*SMALL, "--impl", impl, "--precision",
                                      "default", "--device", "cpu"],
                               monkeypatch))
    assert low["tier"] == "precision_default_vs_highest"
    for name in ("d_w_src", "d_w_dst", "d_a"):
        assert all(math.isfinite(v) and 0 < v < 1 for v in
                   low[name].values()), (name, low[name])
    assert 0 < low["loss_rel_err"] < 1e-2
    assert low["loss_highest"] == high["loss_highest"]
    with pytest.raises(SystemExit, match="sell-only"):
        tool.main([*SMALL, "--impl", "pallas", "--streams", "bf16",
                   "--device", "cpu"])


def _probe_loss(text):
    return float(re.search(r"OK fwd(?:\+bwd)? loss=([0-9.eE+-]+)",
                           text).group(1))


@pytest.mark.parametrize("graph", [[], ["--powerlaw"]],
                         ids=["uniform", "powerlaw"])
def test_bisect_probe_matches_jax(monkeypatch, graph):
    port = _run_main(_load("torch_bisect_sell_high"),
                     [*SMALL, *graph, "--device", "cpu"], monkeypatch)
    ref = _run_main(_jax_tool("bisect_sell_high"),
                    [*SMALL, *graph, "--precision", "highest"], monkeypatch)
    assert _probe_loss(port) == pytest.approx(_probe_loss(ref), rel=1e-5)
    gmax = json.loads(re.search(r"gmax=(\[.*\])", port).group(1))
    gmax_ref = json.loads(re.search(r"gmax=(\[.*\])", ref).group(1))
    assert gmax == pytest.approx(gmax_ref, rel=1e-4)
    assert port.splitlines()[0] == ref.splitlines()[0]  # the layout line
    ran = json.loads(re.search(r"kernels: (\{.*\}) on cpu", port).group(1))
    assert set(ran) == {"sell_fwd", "sell_bwd_dst", "sell_segsum",
                        "sell_bwd_src"}


def test_bisect_probe_forward_only_and_chunked(monkeypatch):
    tool = _load("torch_bisect_sell_high")
    full = _run_main(tool, [*SMALL, "--device", "cpu"], monkeypatch)
    fwd = _run_main(tool, [*SMALL, "--fwd-only", "--device", "cpu"],
                    monkeypatch)
    chunked = _run_main(tool, [*SMALL, "--chunks", "2", "--device", "cpu"],
                        monkeypatch)
    assert "OK fwd loss=" in fwd and "gmax" not in fwd
    assert "chunks=2" in chunked.splitlines()[0]
    assert _probe_loss(fwd) == pytest.approx(_probe_loss(full), rel=1e-6)
    assert _probe_loss(chunked) == pytest.approx(_probe_loss(full), rel=1e-6)
