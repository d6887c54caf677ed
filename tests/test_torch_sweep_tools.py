"""The port's sweep runner and report (tools/torch_run_sweep.py,
tools/torch_sweep_report.py) against the JAX sweep tools' contract
(tests/test_sweep_tools.py): a transient that recurs fails loud, never
silently absorbed as attempts=2; with the port's own transient signatures
(rendezvous and gloo transport failures), a CUDA error and a leg whose
bench line says `"correct": false` never retried; and a report that
carries no number of another chip. subprocess.run is faked throughout:
no bench runs here."""

import importlib.util
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_mod", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def rs(monkeypatch):
    mod = _load("torch_run_sweep")
    monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    return mod


class _FakeCompleted:
    def __init__(self, rc, stdout="", stderr=""):
        self.returncode = rc
        self.stdout = stdout
        self.stderr = stderr


def _fake_runs(monkeypatch, mod, results):
    """subprocess.run returns results[i] on its i-th call; the calls are
    counted and their commands kept."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return results[min(len(calls), len(results)) - 1]

    monkeypatch.setattr(mod.subprocess, "run", fake_run)
    return calls


_RENDEZVOUS = ("torch.distributed.DistNetworkError: The server socket has "
               "failed to listen on any local network address. port: 41234"
               " [errno: 98 - Address already in use]")
_GLOO_RESET = ("RuntimeError: [../third_party/gloo/gloo/transport/tcp/"
               "pair.cc:534] Read error [127.0.0.1]:5843: Connection reset "
               "by peer")


def _line(**kw):
    return json.dumps({"value": 1.0, "correct": True, **kw}) + "\n"


def test_run_leg_transient_retry_records_signature(rs, monkeypatch):
    calls = _fake_runs(monkeypatch, rs, [
        _FakeCompleted(1, stderr=_RENDEZVOUS),
        _FakeCompleted(0, stdout=_line()),
    ])
    rec = rs.run_leg("t1", ["--config", "x"], 10)
    assert len(calls) == 2
    assert rec["attempts"] == 2
    assert rec["retry_signatures"] == ["Address already in use"]
    assert "red" not in rec and "error" not in rec
    # every leg is one subprocess of the port's bench, on the card
    assert calls[0][1:4] == ["-m", "gatv2_tpu_torch.bench", "--config"]
    assert calls[0][-2:] == ["--device", "cuda"]


def test_run_leg_both_retries_consumed_marks_red(rs, monkeypatch):
    _fake_runs(monkeypatch, rs, [
        _FakeCompleted(1, stderr=_GLOO_RESET),
        _FakeCompleted(1, stderr=_RENDEZVOUS),
        _FakeCompleted(0, stdout=_line(value=2.0)),
    ])
    rec = rs.run_leg("t2", [], 10)
    assert rec["attempts"] == 3
    assert rec["red"] == "both retries consumed in one sweep"
    assert rec["retry_signatures"] == ["Connection reset by peer",
                                       "Address already in use"]
    assert rec["value"] == 2.0


def test_run_leg_non_transient_fails_immediately(rs, monkeypatch):
    calls = _fake_runs(monkeypatch, rs, [
        _FakeCompleted(1, stderr="ValueError: genuine bug")])
    rec = rs.run_leg("t3", [], 10)
    assert len(calls) == 1
    assert rec["attempts"] == 1
    assert "genuine bug" in rec["error"]


@pytest.mark.parametrize("fault", [
    "CUDA error: an illegal memory access was encountered",
    "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB",
    "CUDA error: unspecified launch failure",
])
def test_run_leg_cuda_error_is_never_retried(rs, monkeypatch, fault):
    """A CUDA fault is the program's or the card's, even when a rank's
    peer then reports a transport failure in the same stderr."""
    calls = _fake_runs(monkeypatch, rs, [
        _FakeCompleted(1, stderr=f"RuntimeError: {fault}\n{_GLOO_RESET}"),
        _FakeCompleted(0, stdout=_line()),
    ])
    rec = rs.run_leg("t4", [], 10)
    assert len(calls) == 1
    assert rec["attempts"] == 1 and fault.split(":")[0] in rec["error"]
    assert "retry_signatures" not in rec


def test_run_leg_incorrect_line_is_recorded_red_and_not_retried(
        rs, monkeypatch):
    """The bench exits 1 after printing a line with correct: false: the
    line is kept for inspection, with an error and a red flag."""
    line = _line(value=7.5, correct=False,
                 correct_check="logits0 3.1e-01 > 1e-03")
    calls = _fake_runs(monkeypatch, rs, [
        _FakeCompleted(1, stdout=line, stderr=_GLOO_RESET),
        _FakeCompleted(0, stdout=_line()),
    ])
    rec = rs.run_leg("t5", [], 10)
    assert len(calls) == 1
    assert rec["value"] == 7.5 and rec["correct"] is False
    assert rec["error"].startswith("correct: false")
    assert "logits0" in rec["error"]
    assert rec["red"]
    table = rs.markdown_table([rec])
    assert "RED:" in table and "7.500" in table


def test_run_leg_timeout_and_no_line(rs, monkeypatch):
    def timeout(cmd, **kw):
        raise rs.subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(rs.subprocess, "run", timeout)
    assert rs.run_leg("t6", [], 10)["error"] == "timeout after 10s"
    _fake_runs(monkeypatch, rs, [_FakeCompleted(0, stdout="not json\n")])
    assert "no JSON line" in rs.run_leg("t7", [], 10)["error"]


def test_markdown_table_flags_column(rs):
    out = rs.markdown_table([
        {"tag": "a", "value": 1.2, "edges_per_s": 1e6, "variance_pct": 24.3,
         "device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0},
        {"tag": "b", "value": 5.0, "attempts": 3,
         "red": "both retries consumed in one sweep", "variance_pct": 1.0},
        {"tag": "c-mesh1", "value": 9.0, "mesh": 1, "transport": "nccl",
         "ranks_per_card": 1},
        {"tag": "d", "error": "timeout after 300s", "attempts": 1},
    ])
    assert "RED: both retries consumed" in out
    assert "attempts=3" in out
    assert "NVIDIA H100 80GB HBM3 | 700.000" in out
    assert "mesh 1, nccl, 1 rank(s) a card" in out
    assert "| d | ERROR: timeout after 300s |" in out


def test_sweep_main_is_rerun_safe(rs, monkeypatch, tmp_path, capsys):
    """A leg already in --out without an error is skipped; one with an
    error runs again; --only picks legs; the legs keep the JAX tags."""
    assert [t for t, _, _ in rs.LEGS][:2] == ["arxiv", "arxiv-sell"]
    assert {"cora", "cora-sell", "arxiv-high", "citeseer3-mesh1",
            "products-full-high"} <= {t for t, _, _ in rs.LEGS}
    args = dict((t, a) for t, a, _ in rs.LEGS + rs.TILE_LEGS)
    assert args["arxiv-sell-high"][-4:] == ["--impl", "sell", "--precision",
                                            "high"]
    assert args["products-sub-mesh1"][-2:] == ["--mesh", "1"]
    assert args["arxiv-te256"][-2:] == ["--tile-e", "256"]
    out = tmp_path / "sweep.jsonl"
    out.write_text(json.dumps({"tag": "cora", "value": 3.0}) + "\n"
                   + json.dumps({"tag": "cora-sell", "error": "x"}) + "\n")
    ran = []

    def fake_leg(tag, args, timeout_s, device="cuda"):
        ran.append((tag, device))
        return {"tag": tag, "value": 4.0, "edges_per_s": 1e6}

    monkeypatch.setattr(rs, "run_leg", fake_leg)
    assert rs.main(["--only", "cora,cora-sell", "--out", str(out),
                    "--device", "cpu"]) == 0
    assert ran == [("cora-sell", "cpu")]
    lines = [json.loads(s) for s in out.read_text().splitlines()]
    assert [r["tag"] for r in lines] == ["cora", "cora-sell", "cora-sell"]
    table = capsys.readouterr().out
    assert "| cora | 3.000 |" in table and "| cora-sell | 4.000 |" in table
    with pytest.raises(SystemExit):
        rs.main(["--only", "nonesuch", "--out", str(out), "--device", "cpu"])


def _rec(tag, value, impl, **kw):
    return {"tag": tag, "value": value, "edges_per_s": 2e9 / value,
            "mfu": 10.0, "impl": impl, "device": "NVIDIA H100 80GB HBM3",
            "power_limit_w": 700.0, "correct": True, **kw}


def test_report_ab_table_prev_and_no_foreign_numbers(tmp_path, capsys):
    rep = _load("torch_sweep_report")
    cur = [
        _rec("arxiv", 6.5, "pallas"), _rec("arxiv-sell", 7.5, "sell"),
        _rec("cora", 4.0, "pallas"), _rec("cora-sell", 3.2, "sell"),
        _rec("arxiv-high", 5.0, "pallas"),
        _rec("products-sub-mesh1", 33.0, "pallas", mesh=1,
             transport="nccl"),
        _rec("products-sub", 30.0, "pallas"),
        _rec("arxiv-te256", 6.0, "pallas"),
        _rec("pubmed", 5.0, "pallas", attempts=2,
             retry_signatures=["Address already in use"]),
        {"tag": "pubmed-sell", "error": "correct: false (logits0)",
         "red": "the bench's correctness check failed", "value": 1.0},
    ]
    prev = [_rec("arxiv", 8.0, "pallas"), _rec("cora-sell", 3.2, "sell")]
    src, old = tmp_path / "cur.jsonl", tmp_path / "prev.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in cur))
    old.write_text("".join(json.dumps(r) + "\n" for r in prev))

    assert rep.main(["--in", str(src), "--prev", str(old)]) == 0
    out = capsys.readouterr().out
    rows = {ln.split(" | ")[0][2:]: ln for ln in out.splitlines()
            if ln.startswith("| ")}
    assert "| 6.500 | 7.500 | 0.87x |" in rows["arxiv"]
    assert rows["arxiv"].endswith("| pallas | 8.000 | 1.23x |")
    assert "| sell | 3.200 | 1.00x |" in rows["cora"]
    assert "Card: NVIDIA H100 80GB HBM3, 700.00 W" in out
    # the failed leg is listed, never quoted as a number
    assert "pubmed-sell: RED: the bench's correctness check failed" in out
    assert "| pubmed | 5.000 | — |" in rows["pubmed"]
    assert "pubmed: attempts=2 (Address already in use)" in out
    assert "arxiv-high: 5.000 ms (1.30x vs exact 6.500 ms)" in out
    assert "products-sub-mesh1: 33.000 ms (+10.0% vs unsharded" in out
    assert "one rank on one card" in out
    assert "arxiv-te256: 6.000 ms (0.92x the auto tile's" in out
    # no target unless asked for; no number of another chip
    assert "Targets" not in out
    for foreign in ("TPU", "v5e", "r2 ms", "r4", "26,528", "9,293", "240.00",
                    "MET"):
        assert foreign not in out, foreign
    assert not hasattr(rep, "ROUND2_MS")
    assert not hasattr(rep, "TARGETS_EDGES_PER_S")

    assert rep.main(["--in", str(src), "--target", "arxiv=3e8",
                     "--target", "products-full=1e9"]) == 0
    out = capsys.readouterr().out
    assert "- arxiv: target 300.0 M edges/s, best measured 307.7 M -> MET" \
        in out
    assert "- products-full: not measured yet" in out
    assert "prev best ms" not in out
