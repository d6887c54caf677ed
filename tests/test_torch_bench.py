"""The port's bench (gatv2_tpu_torch/bench.py) and its tools
(tools/torch_bench_kernels.py, tools/torch_bench_minibatch.py,
tools/torch_profile_roofline.py) on the CPU: their tables against the root
bench.py's, the comm-volume table against the JAX one, the JSON lines of
--device cpu runs (single device and a 2-rank gloo mesh) on a tiny config,
the refusal to run without a card, and that none of them imports JAX."""

import contextlib
import importlib.util
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from gatv2_tpu.data.synthetic import random_graph as jrandom_graph
from gatv2_tpu.parallel import partition as jpart
from gatv2_tpu_torch import bench
from gatv2_tpu_torch.data.synthetic import random_graph
from gatv2_tpu_torch.parallel import partition as tpart
from test_torch_predict import ROOT

# a config small enough for the CPU: 2 layers, heads 2,1, outdims 8,4
TINY = (300, 1500, 16, 4, 2, (2, 1), (8, 4))
TINY_PLAN = (1, 3, 2)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root_bench():
    """The root bench.py (it imports JAX only inside its functions)."""
    return _load(ROOT / "bench.py", "root_bench")


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(bench.CONFIGS, "tiny", TINY)
    return "tiny"


def test_configs_and_rep_plan_match_root_bench(root_bench):
    assert bench.CONFIGS == root_bench.CONFIGS
    assert bench.REFERENCE_EPOCH_MS == root_bench.REFERENCE_EPOCH_MS
    edges = {spec[1] for spec in bench.CONFIGS.values()} | {
        0, 499_999, 500_000, 3_999_999, 4_000_000, 29_999_999, 30_000_000}
    for e in sorted(edges):
        assert bench._rep_plan(e, None, None, None) == \
            root_bench._rep_plan(e, None, None, None), e
    assert bench._rep_plan(10, 2, 5, 1) == (2, 5, 1)


@pytest.mark.parametrize("name", list(bench.CONFIGS))
def test_flops_match_root_bench(root_bench, name):
    got = bench.flops_per_epoch(name)
    for impl in ("xla", "pallas", "sell"):
        want = root_bench.flops_per_epoch(name, impl)
        for k in ("model_gflop", "dense_gflop", "edge_gflop"):
            assert got[k] == want[k], (impl, k)


@pytest.mark.parametrize("shards", [2, 4])
def test_comm_volume_table_matches_jax(root_bench, shards):
    kw = dict(num_nodes=400, num_edges=2400, feature_dim=8, num_classes=3,
              seed=3)
    jpg = jpart.partition_graph(jrandom_graph(**kw), shards)
    tpg = tpart.partition_graph(random_graph(**kw), shards)
    jplan, tplan = jpart.halo_exchange_plan(jpg), tpart.halo_exchange_plan(tpg)
    heads, outdims = (4, 1, 1), (64, 32, 16)
    for jp, tp in ((jplan, tplan), (None, None)):
        assert bench.comm_volume_table(tpg, tp, heads, outdims) == \
            root_bench.comm_volume_table(jpg, jp, heads, outdims)


def _main_line(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


@pytest.mark.parametrize("impl", ["auto", "sell", "pallas"])
def test_cpu_line(tiny, impl, monkeypatch):
    """`--device cpu` on a tiny config: one line that parses, with every
    key, `correct: true` against the torch impl (the sell impl for torch
    itself), and null in every field only the card gives. auto resolves to
    torch on the CPU."""
    monkeypatch.setattr(bench, "_rep_plan", lambda e, k1, k2, reps:
                        TINY_PLAN)
    rc, line = _main_line(["--config", tiny, "--device", "cpu", "--impl",
                           impl])
    assert rc == 0
    assert set(bench.LINE_FIELDS) <= set(line)
    oracle = "sell" if line["impl"] == "torch" else "torch"
    assert line["correct"] is True
    assert line["correct_check"].startswith(f"vs the {oracle} impl ")
    assert line["device"] == "cpu"
    assert line["impl"] == ("torch" if impl == "auto" else impl)
    for k in bench.DEVICE_ONLY + ("peak_tflops", "peak_tier"):
        assert line[k] is None, k
    assert line["samples"] == TINY_PLAN[2] == len(line["epoch_ms_all"])
    assert line["epoch_ms_q1"] <= line["epoch_ms"] <= line["epoch_ms_q3"]
    assert line["vs_baseline"] is None
    assert line["metric"] == "epoch_time_tiny_300N_1500E_fwd_bwd_update"
    assert np.isfinite(line["final_loss"])


@pytest.mark.parametrize("impl,oracle", [("sell", "pallas"),
                                         ("pallas", "sell"), ("torch", None)])
def test_cpu_line_above_the_torch_oracles_size(tiny, impl, oracle,
                                               monkeypatch):
    """Above CHECK_MAX_EDGES `correct` holds sell and pallas to each other
    (the torch path has no oracle there, only finite losses)."""
    monkeypatch.setattr(bench, "CHECK_MAX_EDGES", TINY[1] - 1)
    r = bench.bench_config(tiny, impl=impl, device="cpu", k1=TINY_PLAN[0],
                           k2=TINY_PLAN[1], reps=TINY_PLAN[2])
    assert r["correct"] is True
    if oracle is None:
        assert "no oracle" in r["correct_check"]
    else:
        assert r["correct_check"].startswith(f"vs the {oracle} impl ")


def test_alongside_runs_are_timed_in_turns(tiny):
    """bench_config times `alongside` runs in turns with its runner: each is
    called at k1 and k2 epochs as often as the runner (a warm-up pair, then
    reps pairs), and its samples come back under alongside_ms."""
    k1, k2, reps = TINY_PLAN
    calls = []
    r = bench.bench_config(tiny, impl="sell", device="cpu", k1=k1, k2=k2,
                           reps=reps, alongside={"b": calls.append})
    assert sorted(calls) == sorted([k1, k2] * (reps + 1))
    assert len(r["alongside_ms"]["b"]) == reps == r["samples"]
    assert all(np.isfinite(r["alongside_ms"]["b"]))
    assert "alongside_ms" not in bench.bench_config(
        tiny, impl="sell", device="cpu", k1=k1, k2=k2, reps=reps)


@pytest.mark.parametrize("fault", list(bench.FAULTS))
def test_planted_fault_is_not_correct(tiny, fault):
    """`correct` fails a sell run with a planted fault (bench.planted_fault:
    uniform logits, a backward off by a scale, a runner that never
    updates), and the part of the check meant for it is out of its
    tolerance by more than 10x; once the fault is gone the run is right
    again."""
    plan = dict(k1=TINY_PLAN[0], k2=TINY_PLAN[1], reps=TINY_PLAN[2])
    with bench.planted_fault(fault):
        r = bench.bench_config(tiny, impl="sell", device="cpu", **plan)
    assert r["correct"] is False, r["correct_check"]
    part = bench.FAULTS[fault]
    assert r["check_errs"][part] > 10 * bench.CHECK_RTOL[part], \
        r["correct_check"]
    assert bench.bench_config(tiny, impl="sell", device="cpu",
                              **plan)["correct"] is True


def test_mesh_cpu_line(tiny):
    """One `--mesh 2 --device cpu` line from a RankPool of 2 gloo ranks."""
    r = bench.bench_mesh_config(tiny, 2, device="cpu", impl="sell",
                                k1=TINY_PLAN[0], k2=TINY_PLAN[1],
                                reps=TINY_PLAN[2])
    line = json.loads(json.dumps(bench.mesh_line(r, tiny, 2)))
    assert set(bench.MESH_FIELDS) <= set(line)
    assert line["correct"] is True
    assert (line["transport"], line["ranks_per_card"]) == ("gloo", 0)
    assert line["transport_line"] == "Transport: gloo, 2 ranks on the CPU"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["halo"] == "boundary" and line["mesh"] == 2
    assert len(line["comm_volume"]) == TINY[4]


def test_bench_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run on it")
    out = subprocess.run(
        [sys.executable, "-m", "gatv2_tpu_torch.bench", "--config",
         "citeseer3"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_bench_and_tools_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        "import gatv2_tpu_torch.bench\n"
        "for name in ('torch_bench_kernels', 'torch_bench_minibatch', "
        "'torch_profile_roofline'):\n"
        "    spec = importlib.util.spec_from_file_location(name, "
        "f'tools/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gatv2_tpu', 'bench'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def roofline():
    return _load(ROOT / "tools" / "torch_profile_roofline.py",
                 "torch_profile_roofline")


# kernel names as torch.profiler prints them on the H100 (PERF.md §5)
PROFILER_NAMES = [
    ("void sell_bwd_src_kernel<4, 1>(float const*, int)", "K4 sell_bwd_src"),
    ("void sell_bwd_dst_kernel<8, 1>(float const*)", "K2 sell_bwd_dst"),
    ("void sell_fwd_kernel<8, 4>(float const*)", "K1 sell_fwd"),
    ("void sell_segsum_kernel(float const*)", "K3 sell_segsum"),
    ("void pallas_fwd_kernel<8, 4>(float const*)", "K5 pallas_fwd"),
    ("void pallas_bwd_dst_kernel<8, 4>(float const*)", "K6 pallas_bwd_dst"),
    ("void pallas_segsum_kernel<8, 4>(float const*)", "K7 pallas_segsum"),
    ("void pallas_bwd_src_kernel<8, 4>(float const*)", "K8 pallas_bwd_src"),
    ("merge_segments(float const*, int)", "K6-K8 merge_segments"),
    ("void at::native::(anonymous namespace)::vectorized_gather_kernel<16, "
     "long>(char*, char*, long*, int, long, long, long, long, bool)",
     "gather_index_select"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>", "gather_index_select"),
    ("void at::native::(anonymous namespace)::indexFuncLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>", "scatter_index_add"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3",
     "dense_gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>",
     "dense_gemm"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
     "at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 1, "
     "128, 1>", "layout_copy"),
    ("Memcpy HtoD (Pageable -> Device)", "layout_copy"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "elementwise"),
    ("gloo:all_to_all", "collective"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("void at::native::(anonymous namespace)::distribution_elementwise",
     "elementwise"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float>",
     "dense_gemm"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::"
     "gpu_index_kernel<at::native::index_kernel_impl<at::native::"
     "OpaqueType<4> > >", "gather_index_select"),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>", "layout_copy"),
    ("cudaLaunchKernel", "other"),
]


@pytest.mark.parametrize("name,cat", PROFILER_NAMES)
def test_categorize(roofline, name, cat):
    assert roofline.categorize(name) == cat


@pytest.mark.parametrize("tool,argv,keys", [
    ("torch_bench_kernels", ["--config", "citeseer3", "--k", "4", "--reps",
                             "2", "--impl", "sell"],
     ("ms_per_call", "ms_min", "edges_per_s", "num_chunks", "gflop",
      "achieved_tflops")),
    ("torch_bench_minibatch", ["--nodes", "2000", "--edges", "16000",
                               "--batch", "64", "--fanouts", "4,4",
                               "--batches", "3"],
     ("device_step_ms", "sample_ms", "replay_per_batch_ms",
      "pipelined_per_batch_ms", "pipeline_ratio")),
    ("torch_profile_roofline", ["--config", "citeseer3", "--epochs", "2",
                                "--top", "5"],
     ("categories_ms", "categories_pct", "top_kernels", "busy_pct")),
])
def test_tools_run_on_cpu(tool, argv, keys, tmp_path):
    """Each tool's --device cpu line parses, with its keys and the device
    named; the device-only fields are null."""
    mod = _load(ROOT / "tools" / f"{tool}.py", tool)
    if tool == "torch_profile_roofline":
        argv = argv + ["--out", str(tmp_path)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(argv + ["--device", "cpu"]) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(keys) <= set(line)
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    if tool == "torch_profile_roofline":
        assert line["busy_pct"] is None and line["categories_ms"]
        assert (tmp_path / "trace.json").exists()
    if tool == "torch_bench_kernels":
        assert line["achieved_tflops"] is None and line["num_chunks"] == 1
