"""The device trace's arithmetic on a synthetic event list: busy time
as the union of device intervals, idle gaps named by the host op
running in them, and the idle share a reader makes of them."""

import math

from benchmark import readers, trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    # device: [0, 100] and [50, 150] overlap -> [0, 150]; a memcpy
    # [200, 250]; a kernel [400, 500]: busy 150 + 50 + 100 = 300 us
    ev("kernel", "sell_fwd_kernel<4>", 0, 100),
    ev("kernel", "void gemm_kernel", 50, 100),
    ev("gpu_memcpy", "Memcpy HtoD", 200, 50),
    ev("kernel", "vectorized_gather_kernel", 400, 100),
    # host: an outer op over everything, an inner one in the long gap
    ev("cpu_op", "outer", 0, 600),
    ev("cpu_op", "aten::item", 260, 130),
    ev("cuda_runtime", "cudaLaunchKernel", 160, 5),
]


def test_busy_time_is_the_union_of_device_intervals():
    r = trace.analyse(EVENTS, wall_s=0.001, steps=2)
    assert math.isclose(r["busy_s"], 300e-6)
    assert r["window_s"] == 0.001 and r["steps"] == 2


def test_idle_gaps_are_named_by_the_innermost_host_op():
    r = trace.analyse(EVENTS, wall_s=0.001, steps=2)
    # gaps: [250, 400] 150 us (mid 325: aten::item), [150, 200] 50 us
    # (mid 175: only "outer")
    assert r["idle_gaps"][0][0] == "aten::item"
    assert math.isclose(r["idle_gaps"][0][1], 150e-6)
    assert r["idle_gaps"][1] == ["outer", 50e-6]


def test_device_ops_by_category():
    r = trace.analyse(EVENTS, wall_s=0.001, steps=2)
    cats = dict(r["device_ops"])
    assert math.isclose(cats["K1 sell_fwd"], 100e-6)
    assert math.isclose(cats["dense_gemm"], 100e-6)
    assert math.isclose(cats["layout_copy"], 50e-6)
    assert math.isclose(cats["gather_index_select"], 100e-6)


def test_no_device_event_reads_nothing():
    assert trace.analyse([ev("cpu_op", "x", 0, 5)], 1.0, 1) == {}
    rec = {"kind": "fullgraph", "steps": 10, "window_s": 1.0}
    assert readers.idle_pct(rec, "fullgraph") is None


def test_idle_share_against_the_unprofiled_step():
    # 2 profiled steps busy 300 us: 150 us a step; unprofiled window
    # 10 steps in 2 ms: 200 us a step -> idle 25%
    rec = {"kind": "fullgraph", "steps": 10, "window_s": 0.002,
           "trace": trace.analyse(EVENTS, wall_s=0.001, steps=2)}
    assert math.isclose(readers.idle_pct(rec, "fullgraph"), 25.0)
    assert readers.idle_pct(rec, "replay") is None


def test_copies_and_categories_per_step():
    # the 50 us HtoD memcpy and the 100 us GEMM over 2 steps
    rec = {"kind": "replay", "steps": 10, "window_s": 0.002,
           "trace": trace.analyse(EVENTS, wall_s=0.001, steps=2)}
    assert math.isclose(rec["trace"]["h2d_s"], 50e-6)
    assert math.isclose(rec["trace"]["categories"]["dense_gemm"], 100e-6)
    assert math.isclose(readers.traced_ms(
        rec, "replay", lambda tr: tr["h2d_s"]), 0.025)
    assert readers.traced_ms(rec, "replay",
                             lambda tr: tr["categories"].get("x", 0)) is None
    assert readers.traced_ms(rec, "fullgraph", lambda tr: 1.0) is None
