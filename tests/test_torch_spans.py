"""The program's spans (utils/metrics.py span) on the CPU: without a
profiler recording they open no record_function; under torch.profiler each
is a user_annotation event by name, nested where the work happens; the
layout's steps sit under setup.layout in a full-graph set-up and under
sample.tiles in a sampler's draw; model.remat opens only on the
backward's recompute."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gatv2_tpu_torch.config import ModelConfig, TrainConfig
from gatv2_tpu_torch.data.synthetic import random_graph
from gatv2_tpu_torch.ops import sell_attention
from gatv2_tpu_torch.train import minibatch as tminibatch
from gatv2_tpu_torch.train.loop import Trainer
from gatv2_tpu_torch.utils import metrics

ARCH = dict(num_layers=2, heads=(2, 1), out_dims=(8, 4))
# 128 KiB: the layout splits into several chunks, so the chunk joins run
CHUNKED = 1 << 17

FULL_GRAPH_SPANS = {"train.step", "attn.join", "model.remat"}
LAYOUT_STEPS = {"layout.chunk_plan", "layout.dst_side", "layout.csc_sort",
                "layout.src_side", "layout.pad", "layout.to_device"}
LAYOUT_SPANS = {"setup.layout"} | LAYOUT_STEPS
MINIBATCH_SPANS = {"train.step", "train.h2d", "train.readback",
                   "sample.draw", "sample.tiles"}
SPANS = FULL_GRAPH_SPANS | LAYOUT_SPANS | MINIBATCH_SPANS


@pytest.fixture(scope="module")
def graph():
    return random_graph(num_nodes=300, num_edges=2400, feature_dim=12,
                        num_classes=4, seed=3)


def _model_config(graph, remat=True):
    return ModelConfig(**ARCH, num_classes=graph.num_classes,
                       in_dim=graph.feature_dim, remat=remat)


def _full_graph_epochs(graph, epochs=1, remat=True):
    """The trainer's set-up on a chunked SELL layout, then `epochs` epochs
    through the plain twins of K1, K2 and K4; returns the trainer."""
    tc = TrainConfig(optimizer="adam", lr=0.01, seed=0, impl="sell")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sell_attention, "CPU_CHUNK_BUDGET", CHUNKED)
        tr = Trainer(graph, _model_config(graph, remat), tc,
                     log_fn=lambda _: None, device="cpu")
    tr.run(epochs)
    return tr


def _minibatch_steps(graph, steps=2, impl="pallas"):
    """`steps` sampled steps, each batch drawn by the trainer's sampler."""
    tc = TrainConfig(optimizer="adam", lr=0.01, seed=0, impl=impl,
                     batch_size=32, fanouts=(4, 3), sampler_engine="python",
                     feature_residency="device")
    tr = tminibatch.MinibatchTrainer(graph, _model_config(graph, False), tc,
                                     log_fn=lambda _: None, device="cpu")
    it = iter(tr.sampler)
    for _ in range(steps):
        tr.train_step(next(it))
    return tr


def _profiled_spans(work, *args, **kw) -> list[tuple[str, str | None]]:
    """(name, enclosing span's name or None) of every program span that
    `work` opened under a CPU torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work(*args, **kw)
    found = []
    for ev in prof.events():
        if not (ev.is_user_annotation and ev.name in SPANS):
            continue
        up = ev.cpu_parent
        while up is not None and not (up.is_user_annotation
                                      and up.name in SPANS):
            up = up.cpu_parent
        found.append((ev.name, None if up is None else up.name))
    return found


def test_spans_off_open_no_record_function(graph, monkeypatch):
    """Without a profiler recording, a span is the shared null context:
    the set-up, a chunked full-graph epoch with remat and a minibatch step
    never reach record_function."""

    def refuse(*_a, **_k):
        raise AssertionError("record_function opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert metrics.span("train.step") is metrics.span("attn.join")
    tr = _full_graph_epochs(graph)
    assert tr.edge_tiles.num_chunks > 1
    _minibatch_steps(graph)


@pytest.fixture(scope="module")
def profiled(graph):
    """The spans of a chunked full-graph set-up and epoch, and of two
    minibatch steps with their draws, each under its own profiler."""
    return {"full-graph": _profiled_spans(_full_graph_epochs, graph),
            "minibatch": _profiled_spans(_minibatch_steps, graph)}


@pytest.mark.parametrize("work,names", [
    ("full-graph", FULL_GRAPH_SPANS | LAYOUT_SPANS),
    ("minibatch", MINIBATCH_SPANS),
])
def test_spans_are_profiler_annotations(profiled, work, names):
    """Under torch.profiler (CPU activity) each span is a user_annotation
    event under its own name, and no other span opens."""
    assert {name for name, _ in profiled[work]} == names


@pytest.mark.parametrize("child,parents", [
    *[(c, {"setup.layout"}) for c in sorted(LAYOUT_STEPS)],
    ("train.h2d", {"train.step"}),
    ("train.readback", {"train.step"}),
    # the recompute takes the attention op's kept result: no join runs in it
    ("attn.join", {"train.step"}),
    ("model.remat", {"train.step"}),
])
def test_spans_nest(profiled, child, parents):
    """Each span lies inside the span that owns its work on its thread."""
    mine = [p for work in profiled.values() for name, p in work
            if name == child]
    assert mine and set(mine) == parents


def test_top_level_spans(profiled):
    tops = {name for work in profiled.values() for name, p in work
            if p is None}
    assert tops == {"setup.layout", "train.step", "sample.draw",
                    "sample.tiles"}


def test_sampled_layouts_are_not_set_up(graph):
    """A sell batch's layout is built in the sampler's draw: its steps
    open under sample.tiles, and setup.layout does not open."""
    spans = _profiled_spans(_minibatch_steps, graph, impl="sell")
    steps = {(name, p) for name, p in spans if name.startswith("layout.")}
    assert steps and {p for _, p in steps} == {"sample.tiles"}
    assert "setup.layout" not in {name for name, _ in spans}


@pytest.mark.parametrize("remat,per_backward", [(True, 1), (False, 0)])
def test_remat_span_opens_only_on_the_recompute(graph, remat,
                                                per_backward):
    """model.remat opens once per layer in each backward with remat on (the
    checkpoint's recompute), never in the forward, and never with remat
    off."""
    epochs = 2
    spans = _profiled_spans(_full_graph_epochs, graph, epochs=epochs,
                            remat=remat)
    n_remat = sum(name == "model.remat" for name, _ in spans)
    assert n_remat == per_backward * epochs * ARCH["num_layers"]
    # the joins nest in the step (the recompute runs none of them)
    assert {p for name, p in spans if name == "attn.join"} <= {
        "train.step", "model.remat"}
