"""Readings that the limits of an edge-feature cell (traffic mode
"fullgraph_edge") are set from, run on the card; never by run.py:

    python3 benchmark/calibrate_edge.py --workload ogbn-proteins.fullgraph \
        --seeds S1 S2 ... [--control-seeds C1 ...] [--max-edges M] \
        [--witness] [--out FILE]

As benchmark/calibrate.py does for the plain full-graph cells, on one
graph and one program layout per seed: the numbers of correct.py for the
program as the cell runs it; on the control seeds also for the control
(the program with its own TF32 projections, precision high, the nearest
precision below the configuration's fp32) and for each fault of
faults_edge.py (the edge term dropped, dW_e zero). One JSON line per
(seed, variant), then calibrate.summary's summary. --max-edges cuts the
graph's nodes and edges by one factor, as
benchmark/tests/test_benchmark_control.py does.

--witness asks, seed by seed, which side a gap between the program and
the reference lies with: from the same weights and graph, the program as
the cell runs it, the port's other path (impl 'torch', gathers and
autograd, remat on so that its per-edge tensors fit), that path in
float64 with Adam's step count in float64 too (the runner's is fp32, as
in the JAX package, so 1 - beta2 comes out 1.3e-5 off), and the reference
in float64, each against the fp32 reference and against the float64 one:
the loss gap of every step ("loss_steps", "loss_steps64") and correct.py's
numbers ("numbers", "numbers64"). A variant the card cannot hold reads
"error".
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def variants(control: bool):
    from benchmark.faults_edge import FAULTS

    out = [("program", "highest", None)]
    if control:
        out.append(("control", "high", None))
        out += [(f, "highest", f) for f in FAULTS]
    return out


def seed_rows(ctx, control: bool):
    """Every variant of one seed on one graph and one program layout."""
    from benchmark import correct
    from benchmark.drivers import common, fullgraph, fullgraph_edge
    from benchmark.faults_edge import planted
    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

    cfg, n = ctx.config, ctx.traffic["check_steps"]
    mc = fullgraph_edge.model_config(cfg, "highest")
    graph, w0 = fullgraph_edge.inputs(ctx, mc.edge_dim)
    common.free(ctx.device)
    t0 = time.perf_counter()
    prog, _ = fullgraph_edge.setup(ctx, graph, mc)
    setup_s = time.perf_counter() - t0
    readings = {}
    for name, precision, fault in variants(control):
        mc_v = fullgraph_edge.model_config(cfg, precision)
        p = dict(prog)
        if precision != "highest":
            tc = TrainConfig(optimizer="adam", lr=cfg["lr"], seed=ctx.seed,
                             impl=prog["impl"])
            p["runner"] = make_multi_epoch_runner(
                mc_v, tc, 1, edge_tiles=prog["layout"],
                num_valid=prog["num_valid"])
        params, opt = common.program_state(mc_v, w0, ctx.device)
        with planted(fault) if fault else contextlib.nullcontext():
            readings[name] = fullgraph.first_steps(p, params, opt, n)
        del params, opt, p
    del prog
    common.free(ctx.device)
    t0 = time.perf_counter()
    from benchmark.reference import gatv2_edge as reference

    steps = [(graph["features"], graph["src"], graph["dst"],
              graph["edge_feat"], graph["labels"])] * n
    ref = reference.train(w0, steps, cfg["heads"], cfg["out_dims"],
                          lr=cfg["lr"], slope=cfg["negative_slope"])
    ref_s = time.perf_counter() - t0
    return [dict(variant=name, setup_s=setup_s, reference_s=ref_s,
                 losses=r["losses"], ref_losses=ref["losses"],
                 **correct.training_numbers(r, ref, w0))
            for name, r in readings.items()]


def witness_rows(ctx):
    """The variants of --witness at one seed (module docstring)."""
    import dataclasses

    import torch

    from benchmark import correct
    from benchmark.drivers import common, fullgraph, fullgraph_edge
    from benchmark.reference import gatv2_edge as reference
    from benchmark.reference.gatv2 import ADAM_BETAS
    from gatv2_tpu_torch.config import TrainConfig
    from gatv2_tpu_torch.train import optim
    from gatv2_tpu_torch.train.loop import (make_multi_epoch_runner,
                                            train_epoch)

    cfg, n = ctx.config, ctx.traffic["check_steps"]
    mc = fullgraph_edge.model_config(cfg, "highest")
    graph, w0 = fullgraph_edge.inputs(ctx, mc.edge_dim)
    common.free(ctx.device)
    prog, _ = fullgraph_edge.setup(ctx, graph, mc)
    params, opt = common.program_state(mc, w0, ctx.device)
    got = {"program": fullgraph.first_steps(prog, params, opt, n)}
    del prog, params, opt
    common.free(ctx.device)
    mc_t = dataclasses.replace(mc, remat=True)
    tc = TrainConfig(optimizer="adam", lr=cfg["lr"], seed=ctx.seed,
                     impl="torch")
    runner = make_multi_epoch_runner(mc_t, tc, 1,
                                     edge_feat=graph["edge_feat"])
    path = dict(runner=lambda p, o, t, f, _s, _d, y: runner(
        p, o, t, f, graph["src"], graph["dst"], y),
        features=graph["features"], labels=graph["labels"])
    params, opt = common.program_state(mc_t, w0, ctx.device)
    got["torch_path"] = fullgraph.first_steps(path, params, opt, n)
    del params, opt, path
    common.free(ctx.device)
    f64 = torch.float64
    ef64 = graph["edge_feat"].to(f64)

    def epoch64(p, o, t, f, _s, _d, y):
        loss, acc = train_epoch(p, o, torch.tensor(t + 1.0, dtype=f64,
                                                   device=ctx.device),
                                f, graph["src"], graph["dst"], y, mc_t, tc,
                                edge_feat=ef64)
        return p, o, loss[None], acc

    path = dict(runner=epoch64, features=graph["features"].to(f64),
                labels=graph["labels"])
    try:
        params = common.program_state(mc_t, w0, ctx.device)[0].to(f64)
        opt = optim.init_opt_state(params, "adam")
        got["torch_path64"] = fullgraph.first_steps(path, params, opt, n)
    except torch.cuda.OutOfMemoryError as e:
        got["torch_path64"] = {"error": str(e).splitlines()[0]}
    params = opt = path = ef64 = None
    common.free(ctx.device)
    refs = {}
    for name, dt in (("fp32", torch.float32), ("fp64", torch.float64)):
        steps = [(graph["features"].to(dt), graph["src"], graph["dst"],
                  graph["edge_feat"].to(dt), graph["labels"])] * n
        refs[name] = reference.train([w.to(dt) for w in w0], steps,
                                     cfg["heads"], cfg["out_dims"],
                                     lr=cfg["lr"],
                                     slope=cfg["negative_slope"])
    b1 = ADAM_BETAS[0]
    r64 = refs["fp64"]
    got["reference64"] = dict(losses=r64["losses"],
                              m1=[(1.0 - b1) * g for g in r64["grads1"]],
                              params=r64["params"])
    rows = []
    for name, r in got.items():
        if "error" in r:
            rows.append(dict(variant=name, error=r["error"]))
            continue
        nums = correct.training_numbers(r, refs["fp32"], w0)
        nums64 = correct.training_numbers(r, r64, w0)
        keep = ("loss", "loss1", "grad1", "grad1_median", "grad1_wo",
                "change")
        rows.append(dict(variant=name, losses=r["losses"],
                         ref_losses=refs["fp32"]["losses"],
                         ref64_losses=r64["losses"],
                         loss_steps=nums["loss_steps"],
                         loss_steps64=nums64["loss_steps"],
                         numbers={k: nums[k] for k in keep},
                         numbers64={k: nums64[k] for k in keep}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate_edge.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--max-edges", type=int, default=0)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import calibrate, harness

    if not torch.cuda.is_available():
        print("calibrate_edge: no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        ctx = harness.context(args.workload, seed, 0.0, False,
                              torch.device("cuda", 0), T0, check_only=True)
        if args.max_edges:
            cut = max(1, -(-ctx.config["num_edges"] // args.max_edges))
            ctx.config["num_edges"] //= cut
            ctx.config["num_nodes"] //= cut
        found = (witness_rows(ctx) if args.witness
                 else seed_rows(ctx, seed in args.control_seeds))
        for r in found:
            r = dict(workload=args.workload, seed=seed,
                     **{k: v for k, v in r.items() if k != "leaves"})
            rows.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    s = json.dumps({"workload": args.workload,
                    "summary": calibrate.summary(rows),
                    "card": torch.cuda.get_device_name(0)})
    print(s)
    if out:
        out.write(s + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
