"""Readings that the limits of benchmark/limits/<cell>.json are set from
(run on the card; never by run.py):

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--control-seeds C1 C2 C3] [--out FILE]

For each seed: the numbers of correct.py for the program as the cell
runs it; on the control seeds also for the control (the program with its
own TF32 projections, --precision high: the nearest precision below the
configuration's fp32) and for each fault of faults.py. One JSON line per
(seed, variant) on standard output and in --out, then a summary: per
number, the largest over the program's seeds (the lower reading) and the
smallest over the control's and each fault's seeds.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

NUMBERS = ("loss", "loss1", "grad1", "grad1_median", "grad1_wo", "change",
           "batch_invalid")


def variants(control: bool):
    from benchmark.faults import FAULTS

    out = [("program", "highest", None)]
    if control:
        out.append(("control", "high", None))
        out += [(f, "highest", f) for f in FAULTS]
    return out


def fullgraph_seed(ctx, control: bool):
    """Every variant of one seed on one graph and one program layout."""
    import torch

    from benchmark.drivers import common, fullgraph
    from benchmark.faults import planted
    from benchmark.reference import gatv2 as reference
    from benchmark import correct

    cfg = ctx.config
    graph, w0 = common.inputs(ctx)
    common.free(ctx.device)
    t0 = time.perf_counter()
    prog = fullgraph.setup(ctx, graph, common.model_config(
        cfg, "highest", cfg["num_edges"]))
    setup_s = time.perf_counter() - t0
    readings = {}
    for name, precision, fault in variants(control):
        mc = common.model_config(cfg, precision, cfg["num_edges"])
        p = dict(prog)
        if precision != "highest":
            from gatv2_tpu_torch.config import TrainConfig
            from gatv2_tpu_torch.train.loop import make_multi_epoch_runner

            tc = TrainConfig(optimizer="adam", lr=cfg["lr"], seed=ctx.seed,
                             impl=prog["impl"])
            p["runner"] = make_multi_epoch_runner(
                mc, tc, 1, edge_tiles=prog["layout"],
                num_valid=prog["num_valid"])
        params, opt = common.program_state(mc, w0, ctx.device)
        with planted(fault) if fault else contextlib.nullcontext():
            readings[name] = fullgraph.first_steps(
                p, params, opt, ctx.traffic["check_steps"])
        del params, opt, p
    del prog
    common.free(ctx.device)
    t0 = time.perf_counter()
    steps = [(graph["features"], graph["src"], graph["dst"],
              graph["labels"],
              torch.ones(cfg["num_nodes"], dtype=torch.bool,
                         device=ctx.device))] * ctx.traffic["check_steps"]
    ref = reference.train(w0, steps, cfg["heads"], cfg["out_dims"],
                          lr=cfg["lr"])
    ref_s = time.perf_counter() - t0
    return [dict(variant=name, setup_s=setup_s, reference_s=ref_s,
                 losses=r["losses"], ref_losses=ref["losses"],
                 **correct.training_numbers(r, ref, w0))
            for name, r in readings.items()]


def driver_seed(ctx, control: bool):
    """Every variant of one seed, each run through the traffic driver's
    set-up and correctness check alone (no window)."""
    from benchmark import harness
    from benchmark.faults import planted

    out = []
    for name, precision, fault in variants(control):
        ctx.precision = precision
        ctx.check_only = True
        t0 = time.perf_counter()
        with planted(fault) if fault else contextlib.nullcontext():
            rec = harness.run_driver(ctx)
        out.append(dict(variant=name, seconds=time.perf_counter() - t0,
                        **rec["numbers"]))
    return out


def summary(rows):
    def pick(variant, fn):
        vals = {}
        for r in rows:
            if r["variant"] != variant:
                continue
            for k in NUMBERS:
                v = r.get(k)
                if v is not None:
                    vals.setdefault(k, []).append(v)
        return {k: fn(v) for k, v in vals.items()}

    worst = (lambda v: math.nan if any(map(math.isnan, v)) else max(v))
    out = {"program_max": pick("program", worst)}
    for name in sorted({r["variant"] for r in rows} - {"program"}):
        out[f"{name}_min"] = pick(name, min)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmark import harness

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    rows = []
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    for seed in seeds:
        ctx = harness.context(args.workload, seed, 0.0, False,
                              torch.device("cuda", 0), T0, check_only=True)
        control = seed in args.control_seeds
        run = (fullgraph_seed if ctx.traffic["mode"] == "fullgraph"
               else driver_seed)
        for r in run(ctx, control):
            r = dict(workload=args.workload, seed=seed, **r)
            rows.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    s = json.dumps({"workload": args.workload, "summary": summary(rows),
                    "card": torch.cuda.get_device_name(0)})
    print(s)
    if out:
        out.write(s + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
