"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, with --trace 1 breakdown,
and last `compared` (each number of the correctness check beside its
limit), whose lines also end standard error. Without a card, or with
fewer cards than the cell asks for, it prints no result and exits 3; if
JAX or the JAX package is loaded once the window has closed, exit 4.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import correct, harness

    s = harness.spec()
    cell = harness.cell_entry(s, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 3
    trace = bool(args.trace)
    ctx = harness.context(args.workload, args.seed, args.seconds, trace,
                          torch.device("cuda", 0), T0)
    record = harness.run_driver(ctx)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    metrics = harness.read_metrics(harness.metrics_of(s, cell["name"], trace),
                                   record)
    ok, compared = correct.judge(record["numbers"], ctx.limits)
    line = harness.result_line(record, metrics,
                               harness.device_info(record, trace), ok,
                               compared, trace)
    print(json.dumps({k: record[k] for k in record
                      if k not in ("numbers", "trace", "spans", "step_ms")}),
          file=sys.stderr)
    print(json.dumps({"numbers": {k: v for k, v in record["numbers"].items()
                                  if k != "leaves"}}), file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
