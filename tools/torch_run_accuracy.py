#!/usr/bin/env python
"""Train the committed real datasets (data/karate, data/digits) through
every training path of the port and put each test accuracy beside the JAX
package's row in ACCURACY.md (the counterpart of tools/run_accuracy.py).

Each (dataset, mode) cell runs `python -m gatv2_tpu_torch.train` in its own
subprocess with tools/run_accuracy.py's protocol: 2 layers, Adam lr 0.01,
200 epochs, seed 0, the committed split masks. The cells run on the card
unless --device cpu is given; the mesh2-* and dp2-minibatch cells start 2
ranks, which share the one card over gloo (or run on the CPU). The device
column names the card and its power limit (nvidia-smi), or `cpu`.

Usage:
  python tools/torch_run_accuracy.py            # every cell -> PERF.md
  python tools/torch_run_accuracy.py --device cpu --epochs 3 \\
      --single dataset=karate mode=torch         # one cell, its JSON row
  python tools/torch_run_accuracy.py --seed 3 --single dataset=digits \\
      mode=minibatch-pallas                      # the same cell, seed 3

The table replaces the block between the two marker lines in PERF.md (or
in the file --perf names); ACCURACY.md is read, never written.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# tools/run_accuracy.py's CONFIGS
CONFIGS = {
    "karate": ["--num-layers", "2", "--heads", "2,2", "--outdims", "8,8",
               "--epochs", "200", "--optimizer", "adam", "--lr", "0.01",
               "--seed", "0"],
    "digits": ["--num-layers", "2", "--heads", "4,4", "--outdims", "16,16",
               "--epochs", "200", "--optimizer", "adam", "--lr", "0.01",
               "--seed", "0"],
}

_MB = ["--batch-size", "128", "--fanouts", "10,10"]
# mode -> (the train command's flags, the mode of its ACCURACY.md row)
MODES = {
    "torch": (["--impl", "torch"], "xla"),
    "sell": (["--impl", "sell"], "sell"),
    "pallas": (["--impl", "pallas"], "pallas"),
    "minibatch-pallas": (["--impl", "pallas", *_MB], "minibatch-pallas"),
    "minibatch-sell": (["--impl", "sell", *_MB], "minibatch-sell"),
    "mesh2-torch": (["--impl", "torch", "--mesh", "2"], "mesh8-cpu"),
    "mesh2-sell": (["--impl", "sell", "--mesh", "2"], "mesh8-sell-cpu"),
    "mesh2-pallas": (["--impl", "pallas", "--mesh", "2"], "mesh8-pallas-cpu"),
    "dp2-minibatch": (["--impl", "torch", "--mesh", "2", *_MB],
                      "dp4-minibatch-cpu"),
}

# tiny karate (34 nodes) is not meaningful for sampled-minibatch modes
_SKIP = {("karate", "minibatch-pallas"), ("karate", "minibatch-sell"),
         ("karate", "dp2-minibatch")}

BEGIN = "<!-- tools/torch_run_accuracy.py: begin -->"
END = "<!-- tools/torch_run_accuracy.py: end -->"


def device_label(device: str) -> str:
    """`cpu`, or the card's name and power limit (nvidia-smi)."""
    if device == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "power limit not read"
    return f"{torch.cuda.get_device_name(0)}, {limit}"


def run_cell(dataset: str, mode: str, device: str, epochs: int, seed: int,
             label: str) -> dict:
    flags, _ = MODES[mode]
    args = list(CONFIGS[dataset])
    args[args.index("--epochs") + 1] = str(epochs)
    args[args.index("--seed") + 1] = str(seed)
    cmd = [sys.executable, "-m", "gatv2_tpu_torch.train", "--dataset",
           dataset, "--data-root", str(REPO / "data"), *args, *flags,
           "--device", device]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         timeout=3600)
    if out.returncode != 0:
        raise RuntimeError(
            f"{dataset}/{mode} failed rc={out.returncode}\n"
            f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    test_acc = final_loss = None
    for line in out.stdout.splitlines():
        if line.startswith("Final Test Accuracy:"):
            test_acc = float(line.split(":")[1].strip().rstrip("%"))
        if line.startswith("Avg Loss:"):
            final_loss = float(line.split("Avg Loss:")[1].split(",")[0])
    if test_acc is None or final_loss is None:
        raise RuntimeError(
            f"{dataset}/{mode}: no accuracy or loss line in the output\n"
            f"{out.stdout[-1500:]}")
    if "--mesh" in flags:
        label += " (2 ranks)" if device == "cpu" else \
            " (2 gloo ranks sharing it)"
    return {"dataset": dataset, "mode": mode, "epochs": epochs, "seed": seed,
            "test_acc_pct": test_acc, "final_train_loss": final_loss,
            "device": label}


def jax_rows() -> tuple[dict, dict]:
    """{(dataset, mode): test accuracy %} of ACCURACY.md's table, and
    {dataset: its cross-implementation spread in pp}."""
    text = (REPO / "ACCURACY.md").read_text()
    rows = {(m[1], m[2]): float(m[3]) for m in re.finditer(
        r"^\| (\w+) \| ([\w-]+) \| ([0-9.]+)% \|", text, re.M)}
    spread = {m[1]: float(m[2]) for m in re.finditer(
        r"^Cross-implementation spread \((\w+)\): ([0-9.]+) pp", text, re.M)}
    return rows, spread


def table(results: list[dict]) -> str:
    rows, spread = jax_rows()
    lines = [
        BEGIN,
        f"{results[0]['epochs']} epochs, seed {results[0]['seed']}:",
        "",
        "| dataset | mode | test accuracy | final train loss | device | "
        "ACCURACY.md row | its test accuracy | difference |",
        "|---|---|---|---|---|---|---|---|",
    ]
    beyond = []
    for r in results:
        jmode = MODES[r["mode"]][1]
        want = rows.get((r["dataset"], jmode))
        diff = None if want is None else r["test_acc_pct"] - want
        lines.append(
            f"| {r['dataset']} | {r['mode']} | {r['test_acc_pct']:.2f}% | "
            f"{r['final_train_loss']:.4f} | {r['device']} | {jmode} | "
            + ("—" if want is None else f"{want:.2f}%") + " | "
            + ("—" if diff is None else f"{diff:+.2f} pp") + " |")
        lim = spread.get(r["dataset"])
        if diff is not None and lim is not None and abs(diff) > lim:
            beyond.append(f"{r['dataset']}/{r['mode']} ({diff:+.2f} pp)")
    lines.append("")
    for ds in dict.fromkeys(r["dataset"] for r in results):
        accs = [r["test_acc_pct"] for r in results if r["dataset"] == ds]
        jax_spread = spread.get(ds, float("nan"))
        lines.append(
            f"Cross-path spread ({ds}): {max(accs) - min(accs):.2f} pp across "
            f"{len(accs)} paths (ACCURACY.md: {jax_spread:.2f} pp).")
    lines.append("Cells further from their ACCURACY.md row than that table's "
                 "own spread: " + (", ".join(beyond) or "none") + ".")
    lines.append(END)
    return "\n".join(lines)


def write_table(path: pathlib.Path, text: str) -> None:
    doc = path.read_text()
    if BEGIN not in doc or END not in doc:
        raise SystemExit(f"{path}: no {BEGIN} ... {END} block to replace")
    head, rest = doc.split(BEGIN, 1)
    path.write_text(head + text + rest.split(END, 1)[1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--epochs", type=int, default=200,
                   help="epochs per cell (the protocol's is 200)")
    p.add_argument("--seed", type=int, default=0,
                   help="the cells' --seed (the protocol's is 0)")
    p.add_argument("--perf", default=str(REPO / "PERF.md"),
                   help="the file whose marked block takes the table")
    p.add_argument("--single", nargs=2, metavar=("dataset=D", "mode=M"),
                   help="run one cell and print its JSON row")
    args = p.parse_args(argv)
    label = device_label(args.device)
    if args.single:
        kv = dict(a.split("=", 1) for a in args.single)
        print(json.dumps(run_cell(kv["dataset"], kv["mode"], args.device,
                                  args.epochs, args.seed, label)))
        return 0
    results = []
    for dataset in CONFIGS:
        for mode in MODES:
            if (dataset, mode) in _SKIP:
                continue
            r = run_cell(dataset, mode, args.device, args.epochs, args.seed,
                         label)
            print(json.dumps(r), flush=True)
            results.append(r)
    text = table(results)
    print(text)
    write_table(pathlib.Path(args.perf), text)
    print(f"wrote the table into {args.perf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
