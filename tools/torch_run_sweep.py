#!/usr/bin/env python
"""Benchmark sweep runner of the port (counterpart of tools/run_sweep.py):
runs every leg of `python -m gatv2_tpu_torch.bench` on the card, one
subprocess per leg under its own timeout, into one JSONL file, and prints a
markdown table of the legs measured.

Legs (the JAX sweep's tags and arguments): a bare config tag runs
--impl pallas, `-sell` --impl sell, `-high` --precision high (TF32 dense
projections), `-mesh1` --mesh 1 (the sharded step on one rank and one
card: the sharding machinery's cost with no peer to talk to);
--tile-study adds the --tile-e 128/256/512 legs on arxiv pallas.

Retries. A leg whose stderr shows a rendezvous or gloo transport failure
(TRANSIENT_SIGNATURES: a port taken between RankPool's free_port() and the
group's bind, a peer's connection reset) is run again, at most twice, after
RETRY_SETTLE_S; its record keeps the attempts and the signatures, and a leg
that needed both retries is marked red. Never retried: a CUDA error
(NEVER_TRANSIENT), and a leg whose last line parses but says
`"correct": false` (the bench exits 1 then). The latter is recorded with
its line, an `error` and a `red` flag, so the report never quotes it as a
clean number.

Usage:  python tools/torch_run_sweep.py [--out SWEEP_H100.jsonl]
            [--tile-study] [--only cora,cora-sell] [--no-sell]
            [--prev EARLIER.jsonl] [--device cpu]
Rerun-safe: legs already in --out without an error are skipped.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# stderr signatures of a rendezvous or transport failure between processes
# (not a fault of the program): retrying is safe
TRANSIENT_SIGNATURES = (
    "Address already in use",
    "Connection reset by peer",
    "Connection closed by peer",
    "DistNetworkError",
)
# a fault of the program or of the card: never retried, whatever else the
# stderr holds
NEVER_TRANSIENT = (
    "illegal memory access",
    "out of memory",
    "unspecified launch failure",
    "CUDA error",
)
RETRY_SETTLE_S = 10

# timeouts: about 5x the longest leg of each size seen on the H100
# (products-full set-up alone takes 42-50 s)
T_SMALL, T_SUB, T_FULL = 300, 600, 900

LEGS: list[tuple[str, list[str], int]] = [
    # (tag, bench args, timeout seconds); every leg names its --impl (the
    # bench's auto would alias the A/B pairs), A/B pairs adjacent
    ("arxiv", ["--config", "arxiv", "--impl", "pallas"], T_SMALL),
    ("arxiv-sell", ["--config", "arxiv", "--impl", "sell"], T_SMALL),
    ("citeseer3", ["--config", "citeseer3", "--impl", "pallas"], T_SMALL),
    ("citeseer3-sell", ["--config", "citeseer3", "--impl", "sell"], T_SMALL),
    ("arxiv-pl", ["--config", "arxiv-pl", "--impl", "pallas"], T_SMALL),
    ("arxiv-pl-sell", ["--config", "arxiv-pl", "--impl", "sell"], T_SMALL),
    ("products-sub", ["--config", "products-sub", "--impl", "pallas"], T_SUB),
    ("products-sub-sell", ["--config", "products-sub", "--impl", "sell"],
     T_SUB),
    ("arxiv-high",
     ["--config", "arxiv", "--impl", "pallas", "--precision", "high"],
     T_SMALL),
    ("arxiv-sell-high",
     ["--config", "arxiv", "--impl", "sell", "--precision", "high"], T_SMALL),
    ("arxiv-pl-sell-high",
     ["--config", "arxiv-pl", "--impl", "sell", "--precision", "high"],
     T_SMALL),
    ("pubmed", ["--config", "pubmed", "--impl", "pallas"], T_SMALL),
    ("pubmed-sell", ["--config", "pubmed", "--impl", "sell"], T_SMALL),
    ("cora", ["--config", "cora", "--impl", "pallas"], T_SMALL),
    ("cora-sell", ["--config", "cora", "--impl", "sell"], T_SMALL),
    ("citeseer3-mesh1",
     ["--config", "citeseer3", "--impl", "pallas", "--mesh", "1"], T_SMALL),
    ("products-sub-mesh1",
     ["--config", "products-sub", "--impl", "pallas", "--mesh", "1"], T_SUB),
    ("products-sub-mesh1-sell",
     ["--config", "products-sub", "--mesh", "1", "--impl", "sell"], T_SUB),
    ("products-full", ["--config", "products-full", "--impl", "pallas"],
     T_FULL),
    ("products-full-sell", ["--config", "products-full", "--impl", "sell"],
     T_FULL),
    ("products-full-high",
     ["--config", "products-full", "--impl", "pallas", "--precision",
      "high"], T_FULL),
]

TILE_LEGS = [
    (f"arxiv-te{te}",
     ["--config", "arxiv", "--impl", "pallas", "--tile-e", str(te)], T_SMALL)
    for te in (128, 256, 512)
]


def _last_json(stdout: str) -> dict | None:
    lines = stdout.strip().splitlines()
    if not lines:
        return None
    try:
        rec = json.loads(lines[-1])
    except json.JSONDecodeError:
        return None
    return rec if isinstance(rec, dict) else None


def run_leg(tag: str, args: list[str], timeout_s: int,
            device: str = "cuda") -> dict:
    cmd = [sys.executable, "-m", "gatv2_tpu_torch.bench", *args,
           "--device", device]
    attempts = 0
    retry_signatures: list[str] = []
    while True:
        attempts += 1
        print(f"[sweep] {tag} (attempt {attempts}): {' '.join(args)}",
              file=sys.stderr, flush=True)
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=timeout_s, cwd=REPO)
        except subprocess.TimeoutExpired:
            return {"tag": tag, "error": f"timeout after {timeout_s}s",
                    "attempts": attempts}
        rec = _last_json(out.stdout)
        if out.returncode != 0:
            err = out.stderr.strip()
            if rec is not None and rec.get("correct") is False:
                # measured, but wrong: kept for inspection, never retried
                check = rec.get("correct_check")
                rec.update(tag=tag, attempts=attempts,
                           error=f"correct: false ({check})",
                           red="the bench's correctness check failed")
                return rec
            fatal = any(s in err for s in NEVER_TRANSIENT)
            sig = next((s for s in TRANSIENT_SIGNATURES if s in err), None)
            if attempts <= 2 and sig is not None and not fatal:
                retry_signatures.append(sig)
                print(f"[sweep] {tag}: transient transport error, retrying "
                      f"in {RETRY_SETTLE_S}s", file=sys.stderr, flush=True)
                time.sleep(RETRY_SETTLE_S)
                continue
            return {"tag": tag, "error": err[-2000:], "attempts": attempts,
                    **({"retry_signatures": retry_signatures}
                       if retry_signatures else {})}
        if rec is None:
            tail = out.stdout.strip()[-500:] or out.stderr.strip()[-500:]
            return {"tag": tag, "attempts": attempts,
                    "error": f"no JSON line on stdout (tail: {tail})"}
        rec["tag"] = tag
        if attempts > 1:
            rec["attempts"] = attempts
            rec["retry_signatures"] = retry_signatures
            if attempts > 2:
                # both retries consumed: no longer a transient; the
                # measurement is kept but must not be quoted as clean
                rec["red"] = "both retries consumed in one sweep"
        return rec


def _cell(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:,.3f}" if v < 1e4 else f"{v:,.0f}"
    return str(v)


def markdown_table(records: list[dict]) -> str:
    cols = [
        ("tag", "leg"), ("value", "epoch ms"), ("edges_per_s", "edges/s"),
        ("mfu", "mfu %"), ("variance_pct", "variance %"),
        ("num_chunks", "chunks"), ("peak_mem_gib", "peak GiB"),
        ("device", "card"), ("power_limit_w", "power limit W"),
        ("_flags", "flags"),
    ]
    lines = ["| " + " | ".join(h for _, h in cols) + " |",
             "|" + "---|" * len(cols)]
    for r in records:
        if "error" in r and "value" not in r:
            cells = [r["tag"], f"ERROR: {r['error'][:60]}"]
            cells += ["—"] * (len(cols) - 2)
            lines.append("| " + " | ".join(cells) + " |")
            continue
        cells = []
        for k, _ in cols:
            if k != "_flags":
                cells.append(_cell(r.get(k)))
                continue
            flags = []
            if r.get("red"):
                flags.append(f"RED: {r['red']}")
            if r.get("attempts", 1) > 1:
                flags.append(f"attempts={r['attempts']}")
            if r.get("mesh"):
                per_card = (f", {r['ranks_per_card']} rank(s) a card"
                            if r.get("ranks_per_card") else "")
                flags.append(f"mesh {r['mesh']}, {r.get('transport')}"
                             f"{per_card}")
            cells.append("; ".join(flags) or "—")
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _read_jsonl(path: pathlib.Path) -> list[dict]:
    if not path.exists():
        return []
    return [json.loads(s) for s in path.read_text().splitlines() if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "SWEEP_H100.jsonl"))
    ap.add_argument("--tile-study", action="store_true")
    ap.add_argument("--no-sell", action="store_true",
                    help="skip the *-sell legs")
    ap.add_argument("--only", default=None,
                    help="comma-separated leg tags to run (a subset sweep)")
    ap.add_argument("--prev", default=None,
                    help="an earlier sweep's JSONL: a leg that needed a "
                         "retry there AND here is marked red (recurring, "
                         "not transient)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="passed to every leg (cpu: the kernels' twins)")
    args = ap.parse_args(argv)

    from gatv2_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card without --device cpu: raise

    prev_path = pathlib.Path(args.prev) if args.prev else None
    prev_retried = {r["tag"] for r in _read_jsonl(prev_path)
                    if r.get("attempts", 1) > 1} if prev_path else set()

    out_path = pathlib.Path(args.out)
    records = [r for r in _read_jsonl(out_path) if "error" not in r]
    done = {r["tag"] for r in records}

    legs = LEGS + (TILE_LEGS if args.tile_study else [])
    if args.no_sell:
        legs = [leg for leg in legs if "-sell" not in leg[0]]
    if args.only:
        want = {t.strip() for t in args.only.split(",")}
        legs = [leg for leg in legs if leg[0] in want]
        missing = want - {leg[0] for leg in legs}
        if missing:
            ap.error(f"unknown --only tags: {sorted(missing)}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("a") as f:
        for tag, leg_args, timeout_s in legs:
            if tag in done:
                print(f"[sweep] {tag}: already done, skipping",
                      file=sys.stderr)
                continue
            rec = run_leg(tag, leg_args, timeout_s, args.device)
            if (rec.get("attempts", 1) > 1 and tag in prev_retried
                    and "red" not in rec):
                rec["red"] = ("retried in two consecutive sweeps (see "
                              f"{prev_path.name}): recurring, not transient")
            f.write(json.dumps(rec) + "\n")
            f.flush()
            records.append(rec)
            print(f"[sweep] {tag}: {json.dumps(rec)[:200]}",
                  file=sys.stderr, flush=True)

    print(markdown_table(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
