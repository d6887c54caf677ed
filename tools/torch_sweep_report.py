#!/usr/bin/env python
"""Turn a sweep JSONL of the port (tools/torch_run_sweep.py) into its
analysis (counterpart of tools/sweep_report.py): the legs that failed or
were flagged, the pallas-vs-sell A/B table with the winner of each config,
the TF32 (`-high`) points against exact fp32, the `-mesh1` rows (one rank
on one card) against the unsharded leg, and the --tile-e study. Markdown
on stdout; every table names the card and power limit its legs ran on.

The round-over-round column compares with an earlier sweep of the port
(--prev FILE); a target verdict is printed only for the targets given on
the command line (--target arxiv=5e8). There are none by default: no
number measured on another chip is a target or a baseline here.

Usage: python tools/torch_sweep_report.py [--in SWEEP_H100.jsonl]
           [--prev EARLIER.jsonl] [--target CONFIG=EDGES_PER_S ...]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# the configs with a pallas leg (bare tag) and a sell leg (-sell)
AB_CONFIGS = ("citeseer3", "cora", "pubmed", "arxiv", "arxiv-pl",
              "products-sub", "products-full")


def load(path: pathlib.Path) -> tuple[dict, dict]:
    """({tag: record} of the legs measured without error, {tag: record}
    of the legs recorded with one); a later line of a tag wins."""
    recs, failed = {}, {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        r = json.loads(line)
        if "error" in r:
            failed[r["tag"]] = r
            recs.pop(r["tag"], None)
        else:
            recs[r["tag"]] = r
            failed.pop(r["tag"], None)
    return recs, failed


def fmt(v, nd=2):
    return "—" if v is None else f"{v:,.{nd}f}"


def cards(recs) -> str:
    seen = sorted({(r.get("device"), r.get("power_limit_w"))
                   for r in recs if r})
    return "; ".join(
        f"{d}, {w:.2f} W" if w is not None else f"{d}" for d, w in seen
    ) or "no leg"


def best_ms(recs: dict, cfg: str):
    vals = [r["value"] for r in (recs.get(cfg), recs.get(f"{cfg}-sell"))
            if r and r.get("value")]
    return min(vals) if vals else None


def parse_targets(items: list[str]) -> dict:
    out = {}
    for item in items:
        cfg, sep, val = item.partition("=")
        if not sep:
            raise SystemExit(
                f"--target wants CONFIG=EDGES_PER_S, got {item!r}")
        out[cfg] = float(val)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default=str(REPO / "SWEEP_H100.jsonl"))
    ap.add_argument("--prev", default=None,
                    help="an earlier sweep JSONL of the port: the "
                         "round-over-round column")
    ap.add_argument("--target", action="append", default=[],
                    metavar="CONFIG=EDGES_PER_S",
                    help="a target for the verdict (repeatable; none by "
                         "default)")
    args = ap.parse_args(argv)
    recs, failed = load(pathlib.Path(args.inp))
    prev = load(pathlib.Path(args.prev))[0] if args.prev else {}
    targets = parse_targets(args.target)
    print(f"Card: {cards(recs.values())} ({args.inp})\n")

    if failed:
        print("## Failed legs (not quoted below)\n")
        for t in sorted(failed):
            r = failed[t]
            red = f" RED: {r['red']};" if r.get("red") else ""
            print(f"- {t}:{red} {r['error'][:200]}")
        print()
    flagged = [t for t, r in recs.items()
               if r.get("red") or r.get("attempts", 1) > 1]
    if flagged:
        print("## Flagged legs (retries / red)\n")
        for t in sorted(flagged):
            r = recs[t]
            bits = []
            if r.get("red"):
                bits.append(f"RED: {r['red']}")
            if r.get("attempts", 1) > 1:
                bits.append(f"attempts={r['attempts']} "
                            f"({', '.join(r.get('retry_signatures', []))})")
            print(f"- {t}: {'; '.join(bits)}")
        print()

    print("## A/B: edge tiles (pallas, K5-K8) vs SELL (K1-K4)\n")
    prev_col = " | prev best ms | vs prev" if prev else ""
    print("| config | pallas ms | sell ms | sell speedup | pallas Medges/s"
          " | sell Medges/s | pallas mfu % | sell mfu % | winner"
          + prev_col + " |")
    print("|---|---|---|---|---|---|---|---|---|" + ("---|---|" if prev
                                                      else ""))
    verdict = []
    for cfg in AB_CONFIGS:
        p, s = recs.get(cfg), recs.get(f"{cfg}-sell")
        p_ms = p and p.get("value")
        s_ms = s and s.get("value")
        speed = (p_ms / s_ms) if (p_ms and s_ms) else None
        winner = ("—" if speed is None else "sell" if speed > 1 else
                  "pallas" if speed < 1 else "tie")
        row = (f"| {cfg} | {fmt(p_ms, 3)} | {fmt(s_ms, 3)} | {fmt(speed)}x | "
               f"{fmt(p and p['edges_per_s'] / 1e6, 1)} | "
               f"{fmt(s and s['edges_per_s'] / 1e6, 1)} | "
               f"{fmt(p and p.get('mfu'))} | {fmt(s and s.get('mfu'))} | "
               f"{winner}")
        if prev:
            best, was = best_ms(recs, cfg), best_ms(prev, cfg)
            gain = (was / best) if (best and was) else None
            row += f" | {fmt(was, 3)} | {fmt(gain)}x"
        print(row + " |")
        tgt = targets.get(cfg)
        if tgt:
            if not (p or s):
                verdict.append(f"- {cfg}: not measured yet")
                continue
            got = max((r.get("edges_per_s") or 0) for r in (p, s) if r)
            verdict.append(
                f"- {cfg}: target {tgt / 1e6:,.1f} M edges/s, best measured "
                f"{got / 1e6:,.1f} M -> " + ("MET" if got >= tgt
                                             else "NOT MET"))
    if targets:
        print("\n## Targets (from the command line)\n")
        print("\n".join(verdict) if verdict else "- (no target row measured)")

    hi = sorted(t for t in recs if t.endswith("-high"))
    if hi:
        print("\n## TF32 ('high') points against exact fp32\n")
        for t in hi:
            r = recs[t]
            base = recs.get(t[: -len("-high")])
            rel = (f" ({base['value'] / r['value']:.2f}x vs exact "
                   f"{fmt(base['value'], 3)} ms)"
                   if base and r.get("value") else "")
            print(f"- {t}: {fmt(r.get('value'), 3)} ms{rel}")

    mesh = sorted(t for t in recs if "mesh1" in t)
    if mesh:
        print("\n## mesh=1 (one rank on one card) against unsharded\n")
        for t in mesh:
            r = recs[t]
            base = recs.get(t.replace("-mesh1", ""))
            ov = (f" ({r['value'] / base['value'] - 1:+.1%} vs unsharded "
                  f"{fmt(base['value'], 3)} ms)"
                  if base and base.get("value") else "")
            print(f"- {t}: {fmt(r.get('value'), 3)} ms{ov}; transport "
                  f"{r.get('transport')}")

    tiles = sorted((t for t in recs if t.startswith("arxiv-te")),
                   key=lambda t: int(t[len("arxiv-te"):]))
    if tiles:
        base = recs.get("arxiv")
        print("\n## --tile-e study (arxiv, pallas)\n")
        for t in tiles:
            r = recs[t]
            rel = (f" ({r['value'] / base['value']:.2f}x the auto tile's "
                   f"{fmt(base['value'], 3)} ms)" if base else "")
            print(f"- {t}: {fmt(r.get('value'), 3)} ms{rel}")

    missing = [t for c in AB_CONFIGS for t in (c, f"{c}-sell")
               if t not in recs]
    if missing:
        print(f"\n(legs not measured: {', '.join(missing)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
