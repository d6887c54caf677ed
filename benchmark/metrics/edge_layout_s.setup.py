"""edge_layout_s.setup: host seconds that set-up spends in the program's
span layout.edge_features (the per-slot edge-feature tables of both SELL
sides), read by a CPU-only profiler around the program's set-up in traced
runs; None where the program has no such span."""


def read(record):
    value = record.get("spans", {}).get("edge_layout_s")
    return value if value else None
