"""gemm_ms.step: device ms per traced step of the dense_gemm category
(benchmark/trace.py categorize)."""

from benchmark import readers


def read(record):
    return readers.traced_ms(
        record, "replay", lambda tr: tr["categories"].get("dense_gemm", 0.0))
