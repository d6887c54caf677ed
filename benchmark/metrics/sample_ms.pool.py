"""sample_ms.pool: the median host ms of one next() on the program's
NeighborSampler while set-up draws the pool; nothing else runs on the
host then."""

from benchmark import readers


def read(record):
    if record.get("kind") != "replay":
        return None
    return readers.median(record.get("spans", {}).get("sample_ms", []))
