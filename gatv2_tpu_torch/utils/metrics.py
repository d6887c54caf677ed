"""Structured metrics, timing and device-memory reports (port of
gatv2_tpu/utils/metrics.py): a JSONL sink for per-epoch records, the CUDA
allocator's bytes in use per device, and a synchronising step timer."""

from __future__ import annotations

import json
import time
from typing import IO, Any

import torch


class JsonlSink:
    def __init__(self, path: str):
        self.path = path
        self._f: IO | None = open(path, "a", buffering=1)

    def write(self, record: dict[str, Any]) -> None:
        if self._f is None:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        self._f.write(json.dumps(dict(record, ts=time.time())) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def device_memory_report() -> dict[str, int]:
    """Bytes the CUDA caching allocator holds in tensors, per device
    (torch.cuda.memory_allocated); empty without a CUDA device."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())}


class StepTimer:
    """Wall-clock timing of fn(*args) up to the end of its device work
    (torch.cuda.synchronize when a CUDA device is present)."""

    def __init__(self):
        self.times_ms: list[float] = []

    def time(self, fn, *args) -> Any:
        t0 = time.perf_counter()
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    @property
    def best_ms(self) -> float:
        return min(self.times_ms)

    @property
    def mean_ms(self) -> float:
        return sum(self.times_ms) / len(self.times_ms)
