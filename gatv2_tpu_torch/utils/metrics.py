"""Structured metrics, device-memory reports and the program's spans
(port of gatv2_tpu/utils/metrics.py, which has no spans): a JSONL sink for
per-epoch records, the CUDA allocator's bytes in use per device, and
span(name), which marks where the work happens.

A span costs one flag check unless a torch.profiler records (train
--profile DIR, the tools). Then it is a torch.profiler.record_function, a
`user_annotation` event on the profiler's clock and thread, so every
device operation and idle gap in the trace falls inside the program span
that launched it. A CPU-only profiler records the spans of host work the
same way (set-up, the sampler's draws).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import IO, Any

import torch
from torch.autograd import _profiler_enabled


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


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking the enclosed work as `name`: a
    torch.profiler.record_function while a profiler records, else one
    shared null context."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
