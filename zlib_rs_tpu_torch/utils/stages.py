"""Per-stage timing of the encode and decode paths, off unless `STAGES.enabled`."""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class StageTimes:
    """Per-stage time of `compress_parallel` and `decompress_parallel`,
    off unless `enabled`.
    Device stages are bracketed with CUDA events (summed by `ms()` after
    a synchronize); host stages with the host clock."""

    enabled = False

    def __init__(self):
        self._events = []
        self._host = collections.Counter()

    @contextlib.contextmanager
    def stage(self, name: str, device: torch.device):
        if not self.enabled:
            yield
            return
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            self._events.append((name, e0, e1))
        else:
            t0 = time.perf_counter()
            yield
            self._host[name] += (time.perf_counter() - t0) * 1e3

    def host(self, name: str):
        return self.stage(name, torch.device("cpu"))

    def ms(self) -> dict:
        if self._events:
            torch.cuda.synchronize()
        out = collections.Counter(self._host)
        for name, e0, e1 in self._events:
            out[name] += e0.elapsed_time(e1)
        return dict(out)

    def reset(self):
        self._events.clear()
        self._host.clear()


STAGES = StageTimes()
