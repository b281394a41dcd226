"""Structured run metrics: loss, rays/s, step time, grad norms.

The port's own copy of ``adjointnonlinearraytracing_tpu/utils/metrics.py``
(framework-free): JSON-lines on disk plus an in-memory history, greppable and
plottable with no external dependency.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, append: bool = False):
        """``append=True`` keeps an existing file's rows (a resumed run must
        not truncate the loss history already written)."""
        self.path = path
        self.history: List[Dict[str, Any]] = []
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            if not append:
                open(path, "w").close()

    def log(self, step: int, **values):
        rec = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "__float__") else v)
            for k, v in values.items()}}
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def last(self) -> Optional[Dict[str, Any]]:
        return self.history[-1] if self.history else None


class StepTimer:
    """Wall-clock + rays/s accounting for the optimization loop.

    The caller synchronises the device inside the ``with`` block (for example
    by reading the loss), or the time is that of the enqueue only.
    """

    def __init__(self, nrays: int):
        self.nrays = nrays
        self.t0 = None
        self.elapsed = 0.0
        self.steps = 0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self.t0
        self.steps += 1

    @property
    def rays_per_sec(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.nrays * self.steps / self.elapsed

    @property
    def sec_per_step(self) -> float:
        return self.elapsed / max(self.steps, 1)
