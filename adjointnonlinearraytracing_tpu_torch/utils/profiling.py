"""Profiling helpers: a synchronising checksum, timing, a profiler trace, the
peak memory and the card's name and power limit.

Twin of ``adjointnonlinearraytracing_tpu/utils/profiling.py``.  PyTorch returns
from a CUDA call before the card has finished, so a time read on the host
clock without a synchronise measures the enqueue.  Each helper takes the
device it measures explicitly: on the card it times with CUDA events and
reads ``torch.cuda``'s counters; the host clock and "no reading" are for a
caller that asked for the CPU.  None falls back to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Optional

import torch

from ..convert import require_device


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def force(x, device="cuda") -> float:
    """The sum of every tensor in ``x`` (a tensor or nested tuples, lists and
    dicts of them), read on the host: it waits for ``device`` to finish the
    work that made them."""
    dev = require_device(device)
    total = 0.0
    for leaf in _leaves(x):
        total += float(leaf.detach().sum())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return total


def timeit(fn, *args, iters: int = 3, warmup: int = 1, device="cuda") -> float:
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls.

    On a CUDA ``device`` the time is CUDA events around ``iters`` calls on the
    current stream; on the CPU the host clock around them, each call's result
    forced (:func:`force`)."""
    dev = require_device(device)
    for _ in range(warmup):
        force(fn(*args), dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        force(fn(*args), dev)
    return (time.perf_counter() - t0) / iters


def best_of(fn, arg_sets, device="cuda") -> float:
    """Least seconds of one call ``fn(*args)`` over ``arg_sets[1:]``, after a
    warm-up call on ``arg_sets[0]`` (distinct inputs per timed call, as the
    JAX package's in-loop probes take them)."""
    force(fn(*arg_sets[0]), device)
    return min(timeit(fn, *args, iters=1, warmup=0, device=device) for args in arg_sets[1:])


#: ~0.5 ms of the card's clock: longer than the host takes to launch a kernel,
#: K6's wrapper included (its checks, allocation and launch took more than the
#: 0.1 ms allowed before, and the gap showed as kernel time)
BUSY_CYCLES = 1_000_000


def l2_flush_buffer(device="cuda") -> torch.Tensor:
    """256 MB on the card, for :func:`kernel_ms`'s ``flush``."""
    return torch.zeros(64 << 20, dtype=torch.float32, device=require_device(device))


def kernel_ms(fn, reps, flush=None, dirty=False, warm=True) -> float:
    """Median CUDA-event time (ms) of ``fn`` over ``reps`` calls after one warm-up.

    ``flush``: a 256 MB buffer (:func:`l2_flush_buffer`), read before each
    call so that the 50 MB L2 holds none of the call's data, only clean
    lines; with ``dirty`` it is written instead (an earlier yardstick),
    leaving dirty lines that the call's misses must write back first.  Before
    each call the card is kept busy for ~0.5 ms (:data:`BUSY_CYCLES`), so that
    the host's own work before the launch (Python, argument checks,
    allocations) does not show as idle time between the two events: without
    it a call of 0.02 ms on the card read up to twice that."""
    if warm:
        fn()
        if flush is not None:  # the flush's and the wait's own kernels load at first use
            flush.sum()
        torch.cuda._sleep(BUSY_CYCLES)
    times = []
    for _ in range(reps):
        if flush is not None:
            if dirty:
                flush.add_(1.0)
            else:
                flush.sum()
        torch.cuda._sleep(BUSY_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """``torch.profiler`` over the ``with`` block, the card's activity too on a
    CUDA ``device``; writes a Chrome / Perfetto trace ``logdir/trace.json``.
    Yields the profiler (``key_averages()`` sums by kernel)."""
    dev = require_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_gb(device="cuda"):
    """Peak bytes allocated on a CUDA ``device`` (since the last
    ``torch.cuda.reset_peak_memory_stats``) in GB; None for the CPU, which
    keeps no such count."""
    dev = require_device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def card_line() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (a card
    set below its maximum runs slower under load), or None where
    ``nvidia-smi`` is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
