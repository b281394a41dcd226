"""Probe: the hand-written row gather (kernel K4) against ``torch.index_select``.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/probe_dma_gather.py``.
The JAX probe asks whether a Pallas kernel that keeps several row copies in
flight on a semaphore ring beats its compiler's row gather for ``table[idx]``
(N rows of 128 f32 from an (R, 128) table).  Here the same function is the
CUDA kernel ``kernels/csrc/gather_rows.cu`` (one warp per row, 16 bytes per
lane) and the yardstick is the library call ``torch.index_select``, which the
port uses nowhere else.

Method: ``reps`` distinct index vectors from a seeded generator (one per timed
dispatch), correctness first (``max|plain - kernel| == 0``), then ms per
dispatch, ns per row and GB/s of gathered rows, timed with CUDA events.

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.probe_dma_gather
Env:    PROBE_R (table rows, default 287496 = 66^3), PROBE_N (rows gathered,
        default 262144), PROBE_REPS (default 8).  The JAX probe's PROBE_CHUNK
        and PROBE_SLOTS size its ring and have no counterpart; neither has
        PROBE_INTERPRET: tensors on the CPU go to the plain version.
"""

from __future__ import annotations

import json
import os

import torch

from ..convert import require_device
from ..kernels import wrappers as _K

LANES = 128


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K4: ``out[i] = table[idx[i]]`` by tensor indexing."""
    return table[idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (R, L) picked by ``idx`` (N,): the CUDA kernel for CUDA
    tensors, :func:`gather_rows_plain` for CPU tensors.  Indices outside
    ``[0, R)`` are the caller's error on the card (see ``kernels.wrappers``)."""
    if table.is_cuda:
        return _K.gather_rows(table, idx)
    return gather_rows_plain(table, idx)


def _time_ms(fn, idxs) -> float:
    """Mean CUDA-event time of ``fn(idx)`` over the index vectors, after a warm-up."""
    fn(idxs[-1])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for idx in idxs:
        fn(idx)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(idxs)


def run(R=66 ** 3, N=262144, reps=8, device="cuda", seed=0):
    """Check the gather and, on a GPU, time it; returns the result record.

    On ``device="cpu"`` only the correctness check runs (through the plain
    version) and the record holds no times.
    """
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((R, LANES), generator=gen, dtype=torch.float32, device=dev)
    idxs = [torch.randint(0, R, (N,), generator=gen, dtype=torch.int32, device=dev)
            for _ in range(reps)]

    err = float((gather_rows_plain(table, idxs[0]) - gather_rows(table, idxs[0])).abs().max())
    rec = {"R": R, "N": N, "reps": reps, "device": str(dev), "max_abs_err": err}
    if err != 0.0:
        raise AssertionError(f"gather_rows disagrees with its plain version: {err}")
    if dev.type != "cuda":
        return rec

    rec["device"] = torch.cuda.get_device_name(dev)
    row_bytes = LANES * table.element_size()
    for name, fn in (("kernel", lambda i: gather_rows(table, i)),
                     ("index_select", lambda i: torch.index_select(table, 0, i))):
        ms = _time_ms(fn, idxs)
        rec[name] = {"ms_per_dispatch": ms, "ns_per_row": 1e6 * ms / N,
                     "GB_per_s": N * row_bytes / (1e-3 * ms) / 1e9}
    return rec


def main():
    rec = run(R=int(os.environ.get("PROBE_R", 66 ** 3)),
              N=int(os.environ.get("PROBE_N", 262144)),
              reps=int(os.environ.get("PROBE_REPS", 8)))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
