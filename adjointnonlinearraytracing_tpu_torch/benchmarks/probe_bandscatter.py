"""Probe: grouped forms of the adjoint's scatter under the bench scene's
coherence.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/probe_bandscatter.py``.
The indices follow the JAX probe's measured profile of the bench sweep: 96 %
of ``N`` rays a step land in a window of ``BAND / 2`` rows around a centre
that drifts one z-layer (``ROWLEN`` rows) a step, 4 % anywhere in the table
(the stragglers).  Each step adds ``(N, L)`` rows into a ``(SITES, L)``
table.  The JAX cases and their torch twins (library calls, measured on
purpose):

- A, the baseline: ``index_add_`` into the table;
- B, a band accumulator: the rows inside a dense ``(BAND, L)`` band go into
  it (``index_add_``), the others straight into the table; every ``K``
  steps the band is added into the table's rows it covers and re-centred on
  the drifted window (K = 8 and 16);
- C, sort + segment sum: ``torch.sort``, the rows taken in order, summed per
  index by ``index_add_`` onto the unique rows, those added into the table;
- D, the unsorted segment sum: ``index_add_`` into a zeroed table, then
  added;
- the attribution of C: the sort alone, and the sort and the take.

The indices of every step are drawn before the timing from a
``torch.Generator`` (the JAX probe draws them inside its loop, and times
the draws), so the times are the scatters'.  Each scatter case, A included,
is held against the same scatter by ``index_put_`` with ``accumulate`` on the
same indices and rows (``max_rel_err``; the JAX probe prints B's against
A) and against the same sums in f64 (``max_rel_err_f64``) before it is
timed.  Times are CUDA events, the least of ``reps``
runs on distinct inputs: ms a step and ns a row.

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.probe_bandscatter
"""

from __future__ import annotations

import json

import torch

from ..convert import require_device
from ..utils import profiling
from .probe_scatter3 import per_step, rel_err, segment_rows

N = 1 << 18
L = 125
SITES = 275_000          # the snapped site count at 128^3, (64 + 2)^3 ~ 287k
ROWLEN = 66 * 66         # sites a z-layer
STEPS = 64
BAND = 1 << 14           # rows of the dense band accumulator


def coherent_idx(gen, n, step, sites=SITES, band=BAND, rowlen=ROWLEN):
    """One step's indices: a window drifting a layer a step, and 4 % stragglers."""
    dev = gen.device
    centre = (20 + step) * rowlen
    main = centre + torch.randint(-band // 4, band // 4, (n,), generator=gen, device=dev)
    tail = torch.randint(0, sites, (n,), generator=gen, device=dev)
    is_tail = torch.rand((n,), generator=gen, device=dev) < 0.04
    return torch.clamp(torch.where(is_tail, tail, main), 0, sites - 1)


def baseline(idxs, vals, sites):
    g = torch.zeros((sites, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for idx in idxs:
        g.index_add_(0, idx, vals)
    return g


def band_scatter(idxs, vals, sites, flush_every, band=BAND, rowlen=ROWLEN):
    """B: the dense band, flushed and re-centred every ``flush_every`` steps."""
    g = torch.zeros((sites + band, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    acc = torch.zeros((band, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    lo = 20 * rowlen
    for i, idx in enumerate(idxs):
        off = idx - lo
        inside = (off >= 0) & (off < band)
        rows_in = inside.nonzero().squeeze(1)
        rows_out = (~inside).nonzero().squeeze(1)
        acc.index_add_(0, off[rows_in], vals[rows_in])
        g.index_add_(0, idx[rows_out], vals[rows_out])
        if (i + 1) % flush_every == 0:
            _flush(g, acc, lo, sites)
            acc.zero_()
            lo += flush_every * rowlen
    _flush(g, acc, lo, sites)
    return g[:sites]


def _flush(g, acc, lo, sites):
    """Add the band into the table's rows from ``lo``.  A band that starts at or
    past the last site holds nothing (every index is below ``sites``; the
    window drifts off the table's end after ~40 of the JAX probe's 64 steps),
    and the JAX probe's ``dynamic_update_slice`` clamps its start there."""
    if lo < sites:
        g[lo:lo + acc.shape[0]] += acc


def sort_segsum(idxs, vals, sites):
    g = torch.zeros((sites, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for idx in idxs:
        uniq, sums = segment_rows(idx, vals)
        g.index_add_(0, uniq, sums)
    return g


def segsum_unsorted(idxs, vals, sites):
    g = torch.zeros((sites, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for idx in idxs:
        g += torch.zeros_like(g).index_add_(0, idx, vals)
    return g


def sort_only(idxs, vals, sites):
    acc = torch.zeros(vals.shape[0], dtype=torch.int64, device=vals.device)
    for idx in idxs:
        acc += torch.sort(idx)[1]
    return acc


def sort_take(idxs, vals, sites):
    acc = torch.zeros_like(vals)
    for idx in idxs:
        acc += vals[torch.sort(idx)[1]]
    return acc


def run(n=N, lanes=L, sites=SITES, steps=STEPS, band=BAND, rowlen=ROWLEN, reps=3,
        dtype=torch.float32, device="cuda", seed=0):
    """Every case's row (printed as it comes); on the CPU only the checks."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets = [([coherent_idx(gen, n, s, sites, band, rowlen) for s in range(steps)],
             torch.randn((n, lanes), generator=gen, dtype=dtype, device=dev), sites)
            for _ in range(reps + 1)]
    idxs, vals, _ = sets[0]
    # the checks: the same sums by index_put_ with accumulate, and in f64
    want, want64 = (torch.zeros((sites, lanes), dtype=t, device=dev)
                    for t in (dtype, torch.float64))
    for idx in idxs:
        want.index_put_((idx,), vals, accumulate=True)
        want64.index_put_((idx,), vals.double(), accumulate=True)
    cases = [("A baseline scatter", baseline, True),
             *((f"B band scatter + flush/{k}",
                lambda i, v, s, k=k: band_scatter(i, v, s, k, band, rowlen), True) for k in (8, 16)),
             ("C sort+take+segsum(sorted)", sort_segsum, True),
             ("D segsum(unsorted ids)", segsum_unsorted, True),
             ("attribution: sort only", sort_only, False),
             ("attribution: sort+take", sort_take, False)]
    rows = []
    for name, fn, scatters in cases:
        got = fn(*sets[0]) if scatters else None
        errs = dict(max_rel_err=rel_err(got, want) if scatters else None,
                    max_rel_err_f64=rel_err(got.double(), want64) if scatters else None)
        dt = profiling.best_of(fn, sets, dev) if dev.type == "cuda" else None
        rows.append(dict(case=name, **per_step(dt, n, steps), **errs))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    run()


if __name__ == "__main__":
    main()
