"""Probe: the cost of a row scatter-add against its width and its table's rows,
and of its grouped forms, on the card.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/probe_scatter3.py``.  Each
case runs ``steps`` iterations; every iteration adds ``(N, L)`` rows at
pseudo-random row indices, evolved by the JAX probe's LCG, into an ``(R, L)``
table.  The JAX cases map to library calls, measured on purpose (the port's
splat is one, ``fields/rbf.py::splat``):

- the XLA row scatter-add: ``index_add_``;
- the XLA row gather: ``index_select`` (rows summed into an accumulator);
- sort + segment sum: ``torch.sort``, then a segment sum of the sorted rows by
  ``index_add_`` onto the unique rows, then one ``index_add_`` of those;
- the unsorted segment sum: ``index_add_`` into a zeroed table, then added.

Each grouped case is held against the scatter-add baseline on the same
indices and rows, the baseline against ``index_put_`` with ``accumulate``
and the gather against plain indexing (``max_rel_err``), and each against
the same sums in f64 (``max_rel_err_f64``), before it is timed.  The LCG
(the JAX probe's) is not one to one modulo 139,000: after the first step
every row lands on one of 40, so a word sums ~2e4 terms a step and two f32
orders of the same sum differ by up to ~1e-5 of the largest; each order is
within ~5e-6 of the f64 sum.  Times are CUDA events, the least of ``reps``
runs on distinct inputs: ms a step and ns a row.

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.probe_scatter3
"""

from __future__ import annotations

import json

import torch

from ..convert import require_device
from ..utils import profiling

N = 1 << 18
STEPS = 64
SCATTER_SHAPES = ((1 << 14, 128), (139000, 8), (139000, 64), (139000, 128), (139000, 256),
                  (139000, 512), (2146689, 64), (2146689, 128), (1 << 14, 64), (1 << 17, 128))
GATHER_SHAPES = ((2146689, 64), (2146689, 216), (2146689, 512))
SEGSUM_SHAPES = ((139000, 8), (139000, 64))


def evolve(idx: torch.Tensor, r: int) -> torch.Tensor:
    """The JAX probe's LCG: the next step's indices, in ``[0, r)``."""
    return (idx * 1664525 + 1013904223) % r


def scatter(idx, vals, r, steps):
    g = torch.zeros((r, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for _ in range(steps):
        g.index_add_(0, idx, vals)
        idx = evolve(idx, r)
    return g


def scatter_put(idx, vals, r, steps):
    """:func:`scatter` by ``index_put_`` with ``accumulate``: the baseline's check."""
    g = torch.zeros((r, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for _ in range(steps):
        g.index_put_((idx,), vals, accumulate=True)
        idx = evolve(idx, r)
    return g


def gather(idx, table, steps):
    acc = torch.zeros((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    for _ in range(steps):
        acc += torch.index_select(table, 0, idx)
        idx = evolve(idx, table.shape[0])
    return acc


def gather_plain(idx, table, steps):
    """:func:`gather` by plain indexing: the gather case's check."""
    acc = torch.zeros((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    for _ in range(steps):
        acc = acc + table[idx]
        idx = evolve(idx, table.shape[0])
    return acc


def segment_rows(idx, vals):
    """``(unique rows, their sums)``: the rows sorted by index and summed per
    index (``torch.sort`` and a segment sum by ``index_add_``)."""
    si, order = torch.sort(idx)
    uniq, seg = torch.unique_consecutive(si, return_inverse=True)
    sums = torch.zeros((uniq.shape[0], vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return uniq, sums.index_add_(0, seg, vals[order])


def sort_segsum(idx, vals, r, steps):
    g = torch.zeros((r, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for _ in range(steps):
        uniq, sums = segment_rows(idx, vals)
        g.index_add_(0, uniq, sums)
        idx = evolve(idx, r)
    return g


def segsum_unsorted(idx, vals, r, steps):
    g = torch.zeros((r, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for _ in range(steps):
        g += torch.zeros_like(g).index_add_(0, idx, vals)
        idx = evolve(idx, r)
    return g


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _arg_sets(gen, n, r, lanes, reps, dtype, table=False):
    return [(torch.randint(0, r, (n,), generator=gen, device=gen.device),
             torch.randn((r if table else n, lanes), generator=gen, dtype=dtype,
                         device=gen.device))
            for _ in range(reps + 1)]


def per_step(dt, n, steps):
    """``{ms_per_step, ns_per_row}`` of a loop of ``steps`` taking ``dt`` seconds
    (None for both off the card)."""
    if dt is None:
        return dict(ms_per_step=None, ns_per_row=None)
    return dict(ms_per_step=1e3 * dt / steps, ns_per_row=1e9 * dt / (n * steps))


def run(n=N, steps=STEPS, scatter_shapes=SCATTER_SHAPES, gather_shapes=GATHER_SHAPES,
        segsum_shapes=SEGSUM_SHAPES, reps=3, dtype=torch.float32, device="cuda", seed=0):
    """Every case's row (printed as it comes); on the CPU only the checks."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    timed = dev.type == "cuda"
    rows = []

    def case(name, fn, check, exact, r, lanes, table=False):
        sets = _arg_sets(gen, n, r, lanes, reps, dtype, table)
        idx, arr = sets[0]
        got = fn(idx, arr)
        errs = dict(max_rel_err=rel_err(got, check(idx, arr)),
                    max_rel_err_f64=rel_err(got.double(), exact(idx, arr.double())))
        dt = profiling.best_of(fn, sets, dev) if timed else None
        rows.append(dict(case=name, R=r, L=lanes, **per_step(dt, n, steps), **errs))
        print(json.dumps(rows[-1]), flush=True)

    def base(r):
        return lambda idx, vals: scatter(idx, vals, r, steps)

    def put(r):
        return lambda idx, vals: scatter_put(idx, vals, r, steps)

    for r, lanes in scatter_shapes:
        case("scatter", base(r), put(r), put(r), r, lanes)
    for r, lanes in gather_shapes:
        plain = lambda i, t: gather_plain(i, t, steps)  # noqa: E731
        case("gather", lambda i, t: gather(i, t, steps), plain, plain, r, lanes, table=True)
    for r, lanes in segsum_shapes:
        case("sort+segsum", lambda i, v, r=r: sort_segsum(i, v, r, steps), base(r), put(r), r,
             lanes)
        case("segsum(unsorted)", lambda i, v, r=r: segsum_unsorted(i, v, r, steps), base(r),
             put(r), r, lanes)
    return rows


def main():
    run()


if __name__ == "__main__":
    main()
