"""Probe: row scatter-add and row gather against the row width, in a loop of
steps with evolving indices.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/probe_hotops.py`` (which
runs its sweep when imported; this one when :func:`run` is called).  Per
shape, ``rows`` rows of ``width`` f32 go into (``index_add_``) or come out of
(``index_select``) a table of about 70 MiB, the indices stepping by 7,919
rows a step, as the JAX probe's.  The scatter is held against ``index_put_``
with ``accumulate`` and the gather against plain indexing before each is
timed (``max_rel_err``).  Times are CUDA events: ms a step, rows/s and GB/s
(the scatter's bytes are the rows read and the table rows written, as the
JAX probe counts them).

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.probe_hotops
"""

from __future__ import annotations

import functools
import json

import torch

from ..convert import require_device
from ..utils import profiling
from .probe_scatter3 import rel_err

N = 1 << 18
STEPS = 100
TAB_BYTES = 70 << 20
SCATTER_SHAPES = ((N, 8), (N, 16), (N, 32), (N, 64), (N, 128), (N // 2, 8), (N // 2, 64),
                  (N // 4, 8), (N // 4, 128), (N // 4, 512), (N, 512))
GATHER_SHAPES = ((N, 8), (N, 32), (N, 64), (N, 128), (N // 2, 8), (N // 2, 64), (N // 4, 128),
                 (N // 4, 512))


def table_rows(width, tab_bytes=TAB_BYTES):
    return max(tab_bytes // (width * 4), 2048)


def scatter_loop(tab, idx, vals, steps, put=False):
    g = tab.clone()
    for _ in range(steps):
        if put:
            g.index_put_((idx,), vals, accumulate=True)
        else:
            g.index_add_(0, idx, vals)
        idx = (idx + 7919) % tab.shape[0]
    return g


def gather_loop(tab, idx, steps, plain=False):
    acc = torch.zeros((idx.shape[0], tab.shape[1]), dtype=tab.dtype, device=tab.device)
    for _ in range(steps):
        acc += tab[idx] if plain else torch.index_select(tab, 0, idx)
        idx = (idx + 7919) % tab.shape[0]
    return acc


def run(steps=STEPS, scatter_shapes=SCATTER_SHAPES, gather_shapes=GATHER_SHAPES,
        tab_bytes=TAB_BYTES, reps=1, dtype=torch.float32, device="cuda", seed=0):
    """Every shape's row (printed as it comes); on the CPU only the checks."""
    dev = require_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    timed = dev.type == "cuda"
    rows = []
    for kind, shapes in (("scatter", scatter_shapes), ("gather", gather_shapes)):
        for nrows, width in shapes:
            ncells = table_rows(width, tab_bytes)
            sets = []
            for _ in range(reps + 1):
                idx = torch.randint(0, ncells, (nrows,), generator=gen, device=dev)
                if kind == "scatter":
                    vals = torch.randn((nrows, width), generator=gen, dtype=dtype, device=dev)
                    sets.append((torch.zeros((ncells, width), dtype=dtype, device=dev), idx,
                                 vals))
                else:
                    sets.append((torch.randn((ncells, width), generator=gen, dtype=dtype,
                                             device=dev), idx))
            if kind == "scatter":
                fn = functools.partial(scatter_loop, steps=steps)
                check = functools.partial(scatter_loop, steps=steps, put=True)
                moved = nrows * width * 4 * 2
            else:
                fn = functools.partial(gather_loop, steps=steps)
                check = functools.partial(gather_loop, steps=steps, plain=True)
                moved = nrows * width * 4
            got = fn(*sets[0])
            row = dict(case=kind, rows=nrows, width=width, table_rows=ncells,
                       ms_per_step=None, Mrows_per_s=None, GB_per_s=None,
                       max_rel_err=rel_err(got, check(*sets[0])),
                       max_rel_err_f64=rel_err(got.double(), check(
                           *(a.double() if a.is_floating_point() else a for a in sets[0]))))
            if timed:
                dt = profiling.best_of(fn, sets, dev) / steps
                row.update(ms_per_step=1e3 * dt, Mrows_per_s=nrows / dt / 1e6,
                           GB_per_s=moved / dt / 1e9)
            rows.append(row)
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main():
    run()


if __name__ == "__main__":
    main()
