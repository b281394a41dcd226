"""Slab-sharded grids: the volume trace with the grid split along z over the
ranks of the mesh (the z-slab ring).

Twin of ``adjointnonlinearraytracing_tpu/parallel/slabs.py``.  The replicated
path (``parallel/mesh.py``) holds the whole grid and its gradient on every
rank; here rank ``d`` holds only the z-slab ``d`` of the grid, and the slabs
go round the ring of ranks, one hop a *phase*:

* each rank traces its own shard of the rays; rays never move;
* in a phase, a ray steps only while its cell row lies in the slab its rank
  holds then (the JAX cell table's row, ``clip(floor(z/h), -1, res-1) + 1``),
  for at most ``K`` steps; the others wait, unchanged, for their slab.  A
  per-ray step count caps each ray at the replicated path's ``max_steps``,
  so every ray takes the replicated trace's steps, bit for bit, only later;
* the adjoint sweep runs the same ring, each rank adding its rays' splats into
  the gradient slab that travels with the slab, so when the ring stops each
  slab's gradient holds every rank's contributions: the ring does the
  reduce-scatter; the gradient slab then takes the hops left to its home;
* the ring stops once no rank has a ray with steps left (an ``all_reduce``
  with ``MAX`` a phase), or after ``ndev * (ceil(max_steps / K) +
  phase_slack)`` phases; rays still pending then are truncated, and that is
  never silent: their ``xt``, ``vt`` are NaN, and the whole gradient is NaN if
  a ray of the adjoint sweep was.

Layout (the port's own): a slab is the voxel rows ``[z0 - 1, z0 + S)`` of the
z-padded grid (``S + 1`` rows of ``res x res``, row ``z0 - 1`` the previous
rank's last row, the halo; rank 0 repeats its row 0 there, the edge clamp),
and its gradient is a tensor of the same shape.  The kernels read the raw
voxels of that window (K21 ``slab_trace_phase``, K22 ``slab_backtrace_phase``;
``kernels/csrc/slab.cu``); the JAX package's 8-corner cell table would take
eight times the memory that slabs exist to save.  After the sweep the
gradient's halo row goes back to the previous rank (the reverse shift) and is
added to its last row.

A phase runs as a sweep of z-bands (:func:`sweep_bands`): on the card the
slab is gigabytes and L2 50 MB, so where a phase's rays take more than one
wave of the kernel, each launch steps only the rays whose cell row lies in
one of two bands of the slab, one going up through it and one coming down,
each as high as L2 holds (:func:`band_height`; its gradient too in the
adjoint); rays that fit one wave, and any phase off the card, take one
launch over the whole slab.  Each ray takes the steps one launch over the
slab would give it, so the results do not depend on the band.

Contract of :func:`make_slab_trace_zsharded`: each rank passes **its own**
``S`` rows of ``pad_rif_z(rif, world_size)`` (rows ``[rank*S, (rank+1)*S)``,
shape ``(S, res, res)``) and the whole ray batch; it gets the whole batch's
outputs and the gradient of its own rows.  No rank holds the whole grid or the
whole gradient.  :func:`make_slab_trace` takes the whole grid on every rank,
runs the same ring on its slab, and gives every rank the whole gradient.

Where it runs: CUDA tensors go through K21 and K22 (a failed build or launch
raises); CPU tensors through the plain phases below
(:func:`slab_trace_phase_plain`, :func:`slab_backtrace_phase_plain`), which are
the kernels' plain versions.  The collectives are the mesh's: the ring shift
(:meth:`RayMesh.shift`) and :meth:`RayMesh.all_max`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..fields import grid as G
from ..kernels import wrappers as K
from ..tracer import eikonal as E
from ..tracer import order as O
from .mesh import RayMesh, _gather_plain

__all__ = ["slab_rows", "pad_rif_z", "build_slab_tables", "make_slab_trace_zsharded",
           "make_slab_trace", "slab_trace_phase_plain", "slab_backtrace_phase_plain",
           "band_rows", "band_windows", "sweep_bands"]


def slab_rows(table_rows: int, ndev: int) -> int:
    """Cell-table z-rows per slab: ``ceil(table_rows / ndev)``."""
    return -(-int(table_rows) // int(ndev))


def pad_rif_z(rif: torch.Tensor, ndev: int) -> torch.Tensor:
    """Edge-pad the voxel z-axis to ``ndev * slab_rows(res + 1, ndev)`` rows.

    The padded rows are copies of the last z-plane; autograd through this
    function folds their gradient back into that plane."""
    res = rif.shape[0]
    extra = int(ndev) * slab_rows(res + 1, ndev) - res
    if extra == 0:
        return rif
    return torch.cat([rif, rif[-1:].expand(extra, *rif.shape[1:])])


def build_slab_tables(field: G.GridField, ndev: int):
    """The JAX package's cell table of ``field`` split into ``ndev`` z-slabs:
    ``(ndev, S * (res+1)^2, 8)`` and ``S``; rows past the table are zeros.

    Corner ``a + 2b + 4c`` of cell ``(cz, cy, cx)`` is the voxel
    ``clip(cz - 1 + c), clip(cy - 1 + b), clip(cx - 1 + a)``.  The ring does
    not use it (its slabs are voxel rows); it is the JAX layout, for
    comparison."""
    data = field.data
    d, hgt, wid = data.shape
    padded = F.pad(data[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    table = torch.stack([padded[c:c + d + 1, b:b + hgt + 1, a:a + wid + 1]
                         for c in range(2) for b in range(2) for a in range(2)], dim=-1)
    d1, rowlen = d + 1, (hgt + 1) * (wid + 1)
    S = slab_rows(d1, ndev)
    rows = table.reshape(d1, rowlen, 8)
    if ndev * S > d1:
        rows = torch.cat([rows, rows.new_zeros((ndev * S - d1, rowlen, 8))])
    return rows.reshape(ndev, S * rowlen, 8), S


# ---------------------------------------------------------------------------
# The plain phases (CPU): K21's and K22's plain versions
# ---------------------------------------------------------------------------

def _grid_shape(like: torch.Tensor, res: Tuple[int, int, int], h: float) -> G.GridField:
    """A field of the whole grid's shape that holds no data: its stencils,
    faces and escapes."""
    return G.GridField(like.new_zeros(()).expand(*res), h)


def _in_window(res, z_first: int, rows: int, h: float, p: torch.Tensor) -> torch.Tensor:
    """Whether the window ``[z_first, z_first + rows)`` holds the cell of each
    point (``holds_row(cell_row(p))`` of ``csrc/trilinear.cuh``)."""
    posf = torch.floor(p[:, 2] / G._scalar(h, p))
    cz = posf.clamp(-1, res[0] - 1).to(torch.int64) + 1
    return (cz > z_first) & (cz < z_first + rows)


def _in_windows(res, windows, h: float, p: torch.Tensor) -> torch.Tensor:
    """Whether one of the voxel-row windows ``(first, rows)`` holds the cell of
    each point."""
    out = torch.zeros_like(p[:, 0], dtype=torch.bool)
    for first, rows in windows:
        out |= _in_window(res, first, rows, h, p)
    return out


def _touch(stats, key: str, buf: torch.Tensor, local: torch.Tensor) -> None:
    """Mark in ``stats[key]`` (a bool per 32-byte sector of ``buf``, made on
    first use) the sectors that hold the elements ``local`` (flat indices)."""
    per = 32 // buf.element_size()
    if key not in stats:
        stats[key] = torch.zeros(-(-buf.numel() // per), dtype=torch.bool, device=buf.device)
    stats[key][local.reshape(-1) // per] = True


def _window_corners(slab, z_first, shape: G.GridField, p, mask, stats=None):
    """The corner values ``(2, 2, 2, N)`` at ``p`` read from the window (zeros
    where ``mask`` is false) and the stencil's weights; with ``stats``, the
    sectors read are marked in ``stats["sectors"]``."""
    idx, wx, wy, wz = G._stencil(shape, p)
    local = idx - z_first * (slab.shape[1] * slab.shape[2])
    m = mask[None, None, None, :]
    if stats is not None:
        _touch(stats, "sectors", slab, local[:, :, :, mask])
    vals = slab.reshape(-1)[torch.where(m, local, torch.zeros_like(local))]
    return torch.where(m, vals, torch.zeros_like(vals)), wx, wy, wz


def slab_trace_phase_plain(slab, res, z_first, h, ds, x, v, xt, vt, inside, esc, cnt,
                           max_steps, inner, planes=None, stats=None, start=None,
                           bands=None) -> torch.Tensor:
    """K21's plain version: one forward phase of the ring on ``slab`` (the voxel
    rows ``[z_first, z_first + rows)`` of a ``res`` grid), or one launch of a
    phase's band sweep, the state updated in place; returns a bool ``(1,)``
    tensor, true where a ray has steps left, and with ``bands`` a ``(2,)``
    one whose second word is true where a ray can still step in the slab in
    this phase.

    A ray steps while its cell row is in the slab (with ``bands``: in one of
    the voxel-row windows ``(first, rows)`` of it), it has not escaped and
    ``cnt < max_steps``, up to ``inner`` steps counted from ``start`` (the
    counts at the phase's start; None: from now): the steps of
    ``tracer.eikonal.trace`` (of ``trace_plane`` with ``planes``).  ``stats``
    (a dict) gets ``ray_steps`` and ``evals`` (the steps taken inside the
    grid) added to it, and ``sectors``: the 32-byte sectors of ``slab`` read."""
    shape = _grid_shape(slab, res, h)
    rows = slab.shape[0]
    ds_t = G._scalar(ds, x)
    base = cnt.clone() if start is None else start
    held = [(z_first, rows)] if bands is None else bands
    for _ in range(int(inner)):
        act = ~esc & (cnt < max_steps) & (cnt - base < inner) & _in_windows(res, held, h, x)
        if not bool(act.any()):
            break
        if stats is not None:
            stats["ray_steps"] = stats.get("ray_steps", 0) + int(act.sum())
            stats["evals"] = stats.get("evals", 0) + int((act & inside).sum())
        n, nx = G.value_grad_from(*_window_corners(slab, z_first, shape, x, inside & act,
                                                   stats), h)
        v2 = v + (ds_t * n)[:, None] * nx
        x2 = x + ds_t * v2
        if planes is None:
            cur = G.inbounds(shape, x2)
        else:
            cur = E._plane_inside(shape, x2, *planes)
        cross = inside & ~cur
        esc2 = esc | cross | G.escaped(shape, x2, v2)
        cap = (act & cross)[:, None]
        xt.copy_(torch.where(cap, x2, xt))
        vt.copy_(torch.where(cap, v2, vt))
        a3 = act[:, None]
        x.copy_(torch.where(a3, x2, x))
        v.copy_(torch.where(a3, v2, v))
        inside.copy_(torch.where(act, cur, inside))
        esc.copy_(torch.where(act, esc2, esc))
        cnt.add_(act.to(cnt.dtype))
    pending = ~esc & (cnt < max_steps)
    if bands is None:
        return pending.any().reshape(1)
    live = pending & (cnt - base < inner) & _in_window(res, z_first, rows, h, x)
    return torch.stack([pending.any(), live.any()])


def slab_backtrace_phase_plain(slab, res, z_first, h, ds, snap_tol, x, v, la, mu, active, cnt,
                               gslab, max_steps, inner, stats=None, start=None,
                               bands=None) -> torch.Tensor:
    """K22's plain version: one adjoint phase of the ring, or one launch of a
    phase's band sweep, the state updated and the splats added into ``gslab``
    in place; returns what :func:`slab_trace_phase_plain` returns.

    A ray steps while it is active, ``cnt < max_steps`` and its snapped
    position ``xe`` lies in a cell row of the slab (of ``bands``; tested
    before it moves), up to ``inner`` steps counted from ``start``: the steps
    of
    ``tracer.eikonal.backtrace``.  The terms are computed in the slab's type
    and added in ``gslab``'s (float64: their exact sum, for a check).
    ``stats`` gets ``ray_steps``, ``evals`` and ``splats`` added to it, and
    the 32-byte sectors read of ``slab`` (``sectors``) and written of
    ``gslab`` (``grad_sectors``)."""
    shape = _grid_shape(slab, res, h)
    rows, rowlen = slab.shape[0], slab.shape[1] * slab.shape[2]
    ds_t = G._scalar(ds, x)
    g = gslab.reshape(-1)
    base = cnt.clone() if start is None else start
    held = [(z_first, rows)] if bands is None else bands
    for _ in range(int(inner)):
        pre = active & (cnt < max_steps) & (cnt - base < inner)
        if not bool(pre.any()):
            break
        xr = x - ds_t * v
        xe = G.snap_to_nodes(xr, h, snap_tol)
        act = pre & _in_windows(res, held, h, xe)
        if not bool(act.any()):
            break
        emask = act & G.inbounds(shape, xe)
        corners = _window_corners(slab, z_first, shape, xe, emask, stats)
        n, nx = G.value_grad_from(*corners, h)
        hess = G.hess_from(*corners, h)
        v2 = v - (ds_t * n)[:, None] * nx
        active2 = act & ~G.escaped(shape, xe, -v2)
        dn = mu[:, 0] * nx[:, 0] + mu[:, 1] * nx[:, 1] + mu[:, 2] * nx[:, 2]
        dnx = n[:, None] * mu
        sel = (active2 & emask).nonzero()[:, 0]
        if stats is not None:
            for key, n_ in (("ray_steps", act), ("evals", emask)):
                stats[key] = stats.get(key, 0) + int(n_.sum())
            stats["splats"] = stats.get("splats", 0) + sel.numel()
        if sel.numel():
            idx, contrib = G._splat_corner_values(shape, xe[sel], (dn * ds_t)[sel],
                                                  (dnx * ds_t)[sel], None)
            local = (idx - z_first * rowlen).reshape(-1)
            if stats is not None:
                _touch(stats, "grad_sectors", gslab, local)
            g.index_add_(0, local, contrib.reshape(-1).to(g.dtype))
        la2 = la + ds_t * (dn[:, None] * nx + n[:, None] * G.hess_matvec(hess, mu))
        mu2 = mu + ds_t * la2
        a3 = act[:, None]
        x.copy_(torch.where(a3, xr, x))
        v.copy_(torch.where(a3, v2, v))
        la.copy_(torch.where(a3, la2, la))
        mu.copy_(torch.where(a3, mu2, mu))
        active.copy_(torch.where(act, active2, active))
        cnt.add_(act.to(cnt.dtype))
    pending = active & (cnt < max_steps)
    if bands is None:
        return pending.any().reshape(1)
    xe = G.snap_to_nodes(x - ds_t * v, h, snap_tol)
    live = pending & (cnt - base < inner) & _in_window(res, z_first, rows, h, xe)
    return torch.stack([pending.any(), live.any()])


# ---------------------------------------------------------------------------
# The band sweep: one phase in z-bands that L2 holds
# ---------------------------------------------------------------------------

def band_rows(row_bytes: int, l2_bytes: int, planes: int) -> int:
    """The cell rows ``B`` of a band of a phase's sweep on a card with
    ``l2_bytes`` of L2: the most whose ``B + 1`` voxel rows of ``row_bytes``
    each, in each of ``planes`` tensors (K21: the slab; K22: the slab and its
    gradient), fill at most L2; at least one.  A launch steps in two bands,
    but the rays of each cross their band as a front a few rows deep, so L2
    holds what they read though not both bands whole (``tools/slab_bands.py``
    found every height from 5 to 16 rows within 10 % of the best at 1025^2
    f32, and half this height 16 % slower for K22).  An H100 (50 MiB) at
    1025^2 f32: 11 for K21, 5 for K22."""
    return max(1, int(l2_bytes) // (int(planes) * int(row_bytes)) - 1)


def band_height(cells: int, row_bytes: int, l2_bytes: int, planes: int, rays: int,
                wave: int) -> int:
    """The band height of a phase's sweep over a slab of ``cells`` cell rows:
    :func:`band_rows`, or the whole slab, one launch, where the phase's
    ``rays`` fit one ``wave`` of the kernel (the rays it runs at once on the
    card): those step together and cross the slab as one front that L2
    holds, so bands would only add launches (``tools/slab_bands.py`` at
    1025^2 f32 on an H100: a four-rank slab, 2^16 rays, one wave of K21 and
    of K22, ran 26 % and 12 % faster as one launch than at its best band
    height; one rank, 2^18 rays, two and four waves, 2.0 and 2.6 times
    faster swept)."""
    if rays <= wave:
        return cells
    return min(cells, band_rows(row_bytes, l2_bytes, planes))


def slab_band(slab: torch.Tensor, planes: int, rays: int, plane: bool = False) -> int:
    """:func:`band_height` for ``slab`` (voxel rows, ``(S + 1, H, W)``) and
    ``rays`` rays on the slab's card (``planes`` 2: K22, else K21, with
    K11's rule where ``plane``); the whole slab off the card."""
    cells = slab.shape[0] - 1
    if not slab.is_cuda:
        return cells
    l2 = torch.cuda.get_device_properties(slab.device).L2_cache_size
    wave = K.slab_wave(slab.device, slab.dtype, planes == 2, plane)
    return band_height(cells, slab[0].numel() * slab.element_size(), l2, planes, rays, wave)


def band_windows(cells: int, band: int):
    """The launches of one sweep over a slab of ``cells`` cell rows in bands of
    ``band`` rows: for ``j`` up through the bands, band ``j`` (where the rays
    that go up are) and band ``nb - 1 - j`` (where those that go down are),
    one window where the two meet, and a launch like the one before it left
    out.  Each launch is a list of voxel-row windows ``(lo, rows)`` of the
    slab (band ``b``: ``lo = b * band``, its cell rows plus one)."""
    nb = -(-int(cells) // int(band))

    def rows(a, b):  # bands a..b as one window
        lo = a * band
        return lo, min((b + 1) * band, cells) - lo + 1

    out = []
    for j in range(nb):
        a, b = sorted((j, nb - 1 - j))
        launch = [rows(a, b)] if b - a <= 1 else [rows(a, a), rows(b, b)]
        if not out or out[-1] != launch:
            out.append(launch)
    return out


def sweep_bands(phase, cells: int, band: int) -> Tuple[torch.Tensor, int, int]:
    """One ring phase as sweeps over z-bands of a slab of ``cells`` cell rows.

    ``phase(windows, first, last)`` steps the rays whose cell row lies in one
    of ``windows`` (voxel-row windows ``(lo, rows)`` of the slab) until each
    leaves them (``first``: the phase's first launch; ``last``: a sweep's
    last, which returns the phase's ``[pending, live]`` words after it, live
    where a ray can still step in the slab).  A sweep is the launches of
    :func:`band_windows`: one band goes up through the slab and one comes
    down, so a ray crosses the slab either way in one sweep; sweeps follow
    until a sweep's last launch finds no ray live (rays bent back take more).
    Each ray has then taken the steps one launch over the whole slab gives
    it, in the same order.  Both the kernels (K21, K22) and their plain
    versions run it.  Returns the pending word, the sweeps and the
    launches."""
    seq = band_windows(cells, band)
    sweeps = 0
    while True:
        for q, windows in enumerate(seq):
            flags = phase(windows, sweeps == 0 and q == 0, q == len(seq) - 1)
        sweeps += 1
        if len(seq) == 1 or not bool(flags[1]):
            return flags[:1], sweeps, sweeps * len(seq)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

def _plain_bands(plain, slab, res, z_first, head, state, gslab, tail, **kw):
    """The ``phase(windows, first, last)`` of :func:`sweep_bands` on a plain
    phase (:func:`slab_trace_phase_plain`, :func:`slab_backtrace_phase_plain`):
    ``plain(slab, res, z_first, *head, *state[, gslab], *tail)`` on the given
    windows, the cap counted from the step counts (``state[-1]``) now."""
    start = state[-1].clone()
    grad = () if gslab is None else (gslab,)

    def phase(windows, first, last):
        return plain(slab, res, z_first, *head, *state, *grad, *tail, start=start,
                     bands=[(z_first + lo, rows) for lo, rows in windows], **kw)

    return phase


def _permuted(order: Optional[torch.Tensor], *ts: torch.Tensor):
    """``ts`` in the ray order (thread ``i`` holds ray ``order[i]``), so the
    kernels' loads of a warp's state are coalesced; as they are without one."""
    if order is None:
        return ts
    idx = order.long()
    return tuple(t[idx] for t in ts)


def _unpermuted(order: Optional[torch.Tensor], *ts: torch.Tensor):
    """The inverse of :func:`_permuted`."""
    if order is None:
        return ts
    idx = order.long()
    out = []
    for t in ts:
        u = torch.empty_like(t)
        u[idx] = t
        out.append(u)
    return tuple(out)


class _Ring:
    """The ring of one traced function: its sizes, phases and the two sweeps on one
    rank's rows and ray shard."""

    def __init__(self, mesh: RayMesh, h: float, ds: float, res: int,
                 inner_steps: Optional[int], phase_slack: int, plane: bool):
        self.mesh, self.h, self.ds, self.res = mesh, float(h), float(ds), int(res)
        self.shape = (self.res,) * 3
        self.ndev = mesh.world_size
        self.S = slab_rows(self.res + 1, self.ndev)
        self.K = int(inner_steps) if inner_steps else max(int(self.S * self.h / self.ds) * 2, 8)
        self.phase_slack, self.plane = int(phase_slack), plane
        self.steps_f = E.max_steps_fwd(self.res, self.h, self.ds)
        self.steps_b = E.max_steps_bwd(self.res, self.h, self.ds)
        #: phases the last forward and backward sweeps ran (for checks and logs)
        self.phases_run = {"fwd": 0, "bwd": 0}
        #: each phase's band sweep in the last forward and backward sweeps:
        #: ``(band, launches a sweep, sweeps, launches)``
        self.bands_run = {"fwd": [], "bwd": []}

    def phases(self, max_steps: int) -> int:
        """The phase budget: ``ndev * (ceil(max_steps / K) + phase_slack)``."""
        return self.ndev * (-(-max_steps // self.K) + self.phase_slack)

    def check_rows(self, rows: torch.Tensor, name: str) -> None:
        want = (self.S, self.res, self.res)
        if rows.ndim != 3 or tuple(rows.shape) != want:
            raise ValueError(f"{name}: a rank passes its {want} rows of pad_rif_z(rif, "
                             f"{self.ndev}) (rows [rank*{self.S}, (rank+1)*{self.S})), got "
                             f"{tuple(rows.shape)}")

    def _agree(self, nphase: int, n_local: int, device) -> None:
        """Raise, on every rank alike, unless the ranks run the same ring."""
        mine = torch.tensor([nphase, self.S, self.K, n_local], dtype=torch.int64, device=device)
        hi = self.mesh.all_max(torch.cat([mine, -mine]))
        if not torch.equal(hi[:4], -hi[4:]):
            raise RuntimeError(f"slab ring: the ranks disagree on (phases, S, K, rays): "
                               f"between {(-hi[4:]).tolist()} and {hi[:4].tolist()}")

    def _slab(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's slab: its rows behind the halo (the previous rank's last
        row; rank 0's own row 0)."""
        halo = self.mesh.shift(rows[-1])
        if self.mesh.rank == 0:
            halo = rows[0]
        return torch.cat([halo[None], rows])

    def _z_first(self, phase: int) -> int:
        """The first voxel row of the slab this rank holds in ``phase``."""
        return ((self.mesh.rank - phase) % self.ndev) * self.S - 1

    def _pending(self, flag: torch.Tensor) -> bool:
        return bool(self.mesh.all_max(flag.to(torch.int32)).item())

    def _hop(self, buf: torch.Tensor, spare: Optional[torch.Tensor]):
        """``buf`` one rank on round the ring, received into ``spare``: the
        buffer now held and the one free for the next hop."""
        return self.mesh.shift(buf, out=spare), buf

    def _bands(self, key: str, slab: torch.Tensor, planes: int, rays: int,
               phase) -> torch.Tensor:
        """One phase on ``slab`` as :func:`sweep_bands` over its bands, logged in
        :attr:`bands_run`; returns the pending word."""
        cells = slab.shape[0] - 1
        band = slab_band(slab, planes, rays, self.plane)
        flag, sweeps, launches = sweep_bands(phase, cells, band)
        self.bands_run[key].append((band, len(band_windows(cells, band)), sweeps, launches))
        return flag

    def _sweep(self, key: str, nphase: int, held: list, launch) -> int:
        """The ring's phases: ``launch(phase, *held)`` on the buffers this rank
        holds (updated in place), then each of them hops one rank on, until no
        rank has a ray with steps left or ``nphase`` phases ran.  ``held``
        ends with the buffers held last; returns the hops made."""
        spare = [None] * len(held)
        self.bands_run[key] = []
        for p in range(nphase):
            flag = launch(p, *held)
            self.phases_run[key] = p + 1
            if not self._pending(flag) or p == nphase - 1:
                return p
            for i, buf in enumerate(held):
                held[i], spare[i] = self._hop(buf, spare[i])
        return 0

    def forward(self, rows, x, v, planes):
        """The forward sweep of this rank's rays ``(x, v)``: ``(xt, vt, miss,
        order)`` with the failed-to-exit fix-up and NaN poisoning."""
        shape = _grid_shape(rows, self.shape, self.h)
        order = O.ray_order(x, v, self.shape, self.h) if rows.is_cuda else None
        x, v = _permuted(order, x, v)
        if planes is not None:
            planes = _permuted(order, *planes)
        st = dict(x=x.clone(), v=v.clone(), xt=x.clone(), vt=v.clone(),
                  inside=G.inbounds(shape, x), esc=torch.zeros_like(x[:, 0], dtype=torch.bool),
                  cnt=torch.zeros_like(x[:, 0], dtype=torch.int32))
        nphase = self.phases(self.steps_f)
        self._agree(nphase, x.shape[0], rows.device)
        state = [st[k] for k in ("x", "v", "xt", "vt", "inside", "esc", "cnt")]

        def launch(p, slab):
            z0, tail = self._z_first(p), (self.steps_f, self.K)
            if slab.is_cuda:
                phase = K.slab_trace_bands(slab, self.shape, z0, self.h, self.ds, *state, *tail,
                                           planes=planes)
            else:
                phase = _plain_bands(slab_trace_phase_plain, slab, self.shape, z0,
                                     (self.h, self.ds), state, None, tail, planes=planes)
            return self._bands("fwd", slab, 1, x.shape[0], phase)

        self._sweep("fwd", nphase, [self._slab(rows)], launch)
        esc = st["esc"]
        xt = torch.where(esc[:, None], st["xt"], st["x"])  # failed-to-exit fix-up
        # a ray still pending was truncated by the phase budget: poison it
        pend = (~esc & (st["cnt"] < self.steps_f))[:, None]
        nan = torch.full_like(xt, float("nan"))
        out = (torch.where(pend, nan, xt), torch.where(pend, nan, st["vt"]), ~esc)
        return (*_unpermuted(order, *out), order)

    def backward(self, rows, xt, vt, dxt, dvt, order):
        """The adjoint sweep of this rank's rays: the gradient of its rows."""
        shape = _grid_shape(rows, self.shape, self.h)
        ds_t = G._scalar(self.ds, xt)
        xt, vt, dxt, dvt = _permuted(order, xt, vt, dxt, dvt)
        st = dict(x=xt.clone(), v=vt.clone(), la=dxt.clone(), mu=dvt + ds_t * dxt,
                  active=~G.escaped(shape, xt, -vt),
                  cnt=torch.zeros_like(xt[:, 0], dtype=torch.int32))
        tol = G.snap_tol(rows.dtype)
        nphase = self.phases(self.steps_b)
        self._agree(nphase, xt.shape[0], rows.device)
        state = [st[k] for k in ("x", "v", "la", "mu", "active", "cnt")]

        def launch(p, slab, gslab):
            z0, tail = self._z_first(p), (self.steps_b, self.K)
            if slab.is_cuda:
                phase = K.slab_backtrace_bands(slab, self.shape, z0, self.h, self.ds, tol,
                                               *state, gslab, *tail)
            else:
                phase = _plain_bands(slab_backtrace_phase_plain, slab, self.shape, z0,
                                     (self.h, self.ds, tol), state, gslab, tail)
            return self._bands("bwd", slab, 2, xt.shape[0], phase)

        slab = self._slab(rows)
        held = [slab, torch.zeros_like(slab)]
        del slab
        hops = self._sweep("bwd", nphase, held, launch)
        gslab, gspare = held[1], None
        del held
        for _ in range((-hops) % self.ndev):  # the gradient slab goes home
            gslab, gspare = self._hop(gslab, gspare)
        del gspare
        if self._pending((st["active"] & (st["cnt"] < self.steps_b)).any().reshape(1)):
            gslab.fill_(float("nan"))  # a truncated adjoint sweep: loud, not short
        # the halo row's gradient belongs to the previous rank's last row
        g = gslab[1:]
        halo = gslab[0].clone()
        if self.mesh.rank == 0:
            g[0] += halo  # the edge clamp: row -1 is row 0 (nothing reads it here)
            halo.zero_()
        g[-1] += self.mesh.shift(halo, back=True)
        return g


class _SlabTrace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, x, v, pln_o, pln_d, ring):
        mesh = ring.mesh
        sl = mesh.shard(x.shape[0])
        rows = rows.detach().contiguous()
        xs, vs = (t.detach()[sl].contiguous() for t in (x, v))
        planes = None
        if ring.plane:
            planes = tuple(t.detach()[sl].contiguous() for t in (pln_o, pln_d))
        xt, vt, miss, order = ring.forward(rows, xs, vs, planes)
        ctx.save_for_backward(rows, xt, vt, miss, order)
        ctx.ring, ctx.sl = ring, sl
        out = (mesh.all_gather(xt), mesh.all_gather(vt))
        if not ring.plane:
            return out
        miss = _gather_plain(mesh, miss)
        ctx.mark_non_differentiable(miss)
        return (*out, miss)

    @staticmethod
    def backward(ctx, dxt, dvt, *_):
        rows, xt, vt, miss, order = ctx.saved_tensors
        dxt, dvt = dxt[ctx.sl], dvt[ctx.sl]
        if ctx.ring.plane:  # the rays that missed pass no position cotangent
            dxt = torch.where(miss[:, None], torch.zeros_like(dxt), dxt)
        g = ctx.ring.backward(rows, xt, vt, dxt.contiguous(), dvt.contiguous(), order)
        return g, None, None, None, None, None


def make_slab_trace_zsharded(mesh: RayMesh, h: float, ds: float, res: int,
                             inner_steps: Optional[int] = None, phase_slack: int = 2,
                             variant: str = "plain"):
    """The slab ring's differentiable trace over the mesh, the grid z-sharded.

    ``traced(rif_rows, x, v) -> (xt, vt)`` (``variant="plane"``:
    ``traced(rif_rows, x, v, pln_o, pln_d) -> (xt, vt, miss)``, the planes
    ``(N, 3)``): ``rif_rows`` is this rank's ``(S, res, res)`` rows of
    ``pad_rif_z(rif, world_size)``, ``S = slab_rows(res + 1, world_size)``;
    ``x, v`` the whole batch (a multiple of the world size).  Returns the
    whole batch's outputs (``api.trace``'s, ``trace_plane``'s, bit for bit);
    the backward pass gives the gradient of ``rif_rows`` only.  ``K =
    inner_steps`` or ``max(2 * int(S * h / ds), 8)`` steps a ray a phase, and
    at most ``world_size * (ceil(max_steps / K) + phase_slack)`` phases; rays
    still pending after them are NaN in ``xt``, ``vt``, and a pending ray of
    the adjoint makes the whole gradient NaN.  K21 and K22 on the card.
    """
    if variant not in ("plain", "plane"):
        raise ValueError(f"make_slab_trace_zsharded: variant must be 'plain' or 'plane', "
                         f"got {variant!r}")
    ring = _Ring(mesh, h, ds, res, inner_steps, phase_slack, variant == "plane")
    name = "make_slab_trace_zsharded"

    def check(rif_rows, x, v):
        ring.check_rows(rif_rows, name)
        if x.ndim != 2 or x.shape[-1] != 3 or v.shape != x.shape:
            raise ValueError(f"{name}: x, v must be (N, 3), got {tuple(x.shape)}, "
                             f"{tuple(v.shape)}")

    if ring.plane:
        def traced(rif_rows, x, v, pln_o, pln_d):
            check(rif_rows, x, v)
            for label, p in (("pln_o", pln_o), ("pln_d", pln_d)):
                if p.shape != x.shape:
                    raise ValueError(f"{name}: {label} must be (N, 3) like x, got "
                                     f"{tuple(p.shape)}")
            return _SlabTrace.apply(rif_rows, x, v, pln_o, pln_d, ring)
    else:
        def traced(rif_rows, x, v):
            check(rif_rows, x, v)
            return _SlabTrace.apply(rif_rows, x, v, None, None, ring)
    traced.ring = ring
    return traced


class _OwnRows(torch.autograd.Function):
    """This rank's rows of the padded grid; backward, every rank's row
    gradients gathered into the whole padded grid's."""

    @staticmethod
    def forward(ctx, padded, mesh, S):
        ctx.mesh = mesh
        return padded[mesh.rank * S:(mesh.rank + 1) * S].clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous()), None, None


def make_slab_trace(mesh: RayMesh, h: float, ds: float, res: int,
                    inner_steps: Optional[int] = None):
    """The slab ring's differentiable ``trace(rif, x, v) -> (xt, vt)`` with the
    whole grid on every rank: each rank takes its rows of ``pad_rif_z(rif)``,
    the ring runs as in :func:`make_slab_trace_zsharded`, and every rank
    gets the whole gradient (the ranks' rows gathered, the padded rows folded
    into the last plane).  Outputs equal ``api.trace``'s."""
    zsharded = make_slab_trace_zsharded(mesh, h, ds, res, inner_steps)
    ndev, S = mesh.world_size, zsharded.ring.S

    def traced(rif, x, v):
        if tuple(rif.shape) != (int(res),) * 3:
            raise ValueError(f"make_slab_trace: rif must be ({res},)*3, got {tuple(rif.shape)}")
        return zsharded(_OwnRows.apply(pad_rif_z(rif, ndev), mesh, S), x, v)

    traced.ring = zsharded.ring
    return traced
