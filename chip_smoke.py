"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the repo root with no arguments: ``python3 chip_smoke.py``.  It needs
one CUDA device and ``nvcc``; without a GPU it exits non-zero and prints no
result.  Phases (any failure is an uncaught exception):

1. device  - require CUDA, print the card's name and power limit.
2. build   - compile the kernels from ``kernels/csrc`` (one ``nvcc`` a source,
   all at once) and load them.
3. kernels - hold K1 ``eval_grad`` (and its first design), K2 ``trace_fwd``, K3
   ``backtrace`` and the exact gradient's K5 ``trace_ckpt`` and K6
   ``backtrace_exact`` against their plain PyTorch versions on the card: at a
   small size in f64 and at the bench scene's full width (128^3 grid, 2^18
   rays) in f32, K2 and K3 with and without the ray order
   (``tracer/order.py``) that ``api.trace`` gives them; the exact gradient
   through ``tracer.trace_exact`` against the taped plain stepper
   (``api.trace_ad``) in f64, chunked and not; hold K4 ``gather_rows``
   against its plain version at the gather probe's full size (66^3 rows of
   128, 2^18 indices; f32 and f64, int32 and int64); time kernel, plain
   version and, where one exists, a library call, and the order's own set-up
   time; compute each kernel's bound.  Then K2, K3, K5 and K6 at every stage
   resolution of the fuel trainer (3^3 .. 65^3) with the run's own rays, f64
   and f32 (K5, K6 in f32): K2 and K5's exit state bitwise with and without
   the order, K3 and K6 against their plain versions, the path K3 takes at
   each stage (shared or global; K6 takes the global path at every size),
   the runs K3 and K6 flushed (counted in the kernel) against the plain
   versions' ``flushes``, and K5's and K6's times and shares of their bounds
   (from the plain versions' counts of this stage's work).
4. main paths - each through the entry points a user calls, with the launch
   counters zeroed just before and read just after:
   a. the bench scene: ``bench.run`` and ``api.trace`` forward + adjoint (K2
      and K3, one launch each per pass; they never launch K1) and
      ``fields.grid.eval_grad`` on the rays' points (K1, one launch);
   b. the gather probe: ``benchmarks.probe_dma_gather.run`` (K4);
   c. the fuel-injection trainer at full width:
      ``experiments.fuel_injection.run_opt`` with the shipped configuration
      (six stages 3^3 .. 65^3, 16 views of 128x128 = 262,144 rays, the real
      volume, f32), ``optim_iters`` cut from 300 to 10 (210 Adam steps), with
      the spot check and the stage escalation on as a user runs it: the
      stages before the escalation run K2 and K3, the others the exact
      gradient, K5 and K6 (each spot check runs K2, K3 and K5, K6: the
      adjoint against ``trace_exact``); every kernel is asserted at exactly
      the launches the code implies for the stage the escalation fired at,
      per stage and in all, K3 on each path too, K1 and K4 at none.  Then the
      same trainer in f64 at a small size on the card against the CPU; the
      full 300-iteration run (6,300 steps) comes last.
   d-g. the Luneburg, image (einstein-turing), sdf and focal-stack drivers,
      each through ``experiments.runner.run`` on its shipped section at full
      width (up to 129^3; 983,040 / 327,680 / 327,680 / 1,310,720 rays a step,
      above ``ANRT_EXACT_CHUNK`` for Luneburg, image and focal stack, so the
      exact gradient runs chunk by chunk), spot checks and escalation on:
      every kernel's launches asserted per stage and in all, for the stage the
      escalation fired at; per stage the step time, the kernels' times and
      shares of their bounds (the work counted by the plain versions on 2^15
      of the path's rays), the host's share, the spot checks and the
      checkpoint size; the sensor splat's forward and backward time (image,
      focal stack); :func:`stage_check` at 129^3 on the Luneburg run's field
      with 2^16 of its rays (K2, K5 bitwise, K3, K6 against the f64 sum of the
      same terms, K3's path); and each driver in f64 at a small size on the
      card against the CPU.
   h. the GRIN-fiber driver (``params-fiber.yaml`` ``default``) through
      ``runner.run`` at its shipped size and depth: 840 Adam steps, 3 -> 129
      bins, two passes of 4,096 rays a step traced as one batch (one K7 and
      one K8 a step), spot checks and escalation on; the cable kernels'
      launches asserted per stage and in all; per stage the step time,
      K7-K10's times per launch and a step and shares of their bounds, the
      host's share; the final loss and the profile's L2 distance to
      ``ground_truth(129)``; then the driver in f64 at a small size on the
      card against the CPU.
   h2. the same run with ``gradient: "exact"`` set in the params, the
      driver's own exact mode: every step one K9 and one K10 (the start-up
      check one K7 and one K8, no stage checks), asserted per stage and in
      all, K10 on its column path; per stage as in h, and the final loss and
      L2 distance beside h's; then that mode in f64 at a small size on the
      card against the CPU.
   v. the reference-style variants through ``compat`` at full width (the
      bench scene, 128^3 f32, 2^18 rays): ``BackPlaneTracerC`` (planes at
      y = 0.6 * span, normal +y: K11, then K3), ``BackTargetTracerC``
      (targets past the far face's centre, y = 1.05 * span: K12's two
      launches, then K3) and ``BackSDFTracerC`` (a sphere sdf of radius 0.4 *
      span, 2^18 rays spawned on it by ``sdf_utils.get_pts_sdf``: K13's two
      launches, then K14), forward and backward, four calls each; launches
      asserted exactly, K3's and K14's paths too; ms a call and a launch.
   x. the variants' exact gradients as a user calls them:
      ``tracer.trace_plane_exact`` (K15, then K18), ``trace_target_exact``
      (K16's two launches, then K6) and ``trace_sdf_exact`` (K17's two
      launches, then K19), forward and backward, four calls each on
      configuration v's scene (2^18 rays: one chunk, the checkpoints kept),
      then once each on 2^20 rays (four chunks of ``ANRT_EXACT_CHUNK``: the
      backward pass recomputes each chunk's checkpoints, the target with the
      batch's horizon, the sdf with its chunks' horizons); launches asserted
      exactly; ms a call and a launch.  Before it, ``exact_variant_check``
      holds K15-K17 bitwise (outputs, capture steps, codes, horizon, the
      checkpoint rows the backward pass reads) and K18, K6, K19 within 1e-9
      in f64 and 1e-5 of the f64 sum of the same terms in f32, their runs
      equal to the plain ``flushes``, against ``tracer/checkpointed.py``'s
      plain versions, whole and in chunks (the last padded), at 17^3 x 512
      f64 and on the bench scene f32, on the ragged target batch and on the
      sdf's late crossing; ``exact_variants_api_check`` the three functions
      card against CPU in f64, chunked.
   p. the 2008 path-matrix baseline: ``pathmatrix.fuel2008.
      fuel_reconstruction`` in the repo's configuration
      ``combo_recon16_hermite`` (32 views of 64^2 x 4 = 524,288 rays through
      the 65^3 fuel volume, f64, 16^3 reconstruction, hermite paths): one K2
      and one K1 launch, the native marcher (asserted loaded), the trace,
      path-matrix, solve and integration seconds, ``phi_nnz`` and
      ``rel_norm``, which must lie in 0.82-0.91 (the JAX package's, on its
      own rays: 0.86198); then ``combo_recon16_true``, the same with the
      recorded trajectories (``spline="true"``, ``path_stride`` 8): one K2,
      one K20 ``record_paths`` (held bitwise against its plain version on
      all 524,288 rays beforehand) and one K1, ``rel_norm`` within 5 % of the
      JAX package's 0.86339 (``tools/jax_fuel2008_reference.py`` on the
      CPU); each first as a tiny run on the card against the CPU on the same
      rays, 1e-12.
   m. the ray mesh (``parallel/``): ``configs/params-fuel.yaml`` ``fuel-128``
      through ``runner.run`` at full width (``mesh: true``, a mesh of one
      rank on the card; seven stages to 129^3, 32 views of 128^2 x 4 spp =
      2,097,152 rays, f32, spot checks and escalation on), ``optim_iters``
      cut from 300 to 10 (280 Adam steps): launches asserted exactly per
      stage and in all (the exact steps in 8 chunks, each recomputing its
      checkpoints), per stage the step time, the kernels' time, the host's
      share and the loss, and ``reconstruction_error``; then ``fuel-128``'s
      mesh path in f64 at a small size, card against CPU, 1e-9.  Before the
      main paths, ``make_sharded_trace`` and ``make_sharded_trace_exact`` on
      the bench scene against ``api.trace`` and ``trace_exact``: outputs
      bitwise, gradients within 1e-5, launches asserted.
   s. the rest of the multi-device layer (``parallel/``), at one rank:
      ``make_sharded_trace_{plane,target,sdf,cable}``, plain and exact, on
      configuration v's scene and configuration h's cable (129 bins, a
      step's 8,192 rays) against the unsharded calls: outputs bitwise,
      gradients within 1e-5, launches asserted exactly (the unsharded
      call's); K21 ``slab_trace_phase`` and K22 ``slab_backtrace_phase``
      against their plain phases (``parallel/slabs.py``) on one phase of a
      slab that does not cover the grid (65^3 in 4 slabs, the slab of rank
      1, 2^15 rays through the grid's depth, f64 and f32): K21 bitwise, the
      rays outside the slab frozen bit for bit, K22's positions, directions,
      activity and step counts bitwise, its gradient within 1e-9 (f64) and
      1e-5 (f32), each as one launch over the slab and as a band sweep
      (``parallel.slabs.sweep_bands``, bands of 3 cell rows); then
      ``make_slab_trace_zsharded`` on configuration 14 (the bench field at
      1025^3 f32, 4.3 GB, made on the card a block of rows at a time; 2^18
      rays crossing z both ways) against ``api.trace``: outputs bitwise, the
      gradient within 1e-5, K21 and K22 launched exactly sweeps x a sweep's
      launches a phase, as the sweeps counted them (the band from the card's
      L2), ms forward + backward of both, peak memory; the plain phases'
      times on the first phase's inputs, and the kernels' ms a phase from
      that phase's band sweep replayed on the card alone.
   q. the measurement modules (``benchmarks/``), each through its own entry
      point with the launch counts zeroed before and asserted after:
      ``probe_evalmath.run`` (K1 bitwise against its plain version, masked,
      unmasked and on the points sorted by cell; K1 in ray order and sorted,
      ``grid_sample``, the plain version and the plain Hessian + splat timed
      beside K1's bound), ``sweeps`` (33^3 x 2^18 rays at ``ds`` 0.5 h with
      the tape and 1.0 h without; the resolution sweep 9^3 .. 129^3 at
      2^16), ``ds_study`` in f64 at 17^3 x 64 rays on two scenes, the card's
      rows against the CPU's within 1e-9, ``compaction_bench`` at its full
      size (128^3, 2^18 spread rays, 1, 2, 4, 8 buckets), ``scaling`` at one
      rank, ``probe_ds_speed`` at its four alphas, ``probe_exact_envelope`` at
      65^3 (1,310,720 rays in 5 chunks), the three scatter probes at fewer
      steps (f32, timed; then in f64, each case within 1e-9 of its baseline
      and of the f64 sums of its terms), and the
      area and sphere sources drawn on the card at a Luneburg step's 983,040
      rays and traced forward + backward through the 129^3 lens, timed, one
      pass under ``utils.profiling.trace`` (device time by kernel).
   n. the fuel north star (``experiments/northstar.py``, the twin of the JAX
      system's ``run_fuel_northstar.py``): n1, the shipped ladder uncut
      (9^3 .. 129^3, 760 iterations; a fixed set of 32 views x 128^2 x 20 spp
      = 10,485,760 f32 rays, 16 microbatches of 655,360 an iteration at
      129^3; the ground truth traced once): launches asserted exactly in all,
      by K3's path and by stage (K2 2,581, K3 2,565, K5 5, K6 5), per stage
      the ms an iteration, rays/s, K2 + K3 and the host's share, the spot
      check, ``rel_norm`` (from 17^3 on within 15 % of the JAX record's,
      falling, at most 0.30 at the end) and the peak memory; K2 bitwise and
      K3 within 1e-5 of the f64 sum on a whole 129^3 microbatch (655,360
      rays; ``stage_check``, with K5 and K6); n2, the JAX record's 129^3
      stage resumed from its ``eta_65.npy`` (20 iterations, lr 6.25e-6),
      launches asserted, its ``rel_norm`` before the first step and at the
      end within 10 % of a control's (n1's own 65^3 field resumed the same
      way), each resume's end at most 1.5 times its start, and its end
      printed beside the band of 5 % around the record's; the ray order's
      ms a microbatch.
   r. the JAX system's last repo-root drivers as the port's modules
      (``experiments/``), each into a temporary directory, never
      ``results/``: r1 ``image_flagship.run`` uncut (the record's 1,120 steps,
      2 views x 128^2 x 8 spp, 3^3 .. 129^3) with its launches asserted per
      stage and in all (``expected_launches``, the renders of its log
      function, the report's one K2) and each correlation within 0.10 of the
      record's, then ``--report-only`` on the JAX record's own field
      (``results/einstein_turing_r4/result.npz``) within 0.02 of its four
      correlations; r2 ``image_singleview.run`` uncut (630 steps to 65^3) so
      held, within 0.10 of 0.7138; r3 ``fiber_ladder.run`` uncut (the ladder
      at 100 steps a stage and the three shipped refinements: 4,800 steps of
      K7 and K8, each run's launches asserted for its escalation, every L1 in
      0.08-0.20, a NaN a failure), then ``FIBER_INIT`` on the JAX record's
      refined profile, its L1 equal to the record's 0.144179 within 1e-6
      relative, and before them K8 against its plain version on the
      near-axial ray whose f32 adjoint overflows (ROADMAP C13); r4
      ``fuel_headtohead.run`` cut to 32 views x 64^2 x 4 spp with a 16^3
      reconstruction beside n1's report (one K2, one K1, every ratio from
      the reports); r5 the four sweeps on a tiny screening protocol (row
      keys the JAX rows', no error, the best row the JAX choice, one K2 and
      one K1 a row, one K20 more for the true paths).
   Exit-step compaction: each driver run logs the buckets its trace took
   (``exit_buckets``; k makes an adjoint step k K2 and k K3 launches,
   asserted in c-g; on the card a run takes them only from
   ``ANRT_BUCKETED``, so none); after the drivers,
   ``compaction.trace_bucketed`` against ``api.trace`` on one Luneburg
   step's rays, whose chord spread is above 3, through its field at 17^3
   (outputs bitwise, gradient 1e-5, launches 4 + 4, both times;
   ``make_trace`` with these rays as its probe takes none), and
   the Luneburg adjoint stages (3^3 .. 17^3, 100 steps) run with 4 buckets
   (``ANRT_BUCKETED=4``) and with none (``ANRT_BUCKETED=0``), alternated:
   ms a step per stage.
   Before the main paths, the variants' kernels K11 ``trace_plane``, K12
   ``trace_target``, K13 ``trace_sdf`` and K14 ``backtrace_sdf`` are held
   against their plain versions (``variant_check``) at 17^3 x 512 in f64 and
   on the bench scene in f32: K11-K13 bitwise, with the ray order and
   without, K12 and K13 on the same batch on both sides (their horizon is
   the batch's); K14 1e-9 in f64 and 1e-5 of the f64 sum of the same terms
   in f32, its runs equal to the plain ``flushes``; the ragged case (one ray
   at rest outside the grid: the horizon is max_steps) and the sdf's late
   crossing (rays that leave the grid inside a half-space sdf and cross it
   afterwards) bitwise, in f64 and f32.  The cable kernels K7 ``trace_cable``, K8
   ``backtrace_cable``, K9 ``trace_cable_ckpt`` and K10
   ``backtrace_cable_exact`` are held against their plain versions on the
   fiber source's rays (``cable_check``): at 17 bins and 512 rays in f64 and at
   the path's full width (129 bins, a step's two passes of 4,096 rays, f32):
   K7 and K9 (closest approach, capture steps, checkpoint rows read)
   bitwise, K8 and K10 1e-9 in
   f64 and 1e-5 of the f64 sum of the same terms in f32, with their times and
   bounds; K9 and K10 so again at ``seg`` 7 and 48, shorter and longer than
   K10's replay buffer (``cable_seg_check``); ``api.trace_cable`` against
   ``trace_cable_exact`` in f64, whole and chunked, and against the CPU
   (``cable_api_check``); K8 and K10 on their block paths at 1,025 bins
   and at the largest profile they take, there on more rays than K10's
   block path has blocks (``cable_block_path_check``).  K20
   ``record_paths`` is held bitwise to its plain version
   (``record_paths_checks``): 17^3 x 512 f64 at strides 8 and 3 with two
   rays that start outside and never enter, and 2^15 of
   ``combo_recon16_true``'s rays through the 65^3 fuel volume with and
   without the ray order; then at that configuration's full width (all
   524,288 rays, with and without the ray order) bitwise and timed.
5. report  - one JSON line of the kernels, then the result line.

Bounds use the published peaks of one H100 SXM: 3.35 TB/s of device memory,
67 TFLOP/s in f32 outside the tensor cores.  Kernel times are CUDA events
around a launch after a 256 MB buffer was read (the L2 then holds clean lines
of it, which a launch's misses evict for nothing); the earlier yardstick
wrote the buffer instead, which leaves up to 50 MB of dirty lines that the
timed launch's misses must write back, and is printed once beside it for K1,
``grid_sample`` and K4.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")

from adjointnonlinearraytracing_tpu_torch import bench, compat
from adjointnonlinearraytracing_tpu_torch.benchmarks import probe_dma_gather
from adjointnonlinearraytracing_tpu_torch.benchmarks import scenes
from adjointnonlinearraytracing_tpu_torch.benchmarks import (
    compaction_bench, ds_study, probe_bandscatter, probe_ds_speed, probe_evalmath,
    probe_exact_envelope, probe_hotops, probe_scatter3, scaling, sweeps)
from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case
from adjointnonlinearraytracing_tpu_torch import sensors
from adjointnonlinearraytracing_tpu_torch.experiments import fuel_injection, voxel_scenes
from adjointnonlinearraytracing_tpu_torch.experiments import fiber, focalstack, image, luneburg
from adjointnonlinearraytracing_tpu_torch.experiments import common, northstar, runner
from adjointnonlinearraytracing_tpu_torch.experiments import (
    fiber_ladder, fuel2008_sweep, fuel_headtohead, image_flagship, image_singleview)
from adjointnonlinearraytracing_tpu_torch.fields import cylinder as cyl
from adjointnonlinearraytracing_tpu_torch.fields import grid as G
from adjointnonlinearraytracing_tpu_torch.fields import sdf_utils
from adjointnonlinearraytracing_tpu_torch.fields.cylinder import CylinderField, cyl_eval_grad
from adjointnonlinearraytracing_tpu_torch.kernels import build
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
from adjointnonlinearraytracing_tpu_torch.native import loader as native_loader
from adjointnonlinearraytracing_tpu_torch import parallel
from adjointnonlinearraytracing_tpu_torch.parallel import slabs
from adjointnonlinearraytracing_tpu_torch.pathmatrix import fuel2008
from adjointnonlinearraytracing_tpu_torch.sources import sources
from adjointnonlinearraytracing_tpu_torch import tracer
from adjointnonlinearraytracing_tpu_torch.tracer import api
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as CK
from adjointnonlinearraytracing_tpu_torch.tracer import compaction
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as E
from adjointnonlinearraytracing_tpu_torch.tracer import order as O
from adjointnonlinearraytracing_tpu_torch.utils import profiling
from adjointnonlinearraytracing_tpu_torch.utils.metrics import MetricsLogger

RES, NRAYS = 128, 1 << 18
# the gather probe's own size: a table of 66^3 rows of 128 f32, 2^18 indices
GATHER_ROWS, GATHER_N, GATHER_REPS = 66 ** 3, 1 << 18, 8
# the fuel trainer: iterations per stage are FUEL_ITERS * (stage + 1); the
# shipped configuration has 300
FUEL_ITERS, FUEL_ITERS_SHIPPED = 10, 300
# the exact gradient's checkpoint interval: trace_exact's and make_trace's default
SEG = 32
BUSY_CYCLES = profiling.BUSY_CYCLES
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f64 outside the tensor cores (NVIDIA's H100 SXM data sheet: 34 TFLOP/s)
PEAK_F64_FLOPS = 34e12

# Floating-point operations the functions need, for the operation bounds.
# This is the least arithmetic that computes the same function, not what the
# kernel sources spend: a multiply and an add count one each, comparisons,
# masks, integer index arithmetic and multiplies by +-1 count nothing.
#
# stencil, 3 per axis: p/h, floor, pm - floor.
FLOPS_STENCIL = 9
# value + gradient as a tree of lerps a + w*(b - a), 3 flops each: 4 along y,
# 2 along z, 1 along x give n (21); the differences (b - a) those lerps form
# are the y-, z- and x-derivatives of the partial results, so d/dx costs only
# its scale by 1/h (1), d/dy 2 lerps along z, 1 along x and the scale (10),
# d/dz 1 lerp along x and the scale (4).
FLOPS_VALUE_GRAD = 36
# off-diagonal Hessian from the same differences: dxdy 2 subtractions, 1 lerp
# along z, scale by 1/h^2 (6); dxdz is a difference the d/dz lerp formed,
# scale (1); dydz 1 lerp along x of differences the d/dy lerps formed, scale (4).
FLOPS_HESSIAN = 11
# factorised splat of (val, g) onto 8 corners: 1 - w per axis (3),
# A[a] = val*wx[a] +- gx (4), Q[b][c] = wy[b]*wz[c] (4),
# R[b][c] = +-gy*wz[c] +- gz*wy[b] (4 products, 4 sums: 8),
# corner[a][b][c] = A[a]*Q[b][c] + wx[a]*R[b][c] (8 x 3 = 24).
FLOPS_SPLAT = 43

# K1, per point.
FLOPS_EVAL_POINT = FLOPS_STENCIL + FLOPS_VALUE_GRAD                    # 45
# K2, per step of a ray that has not escaped: x += ds*v (6); and per step
# that evaluates the field (ray inside): stencil, value + gradient,
# v += (ds*n)*grad (7).
FLOPS_FWD_STEP = 6
FLOPS_FWD_EVAL = FLOPS_STENCIL + FLOPS_VALUE_GRAD + 7                  # 52
# K3, per step of an active ray: x -= ds*v (6), snap per axis p/h, round,
# pm - r, pm*h (12), mu += ds*la (6).  Per step that evaluates: stencil on
# the snapped quotient (floor and subtraction, 6), value + gradient, Hessian,
# v update (7), dn = mu . grad (5), H mu (9), la += ds*(dn*grad + n*Hmu) (15).
# Per step that scatters: dn*ds, (ds*n)/h reused from the v update, times mu
# (5), and the splat.
FLOPS_BWD_STEP = 24
FLOPS_BWD_EVAL = 6 + FLOPS_VALUE_GRAD + FLOPS_HESSIAN + 7 + 5 + 9 + 15  # 89
FLOPS_BWD_SPLAT = 5 + FLOPS_SPLAT                                      # 48
# K5 per step as K2.  K6, per gated-on step of a ray: the replayed forward
# step (FLOPS_FWD_STEP, and FLOPS_FWD_EVAL where inside) and mu += ds*la (6);
# per step inside, on top of the n and grad n the replay evaluated at the
# same x_k: Hessian, dn = mu . grad (5), H mu (9), la += ds*(dn*grad +
# n*Hmu) (15); each of those splats (FLOPS_BWD_SPLAT).  (K6 evaluates n and
# grad n a second time in the backward step; that is its design's cost, not
# the function's.)
FLOPS_EXACT_STEP = FLOPS_FWD_STEP + 6                                  # 12
FLOPS_EXACT_EVAL = FLOPS_FWD_EVAL + FLOPS_HESSIAN + 29                 # 92

# Tolerances, relative to the plain version's largest magnitude.
# f64: both sides do the same operations in the same order without FMA
# contraction; what is left is the order of the atomic adds.
TOL_F64 = 1e-9
# f32 at full width: the kernels repeat the plain arithmetic rounding for
# rounding, so exit states agree to rounding; the gradient sums ~10^2 terms
# per voxel by atomics in an order that changes from run to run, on both sides
# (index_add_ on the card is atomic too).  An H100 read 1.3e-6 of the largest
# entry on every run so far; 1e-5 leaves room for the order of the sums and
# none for a splat that is systematically off.
TOL_F32_STATE = 1e-5
TOL_F32_GRAD = 1e-5
# f32 K3 at the fuel trainer's coarse stages (3^3 .. 33^3), where ~2.5e8
# terms land on 27 .. 35,937 words, 10^4 to 10^7 a word.  The plain version
# adds them one by one (index_add_, atomic on the card) into a running f32
# sum; once a word's sum is large, each term loses most of its low bits, the
# same way in every run, so the plain version's error is systematic and its
# run-to-run spread does not show it (an H100 read a spread of 2.1e-5 of the
# largest entry at 3^3 but a distance of 7.2e-3 to the exact sum of the same
# terms).  The kernel sums runs in registers, blocks in shared memory, and
# lands within 1e-6 of that exact sum.  So at every f32 stage the kernel is
# held to TOL_F32_GRAD against the f64 sum of the plain version's own f32
# terms (E.backtrace with acc_dtype=float64), and, at the coarse stages,
# to the plain version within that version's own distance to the same sum
# plus TOL_F32_GRAD (all three distances over the f64 sum's largest entry).
# At 65^3 (and at 128^3 above) the kernel is held to the plain version at
# TOL_F32_GRAD as before.
COARSE_RES = 33


# the card's name and power limit (``nvidia-smi``); the design tools call it
# under this name
smi_line = profiling.card_line


def rel_err(got, want):
    """max |got - want| over max(1, max |want|); also the raw max abs error."""
    err = float((got - want).abs().max())
    return err / max(1.0, float(want.abs().max())), err


# median CUDA-event ms of one call after an L2 flush and ~0.5 ms of busy card
# (``utils/profiling.py``; the design tools call it under this name)
time_ms = profiling.kernel_ms


def set_bound(rec, peak_flops=PEAK_F32_FLOPS):
    """The least time the card could take for ``rec``'s bytes and operations
    (operations at ``peak_flops``: the f32 rate unless given)."""
    by_bytes = 1e3 * rec["bytes"] / PEAK_BYTES_PER_S
    by_ops = 1e3 * rec["flops"] / peak_flops
    rec["bound_ms"] = max(by_bytes, by_ops)
    rec["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return rec


def scene(res, nrays, dtype, noise=0.0):
    """The bench scene plus the cotangents of the bench loss and K1's points."""
    rif, x0, v0, span = build_case(res=res, nrays=nrays, dtype=dtype, device="cuda")
    if noise:
        gen = torch.Generator(device="cuda").manual_seed(0)
        rif = rif + noise * torch.rand(rif.shape, generator=gen, device="cuda", dtype=rif.dtype)
    h = span / (res - 1)
    ds = h / 2
    # K1's points: the rays part-way through the volume, a fraction off-grid
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = torch.rand((nrays, 1), generator=gen, device="cuda", dtype=rif.dtype) * 1.1 * span
    p = (x0 + t * v0).contiguous()
    return dict(rif=rif, field=G.GridField(rif, h), x0=x0, v0=v0, span=span, h=h, ds=ds,
                p=p, nf=E.max_steps_fwd(res, h, ds), nb=E.max_steps_bwd(res, h, ds),
                target=torch.tensor([span / 2, span * 1.1, span / 2], dtype=rif.dtype,
                                    device="cuda"))


def compare_kernels(s, tol_state, tol_grad, label):
    """Run each kernel and its plain version on scene ``s``; returns errors and stats."""
    f, rif, h, ds = s["field"], s["rif"], s["h"], s["ds"]
    mask = G.inbounds(f, s["p"])
    n_k, g_k = G.eval_grad(f, s["p"], mask)  # dispatches to K1 on CUDA tensors
    n_p, g_p = G.eval_grad_plain(f, s["p"], mask)
    e1 = max(rel_err(n_k, n_p)[0], rel_err(g_k, g_p)[0])
    a1 = max(rel_err(n_k, n_p)[1], rel_err(g_k, g_p)[1])
    n_k2, g_k2 = G.eval_grad(f, s["p"])      # unmasked: off-grid points clamp
    n_p2, g_p2 = G.eval_grad_plain(f, s["p"])
    e1 = max(e1, rel_err(n_k2, n_p2)[0], rel_err(g_k2, g_p2)[0])
    a1 = max(a1, rel_err(n_k2, n_p2)[1], rel_err(g_k2, g_p2)[1])
    # K1's first design (the 8 corners one by one), kept as its yardstick, and
    # a grid one word off a 16-byte boundary, where no x-pair comes in one load
    buf = torch.empty(rif.numel() + 1, dtype=rif.dtype, device="cuda")
    buf[1:] = rif.reshape(-1)
    shifted = buf[1:].view(rif.shape)
    k1_equal = {}
    for label_k, (grid, pairs) in {"pair loads": (rif, True), "first design": (rif, False),
                                   "grid off 16 B": (shifted, True)}.items():
        got = K.eval_grad(grid, h, s["p"], mask, pair_loads=pairs)
        k1_equal[label_k] = bool(torch.equal(got[0], n_p) and torch.equal(got[1], g_p))

    fstats, bstats = {}, {}
    order = O.ray_order(s["x0"], s["v0"], rif.shape, h)  # as api.trace makes it
    xt_p, vt_p = E.trace(f, s["x0"], s["v0"], ds, s["nf"], stats=fstats)
    e2, a2, differ = 0.0, 0.0, {}
    for label_o, o in (("ordered", order), ("unordered", None)):
        xt_k, vt_k = K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"], o)
        e2 = max(e2, rel_err(xt_k, xt_p)[0], rel_err(vt_k, vt_p)[0])
        a2 = max(a2, rel_err(xt_k, xt_p)[1], rel_err(vt_k, vt_p)[1])
        differ[label_o] = int(((xt_k != xt_p) | (vt_k != vt_p)).any(dim=1).sum())

    dx = 2.0 * (xt_p - s["target"])
    dv = torch.ones_like(vt_p)
    g_p = E.backtrace(f, xt_p, vt_p, dx, dv, ds, s["nb"], stats=bstats)
    tally = torch.zeros(3, dtype=torch.int64, device="cuda")
    g_k = K.backtrace(rif, h, xt_p, vt_p, dx, dv, ds, s["nb"], G.snap_tol(rif.dtype), order,
                      tally)
    g_u = K.backtrace(rif, h, xt_p, vt_p, dx, dv, ds, s["nb"], G.snap_tol(rif.dtype))
    e3, a3 = (max(a, b) for a, b in zip(rel_err(g_k, g_p), rel_err(g_u, g_p)))
    runs, issued = int(tally[0]), int(tally[1])

    # one stepper step rebuilt from K1's field evaluation must land where one
    # step of K2 lands
    n1, g1 = K.eval_grad(rif, h, s["p"], mask)
    want = s["p"] + ds * (s["v0"] + (ds * n1)[:, None] * g1)
    got, _ = K.trace_fwd(rif, h, s["p"], s["v0"], ds, 1)
    step_err = rel_err(got[mask], want[mask])[0]  # a ray that starts outside keeps x0
    torch.cuda.synchronize()

    print(f"kernels[{label}] eval_grad rel_err {e1:.3e} (tol {tol_state:g}), bitwise equal to "
          f"the plain version: {k1_equal}; "
          f"trace_fwd rel_err {e2:.3e} (tol {tol_state:g}), rays of {s['x0'].shape[0]} not "
          f"bitwise equal: {differ['ordered']} ordered, {differ['unordered']} unordered; "
          f"backtrace ({K.backtrace_path(rif.numel(), rif.dtype)} path) rel_err {e3:.3e} "
          f"(tol {tol_grad:g}, ordered and unordered), max |g| {float(g_p.abs().max()):.4g}, "
          f"runs flushed {runs} (plain version's flushes {bstats['flushes']}), issued after the "
          f"warp sums {issued} ({8 * issued} atomic adds); one K2 step vs "
          f"a step built on K1 rel_err {step_err:.3e} (tol {tol_state:g})", flush=True)
    if not (e1 <= tol_state and e2 <= tol_state and e3 <= tol_grad and step_err <= tol_state):
        raise AssertionError(f"a kernel disagrees with its plain version at {label}")
    if not all(k1_equal.values()):
        raise AssertionError(f"K1 is not bitwise equal to its plain version: {k1_equal}")
    if not float(g_p.abs().max()) > 0:
        raise AssertionError("the plain gradient is all zero: the comparison is empty")
    if runs != bstats["flushes"]:
        raise AssertionError(f"K3 flushed {runs} runs, the plain version counts "
                             f"{bstats['flushes']}")
    if any(differ.values()):
        raise AssertionError(f"K2 is not bitwise equal to its plain version: {differ}")
    return dict(abs_err=(a1, a2, a3), rel_err=(e1, e2, e3), fstats=fstats, bstats=bstats, mask=mask,
                xt=xt_p, vt=vt_p, dx=dx, dv=dv, order=order, differ=differ, issued=issued)


def api_small_check():
    """api.trace on the card (kernels) against api.trace on the CPU (plain), f64."""
    grads = []
    for device in ("cuda", "cpu"):
        rif, x0, v0, span = build_case(res=17, nrays=512, dtype="float64", device=device)
        loss, g = bench.fwd_bwd(rif, x0, v0, span)
        grads.append((float(loss), g.cpu()))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = grads
    err = rel_err(g_gpu, g_cpu)[0]
    print(f"api[f64 17^3 x 512] loss gpu {l_gpu:.12g} cpu {l_cpu:.12g}; "
          f"gradient rel_err {err:.3e} (tol {TOL_F64:g})", flush=True)
    if abs(l_gpu - l_cpu) > TOL_F64 * abs(l_cpu) or err > TOL_F64:
        raise AssertionError("api.trace on the card disagrees with the CPU reference")

    # the same call with non-contiguous rif, x, v (the kernels take contiguous
    # tensors: api.trace makes them so) gives the same exit state, bit for bit
    rif, x0, v0, span = build_case(res=17, nrays=512, dtype="float64", device="cuda")
    h = span / 16
    strided_rif = rif.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    xv = torch.cat([x0, v0], dim=1)
    sx, sv = xv[:, :3], xv[:, 3:]
    if strided_rif.is_contiguous() or sx.is_contiguous() or sv.is_contiguous():
        raise AssertionError("the strided case is contiguous")
    strided_rif.requires_grad_(True)
    xt_s, vt_s = api.trace(strided_rif, sx, sv, h, h / 2)
    (xt_s ** 2).sum().backward()
    ref = rif.clone().requires_grad_(True)
    xt_c, vt_c = api.trace(ref, x0, v0, h, h / 2)
    (xt_c ** 2).sum().backward()
    gerr = rel_err(strided_rif.grad, ref.grad)[0]
    print(f"api[strided rif, x, v] exit state equal {bool(torch.equal(xt_s, xt_c))}, "
          f"gradient rel_err {gerr:.3e} (tol {TOL_F64:g})", flush=True)
    if not (torch.equal(xt_s, xt_c) and torch.equal(vt_s, vt_c)) or gerr > TOL_F64:
        raise AssertionError("api.trace on strided inputs disagrees with contiguous ones")


def exact_check(rif, h, ds, x0, v0, cot, label, tol, times=False):
    """K5 and K6 against the plain exact path (``tracer/checkpointed.py``) on the card.

    K5's exit state must equal the plain version's and K2's bit for bit, its
    capture steps and exit codes the plain version's exactly, and the
    checkpoint rows the backward pass reads the plain version's bit for bit;
    K6 (with the order, as ``trace_exact`` runs it) within ``tol`` of the
    largest entry of the plain gradient, which in f32 is summed in f64 from
    the same f32 terms (``acc_dtype``), and K6's runs (counted in the kernel)
    equal the plain version's ``flushes``.  ``cot(xt, vt)`` gives the
    cotangents.  Returns the row of the report and a list of failures."""
    steps = E.max_steps_fwd(max(rif.shape), h, ds)
    order = O.ray_order(x0, v0, rif.shape, h)
    fw, bw = {}, {}
    xt_p, vt_p, esc_p, c_p, cap_p, ck_p = CK._forward_with_ckpts(
        G.GridField(rif, h), x0, v0, ds, steps, SEG, stats=fw)
    xt_k, vt_k, c_k, code_k, ck_k = K.trace_ckpt(rif, h, x0, v0, ds, steps, SEG, order)
    xt_2, vt_2 = K.trace_fwd(rif, h, x0, v0, ds, steps, order)
    code_p = torch.where(esc_p, torch.where(cap_p, 1, 2), 0).to(torch.uint8)
    # the rows the backward pass reads: segments that start before the ray's last gated-on step
    live_steps = torch.where(code_p == 2, 0, c_p)[order.long()]
    need = (torch.arange(ck_p.shape[0], device="cuda")[:, None] * SEG) < live_steps[None, :]
    state = dict(
        exit_state=bool(torch.equal(xt_k, xt_p) and torch.equal(vt_k, vt_p)),
        exit_state_k2=bool(torch.equal(xt_k, xt_2) and torch.equal(vt_k, vt_2)),
        capture_steps=bool(torch.equal(c_k, c_p) and torch.equal(code_k, code_p)),
        checkpoints=bool(torch.equal(ck_k.transpose(1, 2)[need],
                                     ck_p[:, :, order.long()].transpose(1, 2)[need])))
    fwd_abs = max(float((a - b).abs().max()) for a, b in ((xt_k, xt_p), (vt_k, vt_p)))
    dx, dv = cot(xt_p, vt_p)
    dv_k = torch.where(esc_p[:, None], dv, torch.zeros_like(dv))
    bw["captured"] = cap_p
    f32 = rif.dtype == torch.float32
    g_ref = CK.backtrace_plain(rif, x0, v0, esc_p, c_p, ck_p, dx, dv, h, ds, SEG,
                               acc_dtype=torch.float64 if f32 else None, stats=bw)
    tally = torch.zeros(len(K.EXACT_TALLY), dtype=torch.int64, device="cuda")
    g_k = K.backtrace_exact(rif, h, ck_k, c_k, code_k, dx, dv_k, ds, SEG, order, tally=tally)
    torch.cuda.synchronize()
    err, abs_err = rel_err(g_k.double(), g_ref.double())
    path = "global"  # K6's one path
    row = dict(label=label, path=path, rel_err=err, abs_err=abs_err, tol=tol,
               max_abs_g=float(g_ref.abs().max()), bitwise=state, runs=int(tally[0]),
               fwd_abs_err=fwd_abs, fwd_rel_err=fwd_abs / max(1.0, float(xt_p.abs().max()),
                                                              float(vt_p.abs().max())),
               **run_counts(tally), fwd=fw,
               bwd={k: bw[k] for k in ("ray_steps", "evals", "splats", "flushes")},
               ckpt_rows=int(need.sum()), ckpt_mb=ck_k.numel() * ck_k.element_size() / 1e6,
               rays_code=[int((code_k == k).sum()) for k in range(3)])
    # what this run's data needs: each input read once, each output and each
    # checkpoint row the backward pass reads written once; the ray-steps,
    # evaluations and splats the plain versions counted
    n, item = x0.shape[0], rif.element_size()
    rows_bytes = row["ckpt_rows"] * 7 * item
    row["k5"] = set_bound(dict(
        bytes=12 * n * item + 5 * n + rows_bytes + rif.numel() * item,
        flops=fw["ray_steps"] * FLOPS_FWD_STEP + fw["evals"] * FLOPS_FWD_EVAL))
    row["k6"] = set_bound(dict(
        bytes=rows_bytes + 5 * n + 6 * n * item + 2 * rif.numel() * item,
        flops=(bw["ray_steps"] * FLOPS_EXACT_STEP + bw["evals"] * FLOPS_EXACT_EVAL
               + bw["splats"] * FLOPS_BWD_SPLAT)))
    if times:
        row["k5"]["ms"] = time_ms(lambda: K.trace_ckpt(rif, h, x0, v0, ds, steps, SEG, order), 3)
        row["k6"]["ms"] = time_ms(lambda: K.backtrace_exact(rif, h, ck_k, c_k, code_k, dx, dv_k,
                                                            ds, SEG, order), 3)
        row["k5_ms"], row["k6_ms"] = row["k5"]["ms"], row["k6"]["ms"]
        for k in ("k5", "k6"):
            row[k]["share_of_bound"] = row[k]["bound_ms"] / row[k]["ms"]
    print(f"exact[{label}, {x0.shape[0]} rays] K5 bitwise equal {state}; K6 {path} path: "
          f"rel_err {err:.3e} against the plain version"
          + (" summed in f64 from the same f32 terms" if f32 else "")
          + f" (tol {tol:g}), max |g| {row['max_abs_g']:.4g}; runs flushed {row['runs']} "
          f"(plain flushes {bw['flushes']}, splats {bw['splats']}), issued {row['issued']}; "
          f"rays never escaped / captured / never inside {row['rays_code']}; checkpoints "
          f"{row['ckpt_mb']:.1f} MB, rows read {row['ckpt_rows']}"
          + (f"; K5 {row['k5_ms']:.4f} ms (bound {row['k5']['bound_ms']:.4f}, "
             f"{row['k5']['bound_by']}: {100 * row['k5']['share_of_bound']:.1f} % of it), K6 "
             f"{row['k6_ms']:.4f} ms (bound {row['k6']['bound_ms']:.4f}, "
             f"{row['k6']['bound_by']}: {100 * row['k6']['share_of_bound']:.1f} % of it)"
             if times else ""),
          flush=True)
    failures = []
    if not all(state.values()):
        failures.append(f"K5 is not bitwise equal to its plain version at {label}: {state}")
    if not (err <= tol and row["max_abs_g"] > 0):
        failures.append(f"K6 disagrees with its plain version at {label}: {err:.3e}")
    if row["runs"] != bw["flushes"]:
        failures.append(f"K6 flushed {row['runs']} runs at {label}, the plain version counts "
                        f"{bw['flushes']}")
    return row, failures


def exact_plain_ms(rif, h, ds, x0, v0, cot):
    """One run of each plain version of the exact path on the card, host clock
    after a synchronise (they are Python loops of small launches): K5's
    (the segmented forward) and K6's (the segment replay and reverse sweep)."""
    field = G.GridField(rif, h)
    steps = E.max_steps_fwd(max(rif.shape), h, ds)
    torch.cuda.synchronize()
    t0 = time.time()
    xt, vt, esc, c, _, ck = CK._forward_with_ckpts(field, x0, v0, ds, steps, SEG)
    torch.cuda.synchronize()
    t1 = time.time()
    dx, dv = cot(xt, vt)
    CK.backtrace_plain(rif, x0, v0, esc, c, ck, dx, dv, h, ds, SEG)
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0), 1e3 * (time.time() - t1)


class exact_chunk:
    """``ANRT_EXACT_CHUNK`` set to ``chunk`` inside a ``with`` block."""

    def __init__(self, chunk):
        self.chunk, self.saved = chunk, None

    def __enter__(self):
        self.saved = os.environ.get("ANRT_EXACT_CHUNK")
        os.environ["ANRT_EXACT_CHUNK"] = str(self.chunk)

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("ANRT_EXACT_CHUNK", None)
        else:
            os.environ["ANRT_EXACT_CHUNK"] = self.saved


def exact_api_check():
    """``tracer.trace_exact`` on the card (K5, K6) against the taped plain stepper
    (``api.trace_ad``, the exact discrete gradient by definition) in f64, with
    the batch whole and cut into chunks (``ANRT_EXACT_CHUNK``)."""
    rif, x0, v0, span = build_case(res=17, nrays=512, dtype="float64", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rif = rif + 0.05 * torch.rand(rif.shape, generator=gen, device="cuda", dtype=rif.dtype)
    h = span / 16
    target = torch.tensor([span / 2, span * 1.1, span / 2], dtype=rif.dtype, device="cuda")

    def grad(fn):
        r = rif.clone().requires_grad_(True)
        xt, vt = fn(r, x0, v0, h, h / 2)
        (((xt - target) ** 2).sum() + vt.sum()).backward()
        return xt.detach(), r.grad

    K.reset_launches()
    xt_e, g_e = grad(CK.trace_exact)
    with exact_chunk(100):  # 6 chunks, the last one short
        xt_c, g_c = grad(CK.trace_exact)
    launches = dict(K.LAUNCHES)
    xt_a, g_a = grad(api.trace_ad)
    xt_d, g_d = grad(api.trace)
    e_tape, e_chunk = rel_err(g_e, g_a)[0], rel_err(g_c, g_e)[0]
    print(f"exact[f64 17^3 x 512, api] trace_exact against trace_ad: exit state equal "
          f"{bool(torch.equal(xt_e, xt_a))}, gradient rel_err {e_tape:.3e} (tol {TOL_F64:g}); "
          f"chunked by 100 against whole {e_chunk:.3e}; the adjoint (api.trace) against "
          f"trace_ad {rel_err(g_d, g_a)[0]:.3e}; launches {launches}", flush=True)
    want = {**{name: 0 for name in build.KERNELS}, "trace_ckpt": 1 + 1 + 6,
            "backtrace_exact": 1 + 6}
    if launches != want:
        raise AssertionError(f"trace_exact must launch {want}, counted {launches}")
    if not (torch.equal(xt_e, xt_a) and torch.equal(xt_c, xt_a)):
        raise AssertionError("trace_exact's exit state differs from the plain stepper's")
    if not (e_tape <= TOL_F64 and e_chunk <= TOL_F64 and float(g_a.abs().max()) > 0):
        raise AssertionError("trace_exact on the card is not the exact gradient")


def time_kernels(s, cmp):
    """Times (ms) of kernel, plain version and library call at full width, and bounds."""
    f, rif, h, ds = s["field"], s["rif"], s["h"], s["ds"]
    n, item = s["x0"].shape[0], rif.element_size()
    grid_bytes = rif.numel() * item
    mask = cmp["mask"]
    flush = profiling.l2_flush_buffer()

    # one trilinear grid_sample gives the value alone (no gradient, no mask):
    # the nearest single library call, timed as a yardstick and used nowhere
    hi = torch.tensor([(r - 1) * h for r in f.res], dtype=rif.dtype, device="cuda")
    loc = (2.0 * s["p"] / hi - 1.0).reshape(1, 1, 1, n, 3)
    vol = rif[None, None]

    def sample():
        return torch.nn.functional.grid_sample(vol, loc, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    inside = mask
    lib_err = float((sample().reshape(-1)[inside] - G.eval_grad_plain(f, s["p"])[0][inside])
                    .abs().max())
    print(f"library grid_sample vs plain value on in-grid points: max abs {lib_err:.3e}")

    t = {}

    def k1(pairs):
        return lambda: K.eval_grad(rif, h, s["p"], mask, pair_loads=pairs)

    t["eval_grad"] = dict(
        ms=time_ms(k1(True), 10, flush),
        plain_ms=time_ms(lambda: G.eval_grad_plain(f, s["p"], mask), 5, flush),
        library_ms=time_ms(sample, 10, flush),
        bytes=n * (12 + 16) // 4 * item + n + grid_bytes, flops=n * FLOPS_EVAL_POINT)
    # the first design (the 8 corners one by one, built with the shipped one)
    # under the same yardstick, and both designs and grid_sample under the
    # earlier yardstick (the buffer written)
    before = dict(ms=time_ms(k1(False), 10, flush),
                  ms_dirty_flush=time_ms(k1(False), 10, flush, True))
    t["eval_grad"].update(before=before, ms_dirty_flush=time_ms(k1(True), 10, flush, True),
                          library_ms_dirty_flush=time_ms(sample, 10, flush, True))
    e = t["eval_grad"]
    print(f"eval_grad[f32, {n} points] ms, buffer read / written before each launch: "
          f"pair loads {e['ms']:.4f} / {e['ms_dirty_flush']:.4f}; first design, corners one "
          f"by one (before) {before['ms']:.4f} / {before['ms_dirty_flush']:.4f}; grid_sample "
          f"{e['library_ms']:.4f} / {e['library_ms_dirty_flush']:.4f}", flush=True)
    # K2 and K3 as api.trace launches them (with the ray order), and without it
    order = cmp["order"]
    t["trace_fwd"] = dict(
        ms=time_ms(lambda: K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"], order), 5),
        ms_unordered=time_ms(lambda: K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"]), 5),
        plain_ms=time_ms(lambda: E.trace(f, s["x0"], s["v0"], ds, s["nf"]), 1),
        library_ms=None,
        bytes=4 * n * 3 * item + grid_bytes,
        flops=(cmp["fstats"]["ray_steps"] * FLOPS_FWD_STEP
               + cmp["fstats"]["evals"] * FLOPS_FWD_EVAL))
    args = (cmp["xt"], cmp["vt"], cmp["dx"], cmp["dv"], ds, s["nb"])
    tol = G.snap_tol(rif.dtype)
    t["backtrace"] = dict(
        ms=time_ms(lambda: K.backtrace(rif, h, *args, tol, order), 5),
        ms_unordered=time_ms(lambda: K.backtrace(rif, h, *args, tol), 5),
        plain_ms=time_ms(lambda: E.backtrace(f, *args), 1),
        library_ms=None,
        bytes=4 * n * 3 * item + 2 * grid_bytes,
        flops=(cmp["bstats"]["ray_steps"] * FLOPS_BWD_STEP
               + cmp["bstats"]["evals"] * FLOPS_BWD_EVAL
               + cmp["bstats"]["splats"] * FLOPS_BWD_SPLAT))
    t["order_ms"] = time_ms(lambda: O.ray_order(s["x0"], s["v0"], rif.shape, h), 10)
    print(f"order: tracer.order.ray_order of {n} rays (key + stable argsort, set-up of "
          f"api.trace's forward pass, not a kernel of the port) {t['order_ms']:.4f} ms; "
          f"K2 {t['trace_fwd']['ms']:.4f} ms ordered, {t['trace_fwd']['ms_unordered']:.4f} ms "
          f"unordered; K3 {t['backtrace']['ms']:.4f} ms ordered, "
          f"{t['backtrace']['ms_unordered']:.4f} ms unordered", flush=True)
    for name in ("eval_grad", "trace_fwd", "backtrace"):
        set_bound(t[name])
    t["eval_grad"]["before"]["share_of_bound"] = t["eval_grad"]["bound_ms"] / before["ms"]
    return t


def gather_check_and_time():
    """K4 against its plain version at the probe's size, exactly; times and bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((GATHER_ROWS, probe_dma_gather.LANES), generator=gen,
                        dtype=torch.float32, device="cuda")
    idx = torch.randint(0, GATHER_ROWS, (GATHER_N,), generator=gen, dtype=torch.int32,
                        device="cuda")
    worst = 0.0
    for tab in (table, table.double()):
        for ind in (idx, idx.long()):
            got = K.gather_rows(tab, ind)
            want = probe_dma_gather.gather_rows_plain(tab, ind)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"kernels[gather_rows {str(tab.dtype)[6:]} table {tuple(tab.shape)}, "
                  f"{str(ind.dtype)[6:]} idx ({GATHER_N},)] max abs err {err:g} (must be 0), "
                  f"bitwise equal {bool(torch.equal(got, want))}", flush=True)
            if err != 0.0 or not torch.equal(got, want):
                raise AssertionError("gather_rows disagrees with its plain version")
    del tab, got, want
    flush = profiling.l2_flush_buffer()
    row_bytes = table.shape[1] * table.element_size()
    rec = dict(
        ms=time_ms(lambda: K.gather_rows(table, idx), 10, flush),
        plain_ms=time_ms(lambda: probe_dma_gather.gather_rows_plain(table, idx), 10, flush),
        # the one library call that computes the same function; used nowhere in the port
        library_ms=time_ms(lambda: torch.index_select(table, 0, idx), 10, flush),
        ms_dirty_flush=time_ms(lambda: K.gather_rows(table, idx), 10, flush, True),
        library_ms_dirty_flush=time_ms(lambda: torch.index_select(table, 0, idx), 10, flush,
                                       True),
        # what this run's data needs: each gathered row read once and written
        # once, each index read once (the table as a whole is not an input
        # that must move: only the rows picked are)
        bytes=2 * GATHER_N * row_bytes + GATHER_N * idx.element_size(), flops=0,
        max_abs_err=worst)
    set_bound(rec)
    print(f"gather_rows[f32, int32] {rec['ms']:.4f} ms = {100 * rec['bound_ms'] / rec['ms']:.1f} % "
          f"of the byte bound {rec['bound_ms']:.4f} ms ({rec['bytes'] / 1e6:.1f} MB); plain "
          f"{rec['plain_ms']:.4f} ms; torch.index_select {rec['library_ms']:.4f} ms; with the "
          f"buffer written before each launch (the earlier yardstick): K4 "
          f"{rec['ms_dirty_flush']:.4f} ms, index_select {rec['library_ms_dirty_flush']:.4f} ms",
          flush=True)
    return rec


def gather_probe_path():
    """The probe's entry point; it launches K4 for its check, its warm-up and each repetition."""
    K.reset_launches()
    rec = probe_dma_gather.run(R=GATHER_ROWS, N=GATHER_N, reps=GATHER_REPS)
    launches = dict(K.LAUNCHES)
    print(f"gather probe: {json.dumps(rec)}", flush=True)
    want = {**{name: 0 for name in build.KERNELS}, "gather_rows": 2 + GATHER_REPS}
    if launches != want:
        raise AssertionError(f"probe_dma_gather.run must launch {want}, counted {launches}")
    if rec["max_abs_err"] != 0.0 or not rec["kernel"]["ms_per_dispatch"] > 0:
        raise AssertionError("probe_dma_gather.run: wrong result or no time")
    return launches


def fuel_params():
    """Section ``default`` of ``configs/params-fuel.yaml``, written out (the GPU machine
    is not known to have ``yaml``; a CPU test holds the two equal)."""
    return dict(fuel_injection.default_params(), nviews=16)


def escalation_stage(metrics):
    """The stage at which the run's spot check switched to the exact gradient, or None."""
    stages = [row["gradient_escalated_stage"] for row in metrics.history
              if "gradient_escalated_stage" in row]
    if len(stages) > 1:
        raise AssertionError(f"the run escalated more than once: {stages}")
    return int(stages[0]) if stages else None  # the logger keeps numbers as floats


def expected_launches(params, escalated, nrays, extra_fwd=0, nbuckets=1, mesh=False):
    """The launches that a driver's run of ``params`` implies, from the code,
    when its stage escalation fired at stage ``escalated`` (None: never), with
    ``nrays`` rays a step.

    Per Adam step of a stage before the escalation one K2 (the loss) and one
    K3 (its gradient); from it on the exact gradient (``trace_exact``): one
    K5 and one K6 where the batch fits one chunk of ``ANRT_EXACT_CHUNK`` rays,
    else one K5 for the forward pass and, for each chunk of the backward pass,
    one K5 (its checkpoints) and one K6 (``checkpointed._TraceExact``).  Per
    spot check (one at start-up, one at the start of every stage up to the one
    that escalates, after which the escalator checks no more) one K2 and one
    K3 (``tracer.trace``) and one K5 and one K6 (``trace_exact`` on at most
    2048 rays, one chunk).  ``extra_fwd`` forward passes without a gradient
    (one K2 each) come before the first stage.  Every K3 launch of stage s runs
    on that stage's grid, so its path is that grid's
    (``wrappers.backtrace_path``; K6 has one path).  ``nbuckets``: the
    exit-step buckets the run's trace takes (``make_trace``'s pick): an
    adjoint step is then that many K2 and K3 launches (the spot checks call
    ``tracer.trace`` whole).  ``mesh``: the run traces on the ray mesh, whose
    exact backward pass recomputes the checkpoints even for one chunk (one K5
    more a step).  Returns the steps, the launches in all, the K3 launches by
    path and the launches of each stage."""
    res_list, iters = params["res_list"], params["optim_iters"]
    stages = len(res_list)
    first_exact = stages if escalated is None else escalated
    last_check = stages - 1 if escalated is None else escalated
    checked = ([0] if params.get("grad_spotcheck", True) else []) + (
        list(range(1, last_check + 1)) if params.get("auto_exact", True) else [])
    dtype = {"float32": torch.float32, "float64": torch.float64}[params.get("dtype", "float32")]
    chunks = len(CK._chunks(nrays, CK.exact_chunk_rays()))
    paths = {"backtrace": {"shared": 0, "global": 0}}
    total = {name: 0 for name in build.KERNELS}
    per_stage = []
    for s, res in enumerate(res_list):
        n, check = iters * (s + 1), int(s in checked)
        adjoint, exact = (0, n) if s >= first_exact else (n, 0)
        k = {name: 0 for name in build.KERNELS}
        k["trace_fwd"] = adjoint * nbuckets + check + (extra_fwd if s == 0 else 0)
        k["backtrace"] = adjoint * nbuckets + check
        k["trace_ckpt"] = exact * (chunks + (chunks > 1 or mesh)) + check
        k["backtrace_exact"] = exact * chunks + check
        paths["backtrace"][K.backtrace_path(res ** 3, dtype)] += k["backtrace"]
        per_stage.append(k)
        for name in total:
            total[name] += k[name]
    return iters * stages * (stages + 1) // 2, total, paths, per_stage


def stage_launches(events, step_rows, params):
    """The launches of each stage as the events around every launch recorded
    them: a stage's are those after the previous stage's last step up to its
    own last step (its spot check runs before its first step).  Also returns
    the launches after the last step."""
    res_list, iters = params["res_list"], params["optim_iters"]
    out, first, start = [], 0, 0
    for s in range(len(res_list)):
        end = step_rows[first + iters * (s + 1) - 1][3]
        first += iters * (s + 1)
        counts = {name: 0 for name in build.KERNELS}
        for name, _, _ in events[start:end]:
            counts[name] += 1
        out.append(counts)
        start = end
    return out, events[start:]


def kernel_paths():
    return {"backtrace": dict(K.BACKTRACE_PATHS)}


def fuel_path(iters, label, work):
    """The fuel-injection trainer at full width for ``iters`` iterations a stage.

    As a user runs it: the spot checks and the stage escalation are on, with
    the escalation tolerance (``ANRT_EXACT_TOL``) at its default.  In f32 the
    constant-memory adjoint drifts on this scene (rays of a view run along a
    grid axis and ``ds`` divides ``h``, so every few steps a position sits on
    a node plane, where forward and reverse can pick different cells), so the
    escalation fires and the remaining stages run the exact gradient (K5, K6).
    The stage it fires at is read from the run's metrics, the run fails if it
    never fires (the exact kernels would then be off the trainer's path), and
    the launches are held to what the code implies for that stage.
    """
    params = dict(fuel_params(), optim_iters=iters, grad_spotcheck=True, auto_exact=True)
    res_list = params["res_list"]
    nrays = params["nviews"] * params["nbins"] ** 2 * params["spp"]
    step_rows, events = [], []

    def stat(it, loss, secs):
        step_rows.append((it, loss, secs, len(events)))

    metrics = MetricsLogger()
    if "ANRT_EXACT_TOL" in os.environ:
        raise AssertionError("ANRT_EXACT_TOL is set: the run would not be a user's run")
    K.reset_launches()
    K.record_events(events)
    t0 = time.time()
    try:
        eta, hist, gtruth = fuel_injection.run_opt(params, None, stat_fn=stat, metrics=metrics)
        torch.cuda.synchronize()
    finally:
        K.record_events(None)
    seconds = time.time() - t0
    launches = dict(K.LAUNCHES)
    paths = kernel_paths()
    escalated = escalation_stage(metrics)
    # one forward pass before the first stage: the ground truth's exit rays
    steps, want, want_paths, want_stages = expected_launches(params, escalated, nrays, 1)
    got_stages, after = stage_launches(events, step_rows, params)
    checks = {k: v for row in metrics.history for k, v in row.items()
              if k.startswith("grad_spotcheck")}
    for name in sorted(k for k in checks if not k.endswith(("_rel_l2", "_cos"))):
        print(f"fuel[{label}] {name} (adjoint against trace_exact, 2048 rays): "
              f"max-rel {checks[name]:.3e}, rel-L2 {checks[name + '_rel_l2']:.3e}, cosine "
              f"{checks[name + '_cos']:.5f}; the escalation tolerance is 0.01", flush=True)
    print(f"fuel[{label}] escalation to the exact gradient fired at stage {escalated}"
          + (f" ({res_list[escalated]}^3)" if escalated is not None else ""), flush=True)
    if escalated is None:
        raise AssertionError("the f32 run at full width never escalated to the exact gradient: "
                             "K5 and K6 are not on the trainer's path")
    print(f"fuel[{label}] {params['nviews']} views x {params['nbins']}^2 = {nrays} rays, "
          f"stages {res_list}, optim_iters {iters} (shipped {FUEL_ITERS_SHIPPED}), "
          f"{steps} Adam steps in {seconds:.2f} s; launches {launches}; by path {paths} "
          f"(stages {[f'{r}^3: ' + K.backtrace_path(r ** 3, torch.float32) for r in res_list]})",
          flush=True)
    if launches != want or paths != want_paths or got_stages != want_stages or after:
        raise AssertionError(f"run_opt must launch {want}, by path {want_paths}, by stage "
                             f"{want_stages}, counted {launches}, {paths}, {got_stages} and "
                             f"{len(after)} after the last step")
    if nrays != 262144 or len(hist) != steps or len(step_rows) != steps:
        raise AssertionError("the fuel run is not at full width or lost steps")
    if not all(map(math.isfinite, hist)):
        raise AssertionError("a loss of the fuel run is not finite")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"the loss did not fall: {hist[0]} -> {hist[-1]}")
    clamp_max = float(params["step_res"])
    if eta.shape != (65, 65, 65) or eta.dtype != torch.float32 or not eta.is_cuda:
        raise AssertionError("the recovered field is not a 65^3 f32 tensor on the card")
    if not bool(torch.isfinite(eta).all()) or float(eta.min()) < 1.0 \
            or float(eta.max()) > clamp_max:
        raise AssertionError("the recovered field leaves [1, clamp_max]")
    # the shell is frozen at every stage and a finer shell is interpolated
    # from the coarser shell alone, so a shell that had moved at any stage
    # would show here; resampling a constant costs a few roundings
    interior = torch.zeros_like(eta, dtype=torch.bool)
    interior[1:-1, 1:-1, 1:-1] = True
    start = torch.ones((), dtype=torch.float32, device="cuda") + params["fuel_val"]
    shell_dev = float((eta[~interior] - start).abs().max())
    moved = float((eta[interior] - start).abs().max())
    if shell_dev > 1e-6 or not moved > 1e-6:
        raise AssertionError(f"boundary shell moved by {shell_dev} or interior stayed ({moved})")

    # per stage: step time on the host clock (each step ends with the loss
    # read back, so the device has finished), and the step's forward and
    # backward kernel (K2 + K3, or K5 + K6 once escalated) from the events
    # recorded around the launches
    per_stage, first = [], 0
    first_exact = escalated
    for s, res in enumerate(res_list):
        rows = step_rows[first:first + iters * (s + 1)]
        first += len(rows)
        step_ms = sorted(1e3 * r[2] for r in rows)
        names = ("trace_ckpt", "backtrace_exact") if s >= first_exact else ("trace_fwd",
                                                                           "backtrace")
        kern = []
        for r in rows:
            (n2, a2, b2), (n3, a3, b3) = events[r[3] - 2:r[3]]  # the step's own two launches
            if (n2, n3) != names:
                raise AssertionError(f"a step's launches at stage {s} are not {names}")
            kern.append((a2.elapsed_time(b2), a3.elapsed_time(b3)))
        kf = sorted(k[0] for k in kern)[len(kern) // 2]
        kb = sorted(k[1] for k in kern)[len(kern) // 2]
        med = step_ms[len(step_ms) // 2]
        per_stage.append(dict(res=res, steps=len(rows), gradient=("exact" if s >= first_exact
                                                                  else "adjoint"),
                              step_ms_median=med, step_ms_mean=sum(step_ms) / len(step_ms),
                              rays_per_s=nrays / (1e-3 * med), fwd_ms_median=kf,
                              bwd_ms_median=kb, kernel_share=(kf + kb) / med,
                              loss_last=rows[-1][1]))
        print(f"fuel[{label}] stage {s} res {res}^3 ({per_stage[-1]['gradient']}): {len(rows)} "
              f"steps, median {med:.3f} ms/step = {nrays / (1e-3 * med):.4g} rays/s; "
              f"{'K5' if s >= first_exact else 'K2'} {kf:.3f} ms + "
              f"{'K6' if s >= first_exact else 'K3'} {kb:.3f} ms = "
              f"{100 * (kf + kb) / med:.1f} % of the step, the rest {med - kf - kb:.3f} ms is "
              f"host work and small kernels; loss {rows[-1][1]:.6g}", flush=True)
    # the work of a pass at each stage as the plain versions counted it on the
    # run's own rays (stage_checks), and the rates the stage's kernel times give
    for st, w in zip(per_stage, work):
        if st["gradient"] == "adjoint":
            print(f"fuel[{label}] work of a pass at {st['res']}^3: forward {w['ray_steps_fwd']} "
                  f"ray-steps, K2 at {w['ray_steps_fwd'] / (1e-3 * st['fwd_ms_median']):.4g} "
                  f"ray-steps/s; backward {w['ray_steps']} ray-steps, {w['splats']} splats "
                  f"({8 * w['splats']} adds a splat each would issue), {w['flushes']} runs, "
                  f"issued as {w['issued']} flushes = {8 * w['issued']} adds into K3's "
                  f"{w['path']} accumulator"
                  + (f" + {w['block_adds']} adds of the block-private gradients"
                     if w["path"] == "shared" else "")
                  + f"; K3 at {w['ray_steps'] / (1e-3 * st['bwd_ms_median']):.4g} ray-steps/s",
                  flush=True)
        else:
            ex = w["exact"]
            print(f"fuel[{label}] work of an exact pass at {st['res']}^3: forward "
                  f"{ex['fwd']['ray_steps']} ray-steps, K5 at "
                  f"{ex['fwd']['ray_steps'] / (1e-3 * st['fwd_ms_median']):.4g} ray-steps/s; "
                  f"backward {ex['bwd']['ray_steps']} gated-on ray-steps (each replayed), "
                  f"{ex['bwd']['splats']} splats, {ex['bwd']['flushes']} runs, issued as "
                  f"{ex['issued']} flushes into K6's {ex['path']} accumulator; K6 at "
                  f"{ex['bwd']['ray_steps'] / (1e-3 * st['bwd_ms_median']):.4g} ray-steps/s; "
                  f"checkpoints {ex['ckpt_mb']:.1f} MB", flush=True)
    err = fuel_injection.reconstruction_error(eta, gtruth,
                                              background=1.0 + params["fuel_val"])
    print(f"fuel[{label}] loss {hist[0]:.6g} -> {hist[-1]:.6g}; shell deviation {shell_dev:.2e}; "
          f"reconstruction_error (background 1 + fuel_val) {json.dumps(err)}", flush=True)
    return dict(seconds=seconds, steps=steps, launches=launches, paths=paths,
                escalated=escalated, per_stage=per_stage, loss_first=hist[0],
                loss_last=hist[-1], spot_checks=checks, **err)


def stage_check(rif, h, ds, x0, v0, failures, label=None):
    """K2 and K3 against their plain versions on the grid ``rif`` with the rays
    ``(x0, v0)``: K2 bitwise equal with and without the order; K3 (with the
    order, as api.trace runs it) within the limits above; the runs K3 flushed,
    counted in the kernel, equal to the plain version's ``flushes``.  In f32
    also K5 and K6 (:func:`exact_check`) and the kernels' times.  Appends to
    ``failures``; returns the row of the report and, in f32, the work of a
    pass as the plain versions counted it."""
    dtype, res = rif.dtype, max(rif.shape)
    label = label or f"{str(dtype)[6:]} {res}^3"
    f = G.GridField(rif, h)
    nf, nb, tol_snap = E.max_steps_fwd(res, h, ds), E.max_steps_bwd(res, h, ds), \
        G.snap_tol(dtype)
    order = O.ray_order(x0, v0, rif.shape, h)
    fw, bw = {}, {}
    xt, vt = E.trace(f, x0, v0, ds, nf, stats=fw)
    differ = {}
    for lab, o in (("ordered", order), ("unordered", None)):
        xt_k, vt_k = K.trace_fwd(rif, h, x0, v0, ds, nf, o)
        differ[lab] = int(((xt_k != xt) | (vt_k != vt)).any(dim=1).sum())
    dx, dv = 2.0 * (xt - 0.5), torch.ones_like(vt)
    g_p = E.backtrace(f, xt, vt, dx, dv, ds, nb, stats=bw)
    g_p2 = E.backtrace(f, xt, vt, dx, dv, ds, nb)
    tally = torch.zeros(3, dtype=torch.int64, device="cuda")
    g_k = K.backtrace(rif, h, xt, vt, dx, dv, ds, nb, tol_snap, order, tally)
    path = K.backtrace_path(rif.numel(), dtype)
    err, spread = rel_err(g_k, g_p)[0], rel_err(g_p2, g_p)[0]
    if dtype == torch.float32:
        # every distance over the f64 sum's largest entry, so that the
        # triangle inequality holds between the three
        g_64 = E.backtrace(f, xt, vt, dx, dv, ds, nb, acc_dtype=torch.float64)
        scale = max(1.0, float(g_64.abs().max()))
        err_f = [float((g.double() - w).abs().max()) / scale
                 for g, w in ((g_k, g_p.double()), (g_k, g_64), (g_p, g_64))]
        if res <= COARSE_RES:
            err = err_f[0]
    row = dict(dtype=str(dtype)[6:], res=res, label=label, rays=x0.shape[0], path=path,
               max_abs_g=float(g_p.abs().max()), rel_err=err, plain_spread=spread,
               differ=differ, runs=int(tally[0]), issued=int(tally[1]),
               block_adds=int(tally[2]), flushes=bw["flushes"], splats=bw["splats"])
    work = None
    if dtype == torch.float64:
        tol = TOL_F64
    else:
        row.update(kernel_vs_f64_sum=err_f[1], plain_vs_f64_sum=err_f[2])
        tol = TOL_F32_GRAD
        if res <= COARSE_RES:
            tol = row["plain_vs_f64_sum"] + TOL_F32_GRAD
        if row["kernel_vs_f64_sum"] > TOL_F32_GRAD:
            failures.append(f"K3 at {label} is {row['kernel_vs_f64_sum']:.3e} from "
                            "the f64 sum of the same terms")
        k2o = time_ms(lambda: K.trace_fwd(rif, h, x0, v0, ds, nf, order), 3)
        k2u = time_ms(lambda: K.trace_fwd(rif, h, x0, v0, ds, nf), 3)
        k3o = time_ms(lambda: K.backtrace(rif, h, xt, vt, dx, dv, ds, nb, tol_snap, order), 3)
        k3u = time_ms(lambda: K.backtrace(rif, h, xt, vt, dx, dv, ds, nb, tol_snap), 3)
        row.update(k2_ms_ordered=k2o, k2_ms_unordered=k2u, k3_ms_ordered=k3o,
                   k3_ms_unordered=k3u,
                   order_ms=time_ms(lambda: O.ray_order(x0, v0, rif.shape, h), 5))
        ex, ex_failures = exact_check(
            rif, h, ds, x0, v0, lambda xt_, vt_: (2.0 * (xt_ - 0.5), torch.ones_like(vt_)),
            label.replace("float", "f"), TOL_F32_GRAD, times=True)
        failures += ex_failures
        row["exact"] = ex
        work = dict(res=res, path=path, ray_steps_fwd=fw["ray_steps"],
                    ray_steps=bw["ray_steps"], splats=bw["splats"],
                    flushes=bw["flushes"], issued=int(tally[1]),
                    block_adds=int(tally[2]), exact=ex)
    row["tol"] = tol
    print(f"stage[{label}, {x0.shape[0]} rays] K3 {path} path: rel_err "
          f"{err:.3e} (tol {tol:g}); plain version's run-to-run spread {spread:.3e}"
          + (f"; distance to the f64 sum of the same f32 terms: kernel "
             f"{row['kernel_vs_f64_sum']:.3e} (tol {TOL_F32_GRAD:g}), plain "
             f"{row['plain_vs_f64_sum']:.3e}"
             if dtype == torch.float32 else "")
          + f"; runs flushed {row['runs']} (plain flushes {row['flushes']}, splats "
          f"{row['splats']}), issued after the warp sums {row['issued']}: "
          f"{8 * row['issued']} atomic adds against {8 * row['splats']} a splat each "
          f"would issue; block-private adds {row['block_adds']}; K2 rays not bitwise "
          f"equal {differ}"
          + (f"; K2 {row['k2_ms_ordered']:.4f} ms ordered / "
             f"{row['k2_ms_unordered']:.4f} unordered, K3 {row['k3_ms_ordered']:.4f} "
             f"ordered / {row['k3_ms_unordered']:.4f} unordered, the order "
             f"{row['order_ms']:.4f}"
             if dtype == torch.float32 else ""), flush=True)
    if not (err <= tol and float(g_p.abs().max()) > 0):
        failures.append(f"K3 disagrees with its plain version at {label}")
    if any(differ.values()):
        failures.append(f"K2 is not bitwise equal at {label}: {differ}")
    if row["runs"] != row["flushes"]:
        failures.append(f"K3 flushed {row['runs']} runs at {label}, the "
                        f"plain version counts {row['flushes']}")
    if (path == "shared") != (row["block_adds"] > 0):
        failures.append(f"K3's block-private adds ({row['block_adds']}) do not fit "
                        f"the {path} path at {label}")
    return row, work


def stage_checks(params):
    """:func:`stage_check` at every stage resolution of the fuel trainer, with
    the run's own rays (same seed, same generator), on the ground truth
    resampled to the stage (``ds`` is the run's, fixed by the finest grid), in
    f64 and f32.  Returns the f32 work per stage, the rows of the report and a
    list of failures (raised at the end of the script)."""
    res_list, span = params["res_list"], params["vol_span"]
    ds = span / (res_list[-1] - 1) / params["step_res"]
    gt = voxel_scenes.fuel_injection_rif(params["fuel_val"], torch.float64, "cuda")
    work, rows, failures = [], [], []
    for dtype in (torch.float64, torch.float32):
        rays, _ = fuel_injection.gen_start_rays(
            params, torch.Generator(device="cuda").manual_seed(params["seed"]), dtype)
        x0, v0 = rays.x.contiguous(), rays.v.contiguous()
        for res in res_list:
            rif = G.upres_volume(gt, res).to(dtype).contiguous()
            row, w = stage_check(rif, span / (res - 1), ds, x0, v0, failures)
            rows.append(row)
            if w is not None:
                work.append(w)
    return work, rows, failures


def fuel_small_check():
    """The same trainer in f64 at a small size, on the card against the CPU.

    The card runs the kernels, the CPU the plain versions throughout: the
    whole slice, kernels in, against plain versions."""
    params = dict(fuel_params(), res_list=[3, 5, 9], nviews=2, nbins=16, optim_iters=3,
                  dtype="float64", grad_spotcheck=True, auto_exact=True)
    rays, _ = fuel_injection.gen_start_rays(params, torch.Generator().manual_seed(0),
                                            torch.float64)
    gtruth = voxel_scenes.fuel_injection_rif(params["fuel_val"], torch.float64, "cpu")
    K.reset_launches()
    m_gpu, m_cpu = MetricsLogger(), MetricsLogger()
    eta_gpu, hist_gpu, _ = fuel_injection.run_opt(params, None, gtruth, rays=rays, metrics=m_gpu)
    launches, paths = dict(K.LAUNCHES), kernel_paths()
    escalated = escalation_stage(m_gpu)
    steps, want, want_paths, _ = expected_launches(params, escalated, rays.x.shape[0], 1)
    if paths != want_paths:
        raise AssertionError(f"the small run must launch by path {want_paths}, counted {paths}")
    eta_cpu, hist_cpu, _ = fuel_injection.run_opt(params, None, gtruth, rays=rays, device="cpu",
                                                  metrics=m_cpu)
    if escalation_stage(m_cpu) != escalated:
        raise AssertionError(f"the card escalated at stage {escalated}, the CPU at "
                             f"{escalation_stage(m_cpu)}")
    if launches != want or dict(K.LAUNCHES) != want:
        raise AssertionError(f"the small run must launch {want} on the card and nothing on "
                             f"the CPU, counted {launches} then {dict(K.LAUNCHES)}")
    hist_err = max(abs(a - b) / abs(b) for a, b in zip(hist_gpu, hist_cpu))
    scale = float((eta_cpu - 1.0).abs().max())
    eta_err = float((eta_gpu.cpu() - eta_cpu).abs().max()) / scale
    print(f"fuel[f64 {params['res_list']}, {rays.x.shape[0]} rays, {steps} steps, escalated at "
          f"stage {escalated}] card against CPU: loss history rel_err {hist_err:.3e}, final "
          f"field err {eta_err:.3e} of its "
          f"largest deviation from 1 ({scale:.3e}) (tol {TOL_F64:g}); loss "
          f"{hist_cpu[0]:.6g} -> {hist_cpu[-1]:.6g}", flush=True)
    if len(hist_gpu) != steps or not eta_gpu.is_cuda or eta_cpu.is_cuda:
        raise AssertionError("the small runs did not run where they were asked to")
    if not (hist_err <= TOL_F64 and eta_err <= TOL_F64 and hist_cpu[-1] < hist_cpu[0]):
        raise AssertionError("the fuel trainer on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# the drivers of the image family: Luneburg, image, sdf, focal stack
# ---------------------------------------------------------------------------

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
# each path runs its shipped section, uncut, through runner.run, as a user does
DRIVERS = {
    "luneburg": ("params-luneburg.yaml", None),
    "image": ("params-image.yaml", "einstein-turing"),
    "sdf": ("params-sdf.yaml", None),
    "focalstack": ("params-focalstack.yaml", "lkfs10_3im_srciminfocus_cone1_dist2"),
}
# rays the plain versions count a stage's work on (for the bounds), drawn
# from the path's own source and scaled to the batch
WORK_RAYS = 1 << 15
# rays of the stage check at 129^3, drawn from the Luneburg path's source
BIG_STAGE_RAYS = 1 << 16


def driver_params(name):
    yaml_name, section = DRIVERS[name]
    return runner.cfg.load_params(os.path.join(CONFIGS, yaml_name), section)


def driver_draw(name, params, gen, samples=None, dtype=torch.float32):
    """One step's rays of the path ``name``, drawn from ``gen`` as its driver draws them."""
    samples = params["spp"] if samples is None else samples
    if name == "luneburg":
        return luneburg.gen_start_rays(params, gen, samples, dtype)[0]
    if name in ("image", "sdf"):
        nviews = len(params["images"]) if name == "image" else params.get("nviews", 1)
        return image.gen_start_rays(params, gen, samples, nviews, dtype)[0]
    return focalstack._gen_start_rays(gen, params["source_type"], params["nbins"], samples,
                                      params["vol_span"], params.get("angle_span", 360),
                                      params.get("source_angle", 1.0), dtype)[0]


def run_buckets(metrics, nrays):
    """The exit-step buckets of a driver run's adjoint steps, as the run logged
    ``make_trace``'s choice (``exit_buckets``): 1 where it took none or the
    batch of ``nrays`` does not divide."""
    ks = [int(row["exit_buckets"]) for row in metrics.history if "exit_buckets" in row]
    if len(ks) != 1:
        raise AssertionError(f"a driver run must log its exit-step buckets once, logged {ks}")
    return ks[0] if ks[0] > 1 and nrays % ks[0] == 0 else 1


def plain_work(rif, h, ds, x0, v0, exact):
    """The work of one pass over ``(x0, v0)`` as the plain versions count it:
    the forward and adjoint steppers', or the exact path's and the
    checkpoint rows its backward pass reads."""
    f, res = G.GridField(rif, h), max(rif.shape)
    fw, bw = {}, {}
    if not exact:
        xt, vt = E.trace(f, x0, v0, ds, E.max_steps_fwd(res, h, ds), stats=fw)
        E.backtrace(f, xt, vt, torch.ones_like(xt), torch.ones_like(vt), ds,
                    E.max_steps_bwd(res, h, ds), stats=bw)
        return dict(fwd=fw, bwd=bw, rows=0, n=x0.shape[0])
    xt, vt, esc, c, cap, ck = CK._forward_with_ckpts(f, x0, v0, ds, E.max_steps_fwd(res, h, ds),
                                                     SEG, stats=fw)
    bw["captured"] = cap
    CK.backtrace_plain(rif, x0, v0, esc, c, ck, torch.ones_like(xt), torch.ones_like(vt), h, ds,
                       SEG, stats=bw)
    live = torch.where(esc & ~cap, torch.zeros_like(c), c)  # escaped uncaptured: never inside
    return dict(fwd=fw, bwd=bw, rows=int(((live + SEG - 1) // SEG).sum()), n=x0.shape[0])


def pass_bounds(work, n, rif):
    """The bounds of the kernels of one pass over ``n`` rays on ``rif``, from
    ``work`` counted on ``work['n']`` of them and scaled to ``n``: K2 and K3,
    or K5 (the forward pass writing the checkpoint rows the backward pass
    reads) and K6."""
    item, grid = rif.element_size(), rif.numel() * rif.element_size()
    fw, bw = work["fwd"], work["bwd"]

    def sc(count):
        return count * n / work["n"]

    fwd_flops = sc(fw["ray_steps"]) * FLOPS_FWD_STEP + sc(fw["evals"]) * FLOPS_FWD_EVAL
    if not work["rows"]:
        return {"trace_fwd": set_bound(dict(bytes=4 * n * 3 * item + grid, flops=fwd_flops)),
                "backtrace": set_bound(dict(
                    bytes=4 * n * 3 * item + 2 * grid,
                    flops=(sc(bw["ray_steps"]) * FLOPS_BWD_STEP + sc(bw["evals"]) * FLOPS_BWD_EVAL
                           + sc(bw["splats"]) * FLOPS_BWD_SPLAT)))}
    rows_bytes = sc(work["rows"]) * 7 * item
    return {"trace_ckpt": set_bound(dict(bytes=12 * n * item + 5 * n + rows_bytes + grid,
                                         flops=fwd_flops)),
            "backtrace_exact": set_bound(dict(
                bytes=rows_bytes + 5 * n + 6 * n * item + 2 * grid,
                flops=(sc(bw["ray_steps"]) * FLOPS_EXACT_STEP + sc(bw["evals"]) * FLOPS_EXACT_EVAL
                       + sc(bw["splats"]) * FLOPS_BWD_SPLAT)))}


def median(values):
    values = sorted(values)
    return values[len(values) // 2]


def driver_path(name):
    """The driver ``name`` through ``runner.run`` on its shipped section, as a
    user runs it: the spot checks and the stage escalation on, with the
    escalation tolerance at its default.  The stage the escalation fired at
    is read from the run's metrics and every kernel is held to the launches
    the code implies for it, per stage and in all.  Per stage: step time on
    the host clock (each step ends with the loss read back), the kernels'
    times from the events around the launches, and their shares of the bounds
    (work counted by the plain versions on rays of the path's source through
    the run's final field resampled to the stage)."""
    params = driver_params(name)
    yaml_name, section = DRIVERS[name]
    res_list, iters, span = params["res_list"], params["optim_iters"], params["vol_span"]
    sample = driver_draw(name, params, torch.Generator(device="cuda").manual_seed(12345))
    nrays = sample.x.shape[0]
    # the focal stack renders its synthetic capture first when the lego-knight
    # captures are absent (they are not in the repo): one forward pass
    extra_fwd = 0
    if name == "focalstack":
        extra_fwd = int(any(not os.path.exists(p) and not os.path.exists(
            voxel_scenes.data_path(os.path.basename(p))) for p in params["focal_list"]))
    if "ANRT_EXACT_TOL" in os.environ or "ANRT_BUCKETED" in os.environ:
        raise AssertionError("ANRT_EXACT_TOL or ANRT_BUCKETED is set: the run would not be a "
                             "user's run")
    step_rows, events = [], []

    def stat(it, loss, secs):
        step_rows.append((it, loss, secs, len(events)))

    metrics = MetricsLogger()
    K.reset_launches()
    K.record_events(events)
    t0 = time.time()
    try:
        out = runner.run(os.path.join(CONFIGS, yaml_name), section, device="cuda", stat_fn=stat,
                         metrics=metrics)
        torch.cuda.synchronize()
    finally:
        K.record_events(None)
    seconds = time.time() - t0
    eta, hist = out[0], out[1]
    launches, paths = dict(K.LAUNCHES), kernel_paths()
    escalated = escalation_stage(metrics)
    nbuckets = run_buckets(metrics, nrays)
    steps, want, want_paths, want_stages = expected_launches(params, escalated, nrays, extra_fwd,
                                                             nbuckets)
    got_stages, after = stage_launches(events, step_rows, params)
    checks = {k: v for row in metrics.history for k, v in row.items()
              if k.startswith("grad_spotcheck")}
    chunks = len(CK._chunks(nrays, CK.exact_chunk_rays()))
    print(f"{name}[{yaml_name} {section or 'default'}] {nrays} rays a step "
          f"({int(sample.mask.sum())} live in the first draw), stages {res_list}, "
          f"optim_iters {iters}: {steps} Adam steps in {seconds:.2f} s; escalation to the "
          f"exact gradient fired at stage {escalated}"
          + (f" ({res_list[escalated]}^3)" if escalated is not None else "")
          + f"; the adjoint steps in {nbuckets} exit-step bucket(s); the exact path's batch "
          f"is {chunks} chunk(s) of at most {CK.exact_chunk_rays()} rays; launches "
          f"{launches}; by path {paths}", flush=True)
    if launches != want or paths != want_paths or got_stages != want_stages or after:
        raise AssertionError(f"{name} must launch {want}, by path {want_paths}, by stage "
                             f"{want_stages}, counted {launches}, {paths}, {got_stages} and "
                             f"{len(after)} after the last step")
    if len(hist) != steps or len(step_rows) != steps or not all(map(math.isfinite, hist)):
        raise AssertionError(f"{name}: steps lost or a loss not finite")
    res = res_list[-1]
    clamp_max = float(params["step_res"])
    if eta.shape != (res,) * 3 or eta.dtype != torch.float32 or not eta.is_cuda:
        raise AssertionError(f"{name}: the field is not a {res}^3 f32 tensor on the card")
    if not bool(torch.isfinite(eta).all()) or float(eta.min()) < 1.0 \
            or float(eta.max()) > clamp_max:
        raise AssertionError(f"{name}: the field leaves [1, clamp_max]")
    interior = torch.zeros_like(eta, dtype=torch.bool)
    interior[1:-1, 1:-1, 1:-1] = True
    shell_dev = float((eta[~interior] - 1.0).abs().max())
    moved = float((eta[interior] - 1.0).abs().max())
    if shell_dev > 1e-6 or not moved > 1e-6:
        raise AssertionError(f"{name}: boundary shell moved by {shell_dev} or interior "
                             f"stayed ({moved})")

    ds = span / (res - 1) / params["step_res"]
    first_exact = len(res_list) if escalated is None else escalated
    idx = torch.randperm(nrays, generator=torch.Generator(device="cuda").manual_seed(7),
                         device="cuda")[:WORK_RAYS]
    x_w, v_w = sample.x[idx].contiguous(), sample.v[idx].contiguous()
    per_stage, first = [], 0
    for s, r in enumerate(res_list):
        rows = step_rows[first:first + iters * (s + 1)]
        first += len(rows)
        exact = s >= first_exact
        names = (("trace_fwd",) * nbuckets + ("backtrace",) * nbuckets if not exact
                 else ("trace_ckpt", "backtrace_exact") if chunks == 1
                 else ("trace_ckpt",) + ("trace_ckpt", "backtrace_exact") * chunks)
        by_name, kern, sums = {}, [], {}
        for row in rows:
            own = events[row[3] - len(names):row[3]]  # the step's own launches
            if tuple(n_ for n_, _, _ in own) != names:
                raise AssertionError(f"{name}: a step's launches at stage {s} are not {names}")
            step_sum = {}
            for n_, a, b in own:
                t = a.elapsed_time(b)
                by_name.setdefault(n_, []).append(t)
                step_sum[n_] = step_sum.get(n_, 0.0) + t
            kern.append(sum(step_sum.values()))
            for n_, t in step_sum.items():
                sums.setdefault(n_, []).append(t)
        med = median([1e3 * row[2] for row in rows])
        h = span / (r - 1)
        rif = G.upres_volume(eta, r).contiguous()
        bounds = pass_bounds(plain_work(rif, h, ds, x_w, v_w, exact), nrays, rif)
        key = "grad_spotcheck" if s == 0 else f"grad_spotcheck_stage{s}"
        st = dict(res=r, steps=len(rows), gradient="exact" if exact else "adjoint",
                  step_ms_median=med, rays_per_s=nrays / (1e-3 * med),
                  kernel_ms_median=median(kern), host_ms=med - median(kern),
                  ms_per_launch={n_: median(t) for n_, t in by_name.items()},
                  ms_per_step={n_: median(t) for n_, t in sums.items()},
                  launches_per_step={n_: names.count(n_) for n_ in set(names)},
                  bound_ms={n_: b["bound_ms"] for n_, b in bounds.items()},
                  bound_by={n_: b["bound_by"] for n_, b in bounds.items()},
                  share_of_bound={n_: bounds[n_]["bound_ms"] / median(sums[n_]) for n_ in bounds},
                  spot_check_rel_l2=checks.get(key + "_rel_l2"),
                  ckpt_mb_per_chunk=(-(-E.max_steps_fwd(r, h, ds) // SEG) * 7
                                     * min(nrays, CK.exact_chunk_rays()) * 4 / 1e6
                                     if exact else None),
                  loss_last=rows[-1][1], launches=got_stages[s])
        per_stage.append(st)
        print(f"{name} stage {s} {r}^3 ({st['gradient']}"
              + (f", K3 {K.backtrace_path(r ** 3, torch.float32)}" if not exact else "")
              + f"): {len(rows)} steps, median {med:.3f} ms/step = {st['rays_per_s']:.4g} "
              f"rays/s; kernels {st['kernel_ms_median']:.3f} ms/step "
              f"({100 * st['kernel_ms_median'] / med:.1f} %), host and small kernels "
              f"{st['host_ms']:.3f} ms; ms per launch "
              + ", ".join(f"{n_} {t:.3f}" for n_, t in st["ms_per_launch"].items())
              + "; per step " + ", ".join(f"{n_} {t:.3f} = {100 * st['share_of_bound'][n_]:.1f} %"
                                         f" of its bound {st['bound_ms'][n_]:.4f} "
                                         f"({st['bound_by'][n_]})"
                                         for n_, t in st["ms_per_step"].items())
              + (f"; spot check rel-L2 {st['spot_check_rel_l2']:.3e}"
                 if st["spot_check_rel_l2"] is not None else "")
              + (f"; checkpoints {st['ckpt_mb_per_chunk']:.1f} MB a chunk" if exact else "")
              + f"; loss {st['loss_last']:.6g}", flush=True)
    print(f"{name}: loss {hist[0]:.6g} -> {hist[-1]:.6g} (mean of the first 10 "
          f"{sum(hist[:10]) / 10:.6g}, of the last 10 {sum(hist[-10:]) / 10:.6g}); field in "
          f"[{float(eta.min()):.6f}, {float(eta.max()):.6f}], shell deviation {shell_dev:.2e}",
          flush=True)
    return dict(name=name, seconds=seconds, steps=steps, nrays=nrays, launches=launches,
                paths=paths, escalated=escalated, nbuckets=nbuckets, per_stage=per_stage,
                spot_checks=checks, loss_first=hist[0], loss_last=hist[-1], eta=eta)


def splat_times(name, params, eta, reps=5):
    """The sensor splat of the path ``name`` at its shapes: ``generate_sensor``
    and its backward pass to the rays, CUDA events around each, on rays of
    the path's source traced through the final field; median ms of ``reps``,
    and the images a step renders."""
    span, nbins = params["vol_span"], params["nbins"]
    rays = driver_draw(name, params, torch.Generator(device="cuda").manual_seed(4321))
    res = eta.shape[0]
    h = span / (res - 1)
    with torch.no_grad():
        xm, vm = api.trace(eta, rays.x, rays.v, h, h / params["step_res"])
    planes = rays.planes
    p0, n0, t0 = planes[None, 0, 0], planes[None, 0, 1], planes[None, 0, 2]
    if name == "image":
        nimages = len(params["images"])
        view = slice(0, rays.x.shape[0] // nimages)
        xs, vs = sensors.trace_rays_to_plane((xm, vm), (planes[:, 0], planes[:, 1]))
        xs, vs, mask = xs[view], vs[view], rays.mask[view]

        def render(a, b):
            return sensors.generate_sensor((a, b), 1.0, (p0, n0), nbins, span, t0, mask=mask)
    else:
        nimages = len(params["sensor_dists"])
        src = torch.clamp(-runner.l2ball_sdf(nbins, span), min=0.0)
        d0 = params["sensor_dists"][0]
        e = sensors.get_sdf_vals_near((rays.x, rays.v), src, (p0 - (span + d0) * n0, n0), span, t0)
        xs, vs, mask = xm, vm, rays.mask

        def render(a, b):
            return sensors.generate_sensor((a, b), e, (p0 + d0 * n0, n0), nbins, span, t0,
                                           mask=mask)
    xa, va = xs.detach().requires_grad_(True), vs.detach().requires_grad_(True)
    w = torch.randn((nbins, nbins), generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    fwd, bwd = [], []
    for rep in range(reps + 1):
        torch.cuda._sleep(BUSY_CYCLES)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        img = render(xa, va)
        ev[1].record()
        torch.autograd.grad((img * w).sum(), (xa, va))
        ev[2].record()
        torch.cuda.synchronize()
        if rep:  # the first call is the warm-up
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[1].elapsed_time(ev[2]))
    if not (bool(torch.isfinite(img).all()) and float(img.sum()) > 0):
        raise AssertionError(f"{name}: the sensor image is empty or not finite")
    rec = dict(rays=xa.shape[0], fwd_ms=median(fwd), bwd_ms=median(bwd), images_per_step=nimages)
    print(f"{name} splat: generate_sensor of {rec['rays']} rays onto {nbins}^2 pixels "
          f"{rec['fwd_ms']:.3f} ms, its backward {rec['bwd_ms']:.3f} ms; {nimages} images a "
          f"step = {nimages * (rec['fwd_ms'] + rec['bwd_ms']):.3f} ms a step", flush=True)
    return rec


def big_stage_check(eta, failures):
    """:func:`stage_check` at 129^3 on the Luneburg run's final field with
    ``BIG_STAGE_RAYS`` of its source's rays: K2 and K5 bitwise, K3 and K6
    within ``TOL_F32_GRAD`` of the f64 sum of the same f32 terms, and K3's
    path there (global)."""
    params = driver_params("luneburg")
    rays = driver_draw("luneburg", params, torch.Generator(device="cuda").manual_seed(99))
    idx = torch.randperm(rays.x.shape[0], generator=torch.Generator(device="cuda").manual_seed(3),
                         device="cuda")[:BIG_STAGE_RAYS]
    res = eta.shape[0]
    h = params["vol_span"] / (res - 1)
    row, work = stage_check(eta.contiguous(), h, h / params["step_res"], rays.x[idx].contiguous(),
                            rays.v[idx].contiguous(), failures, label=f"luneburg f32 {res}^3")
    if row["path"] != "global":
        failures.append(f"K3 took its {row['path']} path at {res}^3, not the global one")
    return row


def driver_small_check(name):
    """The driver ``name`` in f64 at a small size, on the card against the CPU,
    with the same rays on both (drawn once on the CPU and handed to the
    driver through its ``sample_rays`` hook) and the same targets."""
    params = dict(driver_params(name), res_list=[3, 5, 9], nbins=8, spp=1, optim_iters=3,
                  record_iters=10 ** 9, dtype="float64")
    rays = driver_draw(name, params, torch.Generator().manual_seed(0), dtype=torch.float64)
    span, f64 = params["vol_span"], torch.float64
    if name == "image":
        params["disp_ims"] = runner._load_image_list(params["images"], 8, "cpu")
    elif name == "sdf":
        fspan = 2 * math.sin(0.5 * math.radians(params["far_sensor_span"]))
        params.update(sdf_disp=[runner.l2ball_sdf(8, span, dtype=f64, device="cpu")],
                      sdf_defl=[runner.l2ball_sdf(8, fspan, dtype=f64, device="cpu")],
                      disp_ims=[None], defl_ims=[None])
    elif name == "focalstack":
        src = torch.clamp(-runner.l2ball_sdf(8, span, dtype=f64, device="cpu"), min=0.0)
        params.update(src_angle=params["source_angle"], source_image=src)
        params["focal_stack"] = focalstack.make_synthetic_stack(
            voxel_scenes.gaussian_bump(9, span, dtype=f64, device="cpu"), params, device="cpu")
    run = {"luneburg": luneburg.run_opt, "image": image.multires_exp, "sdf": image.multires_exp,
           "focalstack": focalstack.multires_exp}[name]
    out = {}
    for device in ("cuda", "cpu"):
        metrics = MetricsLogger()
        K.reset_launches()
        eta, hist = run(params, None, device=device, metrics=metrics,
                        sample_rays=lambda gen, samples: rays)
        out[device] = (eta, hist, escalation_stage(metrics), dict(K.LAUNCHES), metrics)
    (eta_g, hist_g, esc_g, launches, _), (eta_c, hist_c, esc_c, cpu_launches, _) = \
        out["cuda"], out["cpu"]
    nbuckets = run_buckets(out["cuda"][4], rays.x.shape[0])
    steps, want, _, _ = expected_launches(params, esc_g, rays.x.shape[0], nbuckets=nbuckets)
    hist_err = max(abs(a - b) / abs(b) for a, b in zip(hist_g, hist_c))
    scale = float((eta_c - 1.0).abs().max())
    eta_err = float((eta_g.cpu() - eta_c).abs().max()) / scale
    print(f"{name}[f64 {params['res_list']}, {rays.x.shape[0]} rays, {steps} steps, escalated at "
          f"stage {esc_g}] card against CPU: loss history rel_err {hist_err:.3e}, final field err "
          f"{eta_err:.3e} of its largest deviation from 1 ({scale:.3e}) (tol {TOL_F64:g}); "
          f"{nbuckets} exit-step bucket(s); launches on the card {launches}", flush=True)
    if esc_g != esc_c or launches != want or any(cpu_launches.values()):
        raise AssertionError(f"{name}: the card escalated at {esc_g} and launched {launches} "
                             f"(want {want}), the CPU escalated at {esc_c} and launched "
                             f"{cpu_launches}")
    if len(hist_g) != steps or not eta_g.is_cuda or eta_c.is_cuda:
        raise AssertionError(f"{name}: the small runs did not run where they were asked to")
    if not (hist_err <= TOL_F64 and eta_err <= TOL_F64 and scale > 0):
        raise AssertionError(f"{name}: the driver on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# the GRIN-fiber driver: the cylinder field and the cable kernels K7-K10
# ---------------------------------------------------------------------------

FIBER_YAML = "params-fiber.yaml"
# the shipped section's size: 30 * (1 + ... + 7) Adam steps, 64^2 rays a pass
FIBER_STEPS, FIBER_RAYS = 840, 4096
# the f64 cable check: 17 bins, 512 of the fiber source's rays
CABLE_SMALL = (17, 512)
# Least arithmetic of the cable kernels, counted as above.  K7 and K9, per step
# of an active ray: the radial set-up x - R, z - R (2), r^2 (3), sqrt (1), r/h
# (1), floor and rm - i0 (2), 1 - w0 (1); the value and the radial derivative
# as a lerp sharing its difference (4); the gradient (rx/r) times xs on x and
# z (3); v += (ds*n)*grad on x and z (5); x += ds*v (6); |x - target|^2 (8);
# escaped's pl . v on x and z (3) (inbounds' r^2 is the next step's set-up).
FLOPS_CABLE_FWD_STEP = 39
# K8, per step of an active ray: x -= ds*v (6), the cap snap's y - length
# (1), the set-up (10), value and derivative (4), xhat (2) and the gradient
# (2), the Hessian's scale rx/r and its three entries (9), v update (5),
# escaped (3), dn = mu . grad on x and z (3), H mu (6), la on x and z (10:
# its y component does not move), mu += ds*la (6).
FLOPS_CABLE_BWD_STEP = 67
# per splat: dn*ds (1), g . xhat = (n*ds) * (mu . xhat) (5), / h (1), the two
# bins' terms (4), added to the ray's run (2)
FLOPS_CABLE_SPLAT = 13
# K10, per gated-on step: the replayed step (the forward's without the
# distance: 31), and on the replay's n and grad n at x_k: the Hessian (9),
# dn (3), H mu (6), la (10), mu (6); each splats.
FLOPS_CABLE_EXACT_STEP = 65


def fiber_params():
    return runner.cfg.load_params(os.path.join(CONFIGS, FIBER_YAML))


def cable_scene(res, n_rays, dtype, seed=0, both_passes=False):
    """The fiber path's rays at ``res`` bins: one draw of its source (``n_rays``
    of them at random, or all), normalised on entry as the driver does, with
    the hop pass's targets, on the ground-truth profile plus 1 % noise.  With
    ``both_passes`` the rays twice over, the near pass's targets first, as
    the driver traces a step."""
    params = fiber_params()
    radius, length = params["cable_radius"], params["cable_length"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rays = fiber.gen_start_rays(params, gen, dtype)
    x, v, planes = rays.x, rays.v, rays.planes
    if n_rays is not None:
        idx = torch.randperm(x.shape[0], generator=gen, device="cuda")[:n_rays]
        x, v, planes = x[idx], v[idx], planes[idx]
    prof = fiber.ground_truth(res, dtype, "cuda") + 0.01 * torch.rand(
        res, generator=gen, dtype=dtype, device="cuda")
    field = CylinderField(prof, radius, length)
    v = v / cyl_eval_grad(field, x)[0][:, None]
    hop = params.get("hop_distance", 3.14)  # the driver's default
    target = planes[:, 0] + hop * planes[:, 1]
    if both_passes:
        x, v = torch.cat([x, x]), torch.cat([v, v])
        target = torch.cat([planes[:, 0] + 0.0 * planes[:, 1], target])
    ds = radius / res / 2
    return dict(prof=prof, field=field, radius=radius, length=length, x=x.contiguous(),
                v=v.contiguous(), target=target.contiguous(), ds=ds,
                steps=api.cable_steps(length, ds))


def _host_ms(fn):
    """One call of a plain version on the card, host clock after a synchronise."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.time() - t0)


def cable_check(s, label, times=False):
    """K7-K10 against their plain versions on the scene ``s``: K7's closest
    approach and K9's (with its capture steps and every checkpoint row the
    backward pass reads) bitwise; K8 and K10 within ``TOL_F64`` of the plain
    versions in f64, and in f32 within ``TOL_F32_GRAD`` of the plain versions'
    f64 sum of the same f32 terms (``acc_dtype``), both over the largest entry.
    ``times``: the kernels' and plain versions' times and the bounds, from the
    plain versions' counts of this scene's work.  Returns the row and failures."""
    prof, field, radius, length = s["prof"], s["field"], s["radius"], s["length"]
    x, v, tg, ds, steps = s["x"], s["v"], s["target"], s["ds"], s["steps"]
    f64 = prof.dtype == torch.float64
    acc = None if f64 else torch.float64
    cap = G.snap_tol(prof.dtype) * radius
    fw, bw, efw, ebw = {}, {}, {}, {}
    (xt_p, vt_p, d2_p), plain7 = _host_ms(
        lambda: E.trace_cable(field, x, v, tg, ds, steps, stats=fw))
    xt_k, vt_k, d2_k = K.trace_cable(prof, radius, length, x, v, tg, ds, steps)
    dx, dv = 2.0 * (xt_p - tg), torch.ones_like(vt_p)
    g_p, plain8 = _host_ms(lambda: E.backtrace_cable(field, xt_p, vt_p, dx, dv, ds, steps,
                                                     stats=bw, acc_dtype=acc))
    g_k = K.backtrace_cable(prof, radius, length, xt_p, vt_p, dx, dv, ds, steps, cap)
    (xt_e, vt_e, d2_e, c_p, ck_p), plain9 = _host_ms(
        lambda: CK._fwd_ckpts_cable(field, x, v, tg, ds, steps, SEG, stats=efw))
    xt_9, vt_9, d2_9, c_9, ck_9 = K.trace_cable_ckpt(prof, radius, length, x, v, tg, ds, steps,
                                                     SEG)
    g_ep, plain10 = _host_ms(lambda: CK._bwd_segments_cable(field, ck_p, c_p, dx, dv, ds, SEG,
                                                            acc_dtype=acc, stats=ebw))
    g_10 = K.backtrace_cable_exact(prof, radius, length, ck_9, c_9, dx, dv, ds, SEG)
    torch.cuda.synchronize()
    need = (torch.arange(ck_p.shape[0], device="cuda")[:, None] * SEG) < c_p[None, :]
    bitwise = dict(
        k7=bool(torch.equal(xt_k, xt_p) and torch.equal(vt_k, vt_p) and torch.equal(d2_k, d2_p)),
        k9=bool(torch.equal(xt_9, xt_p) and torch.equal(vt_9, vt_p) and torch.equal(d2_9, d2_p)),
        k9_capture_steps=bool(torch.equal(c_9, c_p)),
        k9_checkpoint_rows=bool(torch.equal(ck_9.transpose(1, 2)[need],
                                            ck_p.transpose(1, 2)[need])),
        exact_forward_is_adjoints=bool(torch.equal(xt_e, xt_p) and torch.equal(d2_e, d2_p)))
    errs = {}
    for name, got, want in (("trace_cable", (xt_k, vt_k, d2_k), (xt_p, vt_p, d2_p)),
                            ("trace_cable_ckpt", (xt_9, vt_9, d2_9), (xt_p, vt_p, d2_p))):
        scale = max(float(b.abs().max()) for b in want)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        errs[name] = dict(abs_err=err, rel_err=err / max(scale, 1e-300), max_abs_g=scale)
    for name, got, want in (("backtrace_cable", g_k, g_p), ("backtrace_cable_exact", g_10, g_ep)):
        scale = float(want.abs().max())
        err = float((got - want.to(got.dtype)).abs().max())
        errs[name] = dict(abs_err=err, rel_err=err / max(scale, 1e-300), max_abs_g=scale)
    tol = TOL_F64 if f64 else TOL_F32_GRAD
    n, res, item = x.shape[0], prof.shape[0], prof.element_size()
    rows = int(need.sum())
    row = dict(label=label, rays=n, res=res, steps=steps, bitwise=bitwise, errs=errs, tol=tol,
               work=dict(k7_ray_steps=fw["ray_steps"], k8_ray_steps=bw["ray_steps"],
                         k8_splats=bw["splats"], k9_ray_steps=efw["ray_steps"],
                         k10_gated_steps=ebw["ray_steps"], checkpoint_rows_read=rows,
                         max_c=int(c_p.max()), checkpoint_mb=ck_9.numel() * item / 1e6))
    if times:
        # what this scene's data needs: each input read once, each output (and
        # each checkpoint row the backward pass reads) written once; the
        # ray-steps and splats the plain versions counted
        rec = {
            "trace_cable": dict(bytes=16 * n * item + res * item,
                                flops=fw["ray_steps"] * FLOPS_CABLE_FWD_STEP),
            "backtrace_cable": dict(bytes=12 * n * item + res * item + res * 8,
                                    flops=bw["ray_steps"] * FLOPS_CABLE_BWD_STEP
                                    + bw["splats"] * FLOPS_CABLE_SPLAT),
            "trace_cable_ckpt": dict(bytes=16 * n * item + 4 * n + rows * 7 * item + res * item,
                                     flops=efw["ray_steps"] * FLOPS_CABLE_FWD_STEP),
            "backtrace_cable_exact": dict(
                bytes=rows * 7 * item + 4 * n + 6 * n * item + res * item + res * 8,
                flops=ebw["ray_steps"] * (FLOPS_CABLE_EXACT_STEP + FLOPS_CABLE_SPLAT)),
        }
        calls = {
            "trace_cable": lambda: K.trace_cable(prof, radius, length, x, v, tg, ds, steps),
            "backtrace_cable": lambda: K.backtrace_cable(prof, radius, length, xt_p, vt_p, dx, dv,
                                                         ds, steps, cap),
            "trace_cable_ckpt": lambda: K.trace_cable_ckpt(prof, radius, length, x, v, tg, ds,
                                                           steps, SEG),
            "backtrace_cable_exact": lambda: K.backtrace_cable_exact(prof, radius, length, ck_9,
                                                                     c_9, dx, dv, ds, SEG),
        }
        for name, plain in zip(calls, (plain7, plain8, plain9, plain10)):
            set_bound(rec[name])
            rec[name].update(ms=time_ms(calls[name], 5), plain_ms=plain, library_ms=None)
            rec[name]["share_of_bound"] = rec[name]["bound_ms"] / rec[name]["ms"]
        row["times"] = rec
    print(f"cable[{label}, {n} rays, {res} bins, {steps} steps] bitwise equal {bitwise}; "
          + "; ".join(f"{k} rel_err {e['rel_err']:.3e} (max |g| {e['max_abs_g']:.4g})"
                      for k, e in errs.items())
          + f" against the plain version{'' if f64 else ' summed in f64 from the same f32 terms'}"
          f" (tol {tol:g}); work {json.dumps(row['work'])}"
          + ("; " + ", ".join(f"{k} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} {r['bound_by']}, "
                               f"{100 * r['share_of_bound']:.2f} %; plain {r['plain_ms']:.0f} ms)"
                               for k, r in row.get("times", {}).items()) if times else ""),
          flush=True)
    failures = []
    if not all(bitwise.values()):
        failures.append(f"K7 or K9 is not bitwise equal to its plain version at {label}: "
                        f"{bitwise}")
    for name, e in errs.items():
        if not (e["rel_err"] <= tol and e["max_abs_g"] > 0):
            failures.append(f"{name} disagrees with its plain version at {label}: "
                            f"{e['rel_err']:.3e}")
    return row, failures


# K10's segments beside its replay buffer of K.CABLE_REPLAY steps: shorter, and
# longer (replayed in two stretches, the later first)
CABLE_SEGS = (7, 48)


def cable_seg_check(s, label):
    """K9 and K10 against their plain versions on the scene ``s`` at each
    ``seg`` of ``CABLE_SEGS``, held as ``cable_check`` holds them at ``SEG``:
    K9's closest approach, capture steps and checkpoint rows read bitwise, K10
    within ``TOL_F64`` (f64) or ``TOL_F32_GRAD`` of the f64 sum of the same
    terms (f32).  Returns the failures."""
    prof, field, radius, length = s["prof"], s["field"], s["radius"], s["length"]
    x, v, tg, ds, steps = s["x"], s["v"], s["target"], s["ds"], s["steps"]
    f64 = prof.dtype == torch.float64
    tol = TOL_F64 if f64 else TOL_F32_GRAD
    failures = []
    for seg in CABLE_SEGS:
        xt_p, vt_p, d2_p, c_p, ck_p = CK._fwd_ckpts_cable(field, x, v, tg, ds, steps, seg)
        xt_k, vt_k, d2_k, c_k, ck_k = K.trace_cable_ckpt(prof, radius, length, x, v, tg, ds,
                                                         steps, seg)
        need = (torch.arange(ck_p.shape[0], device="cuda")[:, None] * seg) < c_p[None, :]
        bitwise = bool(torch.equal(xt_k, xt_p) and torch.equal(vt_k, vt_p)
                       and torch.equal(d2_k, d2_p) and torch.equal(c_k, c_p)
                       and torch.equal(ck_k.transpose(1, 2)[need], ck_p.transpose(1, 2)[need]))
        dx, dv = 2.0 * (xt_p - tg), torch.ones_like(vt_p)
        want = CK._bwd_segments_cable(field, ck_p, c_p, dx, dv, ds, seg,
                                      acc_dtype=None if f64 else torch.float64)
        K.reset_launches()
        got = K.backtrace_cable_exact(prof, radius, length, ck_k, c_k, dx, dv, ds, seg)
        paths = dict(K.BACKTRACE_CABLE_EXACT_PATHS)
        scale = float(want.abs().max())
        err = float((got - want.to(got.dtype)).abs().max()) / max(scale, 1e-300)
        print(f"cable[{label}, seg {seg}] K9 bitwise equal {bitwise} (rows read {int(need.sum())}"
              f"); K10 paths {paths}: rel_err {err:.3e} (max |g| {scale:.4g}, tol {tol:g})",
              flush=True)
        if not (bitwise and err <= tol and scale > 0):
            failures.append(f"K9 or K10 at seg {seg}, {label}: bitwise {bitwise}, K10 rel_err "
                            f"{err:.3e}")
    return failures


def cable_api_check():
    """``api.trace_cable`` (K7, K8) against ``trace_cable_exact`` (K9, K10) in
    f64 on the card, whole and chunked (``ANRT_EXACT_CHUNK``), and against
    ``api.trace_cable`` on the CPU (the plain versions); a loss with a term in
    ``dist2``, whose cotangent every rule drops."""
    s = cable_scene(*CABLE_SMALL, torch.float64, seed=5)
    args = (s["radius"], s["length"], s["x"], s["v"], s["target"], s["ds"])

    def grad(fn, device="cuda"):
        p = s["prof"].to(device).clone().requires_grad_(True)
        xt, vt, d2 = fn(p, *(a.to(device) if torch.is_tensor(a) else a for a in args))
        ((xt ** 2 + xt * vt).sum() + d2.sum()).backward()
        return xt.detach().cpu(), p.grad.cpu()

    K.reset_launches()
    xt_a, g_a = grad(api.trace_cable)
    xt_e, g_e = grad(CK.trace_cable_exact)
    with exact_chunk(100):  # 6 chunks, the last one short
        xt_c, g_c = grad(CK.trace_cable_exact)
    launches = {k: K.LAUNCHES[k] for k in CABLE_KERNELS}
    xt_cpu, g_cpu = grad(api.trace_cable, "cpu")
    e_ex, e_chunk, e_cpu = rel_err(g_a, g_e)[0], rel_err(g_c, g_e)[0], rel_err(g_a, g_cpu)[0]
    print(f"cable[f64 {CABLE_SMALL[0]} bins x {CABLE_SMALL[1]}, api] trace_cable against "
          f"trace_cable_exact: gradient rel_err {e_ex:.3e}; exact chunked by 100 against whole "
          f"{e_chunk:.3e}; the card against the CPU {e_cpu:.3e} (tol {TOL_F64:g}); launches "
          f"{launches}", flush=True)
    want = {"trace_cable": 1, "backtrace_cable": 1, "trace_cable_ckpt": 1 + 1 + 6,
            "backtrace_cable_exact": 1 + 6}
    if launches != want:
        raise AssertionError(f"the cable API must launch {want}, counted {launches}")
    if not (torch.equal(xt_a, xt_e) and torch.equal(xt_a, xt_c)):
        raise AssertionError("trace_cable_exact's closest approach differs from trace_cable's")
    if not (e_ex <= TOL_F64 and e_chunk <= TOL_F64 and e_cpu <= TOL_F64
            and float(g_e.abs().max()) > 0):
        raise AssertionError("the cable gradients on the card disagree")


# K8's block path: a profile too large for a column a lane (wrappers.
# backtrace_cable_path), 512 of the fiber source's rays, the steps cut to 400
# on both sides so that the plain version stays quick
CABLE_WIDE, CABLE_WIDE_STEPS = 1025, 400
# and the largest profile K8 and K10 take (9,685 bins in f32, 5,811 in f64),
# with a fiber step's rays nine times over: 73,728 rays, more groups of 32
# than K10's block path has blocks, so that its blocks take two groups each
CABLE_WIDEST_COPIES = 9


def cable_largest_res(dtype):
    """The most bins K8 and K10 take: one gradient a block beside the table."""
    return K.SHARED_BYTES_MAX // K.cable_shared_bytes(1, dtype, 1)


def cable_block_path_check():
    """K8 and K10 on their block paths (one gradient a block, runs; K10's
    buffers in device memory) against the plain versions at ``CABLE_WIDE``
    bins on 512 rays and at the largest profile on 73,728: f64 within
    ``TOL_F64``, f32 within ``TOL_F32_GRAD`` of the f64 sum of the same
    terms; the path each launch took is asserted.  Returns the failures."""
    failures = []
    for dtype, res in ((torch.float64, CABLE_WIDE), (torch.float32, CABLE_WIDE),
                       (torch.float64, None), (torch.float32, None)):
        if res is None:
            res = cable_largest_res(dtype)
            s = cable_scene(res, None, dtype, seed=9, both_passes=True)
            for k in ("x", "v", "target"):
                s[k] = s[k].repeat(CABLE_WIDEST_COPIES, 1).contiguous()
            if s["x"].shape[0] <= 32 * K.CABLE_EXACT_BLOCK_GRID:
                raise AssertionError("the widest block-path check must give K10's blocks more "
                                     "than one group of rays")
        else:
            s = cable_scene(res, 512, dtype, seed=9)
        prof, field, radius, length, ds = s["prof"], s["field"], s["radius"], s["length"], s["ds"]
        x, v, tg = s["x"], s["v"], s["target"]
        n = x.shape[0]
        xt, vt, _, c, ck = CK._fwd_ckpts_cable(field, x, v, tg, ds, CABLE_WIDE_STEPS, SEG)
        dx, dv = 2.0 * (xt - tg), torch.ones_like(vt)
        want8 = E.backtrace_cable(field, xt, vt, dx, dv, ds, CABLE_WIDE_STEPS,
                                  acc_dtype=torch.float64)
        want10 = CK._bwd_segments_cable(field, ck, c, dx, dv, ds, SEG, acc_dtype=torch.float64)
        K.reset_launches()
        got8 = K.backtrace_cable(prof, radius, length, xt.contiguous(), vt.contiguous(),
                                 dx.contiguous(), dv, ds, CABLE_WIDE_STEPS,
                                 G.snap_tol(dtype) * radius)
        c_k, ck_k = K.trace_cable_ckpt(prof, radius, length, x, v, tg, ds, CABLE_WIDE_STEPS,
                                       SEG)[3:]
        got10 = K.backtrace_cable_exact(prof, radius, length, ck_k, c_k, dx.contiguous(), dv, ds,
                                        SEG)
        paths = {"K8": dict(K.BACKTRACE_CABLE_PATHS), "K10": dict(K.BACKTRACE_CABLE_EXACT_PATHS)}
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32_GRAD
        for name, got, want in (("K8", got8, want8), ("K10", got10, want10)):
            err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)
            print(f"cable[{dtype} {res} bins x {n}, {CABLE_WIDE_STEPS} steps] {name} "
                  f"paths {paths[name]}: rel_err {err:.3e} against the plain version's f64 sum "
                  f"(tol {tol:g})", flush=True)
            if paths[name] != {"columns": 0, "block": 1} or not (
                    err <= tol and float(want.abs().max()) > 0):
                failures.append(f"{name} on its block path at {res} bins x {n} {dtype}: paths "
                                f"{paths[name]}, rel_err {err:.3e}")
    return failures


CABLE_KERNELS = ("trace_cable", "backtrace_cable", "trace_cable_ckpt", "backtrace_cable_exact")


def expected_fiber_launches(params, escalated, nrays):
    """The launches a fiber run of ``params`` implies when its escalation fired
    at stage ``escalated`` (None: never), with ``nrays`` rays a step.

    Each step traces its two passes (the near and the hop focus) as one batch
    of ``2 * nrays`` rays: a forward and a backward launch of the stage's
    gradient, K7 and K8 before the escalation, K9 and K10 from it on (above
    ``ANRT_EXACT_CHUNK`` a K9 for the forward pass and a K9 and a K10 a
    chunk).  The start-up spot check (the
    adjoint against the tape) is one K7 and one K8, the tape launching none;
    each per-stage check (every stage after the first, up to the one that
    escalates) one K7, K8, K9 and K10.  Returns the steps, the launches in
    all and the launches of each stage."""
    res_list, iters = params["res_list"], params["optim_iters"]
    stages = len(res_list)
    first_exact = stages if escalated is None else escalated
    last_check = stages - 1 if escalated is None else escalated
    chunks = len(CK._chunks(2 * nrays, CK.exact_chunk_rays()))
    total = {name: 0 for name in build.KERNELS}
    per_stage = []
    for s in range(stages):
        n = iters * (s + 1)
        adjoint, exact = (0, n) if s >= first_exact else (n, 0)
        check = int(params.get("auto_exact", True) and 1 <= s <= last_check)
        start = int(s == 0 and params.get("grad_spotcheck", True))
        k = {name: 0 for name in build.KERNELS}
        k["trace_cable"] = adjoint + check + start
        k["backtrace_cable"] = adjoint + check + start
        k["trace_cable_ckpt"] = exact * (chunks + (chunks > 1)) + check
        k["backtrace_cable_exact"] = exact * chunks + check
        per_stage.append(k)
        for name in total:
            total[name] += k[name]
    return iters * stages * (stages + 1) // 2, total, per_stage


# a fiber step's launches: both passes as one batch, one forward and one backward
FIBER_STEP_LAUNCHES = 2


def fiber_stage_work(eta, params, rays, exact, res):
    """The work of one step at ``res`` bins on the run's final profile
    resampled there, as the plain versions count it on one draw of the path's
    rays (both passes, one launch of twice the rays): K7 and K8's ray-steps
    and splats, or K9's ray-steps and K10's gated-on steps and the checkpoint
    rows read."""
    radius, length = params["cable_radius"], params["cable_length"]
    prof = cyl.upres_profile(eta, res).contiguous()
    field = CylinderField(prof, radius, length)
    ds = radius / res / 2
    steps = api.cable_steps(length, ds)
    v = (rays.v / cyl_eval_grad(field, rays.x)[0][:, None]).contiguous()
    work = dict(k7_ray_steps=0, k8_ray_steps=0, k8_splats=0, k9_ray_steps=0,
                k10_gated_steps=0, rows=0)
    for hop in (0.0, params.get("hop_distance", 3.14)):
        tg = (rays.planes[:, 0] + hop * rays.planes[:, 1]).contiguous()
        fw, bw = {}, {}
        if not exact:
            xt, vt, _ = E.trace_cable(field, rays.x, v, tg, ds, steps, stats=fw)
            E.backtrace_cable(field, xt, vt, torch.ones_like(xt), torch.ones_like(vt), ds, steps,
                              stats=bw)
            work["k7_ray_steps"] += fw["ray_steps"]
            work["k8_ray_steps"] += bw["ray_steps"]
            work["k8_splats"] += bw["splats"]
        else:
            c = CK._fwd_ckpts_cable(field, rays.x, v, tg, ds, steps, SEG, store_ckpts=False,
                                    stats=fw)[3]
            work["k9_ray_steps"] += fw["ray_steps"]
            work["k10_gated_steps"] += int(c.sum())
            work["rows"] += int(((c + SEG - 1) // SEG).sum())
    n, item = 2 * rays.x.shape[0], prof.element_size()
    if not exact:
        return {"trace_cable": set_bound(dict(bytes=16 * n * item + res * item,
                                              flops=work["k7_ray_steps"] * FLOPS_CABLE_FWD_STEP)),
                "backtrace_cable": set_bound(dict(
                    bytes=12 * n * item + res * item + res * 8,
                    flops=work["k8_ray_steps"] * FLOPS_CABLE_BWD_STEP
                    + work["k8_splats"] * FLOPS_CABLE_SPLAT))}, work
    rows_bytes = work["rows"] * 7 * item
    return {"trace_cable_ckpt": set_bound(dict(
                bytes=16 * n * item + 4 * n + res * item + rows_bytes,
                flops=work["k9_ray_steps"] * FLOPS_CABLE_FWD_STEP)),
            "backtrace_cable_exact": set_bound(dict(
                bytes=rows_bytes + 4 * n + 6 * n * item + res * item + res * 8,
                flops=work["k10_gated_steps"] * (FLOPS_CABLE_EXACT_STEP + FLOPS_CABLE_SPLAT)))}, work


def fiber_path(gradient=None):
    """The fiber driver through ``runner.run`` on ``params-fiber.yaml``
    ``default`` at its shipped size and depth (840 steps, 3 -> 129 bins,
    4,096 rays a pass, both passes one batch), as a user runs it: the
    start-up spot check and the stage escalation on, ``ANRT_EXACT_TOL`` at
    its default.  ``gradient="exact"`` sets the driver's own exact mode in
    the params (phase h2): every step is then one K9 and one K10 and no stage
    check runs, the launches of an escalation at stage 0.  Every cable
    kernel is held to the launches the code implies for the stage the
    escalation fired at, per stage and in all, and no other kernel launches.
    Per stage: step time on the host clock (each step ends with the loss read
    back), the kernels' times from the events around the launches, the host's
    share, and the kernels' shares of their bounds (work counted by the plain
    versions on the final profile resampled to the stage)."""
    overrides = {} if gradient is None else {"gradient": gradient}
    params = dict(fiber_params(), **overrides)
    label = f"{FIBER_YAML} default" + ("" if gradient is None else f", gradient {gradient}")
    res_list, iters = params["res_list"], params["optim_iters"]
    gen_rays = fiber.gen_start_rays(params, torch.Generator(device="cuda").manual_seed(12345))
    nrays = gen_rays.x.shape[0]
    if "ANRT_EXACT_TOL" in os.environ:
        raise AssertionError("ANRT_EXACT_TOL is set: the run would not be a user's run")
    step_rows, events = [], []

    def stat(it, loss, secs):
        step_rows.append((it, loss, secs, len(events)))

    metrics = MetricsLogger()
    K.reset_launches()
    K.record_events(events)
    t0 = time.time()
    try:
        eta, hist = runner.run(os.path.join(CONFIGS, FIBER_YAML), None, overrides=overrides,
                               device="cuda", stat_fn=stat, metrics=metrics)
        torch.cuda.synchronize()
    finally:
        K.record_events(None)
    seconds = time.time() - t0
    launches, k8_paths = dict(K.LAUNCHES), dict(K.BACKTRACE_CABLE_PATHS)
    k10_paths = dict(K.BACKTRACE_CABLE_EXACT_PATHS)
    escalated = escalation_stage(metrics)
    if gradient == "exact":
        if escalated is not None:
            raise AssertionError(f"the exact fiber run escalated at stage {escalated}")
        escalated = 0  # exact from the first step
    steps, want, want_stages = expected_fiber_launches(params, escalated, nrays)
    got_stages, after = stage_launches(events, step_rows, params)
    checks = {k: v for row in metrics.history for k, v in row.items()
              if k.startswith("grad_spotcheck")}
    print(f"fiber[{label}] {nrays} rays a pass ({int(gen_rays.mask.sum())} live "
          f"in one draw), two passes a step as one batch, stages {res_list}, optim_iters "
          f"{iters}: {steps} "
          f"Adam steps in {seconds:.2f} s; spot checks {json.dumps(checks)}; "
          + ("the exact gradient from the first step" if gradient == "exact" else
             f"escalation to the exact gradient fired at stage {escalated}"
             + (f" ({res_list[escalated]} bins)" if escalated is not None else ""))
          + f"; launches {launches}, K8 by path {k8_paths}, K10 by path {k10_paths}",
          flush=True)
    if launches != want or got_stages != want_stages or after:
        raise AssertionError(f"the fiber run must launch {want}, by stage {want_stages}, "
                             f"counted {launches}, {got_stages} and {len(after)} after the "
                             "last step")
    if k8_paths != {"columns": launches["backtrace_cable"], "block": 0} or \
            k10_paths != {"columns": launches["backtrace_cable_exact"], "block": 0}:
        raise AssertionError(f"K8 and K10 must take their column paths at every stage, took "
                             f"{k8_paths}, {k10_paths}")
    if nrays != FIBER_RAYS or len(hist) != steps or len(step_rows) != steps \
            or steps != FIBER_STEPS:
        raise AssertionError("the fiber run is not at its shipped size or lost steps")
    if not all(map(math.isfinite, hist)):
        raise AssertionError("a loss of the fiber run is not finite")
    res = res_list[-1]
    if eta.shape != (res,) or eta.dtype != torch.float32 or not eta.is_cuda:
        raise AssertionError(f"the profile is not a ({res},) f32 tensor on the card")
    if not bool(torch.isfinite(eta).all()) or float(eta.min()) < 1.0 or float(eta[-1]) != 1.0:
        raise AssertionError("the profile went below 1 or its boundary bin moved")
    gt = fiber.ground_truth(res, torch.float32, "cuda")
    l2_gt = float(torch.linalg.norm(eta - gt))
    l2_start = float(torch.linalg.norm(torch.ones_like(gt) - gt))

    first_exact = len(res_list) if escalated is None else escalated
    per_stage, first, prev_end = [], 0, 0
    card = smi_line()
    for s, r in enumerate(res_list):
        rows = step_rows[first:first + iters * (s + 1)]
        first += len(rows)
        exact = s >= first_exact
        names = ("trace_cable_ckpt", "backtrace_cable_exact") if exact else ("trace_cable",
                                                                           "backtrace_cable")
        # the spot check's launches before the stage's first step (512 rays)
        check_ms = {n_: a.elapsed_time(b)
                    for n_, a, b in events[prev_end:rows[0][3] - FIBER_STEP_LAUNCHES]}
        prev_end = rows[-1][3]
        by_name, kern, sums = {}, [], {}
        for row in rows:
            own = events[row[3] - FIBER_STEP_LAUNCHES:row[3]]  # the step's own launches
            if sorted(n_ for n_, _, _ in own) != sorted(names):
                raise AssertionError(f"fiber: a step's launches at stage {s} are not one of "
                                     f"each of {names}")
            step_sum = {}
            for n_, a, b in own:
                t = a.elapsed_time(b)
                by_name.setdefault(n_, []).append(t)
                step_sum[n_] = step_sum.get(n_, 0.0) + t
            kern.append(sum(step_sum.values()))
            for n_, t in step_sum.items():
                sums.setdefault(n_, []).append(t)
        med = median([1e3 * row[2] for row in rows])
        bounds, work = fiber_stage_work(eta, params, gen_rays, exact, r)
        key = "grad_spotcheck" if s == 0 else f"grad_spotcheck_stage{s}_rel_l2"
        st = dict(res=r, steps=len(rows), gradient="exact" if exact else "adjoint",
                  cable_steps=api.cable_steps(params["cable_length"], params["cable_radius"] / r
                                              / 2),
                  step_ms_median=med, rays_per_s=2 * nrays / (1e-3 * med),
                  kernel_ms_median=median(kern), host_ms=med - median(kern),
                  host_share=(med - median(kern)) / med,
                  ms_per_launch={n_: median(t) for n_, t in by_name.items()},
                  ms_per_step={n_: median(t) for n_, t in sums.items()},
                  bound_ms={n_: b["bound_ms"] for n_, b in bounds.items()},
                  bound_by={n_: b["bound_by"] for n_, b in bounds.items()},
                  share_of_bound={n_: bounds[n_]["bound_ms"] / median(sums[n_]) for n_ in bounds},
                  work=work, spot_check=checks.get(key), check_ms_per_launch=check_ms,
                  loss_last=rows[-1][1],
                  launches=got_stages[s])
        per_stage.append(st)
        print(f"fiber[{label}] stage {s} {r} bins ({st['gradient']}, {st['cable_steps']} steps "
              f"a ray at most): {len(rows)} steps, median {med:.3f} ms/step = "
              f"{st['rays_per_s']:.4g} rays/s; kernels {st['kernel_ms_median']:.3f} ms/step "
              f"({100 * st['kernel_ms_median'] / med:.1f} %), host and small kernels "
              f"{st['host_ms']:.3f} ms; ms per launch "
              + ", ".join(f"{n_} {t:.3f}" for n_, t in st["ms_per_launch"].items())
              + "; per step " + ", ".join(f"{n_} {t:.3f} = {100 * st['share_of_bound'][n_]:.2f} %"
                                         f" of its bound {st['bound_ms'][n_]:.5f} "
                                         f"({st['bound_by'][n_]})"
                                         for n_, t in st["ms_per_step"].items())
              + f"; work {json.dumps(work)}"
              + (f"; spot check {st['spot_check']:.3e}" if st["spot_check"] is not None else "")
              + ("; its launches (512 rays) " + ", ".join(f"{n_} {t:.3f} ms"
                                                          for n_, t in check_ms.items())
                 if check_ms else "")
              + f"; loss {st['loss_last']:.6g}; {card}", flush=True)
    print(f"fiber[{label}]: loss {hist[0]:.6g} -> {hist[-1]:.6g} (mean of the first 10 "
          f"{sum(hist[:10]) / 10:.6g}, of the last 10 {sum(hist[-10:]) / 10:.6g}); profile in "
          f"[{float(eta.min()):.6f}, {float(eta.max()):.6f}]; L2 distance to ground_truth({res}) "
          f"{l2_gt:.6f} (the flat start's {l2_start:.6f})", flush=True)
    return dict(gradient=gradient or "adjoint", seconds=seconds, steps=steps, nrays=nrays,
                launches=launches, k8_paths=k8_paths, k10_paths=k10_paths, card=card,
                escalated=escalated, per_stage=per_stage, spot_checks=checks,
                loss_first=hist[0], loss_last=hist[-1], l2_to_ground_truth=l2_gt,
                l2_start_to_ground_truth=l2_start)


def fiber_small_check(gradient=None):
    """The fiber driver in f64 at a small size, on the card against the CPU,
    with the same rays on both (drawn once on the CPU, handed to the driver
    through its ``sample_rays`` hook): loss history and profile within
    ``TOL_F64``, the card's launches as the code implies, the CPU's none.
    ``gradient`` as for :func:`fiber_path`."""
    params = dict(fiber_params(), res_list=[3, 5, 9], nbins=16, optim_iters=2,
                  record_iters=10 ** 9, dtype="float64",
                  **({} if gradient is None else {"gradient": gradient}))
    rays = fiber.gen_start_rays(params, torch.Generator().manual_seed(0), torch.float64)
    out = {}
    for device in ("cuda", "cpu"):
        metrics = MetricsLogger()
        K.reset_launches()
        prof, hist = fiber.multires_exp(params, None, device=device, metrics=metrics,
                                        sample_rays=lambda gen, samples: rays)
        out[device] = (prof, hist, escalation_stage(metrics), dict(K.LAUNCHES))
    (p_g, hist_g, esc_g, launches), (p_c, hist_c, esc_c, cpu_launches) = out["cuda"], out["cpu"]
    exact_from = 0 if gradient == "exact" and esc_g is None else esc_g
    steps, want, _ = expected_fiber_launches(params, exact_from, rays.x.shape[0])
    hist_err = max(abs(a - b) / abs(b) for a, b in zip(hist_g, hist_c))
    scale = float((p_c - 1.0).abs().max())
    p_err = float((p_g.cpu() - p_c).abs().max()) / scale
    print(f"fiber[f64 {params['res_list']}, {rays.x.shape[0]} rays, {steps} steps, gradient "
          f"{gradient or 'adjoint'}, escalated at stage {esc_g}] card against CPU: loss history "
          f"rel_err {hist_err:.3e}, final profile "
          f"err {p_err:.3e} of its largest deviation from 1 ({scale:.3e}) (tol {TOL_F64:g}); "
          f"launches on the card {launches}", flush=True)
    if esc_g != esc_c or launches != want or any(cpu_launches.values()):
        raise AssertionError(f"fiber: the card escalated at {esc_g} and launched {launches} "
                             f"(want {want}), the CPU escalated at {esc_c} and launched "
                             f"{cpu_launches}")
    if len(hist_g) != steps or not p_g.is_cuda or p_c.is_cuda:
        raise AssertionError("fiber: the small runs did not run where they were asked to")
    if not (hist_err <= TOL_F64 and p_err <= TOL_F64 and scale > 0):
        raise AssertionError("fiber: the driver on the card disagrees with the CPU")


BENCH_ITERS = 3
# ---------------------------------------------------------------------------
# the reference-style variants (compat): K11-K14, phase v
# ---------------------------------------------------------------------------

VARIANT_KERNELS = ("trace_plane", "trace_target", "trace_sdf", "backtrace_sdf")
# Least arithmetic of the variants beyond K2's and K3's, counted as above: the
# plane test (x - o) . d > 0 (3 subtractions, 3 products, 2 sums: 8) and the
# squared distance to the target (8), a step each; the sdf's value at a point
# (the stencil and the value's lerps: 9 + 21).
FLOPS_PLANE_TEST = 8
FLOPS_TARGET_D2 = 8
FLOPS_SDF_VALUE = FLOPS_STENCIL + 21
# the compat calls of the variants path: one warm-up and three timed, forward
# and backward each
VARIANT_PASSES = 4


def sphere_sdf(res, span, dtype):
    """Signed distance to the sphere of radius 0.4 * span about the centre, in
    voxel units (the convention of ``sdf_utils.get_pts_sdf``), on the card."""
    h = span / (res - 1)
    idx = torch.arange(res, dtype=torch.float64, device="cuda") * h
    z, y, x = torch.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    r = torch.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    return ((r - 0.4 * span) / h).to(dtype).contiguous()


def variant_scene(res, nrays, dtype, noise=0.0):
    """The bench scene with the variants' inputs: per-ray planes at y = 0.6 *
    span with normal +y (every ray stops mid-volume); per-ray targets at the
    centre of the far face pushed out to y = 1.05 * span (rays escape first,
    then go on straight toward them); a sphere sdf (radius 0.4 * span) and
    ``nrays`` rays spawned on its surface heading in by ``sdf_utils.get_pts_sdf``."""
    s = scene(res, nrays, dtype, noise)
    span, n, dt = s["span"], s["x0"].shape[0], s["rif"].dtype

    def per_ray(vec):
        return torch.tensor(vec, dtype=dt, device="cuda").expand(n, 3).contiguous()

    s.update(pln_o=per_ray([0.0, 0.6 * span, 0.0]), pln_d=per_ray([0.0, 1.0, 0.0]),
             tgt=per_ray([span / 2, 1.05 * span, span / 2]), sdf=sphere_sdf(res, span, dt),
             ns=api.sdf_steps(s["rif"].shape, s["h"], s["ds"]))
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs, vs = sdf_utils.get_pts_sdf(gen, s["sdf"], n, span)
    s["xs"], s["vs"] = xs.contiguous(), vs.contiguous()
    s["sdf_field"] = G.GridField(s["sdf"], s["h"])
    return s


def variant_bounds(st, n, rif, ret=None):
    """The bounds of K11-K14 on ``n`` rays from the work the plain versions
    counted: each input read once and each output written once, the
    ray-steps, evaluations, ballistic and late steps and splats.  ``ret``
    (:func:`target_retirement`): the target's steps after escape that the
    data needs (up to each ray's retirement), else all (to the horizon)."""
    item, grid = rif.element_size(), rif.numel() * rif.element_size()
    p, t, f, b = (st[k] for k in VARIANT_KERNELS)
    ballistic = t["ballistic_steps"] if ret is None else ret["ballistic_needed"]
    return {
        "trace_plane": set_bound(dict(
            bytes=6 * n * 3 * item + n + grid,
            flops=(p["ray_steps"] * (FLOPS_FWD_STEP + FLOPS_PLANE_TEST)
                   + p["evals"] * FLOPS_FWD_EVAL))),
        "trace_target": set_bound(dict(
            bytes=(5 * 3 + 1) * n * item + grid,
            flops=((t["ray_steps"] + ballistic) * (FLOPS_FWD_STEP + FLOPS_TARGET_D2)
                   + t["evals"] * FLOPS_FWD_EVAL))),
        "trace_sdf": set_bound(dict(
            bytes=4 * n * 3 * item + 2 * grid,
            flops=(f["ray_steps"] * FLOPS_FWD_STEP + f["evals"] * (FLOPS_FWD_EVAL + FLOPS_SDF_VALUE)
                   + f["late_steps"] * (FLOPS_FWD_STEP + FLOPS_FWD_EVAL + FLOPS_SDF_VALUE)))),
        "backtrace_sdf": set_bound(dict(
            bytes=4 * n * 3 * item + 2 * grid + 8 * rif.numel(),  # the f64 gradient out
            flops=(b["ray_steps"] * (FLOPS_BWD_STEP + FLOPS_SDF_VALUE)
                   + b["evals"] * FLOPS_BWD_EVAL + b["splats"] * FLOPS_BWD_SPLAT))),
    }


def backtrace_on_variants(s, plane, target, order):
    """K3 where ``BackPlaneTracerC`` and ``BackTargetTracerC`` launch it: from
    the plane's mid-volume exit states (the missed rays' position cotangent
    zeroed) and the target's closest-approach states, with the cotangents of
    ``variants_path``'s loss, ordered and not, against the plain version (in
    f32 summed in f64 from the same f32 terms).  Yields the name, K3's error
    and, in f32, the plain version's own f32 sum's distance."""
    f, rif, h, ds, nb = s["field"], s["rif"], s["h"], s["ds"], s["nb"]
    f32 = rif.dtype == torch.float32
    tgt = s["tgt"][0]
    for name, (xt, vt), missed in (("plane", plane[:2], plane[2]), ("target", target[:2], None)):
        dx = 2.0 * (xt - tgt)
        if missed is not None:
            dx = torch.where(missed[:, None], torch.zeros_like(dx), dx)
        dv = torch.ones_like(vt)
        g_p = E.backtrace(f, xt, vt, dx, dv, ds, nb, acc_dtype=torch.float64 if f32 else None)
        got = [K.backtrace(rif, h, xt, vt, dx, dv, ds, nb, G.snap_tol(rif.dtype), o_)
               for o_ in (order, None)]
        own = (rel_err(E.backtrace(f, xt, vt, dx, dv, ds, nb).double(), g_p)[0]
               if f32 else 0.0)
        torch.cuda.synchronize()
        if not float(g_p.abs().max()) > 0:
            raise AssertionError(f"the {name}'s cotangents give a zero gradient")
        yield name, max(rel_err(g.double(), g_p.double())[0] for g in got), own


def variant_check(s, label, tol, times=False):
    """K11, K12 and K13 bitwise against their plain versions (the whole batch on
    both sides: K12's and K13's horizon is the batch's), with the ray order
    ``api`` makes and without; K14 (which sums in f64) within ``tol`` of the
    plain version (in f32 summed in f64 from the same f32 terms), ordered and
    not, its runs (counted in the kernel) equal to the plain version's
    ``flushes``.  With ``times``,
    the kernels' times (the order given, as the API launches them), the plain
    versions' and the bounds.  Returns the row of the report and failures."""
    f, rif, h, ds = s["field"], s["rif"], s["h"], s["ds"]
    x0, v0, xs, vs, sdf = s["x0"], s["v0"], s["xs"], s["vs"], s["sdf"]
    o, d, tgt, nf, nb, ns = s["pln_o"], s["pln_d"], s["tgt"], s["nf"], s["nb"], s["ns"]
    order = O.ray_order(x0, v0, rif.shape, h)
    order_s = O.ray_order(xs, vs, rif.shape, h)
    st = {k: {} for k in VARIANT_KERNELS}
    plane = E.trace_plane(f, x0, v0, o, d, ds, nf, stats=st["trace_plane"])
    target = E.trace_target(f, x0, v0, tgt, ds, nf, stats=st["trace_target"])
    sdf_out = E.trace_sdf(f, s["sdf_field"], xs, vs, ds, ns, stats=st["trace_sdf"])
    calls = {
        "trace_plane": (plane, lambda o_: K.trace_plane(rif, h, x0, v0, o, d, ds, nf, o_), order),
        "trace_target": (target, lambda o_: K.trace_target(rif, h, x0, v0, tgt, ds, nf, o_),
                         order),
        "trace_sdf": (sdf_out, lambda o_: K.trace_sdf(rif, sdf, h, xs, vs, ds, ns, o_), order_s),
    }
    bitwise, fwd_err = {}, {}
    for name, (want, call, o_ord) in calls.items():
        scale = max(1.0, max(float(b.double().abs().max()) for b in want))
        for lab, o_ in (("ordered", o_ord), ("unordered", None)):
            got = call(o_)
            bitwise[f"{name} {lab}"] = all(torch.equal(a, b) for a, b in zip(got, want))
            err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
            prev = fwd_err.get(name, (0.0, 0.0))
            fwd_err[name] = (max(prev[0], err), max(prev[1], err / scale))
    centre = torch.full((3,), s["span"] / 2, dtype=rif.dtype, device="cuda")
    dx, dv = 2.0 * (sdf_out[0] - centre), torch.ones_like(sdf_out[1])
    f32 = rif.dtype == torch.float32
    g_p = E.backtrace_sdf(f, s["sdf_field"], *sdf_out, dx, dv, ds, nb,
                          stats=st["backtrace_sdf"], acc_dtype=torch.float64 if f32 else None)
    tally = torch.zeros(3, dtype=torch.int64, device="cuda")
    tol_snap = G.snap_tol(rif.dtype)
    g_k = K.backtrace_sdf(rif, sdf, h, *sdf_out, dx, dv, ds, nb, tol_snap, order_s, tally)
    g_u = K.backtrace_sdf(rif, sdf, h, *sdf_out, dx, dv, ds, nb, tol_snap)
    # in f32, how far the plain version's own f32 sum lies from the f64 one
    plain_f32 = (rel_err(E.backtrace_sdf(f, s["sdf_field"], *sdf_out, dx, dv, ds, nb).double(),
                         g_p)[0] if f32 else 0.0)
    torch.cuda.synchronize()
    (e1, a1), (e2, a2) = (rel_err(g.double(), g_p.double()) for g in (g_k, g_u))
    n, ns_rays = x0.shape[0], xs.shape[0]
    row = dict(label=label, bitwise=bitwise, backtrace_sdf_rel_err=max(e1, e2),
               backtrace_sdf_abs_err=max(a1, a2), plain_f32_rel_err=plain_f32, tol=tol,
               fwd_err=fwd_err,
               runs=int(tally[0]),
               issued=int(tally[1]), path=K.backtrace_path(rif.numel(), torch.float64),
               plane_missed=int(plane[2].sum()), target_horizon=st["trace_target"]["horizon"],
               sdf_horizon=st["trace_sdf"]["horizon"],
               sdf_crossed=int((sdf_out[0] != xs).any(dim=1).sum()),
               work={k: dict(v) for k, v in st.items()})
    print(f"variants[{label}, {n} rays, {ns_rays} on the sdf] bitwise equal to the plain "
          f"versions: {bitwise}; plane missed {row['plane_missed']}; target horizon "
          f"{row['target_horizon']} of {nf} steps, ballistic steps "
          f"{st['trace_target']['ballistic_steps']}; sdf horizon {row['sdf_horizon']} of {ns}, "
          f"rays crossed {row['sdf_crossed']}, late steps {st['trace_sdf']['late_steps']}; "
          f"backtrace_sdf ({row['path']} path) rel_err {row['backtrace_sdf_rel_err']:.3e} "
          + (f"against the f64 sum of the same terms (the plain version's own f32 sum: "
             f"{plain_f32:.3e}) " if f32 else "")
          + f"(tol {tol:g}, ordered and unordered), max |g| {float(g_p.abs().max()):.4g}, runs "
          f"flushed {row['runs']} (plain flushes {st['backtrace_sdf']['flushes']})", flush=True)
    failures = []
    if not all(bitwise.values()):
        failures.append(f"K11-K13 are not bitwise equal to their plain versions at {label}: "
                        f"{bitwise}")
    if not (row["backtrace_sdf_rel_err"] <= tol and float(g_p.abs().max()) > 0):
        failures.append(f"K14 disagrees with its plain version at {label}: "
                        f"{row['backtrace_sdf_rel_err']:.3e}")
    if row["runs"] != st["backtrace_sdf"]["flushes"]:
        failures.append(f"K14 flushed {row['runs']} runs at {label}, the plain version counts "
                        f"{st['backtrace_sdf']['flushes']}")
    if row["sdf_crossed"] < ns_rays // 2:
        failures.append(f"only {row['sdf_crossed']} of {ns_rays} sdf rays crossed at {label}")
    row["backtrace_on_variants"] = k3 = {}
    for name, err, own in backtrace_on_variants(s, plane, target, order):
        k3[name] = dict(rel_err=err, plain_f32_rel_err=own)
        print(f"variants[{label}] backtrace (K3) from the {name}'s exit states with the compat "
              f"loss's cotangents: rel_err {err:.3e} "
              + (f"against the f64 sum of the same terms (the plain version's own f32 sum: "
                 f"{own:.3e}) " if f32 else "")
              + f"(tol {tol:g}, ordered and unordered)", flush=True)
        if not err <= tol:
            failures.append(f"K3 disagrees with its plain version on the {name}'s exit states "
                            f"at {label}: {err:.3e}")
    ret = target_retirement(f, x0, v0, tgt, ds, nf)
    row["target_retirement"] = ret
    print(f"variants[{label}] K12's {retirement_line(ret)}", flush=True)
    if ret["closer_after_retirement"] or ret["horizon"] != st["trace_target"]["horizon"]:
        failures.append(f"the target's retirement rule fails at {label}: {ret}")
    if not times:
        return row, failures
    # the sdf's rays are as many (variant_scene)
    bounds, old = variant_bounds(st, n, rif, ret), variant_bounds(st, n, rif)
    timed = {
        "trace_plane": (lambda: calls["trace_plane"][1](order),
                        lambda: E.trace_plane(f, x0, v0, o, d, ds, nf)),
        "trace_target": (lambda: calls["trace_target"][1](order),
                         lambda: E.trace_target(f, x0, v0, tgt, ds, nf)),
        "trace_sdf": (lambda: calls["trace_sdf"][1](order_s),
                      lambda: E.trace_sdf(f, s["sdf_field"], xs, vs, ds, ns)),
        "backtrace_sdf": (lambda: K.backtrace_sdf(rif, sdf, h, *sdf_out, dx, dv, ds, nb,
                                                  tol_snap, order_s),
                          lambda: E.backtrace_sdf(f, s["sdf_field"], *sdf_out, dx, dv, ds, nb)),
    }
    row["times"] = {}
    for name, (kernel, plain) in timed.items():
        rec = dict(bounds[name], ms=time_ms(kernel, 5), plain_ms=time_ms(plain, 1),
                   library_ms=None)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        row["times"][name] = rec
        print(f"variants[{label}] {name}: {rec['ms']:.4f} ms a call (bound {rec['bound_ms']:.4f}, "
              f"{rec['bound_by']}: {100 * rec['share_of_bound']:.2f} % of it), plain version "
              f"{rec['plain_ms']:.1f} ms"
              + (f"; against the steps to the horizon: bound {old[name]['bound_ms']:.4f}, "
                 f"{100 * old[name]['bound_ms'] / rec['ms']:.2f} %" if name == "trace_target"
                 else ""), flush=True)
    row["passes_ms"] = pass_split(timed["trace_target"][0], "trace_target")
    row["sdf_passes_ms"] = pass_split(timed["trace_sdf"][0], "trace_sdf")
    row["step_instructions"] = step_instructions()
    print(f"variants[{label}] trace_target " + ", ".join(
        f"{k} {v:.4f}" for k, v in row["passes_ms"].items()) + " ms; trace_sdf " + ", ".join(
        f"{k} {v:.4f}" for k, v in row["sdf_passes_ms"].items()) + " ms (its grids packed "
          "before pass 1); the step loop's machine code an iteration: "
          + json.dumps(row["step_instructions"]), flush=True)
    return row, failures


def variant_ragged_check(s, label):
    """K12 and K13 on a batch with one more ray that never escapes (outside the
    grid, at rest): the batch's horizon is then max_steps, and every escaped
    ray goes on to it; bitwise against the plain versions."""
    rif, h, ds, f = s["rif"], s["h"], s["ds"], s["field"]
    still = torch.full((1, 3), -h, dtype=rif.dtype, device="cuda")
    rest = torch.zeros_like(still)
    x0, v0 = torch.cat([s["x0"], still]), torch.cat([s["v0"], rest])
    xs, vs = torch.cat([s["xs"], still]), torch.cat([s["vs"], rest])
    tgt = torch.cat([s["tgt"], s["tgt"][:1]])
    order, order_s = (O.ray_order(a, b, rif.shape, h) for a, b in ((x0, v0), (xs, vs)))
    st_t, st_f = {}, {}
    want_t = E.trace_target(f, x0, v0, tgt, ds, s["nf"], stats=st_t)
    want_f = E.trace_sdf(f, s["sdf_field"], xs, vs, ds, s["ns"], stats=st_f)
    got_t = K.trace_target(rif, h, x0, v0, tgt, ds, s["nf"], order)
    got_f = K.trace_sdf(rif, s["sdf"], h, xs, vs, ds, s["ns"], order_s)
    torch.cuda.synchronize()
    row = dict(target=all(torch.equal(a, b) for a, b in zip(got_t, want_t)),
               sdf=all(torch.equal(a, b) for a, b in zip(got_f, want_f)),
               target_horizon=st_t["horizon"], sdf_horizon=st_f["horizon"])
    print(f"variants[{label}, ragged: one ray never escapes] bitwise equal: K12 {row['target']} "
          f"(horizon {row['target_horizon']} of {s['nf']}), K13 {row['sdf']} (horizon "
          f"{row['sdf_horizon']} of {s['ns']})", flush=True)
    failures = []
    if not (row["target"] and row["sdf"]):
        failures.append(f"K12 or K13 is not bitwise equal in the ragged case at {label}: {row}")
    if row["target_horizon"] != s["nf"] or row["sdf_horizon"] != s["ns"]:
        failures.append(f"the ragged case did not run to max_steps at {label}: {row}")
    return row, failures


def late_sdf_scene(dtype):
    """The sdf's late-crossing batch at 17^3: a half-space sdf (x < span / 2)
    reaching the y = 0 face, 64 rays that leave the grid through it while
    still inside and drift across x = span / 2 afterwards, the last one slow
    (it holds the batch's loop open)."""
    s = scene(17, 64, dtype)
    rif, h, span = s["rif"], s["h"], s["span"]
    idx = torch.arange(17, dtype=torch.float64, device="cuda") * h
    sdf = ((idx - span / 2) / h).to(rif.dtype).expand(17, 17, 17).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 64
    u = torch.rand((n, 3), generator=gen, dtype=torch.float64, device="cuda")
    x0 = torch.stack([0.2 + 0.15 * u[:, 0], 0.15 + 0.15 * u[:, 1], 0.3 + 0.4 * u[:, 2]], -1) * span
    v0 = torch.stack([torch.full_like(u[:, 0], 0.3), -torch.ones_like(u[:, 0]),
                      0.1 * (u[:, 2] - 0.5)], -1)
    v0 = v0 / torch.linalg.norm(v0, dim=-1, keepdim=True)
    x0[-1] = torch.tensor([0.3, 0.5, 0.5], dtype=torch.float64, device="cuda") * span
    v0[-1] = torch.tensor([0.0, 0.1, 0.0], dtype=torch.float64, device="cuda")
    s.update(sdf=sdf, sdf_field=G.GridField(sdf, h), x0=x0.to(rif.dtype).contiguous(),
             v0=v0.to(rif.dtype).contiguous(), ns=api.sdf_steps(rif.shape, h, s["ds"]))
    return s


def sdf_late_check(dtype):
    """K13 where rays leave the grid while still inside the sdf (a half-space
    sdf, x < span / 2, reaching the y = 0 face) and cross it afterwards, the
    field read at clamped corners, while a slow ray holds the batch's loop
    open: bitwise against the plain version, and K14 from that state."""
    s = late_sdf_scene(dtype)
    rif, h, ds, span = s["rif"], s["h"], s["ds"], s["span"]
    sdf, x0, v0, ns, n = s["sdf"], s["x0"], s["v0"], s["ns"], s["x0"].shape[0]
    st = {}
    sdf_f = G.GridField(sdf, h)
    want = E.trace_sdf(s["field"], sdf_f, x0, v0, ds, ns, stats=st)
    order = O.ray_order(x0, v0, rif.shape, h)
    got = K.trace_sdf(rif, sdf, h, x0, v0, ds, ns, order)
    dx, dv = torch.ones_like(want[0]), torch.ones_like(want[1])
    f32 = rif.dtype == torch.float32
    g_p = E.backtrace_sdf(s["field"], sdf_f, *want, dx, dv, ds, s["nb"],
                          acc_dtype=torch.float64 if f32 else None)
    g_k = K.backtrace_sdf(rif, sdf, h, *want, dx, dv, ds, s["nb"], G.snap_tol(rif.dtype), order)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    crossed_late = int(((want[0][:, 1] < 0) & (want[0][:, 0] >= span / 2)).sum())
    err = rel_err(g_k.double(), g_p.double())[0]
    tol = TOL_F32_GRAD if f32 else TOL_F64
    print(f"variants[sdf late crossing, {dtype}, 17^3 x {n}] K13 bitwise equal {bitwise}; late "
          f"steps {st['late_steps']}, rays that crossed outside the grid {crossed_late}; K14 "
          f"rel_err {err:.3e} (tol {tol:g})", flush=True)
    failures = []
    if not bitwise or not err <= tol:
        failures.append(f"K13 / K14 disagree in the late-crossing case ({dtype}): bitwise "
                        f"{bitwise}, K14 {err:.3e}")
    if not (st["late_steps"] > 0 and crossed_late > 0):
        failures.append(f"the late-crossing case has no late crossing ({dtype})")
    return failures


def variants_path(s):
    """The slice's main path: the reference's class names from ``compat`` at
    full width, forward and backward, as a user coming from the reference
    calls them: ``BackPlaneTracerC`` (K11, then K3 with the missed rays'
    position cotangent zeroed), ``BackTargetTracerC`` (K12's two launches,
    K3), ``BackSDFTracerC`` (K13's two launches, K14), each
    :data:`VARIANT_PASSES` times; a plane and a target given once for every
    ray.  Launch counts asserted exactly; ms a call (host clock, forward and
    backward, synchronised) and a launch (CUDA events)."""
    rif0, h, ds, span = s["rif"], s["h"], s["ds"], s["span"]
    x0, v0, xs, vs, sdf = s["x0"], s["v0"], s["xs"], s["vs"], s["sdf"]
    tgt = s["tgt"][0]

    def plane(r):
        xt, vt, miss = compat.BackPlaneTracerC(r, x0, v0, s["pln_o"][0], s["pln_d"][0], h, ds)
        return ((xt - tgt) ** 2).sum() + vt.sum(), miss

    def target(r):
        xt, vt, d2 = compat.BackTargetTracerC(r, x0, v0, tgt, h, ds)
        if d2.requires_grad:
            raise AssertionError("BackTargetTracerC: d2 carries a gradient")
        return ((xt - tgt) ** 2).sum() + vt.sum(), d2

    def sdf_call(r):
        xt, vt = compat.BackSDFTracerC(r, sdf, xs, vs, h, ds)
        return ((xt - span / 2) ** 2).sum() + vt.sum(), None

    rec = {}
    events = []
    K.reset_launches()
    K.record_events(events)
    try:
        for name, call in (("plane", plane), ("target", target), ("sdf", sdf_call)):
            ms = []
            for _ in range(VARIANT_PASSES):
                r = rif0.detach().clone().requires_grad_(True)
                torch.cuda.synchronize()
                t0 = time.time()
                loss, extra = call(r)
                loss.backward()
                torch.cuda.synchronize()
                ms.append(1e3 * (time.time() - t0))
                g = r.grad
                if g is None or not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
                    raise AssertionError(f"compat {name}: the gradient is missing, not finite "
                                         "or zero")
            rec[name] = dict(ms_per_call=median(ms[1:]), loss=float(loss.detach()))
            if name == "plane":
                rec[name]["missed"] = int(extra.sum())
    finally:
        K.record_events(None)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    paths = {"backtrace": dict(K.BACKTRACE_PATHS), "backtrace_sdf": dict(K.BACKTRACE_SDF_PATHS)}
    want = {**{name: 0 for name in build.KERNELS}, "trace_plane": VARIANT_PASSES,
            "trace_target": 2 * VARIANT_PASSES, "trace_sdf": 2 * VARIANT_PASSES,
            "backtrace": 2 * VARIANT_PASSES, "backtrace_sdf": VARIANT_PASSES}
    if launches != want:
        raise AssertionError(f"the compat calls must launch {want}, counted {launches}")
    path = K.backtrace_path(rif0.numel(), rif0.dtype)
    path_sdf = K.backtrace_path(rif0.numel(), torch.float64)  # K14 sums in f64
    if paths["backtrace"][path] != 2 * VARIANT_PASSES or \
            paths["backtrace_sdf"][path_sdf] != VARIANT_PASSES:
        raise AssertionError(f"K3 and K14 must take the {path} and {path_sdf} paths, counted "
                             f"{paths}")
    by_name = {}
    for n_, a, b in events:
        by_name.setdefault(n_, []).append(a.elapsed_time(b))
    per_launch = {}
    for name, ms in by_name.items():
        if name in ("trace_target", "trace_sdf"):  # pass 1 and pass 2 in turn
            per_launch[f"{name} pass 1"] = median(ms[2::2])
            per_launch[f"{name} pass 2"] = median(ms[3::2])
        elif name == "backtrace":  # the plane's, then the target's
            per_launch["backtrace (plane)"] = median(ms[1:VARIANT_PASSES])
            per_launch["backtrace (target)"] = median(ms[VARIANT_PASSES + 1:])
        else:
            per_launch[name] = median(ms[1:])
    rec.update(launches=launches, paths=paths, ms_per_launch=per_launch)
    print(f"variants path (compat at {tuple(rif0.shape)}, {x0.shape[0]} rays, "
          f"{VARIANT_PASSES} calls each): ms a call forward + backward "
          + ", ".join(f"{k} {rec[k]['ms_per_call']:.3f}" for k in ("plane", "target", "sdf"))
          + "; ms a launch " + ", ".join(f"{k} {v:.4f}" for k, v in per_launch.items())
          + f"; launches {launches}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# the variants' exact gradients (K15-K19, and K6 for the target), phase x
# ---------------------------------------------------------------------------

EXACT_VARIANT_KERNELS = ("trace_plane_ckpt", "trace_target_ckpt", "trace_sdf_ckpt",
                         "backtrace_plane_exact", "backtrace_sdf_exact")
#: each variant's forward kernel and backward kernel (the target's is K6)
EXACT_VARIANTS = {"plane": ("trace_plane_ckpt", "backtrace_plane_exact"),
                  "target": ("trace_target_ckpt", "backtrace_exact"),
                  "sdf": ("trace_sdf_ckpt", "backtrace_sdf_exact")}
#: the chunked full-width call of phase x: 4 chunks of ANRT_EXACT_CHUNK's default
EXACT_CHUNKED_RAYS = 1 << 20
#: the chunk of the checks' chunked runs: the last chunk is padded (2^18 = 2 x
#: 100,000 + 62,144; 512 = 5 x 100 + 12)
EXACT_CHECK_CHUNK = {"float64": 100, "float32": 100_000}
#: the segment lengths phase x also holds the plane's and the target's rows at
EXACT_CHECK_SEGS = (48, 7)


def exact_case(s, variant, x=None, v=None, tgt=None):
    """One exact variant's batch on the variant scene ``s``: the rays (the
    scene's, or ``x, v``), the per-ray inputs, the plain version's ``vargs``
    and the loss's cotangents' anchor (the target, or the scene's centre)."""
    case = dict(variant=variant, rif=s["rif"], h=s["h"], ds=s["ds"])
    if variant == "sdf":
        case.update(x=s["xs"] if x is None else x, v=s["vs"] if v is None else v,
                    sdf=s["sdf"], vargs=dict(sdf=s["sdf_field"]))
        case["anchor"] = torch.full((3,), s["span"] / 2, dtype=s["rif"].dtype, device="cuda")
        return case
    x, v = (s["x0"], s["v0"]) if x is None else (x, v)
    tgt = s["tgt"][:1].expand(x.shape[0], 3).contiguous() if tgt is None else tgt
    case.update(x=x, v=v, tgt=tgt, anchor=tgt[0])
    if variant == "plane":
        o = s["pln_o"][:1].expand(x.shape[0], 3).contiguous()
        d = s["pln_d"][:1].expand(x.shape[0], 3).contiguous()
        case.update(o=o, d=d, vargs=dict(pln_o=o, pln_d=d))
    else:
        case["vargs"] = dict(target=tgt)
    return case


def exact_forward_kernel(case, order, store, chunk=0, stop=None):
    """K15, K16 (two launches) or K17 (two) over the rays ``order``: returns
    (the outputs the API returns, c, code, ckpts, the horizon).  The case's
    ``seg`` where it has one, else :data:`SEG`."""
    rif, h, ds, x, v = case["rif"], case["h"], case["ds"], case["x"], case["v"]
    seg = case.get("seg", SEG)
    steps = CK.variant_steps(case["variant"], rif.shape, h, ds)
    if case["variant"] == "plane":
        xt, vt, miss, c, code, ck = K.trace_plane_ckpt(rif, h, x, v, case["o"], case["d"], ds,
                                                       steps, seg, order, store)
        return (xt, vt, miss), c, code, ck, None
    if case["variant"] == "target":
        xt, vt, d2, c, code, ck, hz = K.trace_target_ckpt(rif, h, x, v, case["tgt"], ds, steps,
                                                          seg, order, store, horizon=stop)
        return (xt, vt, d2), c, code, ck, hz
    # the horizons given (a chunk's recomputation), or the kernel's from the
    # JAX chunk size
    horizons = stop if stop is not None else chunk
    xt, vt, c, code, ck, hz = K.trace_sdf_ckpt(rif, case["sdf"], h, x, v, ds, steps, seg, order,
                                               horizons, store)
    return (xt, vt), c, code, ck, hz


def exact_backward_kernel(case, ck, c, code, dx, dv, order, out, tally=None):
    """K18, K6 or K19 over the rays ``order``, added into ``out`` (K19's in f64)."""
    rif, h, ds = case["rif"], case["h"], case["ds"]
    seg = case.get("seg", SEG)
    if case["variant"] == "plane":
        return K.backtrace_plane_exact(rif, h, ck, c, code, case["o"], case["d"], dx, dv, ds, seg,
                                       order, out=out, tally=tally)
    if case["variant"] == "target":
        return K.backtrace_exact(rif, h, ck, c, code, dx, dv, ds, seg, order, out=out,
                                 tally=tally)
    return K.backtrace_sdf_exact(rif, case["sdf"], h, ck, c, code, dx, dv, ds, seg, order,
                                 out=out, tally=tally)


def exact_variant_bounds(case, fw, bw, rows):
    """The bounds of the variant's forward and backward kernels from the work
    the plain versions counted on this run's rays: each input read once, each
    output and each checkpoint row the backward pass reads written once."""
    rif, variant = case["rif"], case["variant"]
    n, item, grid = case["x"].shape[0], rif.element_size(), rif.numel() * rif.element_size()
    per_ray_in = {"plane": 4, "target": 3, "sdf": 2}[variant] * 3 * item  # x, v, planes, target
    out_extra = {"plane": 1, "target": item, "sdf": 0}[variant]           # miss, d2
    rows_bytes = rows * 7 * item
    sdf_grid = grid if variant == "sdf" else 0
    grad_out = rif.numel() * (8 if variant == "sdf" else item)  # K19 sums in f64
    step_extra = {"plane": FLOPS_PLANE_TEST, "target": FLOPS_TARGET_D2, "sdf": 0}[variant]
    eval_extra = FLOPS_SDF_VALUE if variant == "sdf" else 0
    fwd = set_bound(dict(
        bytes=per_ray_in * n + (6 * item + 5 + out_extra) * n + rows_bytes + grid + sdf_grid,
        flops=fw["ray_steps"] * (FLOPS_FWD_STEP + step_extra) + fw["evals"] * (FLOPS_FWD_EVAL
                                                                               + eval_extra)))
    replay_extra = FLOPS_PLANE_TEST if variant == "plane" else 0
    bwd = set_bound(dict(
        bytes=(rows_bytes + 5 * n + 6 * n * item + (6 * n * item if variant == "plane" else 0)
               + grid + grad_out + sdf_grid),
        flops=(bw["ray_steps"] * (FLOPS_EXACT_STEP + replay_extra)
               + bw["evals"] * (FLOPS_EXACT_EVAL + eval_extra) + bw["splats"] * FLOPS_BWD_SPLAT)))
    return fwd, bwd


def run_counts(tally):
    """What an exact backward pass's ``tally`` (``K.EXACT_TALLY``) says of its
    runs: the flushes issued after the warp sums and the atomic adds into
    device memory (8 a flush where each corner goes alone), the float4 adds
    among them (K18: an x-pair of corners each)."""
    t = dict(zip(K.EXACT_TALLY, (int(v) for v in tally.tolist())))
    return dict(issued=t["issued"], adds=t["adds"], float4_adds=t["float4_adds"])


def run_line(row):
    """The printed form of :func:`run_counts`."""
    return (f"issued {row['issued']} ({8 * row['issued']} adds at 8 a flush), atomic adds into "
            f"device memory {row['adds']}, of them float4 {row['float4_adds']}")


def pass_split(fn, name, reps=5):
    """Median ms of a two-launch call's pass 1, the gap from its end to pass
    2's start (the host's work between the launches, where the card waits
    on it), and pass 2, from CUDA events the wrappers record around their
    launches; the card kept busy before each call, as in :func:`time_ms`."""
    fn()
    events = []
    K.record_events(events)
    try:
        for _ in range(reps):
            torch.cuda._sleep(BUSY_CYCLES)
            fn()
    finally:
        K.record_events(None)
    torch.cuda.synchronize()
    ev = [(a, b) for n_, a, b in events if n_ == name]
    if len(ev) != 2 * reps:
        raise AssertionError(f"{name}: {len(ev)} launches in {reps} calls, not two a call")
    parts = [(p1[0].elapsed_time(p1[1]), p1[1].elapsed_time(p2[0]), p2[0].elapsed_time(p2[1]))
             for p1, p2 in zip(ev[::2], ev[1::2])]
    return {k: median([p[j] for p in parts]) for j, k in enumerate(("pass 1", "between",
                                                                    "pass 2"))}


def exact_variant_check(case, label, tol, chunk=0, times=False):
    """One variant's exact forward and backward kernels against the plain
    versions (``tracer/checkpointed.py``) on the card, as ``trace_*_exact``
    runs them: the whole batch with its checkpoints, or (``chunk``) the
    forward pass over all the rays without them and the backward pass chunk
    by chunk of the ray order, each chunk recomputing its checkpoints (the
    target with the batch's horizon, the sdf with the horizons of its JAX
    chunks, ``chunk`` rays each, the last padded with ray 0).  The outputs,
    the capture steps and exit codes, the horizon and (whole) the checkpoint
    rows the backward pass reads bitwise; the gradient within ``tol`` of the
    plain version's (in f32 summed in f64 from the same f32 terms); the
    backward kernel's runs equal to the plain ``flushes``.  With ``times``,
    the kernels' times, the plain versions' and the bounds.  Returns the row
    of the report and the failures."""
    variant, rif, h, ds, x, v = (case[k] for k in ("variant", "rif", "h", "ds", "x", "v"))
    seg = case.get("seg", SEG)
    f = G.GridField(rif, h)
    va = case["vargs"]
    steps = CK.variant_steps(variant, rif.shape, h, ds)
    n = x.shape[0]
    chunked = len(CK._chunks(n, chunk)) > 1
    f32 = rif.dtype == torch.float32
    order = O.ray_order(x, v, rif.shape, h)
    # the plain versions: the horizon, the forward pass, the backward pass
    esc_steps = CK._escape_steps(f, x, v, ds, steps, variant=variant, **va)
    stop = None
    if chunked and variant == "target":
        stop = torch.full((n,), CK._target_stop_step(f, x, v, ds, steps, chunk),
                          dtype=torch.int32, device="cuda")
    elif chunked and variant == "sdf":
        stop = CK._index_chunk_horizons(esc_steps, chunk, seg, steps)
    fw, bw = {}, {}
    torch.cuda.synchronize()
    t0 = time.time()
    xt_p, vt_p, esc_p, c_p, cap_p, ck_p = CK._forward_with_ckpts(
        f, x, v, ds, steps, seg, not chunked, stats=fw, variant=variant, stop=stop, **va)
    torch.cuda.synchronize()
    plain_fwd_ms = 1e3 * (time.time() - t0)
    code_p = torch.where(esc_p, torch.where(cap_p, 1, 2), 0).to(torch.uint8)
    want = {"plane": (xt_p, vt_p, ~esc_p), "target": (xt_p, vt_p, E.sum_sq3(xt_p - case.get(
        "tgt", xt_p))), "sdf": (xt_p, vt_p)}[variant]
    # the kernels' forward pass over all the rays
    got, c_k, code_k, ck_k, hz_k = exact_forward_kernel(case, order, not chunked,
                                                        chunk if chunked else 0)
    horizon_p = (int(esc_steps.max()) if variant == "target" else
                 CK._index_chunk_horizons(esc_steps, chunk if chunked else 0, seg, steps))
    # the outputs' largest difference (the plane's miss as 0/1)
    fwd_abs = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                  for a, b in zip(got, want))
    fwd_scale = max(float(b.double().abs().max()) if b.numel() else 0.0 for b in want)
    state = dict(outputs=all(torch.equal(a, b) for a, b in zip(got, want)),
                 capture_steps=bool(torch.equal(c_k, c_p) and torch.equal(code_k, code_p)))
    if variant == "target":
        state["horizon"] = int(hz_k) == horizon_p
    elif variant == "sdf":
        state["horizon"] = bool(torch.equal(hz_k, horizon_p))
    live_steps = torch.where(code_p == 2, 0, c_p)[order.long()]
    need = (torch.arange(-(-steps // seg), device="cuda")[:, None] * seg) < live_steps[None, :]
    rows = int(need.sum())
    if not chunked:
        state["checkpoints"] = bool(torch.equal(ck_k.transpose(1, 2)[need],
                                                ck_p[:, :, order.long()].transpose(1, 2)[need]))
    # the loss's cotangents; the plane's missed rays pass none
    dx, dv = 2.0 * (xt_p - case["anchor"]), torch.ones_like(vt_p)
    if variant == "plane":
        dx = torch.where(esc_p[:, None], dx, torch.zeros_like(dx))
        dv = torch.where(esc_p[:, None], dv, torch.zeros_like(dv))
    bw["captured"] = cap_p
    torch.cuda.synchronize()
    t0 = time.time()
    with exact_chunk(chunk):
        g_p = CK.backtrace_plain(rif, x, v, esc_p, c_p, ck_p, dx, dv, h, ds, seg,
                                 acc_dtype=torch.float64 if f32 else None, stats=bw,
                                 variant=variant, stop=stop, **va)
    torch.cuda.synchronize()
    plain_bwd_ms = 1e3 * (time.time() - t0)
    tally = torch.zeros(len(K.EXACT_TALLY), dtype=torch.int64, device="cuda")
    g_k = torch.zeros((rif.numel(),), device="cuda",
                      dtype=torch.float64 if variant == "sdf" else rif.dtype)
    for sl in CK._chunks(n, chunk if chunked else 0):
        ck = ck_k
        if ck is None:  # recompute this chunk's checkpoints, as the API does
            ck = exact_forward_kernel(case, order[sl], True, stop=hz_k)[3]
        exact_backward_kernel(case, ck, c_k, code_k, dx, dv, order[sl], g_k, tally)
    torch.cuda.synchronize()
    err, abs_err = rel_err(g_k.double(), g_p.double())
    fname, bname = EXACT_VARIANTS[variant]
    row = dict(label=label, variant=variant, chunk=chunk if chunked else None, bitwise=state,
               rel_err=err, abs_err=abs_err, tol=tol, max_abs_g=float(g_p.abs().max()),
               fwd_abs_err=fwd_abs, fwd_rel_err=fwd_abs / max(1.0, fwd_scale),
               runs=int(tally[0]), fwd=fw,
               bwd={k: bw[k] for k in ("ray_steps", "evals", "splats", "flushes")},
               **run_counts(tally), ckpt_rows_read=rows,
               rays_code=[int((code_k == k).sum()) for k in range(3)],
               horizon=horizon_p if variant == "target" else (
                   [int(horizon_p.min()), int(horizon_p.max())] if variant == "sdf" else None))
    print(f"exact {variant}[{label}, {n} rays" + (f", chunks of {chunk}" if chunked else "")
          + f"] {fname} bitwise equal {state}; {bname} rel_err {err:.3e} against the plain "
          f"version" + (" summed in f64 from the same f32 terms" if f32 else "")
          + f" (tol {tol:g}), max |g| {row['max_abs_g']:.4g}; runs flushed {row['runs']} (plain "
          f"flushes {bw['flushes']}); {run_line(row)}; rays never escaped / captured / not "
          f"{row['rays_code']}; horizon {row['horizon']}; checkpoint rows read {rows}",
          flush=True)
    failures = []
    if not all(state.values()):
        failures.append(f"{fname} is not bitwise equal to its plain version at {label} "
                        f"({variant}, chunk {chunk}): {state}")
    if not (err <= tol and row["max_abs_g"] > 0):
        failures.append(f"{bname} disagrees with its plain version at {label} ({variant}, chunk "
                        f"{chunk}): {err:.3e}")
    if row["runs"] != bw["flushes"]:
        failures.append(f"{bname} flushed {row['runs']} runs at {label} ({variant}), the plain "
                        f"version counts {bw['flushes']}")
    if not times:
        return row, failures
    ret = None
    if variant == "target":  # the steps after escape the data needs: to each ray's retirement
        ret = target_retirement(f, x, v, case["tgt"], ds, steps)
        row["target_retirement"] = ret
        if ret["closer_after_retirement"] or ret["horizon"] != horizon_p:
            failures.append(f"the target's retirement rule fails at {label}: {ret}")
        fw_old = dict(fw)
        fw = dict(fw, ray_steps=fw["ray_steps"] - ret["saved"])
    fwd_b, bwd_b = exact_variant_bounds(case, fw, bw, rows)
    fwd_b.update(ms=time_ms(lambda: exact_forward_kernel(case, order, True), 3),
                 plain_ms=plain_fwd_ms, library_ms=None)
    bwd_b.update(ms=time_ms(lambda: exact_backward_kernel(
        case, ck_k, c_k, code_k, dx, dv, order, torch.zeros_like(g_k)), 3),
        plain_ms=plain_bwd_ms, library_ms=None)
    for rec in (fwd_b, bwd_b):
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    if variant != "plane":  # two launches: pass 1, the gap between them, pass 2 apart
        fwd_b["passes_ms"] = pass_split(lambda: exact_forward_kernel(case, order, True), fname)
    row["times"] = {fname: fwd_b, bname: bwd_b}
    extra = ""
    if variant == "target":
        old_b = exact_variant_bounds(case, fw_old, bw, rows)[0]["bound_ms"]
        k12 = pass_split(lambda: K.trace_target(rif, h, x, v, case["tgt"], ds, steps, order),
                         "trace_target")
        row["trace_target_passes_ms"] = k12
        extra = (f"; against the steps to the horizon: bound {old_b:.4f}, "
                 f"{100 * old_b / fwd_b['ms']:.2f} %; K12 on these rays "
                 + ", ".join(f"{k} {v_:.4f}" for k, v_ in k12.items()) + " ms; K12's and "
                 f"{fname}'s pass 2 {retirement_line(ret)}")
    row["step_instructions"] = {k: v_ for k, v_ in step_instructions().items()
                                if k.startswith(fname)}
    print(f"exact {variant}[{label}] {fname} {fwd_b['ms']:.4f} ms (bound {fwd_b['bound_ms']:.4f}, "
          f"{fwd_b['bound_by']}: {100 * fwd_b['share_of_bound']:.2f} % of it; plain "
          f"{plain_fwd_ms:.1f} ms), {bname} {bwd_b['ms']:.4f} ms (bound {bwd_b['bound_ms']:.4f}, "
          f"{bwd_b['bound_by']}: {100 * bwd_b['share_of_bound']:.2f} % of it; plain "
          f"{plain_bwd_ms:.1f} ms); checkpoints {ck_k.numel() * ck_k.element_size() / 1e6:.1f} MB"
          + ("; " + fname + " " + ", ".join(f"{k} {v:.4f}" for k, v in fwd_b["passes_ms"].items())
             + " ms" if "passes_ms" in fwd_b else "") + extra
          + f"; the step loop's machine code an iteration: {json.dumps(row['step_instructions'])}",
          flush=True)
    return row, failures


def exact_variants_api_check(s):
    """``trace_plane_exact``, ``trace_target_exact`` and ``trace_sdf_exact`` on
    the card (K15-K19, K6) against the same functions on the CPU (the plain
    versions the CPU tests hold to JAX) in f64, on 200 of the small scene's
    rays in chunks of 64 (the last padded): outputs 1e-12, gradient 1e-9;
    launches asserted exactly."""
    n, chunk = 200, 64
    nc = -(-n // chunk)
    failures = []
    launches = {}
    with exact_chunk(chunk):
        for variant in EXACT_VARIANTS:
            case = exact_case(s, variant)
            x, v = case["x"][:n].contiguous(), case["v"][:n].contiguous()
            per_ray = {"plane": ("o", "d"), "target": ("tgt",), "sdf": ()}[variant]
            args = [case[k][:n].contiguous() for k in per_ray]
            fn = {"plane": tracer.trace_plane_exact, "target": tracer.trace_target_exact,
                  "sdf": lambda r, *a: tracer.trace_sdf_exact(r, sdf_, *a)}[variant]
            res = []
            for dev in ("cuda", "cpu"):
                r = case["rif"].detach().to(dev).clone().requires_grad_(True)
                sdf_ = case.get("sdf", case["rif"]).to(dev)
                K.reset_launches()
                out = fn(r, x.to(dev), v.to(dev), *(a.to(dev) for a in args), s["h"], s["ds"],
                         SEG)
                (((out[0] - case["anchor"].to(dev)) ** 2).sum() + out[1].sum()).backward()
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches[variant] = {k: c for k, c in K.LAUNCHES.items() if c}
                res.append([t.detach().cpu() for t in out] + [r.grad.cpu()])
            fwd_err = max(rel_err(a.double(), b.double())[0] for a, b in zip(res[0][:-1],
                                                                             res[1][:-1]))
            g_err = rel_err(res[0][-1], res[1][-1])[0]
            fname, bname = EXACT_VARIANTS[variant]
            want = {fname: (2 if variant != "plane" else 1) * (1 + nc), bname: nc}
            print(f"exact {variant}[api, f64 17^3 x {n}, chunks of {chunk}] card against CPU: "
                  f"outputs {fwd_err:.3e} (tol 1e-12), gradient {g_err:.3e} (tol {TOL_F64:g}); "
                  f"launches {launches[variant]}", flush=True)
            if not (fwd_err <= 1e-12 and g_err <= TOL_F64 and float(res[1][-1].abs().max()) > 0):
                failures.append(f"trace_{variant}_exact on the card differs from the CPU: "
                                f"outputs {fwd_err:.3e}, gradient {g_err:.3e}")
            if launches[variant] != want:
                failures.append(f"trace_{variant}_exact must launch {want}, counted "
                                f"{launches[variant]}")
    return failures


def exact_variants_path(s, s_big):
    """Phase x's main path: ``tracer.trace_plane_exact``, ``trace_target_exact``
    and ``trace_sdf_exact`` at full width as a user calls them, forward and
    backward, :data:`VARIANT_PASSES` times each on the bench scene's 2^18 rays
    (unchunked: the forward keeps its checkpoints), then once each on 2^20
    rays (``s_big``: four chunks, the backward recomputing each chunk's
    checkpoints).  Launch counts asserted exactly, those of the 2^18 calls
    apart (``launches_2^18``) and the whole run's; ms a call (host clock,
    synchronised) and a launch (CUDA events)."""
    rec = {}
    p = VARIANT_PASSES
    want_small = {**{name: 0 for name in build.KERNELS},
                  "trace_plane_ckpt": p, "backtrace_plane_exact": p, "trace_target_ckpt": 2 * p,
                  "backtrace_exact": p, "trace_sdf_ckpt": 2 * p, "backtrace_sdf_exact": p}
    events = []
    K.reset_launches()
    K.record_events(events)
    n_big = s_big["x0"].shape[0]
    chunks = -(-n_big // CK.exact_chunk_rays())
    try:
        for sc, label, passes in ((s, "2^18", VARIANT_PASSES), (s_big, "2^20", 1)):
            for variant in EXACT_VARIANTS:
                case = exact_case(sc, variant)
                fn = {"plane": lambda r: tracer.trace_plane_exact(
                          r, case["x"], case["v"], sc["pln_o"][0], sc["pln_d"][0], sc["h"],
                          sc["ds"]),
                      "target": lambda r: tracer.trace_target_exact(
                          r, case["x"], case["v"], sc["tgt"][0], sc["h"], sc["ds"]),
                      "sdf": lambda r: tracer.trace_sdf_exact(
                          r, sc["sdf"], case["x"], case["v"], sc["h"], sc["ds"])}[variant]
                ms = []
                for _ in range(passes):
                    r = sc["rif"].detach().clone().requires_grad_(True)
                    torch.cuda.synchronize()
                    t0 = time.time()
                    out = fn(r)
                    loss = ((out[0] - case["anchor"]) ** 2).sum() + out[1].sum()
                    loss.backward()
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.time() - t0))
                    g = r.grad
                    if g is None or not bool(torch.isfinite(g).all()) or \
                            not float(g.abs().max()) > 0:
                        raise AssertionError(f"trace_{variant}_exact at {label}: the gradient is "
                                             "missing, not finite or zero")
                rec[f"{variant} {label}"] = dict(
                    ms_per_call=median(ms[1:]) if passes > 1 else ms[0],
                    loss=float(loss.detach()))
            if label == "2^18":
                torch.cuda.synchronize()
                small = dict(K.LAUNCHES)
                if small != want_small:
                    raise AssertionError(f"the exact variants at 2^18 rays must launch "
                                         f"{want_small}, counted {small}")
    finally:
        K.record_events(None)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {**{name: 0 for name in build.KERNELS},
            "trace_plane_ckpt": p + 1 + chunks, "backtrace_plane_exact": p + chunks,
            "trace_target_ckpt": 2 * (p + 1 + chunks), "backtrace_exact": p + chunks,
            "trace_sdf_ckpt": 2 * (p + 1 + chunks), "backtrace_sdf_exact": p + chunks}
    if launches != want:
        raise AssertionError(f"the exact variants must launch {want}, counted {launches}")
    by_name = {}
    for n_, a, b in events:
        by_name.setdefault(n_, []).append(a.elapsed_time(b))
    per_launch = {}
    for name, ms in by_name.items():
        if name in ("trace_target_ckpt", "trace_sdf_ckpt"):  # pass 1 and pass 2 in turn
            per_launch[f"{name} pass 1"] = median(ms[2:2 * p:2])
            per_launch[f"{name} pass 2"] = median(ms[3:2 * p:2])
        else:
            per_launch[name] = median(ms[1:p])
    rec.update(launches=launches, ms_per_launch=per_launch, chunks=chunks)
    rec["launches_2^18"] = small
    print(f"exact variants path (tracer.trace_*_exact at {tuple(s['rif'].shape)}, "
          f"{s['x0'].shape[0]} rays x {p} calls each, then {n_big} rays in {chunks} chunks once "
          f"each): ms a call forward + backward "
          + ", ".join(f"{k} {v['ms_per_call']:.3f}" for k, v in rec.items()
                      if isinstance(v, dict) and "ms_per_call" in v)
          + "; ms a launch (2^18) " + ", ".join(f"{k} {v:.4f}" for k, v in per_launch.items())
          + f"; launches {launches}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# the 2008 path-matrix baseline (pathmatrix.fuel2008), phase p
# ---------------------------------------------------------------------------

# the repo's configuration combo_recon16_hermite (run_fuel2008_finish.py): 32
# views of 64^2 x 4 = 524,288 rays through the 65^3 fuel volume, a 16^3
# reconstruction, hermite paths; the JAX package's rel_norm on its own rays
# (results/fuel2008_sweep/sweep.jsonl) and the band outside which a run on the
# port's rays is a fault, not a number
F2008_CONFIG = dict(nviews=32, nbins=64, spp=4, int_res=256, recon_res=16, spline="hermite",
                    seed=0)
F2008_JAX_REL_NORM = 0.8619833885451604
F2008_BAND = (0.82, 0.91)
# combo_recon16_true: the same with the recorded trajectories every 8 steps
# (spline "true", path_stride 8, as run_fuel2008_sweep3.py runs the true
# paths); the JAX package's rel_norm in it, on its own rays, printed by
# tools/jax_fuel2008_reference.py (CPU), and the band of +-5 % around it that
# the port's, on other rays, must lie in (the hermite run's band is as wide)
F2008_TRUE_CONFIG = dict(F2008_CONFIG, spline="true", path_stride=8)
F2008_TRUE_JAX_REL_NORM = 0.8633881328551197
F2008_TRUE_BAND = (0.95 * F2008_TRUE_JAX_REL_NORM, 1.05 * F2008_TRUE_JAX_REL_NORM)


def fuel2008_small_check(spline="hermite"):
    """A tiny ``fuel_reconstruction`` on the card against ``device="cpu"`` on the
    same rays, f64: the reconstruction within 1e-12 of its largest entry."""
    params = dict(nviews=4, nbins=8, spp=2, int_res=64, recon_res=8, spline=spline)
    gt = voxel_scenes.gaussian_bump(17, 1.0, amp=5e-4, dtype=torch.float64, device="cuda")
    rays = fuel2008.gen_rays(params, device="cpu")
    rec_gpu, rep_gpu = fuel2008.fuel_reconstruction(gt, params, rays=rays)
    rec_cpu, rep_cpu = fuel2008.fuel_reconstruction(gt.cpu(), params, rays=rays, device="cpu")
    err = float(abs(rec_gpu - rec_cpu).max() / max(1.0, abs(rec_cpu).max()))
    print(f"fuel2008[{spline}, f64 17^3, {rays.x.shape[0]} rays] card against CPU: "
          f"reconstruction rel_err {err:.3e} (tol 1e-12), rel_norm "
          f"{rep_gpu['rel_err_norm']:.6g} / {rep_cpu['rel_err_norm']:.6g}", flush=True)
    if not err <= 1e-12 or rep_gpu["phi_nnz"] != rep_cpu["phi_nnz"]:
        raise AssertionError("fuel_reconstruction on the card disagrees with the CPU")


def fuel2008_path(config=F2008_CONFIG, label="combo_recon16_hermite", band=F2008_BAND,
                  jax_rel_norm=F2008_JAX_REL_NORM):
    """``fuel2008.fuel_reconstruction`` on the card in a configuration of the
    repo's (``combo_recon16_hermite``, or ``combo_recon16_true``) on the 65^3
    fuel volume in f64, as the JAX driver runs it: one K2 launch (the
    ground-truth trace), one K20 for the true paths (the recorded
    trajectories), one K1 (the error's field evaluation), the native marcher,
    LSQR on the host."""
    gt = voxel_scenes.fuel_injection_rif(dtype=torch.float64, device="cuda")
    K.reset_launches()
    recon, rep = fuel2008.fuel_reconstruction(gt, config)
    launches = dict(K.LAUNCHES)
    want = {**{name: 0 for name in build.KERNELS}, "trace_fwd": 1, "eval_grad": 1,
            "record_paths": int(config["spline"] == "true")}
    if launches != want:
        raise AssertionError(f"fuel_reconstruction must launch {want}, counted {launches}")
    if native_loader._lib is None:
        raise AssertionError("fuel_reconstruction did not load the native marcher")
    if recon.shape != (16, 16, 16) or not np.isfinite(recon).all():
        raise AssertionError("fuel_reconstruction: the reconstruction is misshapen or not finite")
    lo, hi = band
    rec = dict(launches=launches, **{k: rep[k] for k in (
        "num_rays", "trace_time", "phi_time", "phi_nnz", "solve_time", "integration_time",
        "total_time", "rel_err_norm", "max_err", "l1_err", "process_peak_rss_mb")},
        jax_rel_norm=jax_rel_norm, band=band)
    print(f"fuel2008[{label}, f64 65^3, 524,288 rays]: " + json.dumps(rec), flush=True)
    if not lo <= rep["rel_err_norm"] <= hi:
        raise AssertionError(f"fuel_reconstruction's rel_norm {rep['rel_err_norm']:.4f} lies "
                             f"outside {band} (the JAX package's: {jax_rel_norm:.5f})")
    return rec


# ---------------------------------------------------------------------------
# K20 record_paths, the 2008 baseline's recorded trajectories
# ---------------------------------------------------------------------------

# the small check's strides: 8 divides its 136 steps' bound (17^3, ds = h/2), 3 does not
RECORD_STRIDES = (8, 3)


def record_paths_case(rif, h, ds, x0, v0, stride, label, order=None):
    """K20 against its plain version on the card: the float32 records bitwise
    (the plain version's f64 positions cast as the kernel casts them).  In
    f64 the label names the stencil's division the grid takes (the exact
    multiply where h is a power of two, ``wrappers.exact_reciprocal``)."""
    plain = fuel2008.record_paths_plain(rif, x0, v0, h, ds, stride)
    nrec = plain.shape[0]
    got = K.record_paths(rif, h, x0, v0, ds, nrec, stride, order)
    want = plain.to(torch.float32).reshape(-1, 3)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bitwise = bool(torch.equal(got, want))
    division = ("" if rif.dtype != torch.float64 else
                ", h = %r: %s" % (h, "the multiply" if K.exact_reciprocal(h) else "the operator"))
    print(f"K20[{label}, stride {stride}, {nrec} records{', ordered' if order is not None else ''}"
          f"{division}] bitwise: {bitwise} (max abs err {err})", flush=True)
    return err, [] if bitwise else [f"K20 record_paths differs from its plain version ({label}, "
                                    f"stride {stride}): max abs {err}"]


def record_paths_checks():
    """K20 bitwise against its plain version: 17^3 x 512 f64 with strides 8 and
    3 (the step bound not a multiple), two more rays that start outside and
    never enter (h = 1.25: the stencil's division by the operator); 2^15 of
    ``combo_recon16_true``'s rays through the 65^3 fuel volume in f64 (h =
    1/64: by the exact multiply), and the same volume and rays scaled to h =
    0.9/64 (the operator), each with and without the ray order; then at that
    configuration's full width (524,288 rays, 66
    records), the main path's call, with and without the ray order: bitwise
    against the plain version on the same rays, its times beside the plain
    version's, and its bounds.  ``max_abs_err`` is the largest of the
    comparisons at 2^15 rays and at full width."""
    failures = []
    s = scene(17, 512, "float64", noise=0.02)
    out = torch.tensor([[-s["h"], -s["h"], -s["h"]], [2 * s["span"], s["span"] / 2, 0.1]],
                       dtype=torch.float64, device="cuda")
    x0 = torch.cat([s["x0"], out]).contiguous()
    v0 = torch.cat([s["v0"], torch.tensor([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                                          dtype=torch.float64, device="cuda")]).contiguous()
    for stride in RECORD_STRIDES:
        failures += record_paths_case(s["rif"], s["h"], s["ds"], x0, v0, stride,
                                      "f64 17^3 x 514, 2 outside")[1]
    gt = voxel_scenes.fuel_injection_rif(dtype=torch.float64, device="cuda")
    h = 1.0 / (gt.shape[0] - 1)
    ds = h / 2
    stride = F2008_TRUE_CONFIG["path_stride"]
    rays = fuel2008.gen_rays(F2008_TRUE_CONFIG, device="cuda")
    x, v = rays.x.contiguous(), rays.v.contiguous()
    n = x.shape[0]
    sub = slice(0, 1 << 15)
    err, fails = record_paths_case(gt, h, ds, x[sub].contiguous(), v[sub].contiguous(), stride,
                                   "combo_recon16_true, f64 65^3, 2^15 rays")
    failures += fails
    failures += record_paths_case(gt, h, ds, x[sub].contiguous(), v[sub].contiguous(), stride,
                                  "combo_recon16_true, f64 65^3, 2^15 rays",
                                  O.ray_order(x[sub], v[sub], gt.shape, h))[1]
    # the same volume and rays at a spacing that is not a power of two: the
    # stencil's division by the operator (the 17^3 scene's h = 1.25 too)
    hq = K20_OPERATOR_H
    xq, vq = (x[sub] * (hq / h)).contiguous(), v[sub].contiguous()
    for o_ in (None, O.ray_order(xq, vq, gt.shape, hq)):
        failures += record_paths_case(gt, hq, hq / 2, xq, vq, stride,
                                      "combo_recon16_true's volume at h = 0.9/64, 2^15 rays",
                                      o_)[1]
    if K.exact_reciprocal(s["h"]) or K.exact_reciprocal(hq) or not K.exact_reciprocal(h):
        failures.append("K20's checks must run both f64 divisions: the operator at h = "
                        f"{s['h']!r} and {hq!r}, the multiply at {h!r}")
    order = O.ray_order(x, v, gt.shape, h)
    nrec, steps = fuel2008.record_steps(gt.shape[0], h, ds, stride)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    ms = time_ms(lambda: K.record_paths(gt, h, x, v, ds, nrec, stride), 5, flush)
    ms_ordered = time_ms(lambda: K.record_paths(gt, h, x, v, ds, nrec, stride, order), 5, flush)
    work = {}
    torch.cuda.synchronize()
    t0 = time.time()
    plain = fuel2008.record_paths_plain(gt, x, v, h, ds, stride, stats=work)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.time() - t0)
    del flush
    # the main path's call, at its full width, bitwise against the plain version
    want = plain.to(torch.float32).reshape(-1, 3)
    del plain
    full_errs, full_bitwise = {}, True
    for label, o in (("caller's order", None), ("ray order", order)):
        got = K.record_paths(gt, h, x, v, ds, nrec, stride, o)
        full_errs[label] = float((got - want).abs().max())
        if not torch.equal(got, want):
            full_bitwise = False
            failures.append(f"K20 record_paths differs from its plain version at full width "
                            f"({n} rays, {label}): max abs {full_errs[label]}")
        del got
    del want
    print(f"K20[combo_recon16_true, f64 65^3, all {n} rays, stride {stride}, {nrec} records] "
          f"bitwise: {full_bitwise} (max abs err {json.dumps(full_errs)})", flush=True)
    err = max(err, *full_errs.values())
    # each input read once, the records written once; K20's step is K2's
    rec = set_bound(dict(
        bytes=nrec * n * 3 * 4 + 2 * n * 3 * 8 + gt.numel() * 8,
        flops=work["ray_steps"] * FLOPS_FWD_STEP + work["evals"] * FLOPS_FWD_EVAL),
        PEAK_F64_FLOPS)
    rec.update(ms=ms, ms_ordered=ms_ordered, plain_ms=plain_ms, library_ms=None,
               max_abs_err=err, full_width_bitwise=full_bitwise, rays=n, records=nrec, steps=steps, stride=stride, work=work,
               bytes_bound_ms=1e3 * rec["bytes"] / PEAK_BYTES_PER_S,
               ops_bound_ms=1e3 * rec["flops"] / PEAK_F64_FLOPS,
               record_mb=nrec * n * 12 / 1e6)
    print(f"K20[combo_recon16_true, f64 65^3, {n} rays, {nrec} records of {stride} steps]: "
          f"{ms:.4f} ms (ray order: {ms_ordered:.4f} ms), plain {plain_ms:.1f} ms; records "
          f"{rec['record_mb']:.1f} MB; {work['ray_steps']} ray-steps, {work['evals']} "
          f"evaluating; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} (bytes "
          f"{rec['bytes_bound_ms']:.4f}, f64 operations {rec['ops_bound_ms']:.4f}) = "
          f"{100 * rec['bound_ms'] / ms:.1f} %", flush=True)
    return rec, failures


# ---------------------------------------------------------------------------
# phase m: the ray mesh (parallel/) and fuel-128
# ---------------------------------------------------------------------------

FUEL128_ITERS = 10


def mesh_bench_check():
    """``make_sharded_trace`` and ``make_sharded_trace_exact`` on this process's
    mesh (one rank: one card) on the bench scene (128^3 f32, 2^18 rays)
    against ``api.trace`` and ``trace_exact``: the outputs bitwise, the
    gradients within 1e-5 of the largest entry of the unsharded path's (the
    atomic adds of both sum in no fixed order), the launches those of the
    unsharded path plus the exact path's recomputed checkpoints."""
    s = scene(RES, NRAYS, "float32")
    mesh = parallel.make_ray_mesh()
    if mesh.world_size != 1:
        raise AssertionError(f"one process must make a mesh of one rank, got {mesh}")
    failures, rec = [], {}
    target = s["target"]
    for label, sharded, plain in (
            ("make_sharded_trace", parallel.make_sharded_trace(mesh, s["h"], s["ds"], RES),
             lambda r, a, b: api.trace(r, a, b, s["h"], s["ds"])),
            ("make_sharded_trace_exact",
             parallel.make_sharded_trace_exact(mesh, s["h"], s["ds"], RES, seg=SEG),
             lambda r, a, b: tracer.trace_exact(r, a, b, s["h"], s["ds"], SEG))):
        outs = []
        for fn in (sharded, plain):
            r = s["rif"].clone().requires_grad_(True)
            K.reset_launches()
            xt, vt = fn(r, s["x0"], s["v0"])
            (((xt - target) ** 2).sum() + vt.sum()).backward()
            torch.cuda.synchronize()
            outs.append((xt.detach(), vt.detach(), r.grad, dict(K.LAUNCHES)))
        (xs, vs, gs, ls), (xp, vp, gp, lp) = outs
        bitwise = bool(torch.equal(xs, xp) and torch.equal(vs, vp))
        err = float((gs - gp).abs().max() / gp.abs().max())
        want = dict(lp)
        if label.endswith("exact"):
            want["trace_ckpt"] += 1  # the sharded backward recomputes the checkpoints
        rec[label] = dict(bitwise=bitwise, grad_rel_err=err, launches={
            k: v for k, v in ls.items() if v})
        print(f"mesh[{label}, one rank, f32 {RES}^3 x {NRAYS}] outputs bitwise: {bitwise}; "
              f"gradient against the unsharded path's {err:.3e} of its largest entry (tol "
              f"{TOL_F32_GRAD:g}); launches {rec[label]['launches']}", flush=True)
        if not bitwise or not err <= TOL_F32_GRAD or ls != want:
            failures.append(f"{label} on one rank disagrees with the unsharded path: bitwise "
                            f"{bitwise}, gradient {err:.3e}, launches {ls} (want {want})")
    return rec, failures


def fuel128_params():
    return runner.cfg.load_params(os.path.join(CONFIGS, "params-fuel.yaml"), "fuel-128")


def fuel128_path(iters=FUEL128_ITERS):
    """``configs/params-fuel.yaml`` ``fuel-128`` through ``runner.run`` at full
    width as a user runs it (``mesh: true``: the ray mesh of one rank on one
    card; seven stages to 129^3, 32 views of 128^2 x 4 spp = 2,097,152 rays;
    f32; spot checks and escalation on), ``optim_iters`` cut from 300 to
    ``iters``.  Every kernel's launches asserted per stage and in all
    for the stage the escalation fired at; per stage the step time, the
    kernels' time (events around the launches), the host's share and the
    loss; the final ``reconstruction_error``.  ``iters=300`` is the shipped
    run (8,400 steps)."""
    params = dict(fuel128_params(), optim_iters=iters)
    if not params.get("mesh") or "ANRT_EXACT_TOL" in os.environ \
            or "ANRT_BUCKETED" in os.environ:
        raise AssertionError("fuel-128 must run on the mesh, as a user runs it")
    res_list, iters = params["res_list"], params["optim_iters"]
    nrays = params["nviews"] * params["nbins"] ** 2 * params["spp"]
    step_rows, events = [], []

    def stat(it, loss, secs):
        step_rows.append((it, loss, secs, len(events)))

    metrics = MetricsLogger()
    K.reset_launches()
    K.record_events(events)
    t0 = time.time()
    try:
        eta, hist, gtruth = runner.run(os.path.join(CONFIGS, "params-fuel.yaml"), "fuel-128",
                                       overrides=dict(optim_iters=iters), device="cuda",
                                       stat_fn=stat, metrics=metrics)
        torch.cuda.synchronize()
    finally:
        K.record_events(None)
    seconds = time.time() - t0
    launches, paths = dict(K.LAUNCHES), kernel_paths()
    escalated = escalation_stage(metrics)
    if run_buckets(metrics, nrays) != 1:
        raise AssertionError("fuel-128 took exit-step buckets on the card")
    steps, want, want_paths, want_stages = expected_launches(params, escalated, nrays, 1,
                                                             mesh=True)
    got_stages, after = stage_launches(events, step_rows, params)
    chunks = len(CK._chunks(nrays, CK.exact_chunk_rays()))
    print(f"fuel128[params-fuel.yaml fuel-128, mesh of one rank] {nrays} rays, stages "
          f"{res_list}, optim_iters {iters} (shipped {FUEL_ITERS_SHIPPED}): {steps} Adam steps "
          f"in {seconds:.2f} s; escalated at stage {escalated}; the exact path's batch is "
          f"{chunks} chunks; launches {launches}; by path {paths}", flush=True)
    if escalated is None:
        raise AssertionError("fuel-128 never escalated: K5 and K6 are not on its path")
    if launches != want or paths != want_paths or got_stages != want_stages or after:
        raise AssertionError(f"fuel-128 must launch {want}, by path {want_paths}, by stage "
                             f"{want_stages}, counted {launches}, {paths}, {got_stages} and "
                             f"{len(after)} after the last step")
    if nrays != 2097152 or len(hist) != steps or len(step_rows) != steps \
            or not all(map(math.isfinite, hist)) or not hist[-1] < hist[0]:
        raise AssertionError("fuel-128 is not at full width, lost steps or did not learn")
    if eta.shape != (129,) * 3 or eta.dtype != torch.float32 or not eta.is_cuda \
            or not bool(torch.isfinite(eta).all()):
        raise AssertionError("fuel-128's field is not a finite 129^3 f32 tensor on the card")
    per_stage, first = [], 0
    for s_, r in enumerate(res_list):
        rows = step_rows[first:first + iters * (s_ + 1)]
        first += len(rows)
        exact = s_ >= escalated
        names = (("trace_fwd", "backtrace") if not exact else
                 ("trace_ckpt",) + ("trace_ckpt", "backtrace_exact") * chunks)
        kern = []
        for row in rows:
            own = events[row[3] - len(names):row[3]]
            if tuple(n_ for n_, _, _ in own) != names:
                raise AssertionError(f"fuel-128: a step's launches at stage {s_} are not {names}")
            kern.append(sum(a.elapsed_time(b) for _, a, b in own))
        med, kmed = median([1e3 * row[2] for row in rows]), median(kern)
        per_stage.append(dict(res=r, steps=len(rows), gradient="exact" if exact else "adjoint",
                              step_ms_median=med, kernel_ms_median=kmed,
                              host_share=(med - kmed) / med, rays_per_s=nrays / (1e-3 * med),
                              loss_last=rows[-1][1], launches=got_stages[s_]))
        print(f"fuel128 stage {s_} {r}^3 ({per_stage[-1]['gradient']}): {len(rows)} steps, "
              f"median {med:.3f} ms/step = {nrays / (1e-3 * med):.4g} rays/s; kernels "
              f"{kmed:.3f} ms ({100 * kmed / med:.1f} %), host and small kernels "
              f"{med - kmed:.3f} ms; loss {rows[-1][1]:.6g}", flush=True)
    err = fuel_injection.reconstruction_error(eta, gtruth, background=1.0 + params["fuel_val"])
    print(f"fuel128: loss {hist[0]:.6g} -> {hist[-1]:.6g}; reconstruction_error "
          f"{json.dumps(err)}", flush=True)
    return dict(seconds=seconds, steps=steps, nrays=nrays, launches=launches, paths=paths,
                escalated=escalated, chunks=chunks, per_stage=per_stage, loss_first=hist[0],
                loss_last=hist[-1], **err)


def fuel128_small_check():
    """``fuel-128``'s mesh path in f64 at a small size (stages [3, 5, 9], 2 views
    of 8^2 x 4 spp = 512 rays, 3 iterations a stage, escalation forced at
    stage 1 so that the sharded exact path runs too) on the card against the
    CPU, on the same rays: loss history and field within 1e-9."""
    params = dict(fuel128_params(), res_list=[3, 5, 9], nviews=2, nbins=8, optim_iters=3,
                  dtype="float64")
    rays, _ = fuel_injection.gen_start_rays(params, torch.Generator().manual_seed(0),
                                            torch.float64)
    gtruth = voxel_scenes.fuel_injection_rif(params["fuel_val"], torch.float64, "cpu")
    out = {}
    os.environ["ANRT_EXACT_TOL"] = "-1"
    try:
        for device in ("cuda", "cpu"):
            metrics = MetricsLogger()
            K.reset_launches()
            eta, hist, _ = fuel_injection.run_opt(params, None, gtruth, rays=rays, device=device,
                                                  metrics=metrics)
            out[device] = (eta, hist, escalation_stage(metrics), dict(K.LAUNCHES), metrics)
    finally:
        del os.environ["ANRT_EXACT_TOL"]
    (eta_g, hist_g, esc_g, launches, _), (eta_c, hist_c, esc_c, cpu_launches, _) = \
        out["cuda"], out["cpu"]
    steps, want, _, _ = expected_launches(params, esc_g, rays.x.shape[0], 1,
                                          run_buckets(out["cuda"][4], rays.x.shape[0]),
                                          mesh=True)
    hist_err = max(abs(a - b) / abs(b) for a, b in zip(hist_g, hist_c))
    scale = float((eta_c - (1.0 + params["fuel_val"])).abs().max())
    eta_err = float((eta_g.cpu() - eta_c).abs().max()) / scale
    print(f"fuel128[f64 {params['res_list']}, {rays.x.shape[0]} rays, {steps} steps, mesh, "
          f"escalated at stage {esc_g}] card against CPU: loss history rel_err "
          f"{hist_err:.3e}, final field err {eta_err:.3e} of its largest deviation "
          f"({scale:.3e}) (tol {TOL_F64:g}); launches on the card {launches}", flush=True)
    if esc_g != 1 or esc_c != 1 or launches != want or any(cpu_launches.values()):
        raise AssertionError(f"fuel-128 small: escalated {esc_g} / {esc_c}, launched {launches} "
                             f"(want {want}) and {cpu_launches} on the CPU")
    if not (hist_err <= TOL_F64 and eta_err <= TOL_F64 and scale > 0):
        raise AssertionError("fuel-128's mesh path on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# exit-step compaction (tracer/compaction.py)
# ---------------------------------------------------------------------------

def compaction_check(eta):
    """``compaction.trace_bucketed`` against ``api.trace`` on the card on a batch
    whose chord spread is at least 3: one Luneburg step's rays (983,040; a
    randomly turned set of cube faces, the source whose chord spread passes
    the JAX rule's threshold where its rotation spreads the chords) through the Luneburg run's field
    resampled to 17^3, its last adjoint stage, in the buckets
    ``auto_buckets`` picks for them.  Outputs bitwise, the gradient within
    1e-5 of the largest entry of ``api.trace``'s (sums in another order),
    launches 4 K2 + 4 K3 against 1 + 1, and the times of forward + backward
    (CUDA events, the median of 5, alternated).  ``make_trace`` given these
    rays as its probe on the card must take no buckets (its rule there)."""
    params = driver_params("luneburg")
    rays = driver_draw("luneburg", params, torch.Generator(device="cuda").manual_seed(4242))
    x, v = rays.x.contiguous(), rays.v.contiguous()
    span, res = params["vol_span"], 17
    h, ds = span / (res - 1), span / (params["res_list"][-1] - 1) / params["step_res"]
    rif = G.upres_volume(eta, res).contiguous()
    spread = compaction.chord_spread(rif.shape, h, x, v, ds)
    nb = compaction.auto_buckets(span, x, v, ds)
    if "ANRT_BUCKETED" in os.environ:
        raise AssertionError("ANRT_BUCKETED is set: make_trace's rule on the card is not seen")
    card_pick = common.make_trace(span, ds, probe_rays=(x[:4096], v[:4096])).nbuckets
    outs, times = {}, {"bucketed": [], "whole": []}
    fns = {"bucketed": lambda r: compaction.trace_bucketed(r, x, v, h, ds, nb),
           "whole": lambda r: api.trace(r, x, v, h, ds)}

    def run(name):
        r = rif.clone().requires_grad_(True)
        K.reset_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        xt, vt = fns[name](r)
        (xt ** 2 + xt * vt).sum().backward()
        stop.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(stop))
        return xt.detach(), vt.detach(), r.grad, dict(K.LAUNCHES)

    for i in range(6):
        for name in (("bucketed", "whole") if i % 2 else ("whole", "bucketed")):
            outs[name] = run(name)
    (xb, vb, gb, lb), (xw, vw, gw, lw) = outs["bucketed"], outs["whole"]
    bitwise = bool(torch.equal(xb, xw) and torch.equal(vb, vw))
    err = float((gb - gw).abs().max() / gw.abs().max())
    want = {**{n_: 0 for n_ in build.KERNELS}, "trace_fwd": nb, "backtrace": nb}
    rec = dict(buckets=nb, make_trace_buckets=card_pick, spread=spread, rays=x.shape[0], res=res,
               bitwise=bitwise,
               grad_rel_err=err, launches={k: v_ for k, v_ in lb.items() if v_},
               ms_bucketed=median(times["bucketed"][1:]), ms_whole=median(times["whole"][1:]))
    print(f"compaction[luneburg step, {x.shape[0]} rays, 17^3, chord spread {spread:.3f}, "
          f"{nb} buckets] outputs bitwise: {bitwise}; gradient against api.trace's {err:.3e} "
          f"(tol {TOL_F32_GRAD:g}); launches {rec['launches']}; forward + backward "
          f"{rec['ms_bucketed']:.3f} ms bucketed, {rec['ms_whole']:.3f} ms whole; make_trace "
          f"with this probe on the card takes {card_pick}", flush=True)
    failures = []
    if card_pick != 0 or nb != 4 or not spread >= 3.0 or not bitwise or not err <= TOL_F32_GRAD or lb != want \
            or lw["trace_fwd"] != 1 or lw["backtrace"] != 1:
        failures.append(f"trace_bucketed on the card: {rec}")
    return rec, failures


def luneburg_bucket_steps(rounds=3):
    """The Luneburg driver's adjoint stages (3^3 .. 17^3) through
    ``runner.run``, 10 iterations a stage (100 steps), with 4 exit-step
    buckets (``ANRT_BUCKETED=4``, what its probe picks where the rotation
    spreads the chords) and with none (``ANRT_BUCKETED=0``), alternated over
    ``rounds``: the median ms a step per stage of each."""
    overrides = dict(res_list=[3, 5, 9, 17], optim_iters=10, record_iters=10 ** 9,
                     grad_spotcheck=False, auto_exact=False)
    yaml_name, section = DRIVERS["luneburg"]
    out = {"buckets": [], "whole": []}
    for i in range(2 * rounds):
        name = ("buckets", "whole")[i % 2]
        rows = []
        os.environ["ANRT_BUCKETED"] = "4" if name == "buckets" else "0"
        try:
            runner.run(os.path.join(CONFIGS, yaml_name), section, overrides=overrides,
                       device="cuda", stat_fn=lambda it, loss, secs: rows.append(1e3 * secs))
        finally:
            os.environ.pop("ANRT_BUCKETED", None)
        out[name].append(rows)
    rec = {}
    for name, runs in out.items():
        rec[name] = {f"{r}^3": median([ms for run in runs for ms in
                                        run[10 * s * (s + 1) // 2:10 * (s + 1) * (s + 2) // 2]])
                     for s, r in enumerate(overrides["res_list"])}
    print("luneburg adjoint stages, median ms a step: with 4 buckets "
          + json.dumps(rec["buckets"]) + "; ANRT_BUCKETED=0 " + json.dumps(rec["whole"]),
          flush=True)
    return rec


# forward + adjoint passes of the main path: bench.run's warm-up and timed
# iterations, and the pass made here through api.trace
# ---------------------------------------------------------------------------
# phase s: the sharded variants and the z-slab ring (parallel/), K21 and K22
# ---------------------------------------------------------------------------

SLAB_KERNELS = ("slab_trace_phase", "slab_backtrace_phase")
# configuration 14: the bench field at 1025^3 f32 (4.3 GB), z-crossing rays
SLAB_RES = 1025
# the one-phase kernel check: a 65^3 grid in 4 slabs, the phase of slab 1,
# 2^15 rays spread through the grid; its band sweep in bands of 3 cell rows
# (the L2 rule would give this small slab one band)
SLAB_CHECK_RES, SLAB_CHECK_SLABS, SLAB_CHECK_RAYS = 65, 4, 1 << 15
SLAB_CHECK_BAND = 3
# a phase's steps in the check whose cap ends rays inside the slab
SLAB_CHECK_CAP = 5
# the replays that time a phase's band sweep, and the busy wait before each
# (~20 ms: longer than the host takes to enqueue a sweep's few hundred launches)
SLAB_REPS, SLAB_BUSY_CYCLES = 3, 40_000_000
# the launches of one forward + backward of each sharded variant at one rank:
# the unsharded call's, no more
SHARDED_LAUNCHES = {
    "plane_plain": {"trace_plane": 1, "backtrace": 1},
    "plane_exact": {"trace_plane_ckpt": 1, "backtrace_plane_exact": 1},
    "target_plain": {"trace_target": 2, "backtrace": 1},
    "target_exact": {"trace_target_ckpt": 2, "backtrace_exact": 1},
    "sdf_plain": {"trace_sdf": 2, "backtrace_sdf": 1},
    "sdf_exact": {"trace_sdf_ckpt": 2, "backtrace_sdf_exact": 1},
    "cable_plain": {"trace_cable": 1, "backtrace_cable": 1},
    "cable_exact": {"trace_cable_ckpt": 1, "backtrace_cable_exact": 1},
}


def sharded_variants_check(s, cab):
    """Phase s (a): ``parallel.make_sharded_trace_{plane,target,sdf,cable}``,
    plain and exact, on this process's mesh (one rank) against the unsharded
    calls: configuration v's scene (128^3 f32, 2^18 rays, planes at y = 0.6
    span, targets at y = 1.05 span, 2^18 rays spawned on the sphere sdf) and
    the fiber path's cable (129 bins, a step's 8,192 rays).  Outputs bitwise,
    the gradient within 1e-5 of the unsharded one's largest entry, the
    launches of each exactly the unsharded call's (``SHARDED_LAUNCHES``).
    Returns the record, the sharded runs' launches summed, and failures."""
    mesh = parallel.make_ray_mesh()
    if mesh.world_size != 1:
        raise AssertionError(f"one process must make a mesh of one rank, got {mesh}")
    h, ds, span = s["h"], s["ds"], s["span"]
    x0, v0, o, d, tgt = s["x0"], s["v0"], s["pln_o"], s["pln_d"], s["tgt"]
    xs, vs, sdf = s["xs"], s["vs"], s["sdf"]
    prof, cx, cv, ct = cab["prof"], cab["x"], cab["v"], cab["target"]
    rad, length, cds = cab["radius"], cab["length"], cab["ds"]
    centre = torch.full((3,), span / 2, dtype=s["rif"].dtype, device="cuda")
    rec, failures, total = {}, [], {name: 0 for name in build.KERNELS}
    for mode in ("plain", "exact"):
        ex = mode == "exact"
        calls = {
            "plane": (parallel.make_sharded_trace_plane(mesh, h, ds, RES, exact=ex, seg=SEG),
                      (lambda r: tracer.trace_plane_exact(r, x0, v0, o, d, h, ds, SEG)) if ex
                      else (lambda r: api.trace_plane(r, x0, v0, o, d, h, ds)),
                      (x0, v0, o, d), tgt, s["rif"]),
            "target": (parallel.make_sharded_trace_target(mesh, h, ds, RES, exact=ex, seg=SEG),
                       (lambda r: tracer.trace_target_exact(r, x0, v0, tgt, h, ds, SEG)) if ex
                       else (lambda r: api.trace_target(r, x0, v0, tgt, h, ds)),
                       (x0, v0, tgt), tgt, s["rif"]),
            "sdf": (parallel.make_sharded_trace_sdf(mesh, h, ds, RES, exact=ex, seg=SEG),
                    (lambda r: tracer.trace_sdf_exact(r, sdf, xs, vs, h, ds, SEG)) if ex
                    else (lambda r: api.trace_sdf(r, sdf, xs, vs, h, ds)),
                    (sdf, xs, vs), centre, s["rif"]),
            "cable": (parallel.make_sharded_trace_cable(mesh, rad, length, cds, exact=ex,
                                                        seg=SEG),
                      (lambda r: tracer.trace_cable_exact(r, rad, length, cx, cv, ct, cds, SEG))
                      if ex else (lambda r: api.trace_cable(r, rad, length, cx, cv, ct, cds)),
                      (cx, cv, ct), ct, prof),
        }
        for kind, (sharded, unsharded, args, aim, field) in calls.items():
            name = f"{kind}_{mode}"
            runs = []
            for fn in (lambda r: sharded(r, *args), unsharded):
                r = field.detach().clone().requires_grad_(True)
                K.reset_launches()
                torch.cuda.synchronize()
                t0 = time.time()
                out = fn(r)
                (((out[0] - aim) ** 2).sum() + out[1].sum()).backward()
                torch.cuda.synchronize()
                runs.append(([t.detach() for t in out], r.grad, dict(K.LAUNCHES),
                             1e3 * (time.time() - t0)))
            (os_, gs, ls, ms_s), (op, gp, lp, ms_p) = runs
            bitwise = all(torch.equal(a, b) for a, b in zip(os_, op))
            err = float((gs - gp).abs().max() / gp.abs().max())
            want = {**{k: 0 for k in build.KERNELS}, **SHARDED_LAUNCHES[name]}
            for k, n in ls.items():
                total[k] += n
            rec[name] = dict(bitwise=bitwise, grad_rel_err=err, ms=ms_s, unsharded_ms=ms_p,
                             launches={k: n for k, n in ls.items() if n})
            if kind == "target":
                rec[name]["d2_max"] = float(os_[2].max())
            if not bitwise or not err <= TOL_F32_GRAD or not float(gp.abs().max()) > 0:
                failures.append(f"sharded {name}: bitwise {bitwise}, gradient {err:.3e}")
            if ls != want or lp != want:
                failures.append(f"sharded {name}: launches {ls}, unsharded {lp}, want {want}")
    print("sharded variants at one rank (against the unsharded calls, host ms forward + "
          "backward): " + json.dumps(rec), flush=True)
    return rec, total, failures


def slab_check_case(dtype):
    """Phase s (b)'s inputs: the bench field at 65^3 padded for 4 slabs, the
    slab of rank 1 (voxel rows [S - 1, 2S), cell rows [S, 2S)), and 2^15
    rays with the bench's spread turned to z, spread through the grid's
    depth, half going +z, half -z."""
    res, ndev, n = SLAB_CHECK_RES, SLAB_CHECK_SLABS, SLAB_CHECK_RAYS
    span = 20.0
    h = span / (res - 1)
    S = parallel.slab_rows(res + 1, ndev)
    z_first = S - 1
    slab = scenes.bench_rows(res, z_first, z_first + S + 1, span, dtype).contiguous()
    x, v = scenes.z_rays(res, n, span, dtype, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x[:, 2] = torch.rand(n, generator=gen, device="cuda", dtype=x.dtype) * span
    la = torch.randn(x.shape, generator=gen, device="cuda", dtype=x.dtype)
    mu = torch.randn(x.shape, generator=gen, device="cuda", dtype=x.dtype)
    K_ = max(int(S * h / (h / 2)) * 2, 8)
    return dict(res=(res,) * 3, slab=slab, z_first=z_first, S=S, h=h, ds=h / 2, x=x, v=v,
                la=la, mu=mu, inner=K_, nf=E.max_steps_fwd(res, h, h / 2),
                nb=E.max_steps_bwd(res, h, h / 2))


def slab_kernel_check(dtype, tol, cap=None):
    """Phase s (b): K21 and K22 against their plain versions on one phase whose
    slab does not cover the grid, each as one launch over the slab and as the
    ring runs it, a band sweep (``K.slab_*_bands`` under
    ``slabs.sweep_bands``, bands of ``SLAB_CHECK_BAND`` cell rows), both held
    to the one plain phase over the slab.  K21: every state tensor and the
    pending word bitwise, the rays outside the slab frozen bit for bit, some
    rays moved; K22: x, v, active and the step counts bitwise, la, mu and the
    gradient slab within ``tol`` of their largest entries, the gradient also
    against the f64 sum of the plain version's terms.  With ``cap``, a
    phase's steps are ``cap`` and the rays start from step counts spread
    over [0, 40), so that the cap, counted across a sweep's launches from
    the counts at the phase's start, ends rays in the slab."""
    c = slab_check_case(dtype)
    shape = slabs._grid_shape(c["slab"], c["res"], c["h"])
    x, v = c["x"], c["v"]
    inner = c["inner"] if cap is None else cap
    gen = torch.Generator(device="cuda").manual_seed(6)
    cnt0 = (torch.zeros(x.shape[0], dtype=torch.int32, device="cuda") if cap is None else
            torch.randint(0, 40, (x.shape[0],), generator=gen, device="cuda",
                          dtype=torch.int32))
    held = slabs._in_window(c["res"], c["z_first"], c["S"] + 1, c["h"], x)
    init = [x, v, x, v, G.inbounds(shape, x), torch.zeros_like(held), cnt0]
    fwd, sweeps = {}, {}
    for kind in ("kernel", "bands", "plain"):
        st = [t.clone() for t in init]
        args = (c["slab"], c["res"], c["z_first"], c["h"], c["ds"], *st, c["nf"], inner)
        if kind == "kernel":
            flag = K.slab_trace_phase(*args)
        elif kind == "bands":
            flag, *sweeps["fwd"] = slabs.sweep_bands(K.slab_trace_bands(*args), c["S"],
                                                     SLAB_CHECK_BAND)
        else:
            flag = slabs.slab_trace_phase_plain(*args)
        fwd[kind] = (st, bool(flag[0]))
    stp, pp = fwd["plain"]
    fwd_bitwise = {k: all(torch.equal(a, b) for a, b in zip(fwd[k][0], stp)) and fwd[k][1] == pp
                   for k in ("kernel", "bands")}
    fwd_errs = [rel_err(fwd[k][0][i], stp[i]) for k in ("kernel", "bands")
                for i in range(4)]  # x, v, xt, vt
    stk = fwd["kernel"][0]
    frozen = all(torch.equal(a[~held], b[~held]) for a, b in zip(stk, init))
    moved = int((stk[6] > cnt0).sum())
    # the adjoint phase, from the rays' start state, with random cotangents
    xe = G.snap_to_nodes(x - c["ds"] * v, c["h"])
    held_b = slabs._in_window(c["res"], c["z_first"], c["S"] + 1, c["h"], xe)
    bwd = {}
    tol_snap = G.snap_tol(c["slab"].dtype)
    for kind in ("kernel", "bands", "plain", "plain f64 sum"):
        st = [x.clone(), v.clone(), c["la"].clone(), c["mu"].clone(),
              ~G.escaped(shape, x, -v), cnt0.clone()]
        gslab = torch.zeros_like(c["slab"], dtype=torch.float64 if kind.endswith("sum")
                                 else c["slab"].dtype)
        args = (c["slab"], c["res"], c["z_first"], c["h"], c["ds"], tol_snap, *st, gslab,
                c["nb"], inner)
        if kind == "kernel":
            K.slab_backtrace_phase(*args)
        elif kind == "bands":
            _, *sweeps["bwd"] = slabs.sweep_bands(K.slab_backtrace_bands(*args), c["S"],
                                                  SLAB_CHECK_BAND)
        else:
            slabs.slab_backtrace_phase_plain(*args)
        bwd[kind] = (st, gslab)
    (sp, gp), (_, g64) = bwd["plain"], bwd["plain f64 sum"]
    rec = dict(dtype=dtype, rays=SLAB_CHECK_RAYS, inner=inner, held_fwd=int(held.sum()),
               moved=moved, capped=int((stk[6] - cnt0 == inner).sum()),
               band=SLAB_CHECK_BAND, sweeps_launches=sweeps,
               fwd_bitwise=fwd_bitwise["kernel"], band_fwd_bitwise=fwd_bitwise["bands"],
               fwd_abs_err=max(e[1] for e in fwd_errs), fwd_rel_err=max(e[0] for e in fwd_errs),
               frozen_bitwise=frozen, tol=tol)
    ok = all(fwd_bitwise.values()) and frozen and moved > 0 and float(gp.abs().max()) > 0
    for kind, pre in (("kernel", ""), ("bands", "band_")):
        sk, gk = bwd[kind]
        state_bitwise = all(torch.equal(sk[i], sp[i]) for i in (0, 1, 4, 5))
        lm_err = max(rel_err(sk[i], sp[i])[0] for i in (2, 3))
        g_abs = float((gk - gp).abs().max())
        g_err = g_abs / float(gp.abs().max())
        g64_err = float((gk.double() - g64).abs().max() / g64.abs().max())
        rec.update({f"{pre}bwd_state_bitwise": state_bitwise, f"{pre}la_mu_rel_err": lm_err,
                    f"{pre}grad_abs_err": g_abs, f"{pre}grad_rel_err": g_err,
                    f"{pre}grad_rel_err_f64_sum": g64_err})
        ok = ok and state_bitwise and lm_err <= tol and min(g_err, g64_err) <= tol
    sk = bwd["kernel"][0]
    frozen_b = all(torch.equal(a[~held_b], b[~held_b])
                   for a, b in zip(sk, (x, v, c["la"], c["mu"])))
    rec["frozen_bitwise"] = frozen and frozen_b
    ok = ok and frozen_b
    ok = ok and (cap is None or rec["capped"] > 0)
    print(f"slab kernels[{dtype} {SLAB_CHECK_RES}^3 in {SLAB_CHECK_SLABS} slabs, the phase of "
          f"slab 1, {SLAB_CHECK_RAYS} rays, {inner} steps a phase; one launch and bands of "
          f"{SLAB_CHECK_BAND}]: " + json.dumps(rec), flush=True)
    return rec, [] if ok else [f"K21/K22 against their plain versions: {rec}"]


def slab_path():
    """Phase s (c): ``parallel.make_slab_trace_zsharded`` at one rank on
    configuration 14 (the bench field at 1025^3 f32, made on the card a block
    of rows at a time; 2^18 rays crossing z both ways), forward + backward,
    against ``api.trace``: outputs bitwise (K21 steps as K2), the gradient
    within 1e-5 of K3's largest entry; K21 and K22 launched exactly as the
    phases' band sweeps counted and nothing else; ms forward + backward of
    both (and of the ring with no launch timed), ms a phase and a launch
    from events around each launch, peak memory.  Then the plain phases on
    the same first phase's inputs, for the kernels' plain-version times and
    the bounds of that phase's work, and that phase's band sweep replayed on
    the card alone: the kernels' ms a phase."""
    res, n, span = SLAB_RES, NRAYS, 20.0
    h = span / (res - 1)
    ds = h / 2
    rif = scenes.bench_rows(res, 0, res, span, "float32")
    x, v = scenes.z_rays(res, n, span, "float32")
    centre = torch.full((3,), span / 2, dtype=torch.float32, device="cuda")

    def loss(xt, vt):
        return ((xt - centre) ** 2).sum() + vt.sum()

    r = rif.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.time()
    xt_a, vt_a = api.trace(r, x, v, h, ds)
    loss(xt_a, vt_a).backward()
    torch.cuda.synchronize()
    api_ms = 1e3 * (time.time() - t0)
    api_launches = {k: n_ for k, n_ in K.LAUNCHES.items() if n_}
    api_peak = torch.cuda.max_memory_allocated()
    g_ref = r.grad
    del r
    mesh = parallel.make_ray_mesh()
    f = parallel.make_slab_trace_zsharded(mesh, h, ds, res)
    rows = parallel.pad_rif_z(rif, 1).requires_grad_(True)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.reset_launches()
    K.record_events(events)
    try:
        t0 = time.time()
        xt, vt = f(rows, x, v)
        loss(xt, vt).backward()
        torch.cuda.synchronize()
        slab_ms = 1e3 * (time.time() - t0)
    finally:
        K.record_events(None)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(K.LAUNCHES)
    g = rows.grad[:res].clone()
    g[-1] += rows.grad[res:].sum(dim=0)
    bitwise = bool(torch.equal(xt, xt_a) and torch.equal(vt, vt_a))
    out_errs = [rel_err(a.detach(), b.detach()) for a, b in ((xt, xt_a), (vt, vt_a))]
    err = float((g - g_ref).abs().max() / g_ref.abs().max())
    phases = dict(f.ring.phases_run)
    # each phase is a band sweep: (band, launches a sweep, sweeps, launches),
    # the launches counted by the sweep: every sweep makes the launches of
    # slabs.band_windows for the slab's cell rows and the band
    runs = {key: list(f.ring.bands_run[key]) for key in ("fwd", "bwd")}
    swept = all(len(runs[key]) == phases[key] and all(
        per == len(slabs.band_windows(f.ring.S, band)) and n_ == sw * per
        for band, per, sw, n_ in runs[key]) for key in runs)
    want = {**{k: 0 for k in build.KERNELS},
            **{name: sum(r[3] for r in runs[key]) for name, key in zip(SLAB_KERNELS, runs)}}
    per_phase = {}
    for name, key in zip(SLAB_KERNELS, runs):
        evs, first, out = [(a, b) for nm, a, b in events if nm == name], 0, []
        for band, per, sw, n_ in runs[key]:
            chunk = evs[first:first + n_]
            first += n_
            ms = sum(a.elapsed_time(b) for a, b in chunk)
            out.append(dict(band=band, launches_a_sweep=per, sweeps=sw, launches=n_, ms=ms,
                            ms_per_launch=ms / n_,
                            span_ms=chunk[0][0].elapsed_time(chunk[-1][1]) if chunk else None))
        per_phase[name] = out
    slab_bytes = (f.ring.S + 1) * res * res * 4
    waves = {key: K.slab_wave(rif.device, rif.dtype, key == "bwd") for key in runs}
    rec = dict(res=res, rays=n, S=f.ring.S, K=f.ring.K, phases=phases, wave_rays=waves,
               budget={"fwd": f.ring.phases(f.ring.steps_f), "bwd": f.ring.phases(f.ring.steps_b)},
               bitwise=bitwise, out_abs_err=max(e[1] for e in out_errs),
               out_rel_err=max(e[0] for e in out_errs), grad_rel_err=err, slab_ms=slab_ms,
               api_trace_ms=api_ms,
               api_launches=api_launches, per_phase=per_phase,
               peak_gb=peak / 1e9, base_gb=base / 1e9, api_peak_gb=api_peak / 1e9,
               slab_gb=slab_bytes / 1e9, launches={k: n_ for k, n_ in launches.items() if n_})
    failures = []
    if not bitwise or not err <= TOL_F32_GRAD or not float(g_ref.abs().max()) > 0:
        failures.append(f"slab ring at {res}^3: bitwise {bitwise}, gradient {err:.3e}")
    if launches != want or not swept:
        failures.append(f"slab ring at {res}^3: launches {launches}, want {want}; band "
                        f"sweeps {runs}")
    del g, g_ref, rows, xt, vt, xt_a, vt_a
    # the ring again with no launch timed (each timed launch records two
    # events, host work between the launches): forward + backward, host clock
    rows = parallel.pad_rif_z(rif, 1).requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.time()
    loss(*f(rows, x, v)).backward()
    torch.cuda.synchronize()
    rec["slab_ms_untimed"] = 1e3 * (time.time() - t0)
    del rows
    print(f"slab path[{res}^3 f32, {n} z-crossing rays, one rank]: " + json.dumps(rec),
          flush=True)
    # the plain phases on the first phase's inputs (one rank: the whole ring),
    # for the kernels' plain-version times and this run's work
    torch.cuda.empty_cache()
    slab = slabs._Ring(mesh, h, ds, res, None, 2, False)._slab(parallel.pad_rif_z(rif, 1))
    del rif
    torch.cuda.empty_cache()
    shape = slabs._grid_shape(slab, (res,) * 3, h)
    nf, nb, inner = f.ring.steps_f, f.ring.steps_b, f.ring.K
    tol_snap = G.snap_tol(slab.dtype)

    def fwd_state():
        return [x.clone(), v.clone(), x.clone(), v.clone(), G.inbounds(shape, x),
                torch.zeros(n, dtype=torch.bool, device="cuda"),
                torch.zeros(n, dtype=torch.int32, device="cuda")]

    def bwd_state(st):
        xt_p = torch.where(st[5][:, None], st[2], st[0])
        dx, dv = 2.0 * (xt_p - centre), torch.ones_like(st[3])
        return [xt_p, st[3].clone(), dx, dv + G._scalar(ds, dx) * dx,
                ~G.escaped(shape, xt_p, -st[3]),
                torch.zeros(n, dtype=torch.int32, device="cuda")]

    # each plain phase timed alone, then run again counting its work: the
    # ray-steps and the 32-byte sectors of the slab (and gradient slab) its
    # stencils reach, which is what the kernel must move
    st = fwd_state()
    plain_fwd_ms = _host_ms(lambda: slabs.slab_trace_phase_plain(
        slab, (res,) * 3, -1, h, ds, *st, nf, inner))[1]
    fstats, bstats = {}, {}
    slabs.slab_trace_phase_plain(slab, (res,) * 3, -1, h, ds, *fwd_state(), nf, inner,
                                 stats=fstats)
    gslab = torch.zeros_like(slab)
    plain_bwd_ms = _host_ms(lambda: slabs.slab_backtrace_phase_plain(
        slab, (res,) * 3, -1, h, ds, tol_snap, *bwd_state(st), gslab, nb, inner))[1]
    gslab.zero_()
    slabs.slab_backtrace_phase_plain(slab, (res,) * 3, -1, h, ds, tol_snap, *bwd_state(st),
                                     gslab, nb, inner, stats=bstats)
    # the kernels' time a phase: the first phase's band sweep replayed on the
    # ring's inputs (the state permuted into the ray order, as the ring keeps
    # it), two events around its launches while the card waits out a busy
    # kernel long enough for the host to have enqueued them all, so that the
    # host's work between launches is not timed (events around each launch
    # are, where the host falls behind the card)
    order = O.ray_order(x, v, (res,) * 3, h)

    def replay(key):
        if key == "fwd":
            state = slabs._permuted(order, *fwd_state())
            phase = K.slab_trace_bands(slab, (res,) * 3, -1, h, ds, *state, nf, inner)
        else:
            gslab.zero_()
            state = slabs._permuted(order, *bwd_state(st))
            phase = K.slab_backtrace_bands(slab, (res,) * 3, -1, h, ds, tol_snap, *state,
                                           gslab, nb, inner)
        seq = slabs.band_windows(f.ring.S, runs[key][0][0])
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLAB_BUSY_CYCLES)
        t0 = time.time()
        a.record()
        for q, windows in enumerate(seq):
            flags = phase(windows, q == 0, q == len(seq) - 1)
        b.record()
        enqueue_ms = 1e3 * (time.time() - t0)
        torch.cuda.synchronize()
        if bool(flags[1]):
            raise AssertionError(f"slab ring at {res}^3: the first {key} phase needs more "
                                 "than one sweep")
        return a.elapsed_time(b), enqueue_ms

    replays = {key: [replay(key) for _ in range(SLAB_REPS)] for key in ("fwd", "bwd")}
    rec["replay"] = {key: dict(ms=[r[0] for r in rs], enqueue_ms=[r[1] for r in rs])
                     for key, rs in replays.items()}
    del slab, gslab, st
    torch.cuda.empty_cache()
    for stats in (fstats, bstats):
        for key in ("sectors", "grad_sectors"):
            if key in stats:
                stats[key] = int(stats[key].sum())
    state_f = n * (4 * 3 * 4 + 2 + 4)  # x, v, xt, vt; inside, esc; cnt
    state_b = n * (4 * 3 * 4 + 1 + 4)  # x, v, la, mu; active; cnt
    times = {
        "slab_trace_phase": set_bound(dict(
            ms=median(rec["replay"]["fwd"]["ms"]), plain_ms=plain_fwd_ms, library_ms=None,
            bytes=32 * fstats["sectors"] + 2 * state_f,
            flops=fstats["ray_steps"] * FLOPS_FWD_STEP + fstats["evals"] * FLOPS_FWD_EVAL)),
        "slab_backtrace_phase": set_bound(dict(
            ms=median(rec["replay"]["bwd"]["ms"]), plain_ms=plain_bwd_ms, library_ms=None,
            bytes=32 * (bstats["sectors"] + bstats["grad_sectors"]) + 2 * state_b,
            flops=bstats["ray_steps"] * FLOPS_BWD_STEP + bstats["evals"] * FLOPS_BWD_EVAL
            + bstats["splats"] * FLOPS_BWD_SPLAT)),
    }
    rec["work"] = {"slab_trace_phase": fstats, "slab_backtrace_phase": bstats}
    print(f"slab kernels at {res}^3 (the first phase, one rank): " + json.dumps(
        {k: {q: t[q] for q in ("ms", "plain_ms", "bound_ms", "bound_by")}
         for k, t in times.items()}) + f"; replays {json.dumps(rec['replay'])}; work "
          f"{json.dumps(rec['work'])}", flush=True)
    return rec, launches, times, failures


# ---------------------------------------------------------------------------
# phase q: the measurement modules (benchmarks/, utils/profiling.py)
# ---------------------------------------------------------------------------

MEASURE_ITERS = 1          # timed iterations a sweep row
MEASURE_REPS = 10          # K1 launches timed a case in probe_evalmath
MEASURE_RES_LIST = (9, 17, 33, 65, 129)
MEASURE_DS_MULTS = (0.5, 1.0)      # the step-size sweep's rows; the tape at the first
DS_STUDY_SIZE = (17, 64)           # res, rays: f64 on the card and on the CPU
DS_STUDY_SCENES = ("bench_bump", "luneburg")
COMPACTION_BUCKETS, COMPACTION_ITERS = (1, 2, 4, 8), 2
SCALING_ITERS = 2
DS_SPEED_ITERS = 3
ENVELOPE_RES, ENVELOPE_STEPS = 65, 2
# a Luneburg step's batch: six faces of 128^2 x 10 spp
SOURCE_RAYS, SOURCE_PIXELS, SOURCE_SPP, SOURCE_RES, SOURCE_ITERS = 983_040, (128, 128), 60, 129, 2
SCATTER3_SMALL = dict(steps=4, reps=1)
HOTOPS_SMALL = dict(steps=10, reps=1)
BANDSCATTER_SMALL = dict(steps=8, reps=1)
# The scatter probes' cases are held in f64: each within TOL_F64 of its
# baseline and of the f64 sums of its terms.  Their f32 runs (the timed ones)
# print both distances ungated: probe_scatter3's LCG (the JAX probe's) puts
# every row on one of 40 words modulo 139,000 after the first step, ~2e4 f32
# terms a word a step, and on an H100 two f32 orders of those sums differed by
# 1.2e-5 of the largest, and one order from the f64 sum by 1.01e-5, from run
# to run: a 1e-5 limit in f32 is a coin flip there, not a check.


def _launches(**counts):
    return {**{name: 0 for name in build.KERNELS}, **counts}


def measured(label, fn, want, total, out):
    """Run one module's entry point with the counts zeroed before and read after;
    its launches must be ``want``.  Adds them to ``total``; the result to ``out``."""
    K.reset_launches()
    t0 = time.time()
    rec = fn()
    torch.cuda.synchronize()
    got = dict(K.LAUNCHES)
    if got != want:
        raise AssertionError(f"phase q: {label} must launch {want}, counted {got}")
    for name, n in got.items():
        total[name] += n
    out[label] = dict(seconds=time.time() - t0, launches={k: v for k, v in got.items() if v},
                      result=rec)
    print(f"measure[{label}] {out[label]['seconds']:.1f} s, launches "
          f"{out[label]['launches']}: {json.dumps(rec)}", flush=True)
    return rec


def source_path():
    """``sources.area_source3_rand`` and ``sample_sphere`` drawn on the card at a
    Luneburg step's batch and traced through ``api.trace`` forward + backward on
    the Luneburg lens at 129^3 (K2, K3), each timed; one pass under
    ``utils.profiling.trace``, whose device time per kernel is read back."""
    span = 20.0
    lens = ds_study.scenes(SOURCE_RES, span, dtype=torch.float32, names=("luneburg",))["luneburg"]
    h = span / (SOURCE_RES - 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = {
        "area_source3_rand": lambda: sources.area_source3_rand(
            gen, 30.0, SOURCE_PIXELS, SOURCE_SPP, span, sensor_dist=0.5),
        "sample_sphere": lambda: sources.sample_sphere(gen, SOURCE_RAYS, span),
    }
    rec = {}
    for name, draw in draws.items():
        draw_s = profiling.timeit(draw, iters=3, warmup=1)
        rays = draw()[0]
        if rays.x.shape != (SOURCE_RAYS, 3) or not bool(torch.isfinite(rays.v).all()):
            raise AssertionError(f"{name}: wrong or non-finite rays")
        live = rays.mask.to(lens.dtype)

        def step():
            r = lens.detach().requires_grad_(True)
            xt, vt = api.trace(r, rays.x, rays.v, h, h / 2)
            ((xt ** 2).sum(dim=1) * live).sum().backward()
            return r.grad

        step_s = profiling.timeit(step, iters=SOURCE_ITERS, warmup=1)
        g = step()
        if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
            raise AssertionError(f"{name}: the gradient is not finite or all zero")
        rec[name] = dict(rays=SOURCE_RAYS, live=int(rays.mask.sum()), draw_ms=1e3 * draw_s,
                         fwd_bwd_ms=1e3 * step_s, rays_per_s=SOURCE_RAYS / step_s)
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir) as prof:
            step()
        device_us = {e.key: e.device_time_total for e in prof.key_averages()
                     if e.device_time_total > 0}
        rec["profiler"] = dict(trace_bytes=os.path.getsize(os.path.join(logdir, "trace.json")),
                               device_us_top=dict(sorted(device_us.items(),
                                                         key=lambda kv: -kv[1])[:6]))
    return rec


def measure_path():
    """Phase q: every measurement module through its own entry point on the
    card, each module's launches asserted exactly; returns the records and the
    phase's launches."""
    total, out, failures = _launches(), {}, []
    it = MEASURE_ITERS

    k1 = measured("probe_evalmath", lambda: probe_evalmath.run(reps=MEASURE_REPS),
                  _launches(eval_grad=3 + 2 * (MEASURE_REPS + 1)), total, out)
    if not all(k1["bitwise"].values()):
        failures.append(f"probe_evalmath: K1 not bitwise {k1['bitwise']}")

    def sweep():
        rows = [*sweeps.profile_stepsize(nrays=NRAYS, res=33, iters=it, include_ad=True,
                                         ds_mults=MEASURE_DS_MULTS[:1]),
                *sweeps.profile_stepsize(nrays=NRAYS, res=33, iters=it, include_ad=False,
                                         ds_mults=MEASURE_DS_MULTS[1:]),
                *sweeps.profile_resolution(iters=it, res_list=MEASURE_RES_LIST)]
        if any(r["back_time_s"] == "oom" for r in rows) or rows[0]["ad_time_s"] == "oom":
            raise AssertionError(f"sweeps: a row ran out of memory: {rows}")
        return rows

    rows = len(MEASURE_DS_MULTS) + len(MEASURE_RES_LIST)
    measured("sweeps", sweep, _launches(trace_fwd=rows * (1 + it), backtrace=rows * (1 + it)),
             total, out)

    res, n = DS_STUDY_SIZE
    calls = len(DS_STUDY_SCENES) * (1 + len(ds_study.ALPHAS))
    card = measured("ds_study", lambda: ds_study.study(res, n, names=DS_STUDY_SCENES),
                    _launches(trace_ckpt=calls, backtrace_exact=calls), total, out)
    cpu = ds_study.study(res, n, device="cpu", names=DS_STUDY_SCENES)
    worst = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for a, b in zip(card, cpu)
                for k in a if isinstance(a[k], float))
    same = all(a[k] == b[k] for a, b in zip(card, cpu) for k in a if not isinstance(a[k], float))
    out["ds_study"]["card_vs_cpu_rel_err"] = worst
    print(f"ds_study[f64 {res}^3 x {n}] card rows against CPU rows: rel_err {worst:.3e} "
          f"(tol {TOL_F64:g}); other fields equal: {same}", flush=True)
    if not (worst <= TOL_F64 and same):
        failures.append(f"ds_study: card rows differ from CPU rows ({worst:.3e}, {same})")

    nb = sum(COMPACTION_BUCKETS) * (1 + COMPACTION_ITERS)
    measured("compaction_bench",
             lambda: compaction_bench.run(buckets=COMPACTION_BUCKETS, iters=COMPACTION_ITERS),
             _launches(trace_fwd=nb, backtrace=nb), total, out)
    measured("scaling", lambda: scaling.profile_scaling(iters=SCALING_ITERS),
             _launches(trace_fwd=1 + SCALING_ITERS, backtrace=1 + SCALING_ITERS), total, out)
    na = len(probe_ds_speed.ALPHAS) * (1 + DS_SPEED_ITERS)
    measured("probe_ds_speed", lambda: probe_ds_speed.run(iters=DS_SPEED_ITERS),
             _launches(trace_fwd=na, backtrace=na), total, out)
    chunks = len(CK._chunks(probe_exact_envelope.NRAYS, CK.exact_chunk_rays()))
    ne = 1 + ENVELOPE_STEPS
    env = measured("probe_exact_envelope",
                   lambda: probe_exact_envelope.run_case(ENVELOPE_RES, steps=ENVELOPE_STEPS),
                   _launches(trace_ckpt=ne * (1 + chunks), backtrace_exact=ne * chunks),
                   total, out)
    if not env["grad_finite"]:
        failures.append("probe_exact_envelope: the gradient is not finite")
    for label, probe, small in (("probe_scatter3", probe_scatter3, SCATTER3_SMALL),
                                ("probe_hotops", probe_hotops, HOTOPS_SMALL),
                                ("probe_bandscatter", probe_bandscatter, BANDSCATTER_SMALL)):
        rows = measured(label, lambda: probe.run(**small), _launches(), total, out)
        rows64 = probe.run(**small, dtype=torch.float64)
        errs = {k: max((r[k] for r in rows64 if r[k] is not None), default=0.0)
                for k in ("max_rel_err", "max_rel_err_f64")}
        f32 = max((r["max_rel_err_f64"] for r in rows if r["max_rel_err_f64"] is not None),
                  default=0.0)
        out[label]["f64_check"] = errs
        print(f"{label}[f64] largest distance of a case to its baseline "
              f"{errs['max_rel_err']:.3e}, to the f64 sums {errs['max_rel_err_f64']:.3e} (tol "
              f"{TOL_F64:g}); in f32 to the f64 sums {f32:.3e} (printed)", flush=True)
        if not all(e <= TOL_F64 for e in errs.values()):
            failures.append(f"{label}: a case is off its baseline in f64: {errs}")
    # each source: a warm-up, the timed passes and the checked one; then the traced pass
    ns = 2 * (SOURCE_ITERS + 2) + 1
    measured("sources", source_path, _launches(trace_fwd=ns, backtrace=ns), total, out)
    return out, total, failures


# ---------------------------------------------------------------------------
# phase n: the fuel north star (experiments/northstar.py)
# ---------------------------------------------------------------------------

# the JAX record (results/fuel_northstar/report.json, reconstruction_per_stage):
# rel_norm at the end of each stage of the shipped ladder, on the JAX package's
# own rays; the port draws others, so the card is held to bands around it
NS_JAX_REL_NORM = {9: 3.860800266265869, 17: 0.3937952220439911, 33: 0.346317857503891,
                   65: 0.3002689480781555, 129: 0.27131563425064087}
NS_BAND, NS_FINAL_MAX = 0.15, 0.30          # n1: every stage from 17^3 on, and the end
NS_RESUME_BAND = 0.05                       # n2: the end, against the record's
# n2: the JAX record's own final stage, resumed from its 65^3 field: the lr the
# shipped ladder reaches at 129^3 and the 20 iterations the JAX report ran
NS_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                       "fuel_northstar", "eta_65.npy")
NS_RESUME_STAGES, NS_RESUME_LR = ((129, 20, 16),), 1e-4 / 2 ** 4
# A resume starts Adam afresh (the JAX script resumes eta alone), so its
# rel_norm climbs, the JAX script's too; n2 is held to its control instead,
# n1's own 65^3 field resumed the same way: n2's rel_norm before its first step
# and at its end each within NS_CONTROL_BAND of the control's (the JAX record's
# 65^3 field and n1's differ by 4 % at 65^3), and each resume's end at most
# NS_RESUME_CLIMB times its start (a load or a resume gone wrong fails one)
NS_CONTROL_BAND, NS_RESUME_CLIMB = 0.10, 1.5
# the measurement set at full width: 32 views x 128^2 x 20 spp
NS_FULL_RAYS = northstar.NVIEWS * northstar.NBINS ** 2 * northstar.SPP


def northstar_expected_launches(stages):
    """The launches a north-star run of ``stages`` implies, from the code
    (``experiments/northstar.py``), with no exit-step buckets (the card's rule).

    Each microbatch is one ``tracer.trace`` with its gradient: one K2 and one
    K3 on its stage's grid.  The ground truth is traced once, a microbatch at a
    time, forward only: ``NCHUNKS`` K2 on the last stage's grid, before the
    first stage.  Each stage's spot check (2,048 rays, one exact chunk) is one
    K2 and one K3 (``tracer.trace``) and one K5 and one K6 (``trace_exact``).
    Returns the launches in all, K3's by path and each stage's (the first with
    the ground truth's)."""
    paths = {"backtrace": {"shared": 0, "global": 0}}
    total = {name: 0 for name in build.KERNELS}
    per_stage = []
    for s, (res, iters, cpi) in enumerate(stages):
        k = {name: 0 for name in build.KERNELS}
        k["trace_fwd"] = iters * cpi + 1 + (northstar.NCHUNKS if s == 0 else 0)
        k["backtrace"] = iters * cpi + 1
        k["trace_ckpt"] = k["backtrace_exact"] = 1
        paths["backtrace"][K.backtrace_path(res ** 3, torch.float32)] += k["backtrace"]
        per_stage.append(k)
        for name in total:
            total[name] += k[name]
    return total, paths, per_stage


def northstar_path(settings, label, failures, out):
    """A north-star run of ``settings`` on the card, its files into ``out``.

    The launches are held to :func:`northstar_expected_launches`, in all, by
    K3's path and stage by stage.  Per stage from the rows of the run's
    ``metrics.jsonl`` (each iteration ends with its losses read back, so the
    host clock includes the card's work) and from events around every launch:
    the median ms an iteration, rays/s, the kernels' ms (K2 + K3) and the rest
    (the host's share: the ray order, the loss, autograd, Adam, the read-back),
    the spot check, ``rel_norm`` and the peak device memory.  Appends to
    ``failures``; returns the record and the final field."""
    if os.environ.get("ANRT_BUCKETED") is not None:
        raise AssertionError("ANRT_BUCKETED is set: the run would not be a user's run")
    stages = settings.ladder
    rows, events = [], []

    def on_row(row):
        rows.append((row, len(events), torch.cuda.max_memory_allocated(), time.time()))
        if "stage_start" in row:
            torch.cuda.reset_peak_memory_stats()

    want, want_paths, want_stages = northstar_expected_launches(stages)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    K.record_events(events)
    t0 = time.time()
    try:
        eta, report = northstar.run(dataclasses.replace(settings, result_dir=out),
                                    device="cuda", on_row=on_row)
        torch.cuda.synchronize()
    finally:
        K.record_events(None)
    seconds = time.time() - t0
    files = sorted(os.listdir(out))
    launches, paths = dict(K.LAUNCHES), kernel_paths()
    want_files = sorted(["metrics.jsonl", "report.json", "final_eta.npy"]
                        + [f"eta_{res}.npy" for res, _, _ in stages])
    if files != want_files:
        failures.append(f"northstar[{label}] wrote {files}, not {want_files}")
    got_stages, start = [], 0
    for row, n_ev, _, _ in rows:
        if "stage" in row:
            counts = {name: 0 for name in build.KERNELS}
            for name, _, _ in events[start:n_ev]:
                counts[name] += 1
            got_stages.append(counts)
            start = n_ev
    if launches != want or paths != want_paths or got_stages != want_stages \
            or start != len(events):
        raise AssertionError(f"northstar[{label}] must launch {want}, by path {want_paths}, "
                             f"by stage {want_stages}; counted {launches}, {paths}, "
                             f"{got_stages} and {len(events) - start} after the last stage")
    card = report["card"]
    per_stage, setup_gb = [], None
    for res, iters, cpi in stages:
        start_row = next(r for r in rows if r[0].get("stage_start") == res)
        end_row = next(r for r in rows if r[0].get("stage") == res)
        its = [r for r in rows if "iter" in r[0] and r[0]["res"] == res]
        if setup_gb is None:  # the measurement set, its ground truth and the first spot check
            setup_gb = start_row[2] / 2 ** 30
        secs, kern, k2, k3, prev = [], [], [], [], start_row[1]
        for row, n_ev, _, _ in its:
            mine, prev = events[prev:n_ev], n_ev
            if [name for name, _, _ in mine] != ["trace_fwd", "backtrace"] * cpi:
                raise AssertionError(f"northstar[{label}] an iteration at {res}^3 launched "
                                     f"{[name for name, _, _ in mine]}")
            t = [a.elapsed_time(b) for _, a, b in mine]
            k2 += t[0::2]
            k3 += t[1::2]
            kern.append(sum(t))
            secs.append(row["secs"])
        med, k_med = median(secs), median(kern)
        sc, rel_norm = start_row[0], end_row[0]["rel_norm"]
        rec = dict(res=res, iters=iters, microbatches=cpi, rays=its[0][0]["rays"],
                   ms_per_iter=1e3 * med, rays_per_s=its[0][0]["rays"] / med,
                   kernel_ms_per_iter=k_med, host_ms_per_iter=1e3 * med - k_med,
                   k2_ms=median(k2), k3_ms=median(k3),
                   k3_path=K.backtrace_path(res ** 3, torch.float32),
                   max_rel=sc["max_rel"], rel_l2=sc["rel_l2"], cos=sc["cos"],
                   rel_norm=rel_norm, loss_first=its[0][0]["loss"], loss_last=its[-1][0]["loss"],
                   peak_gb=end_row[2] / 2 ** 30, stage_s=sum(secs))
        per_stage.append(rec)
        print(f"northstar[{label}] stage {res}^3, {iters} iterations of {cpi} x "
              f"{rec['rays'] // cpi} rays: median {rec['ms_per_iter']:.3f} ms an iteration = "
              f"{rec['rays_per_s']:.4g} rays/s; K2 + K3 {k_med:.3f} ms (a launch K2 "
              f"{rec['k2_ms']:.3f}, K3 {rec['k3_ms']:.3f} on its {rec['k3_path']} path), the "
              f"host's share {rec['host_ms_per_iter']:.3f} ms; spot check max_rel "
              f"{sc['max_rel']:.3e}, rel_l2 {sc['rel_l2']:.3e}, cos {sc['cos']:.5f}; rel_norm "
              f"{rel_norm:.4f} (JAX record {NS_JAX_REL_NORM.get(res, float('nan')):.4f}); loss "
              f"{rec['loss_first']:.6g} -> {rec['loss_last']:.6g}; peak {rec['peak_gb']:.3f} GB; "
              f"{card}", flush=True)
    # the draw, the ground truth's trace and the first spot check
    setup_s = rows[0][3] - t0
    final = report["reconstruction"]["rel_norm"]
    if not math.isfinite(report["final_loss"]) or eta.shape != (stages[-1][0],) * 3 \
            or eta.dtype != torch.float32 or not eta.is_cuda \
            or not bool(torch.isfinite(eta).all()) or float(eta.min()) < 1.0:
        failures.append(f"northstar[{label}] the final field or loss is not a finite f32 "
                        f"{stages[-1][0]}^3 field >= 1 on the card")
    if report["nbuckets"] != 0 or report["rays_per_iter"] != stages[-1][2] * NS_FULL_RAYS \
            // northstar.NCHUNKS:
        failures.append(f"northstar[{label}] took {report['nbuckets']} buckets or "
                        f"{report['rays_per_iter']} rays an iteration")
    print(f"northstar[{label}] {len(stages)} stages {[list(s) for s in stages]}, "
          f"{sum(r['iters'] for r in per_stage)} iterations in {seconds:.1f} s (set-up "
          f"{setup_s:.2f} s, peak {setup_gb:.3f} GB); launches {launches}; by path {paths}; final rel_norm "
          f"{final:.4f}, loss {report['final_loss']:.6g}; {card}", flush=True)
    return dict(seconds=seconds, launches=launches, paths=paths, per_stage=per_stage,
                rel_norm=final, final_loss=report["final_loss"], setup_s=setup_s,
                setup_peak_gb=setup_gb,
                spot_checks=report["grad_spotcheck_per_stage"], card=card), eta


def northstar_order_ms(settings, rays):
    """ms of ``tracer.order.ray_order`` (CUDA events, L2 flushed) on one
    microbatch of the shipped measurement set at each stage's grid: the host
    column's share that B9 would cache (the rays never change)."""
    chunk = rays.x.shape[0] // northstar.NCHUNKS
    x, v = rays.x[:chunk].contiguous(), rays.v[:chunk].contiguous()
    return {f"{res}^3": time_ms(lambda: O.ray_order(x, v, (res,) * 3,
                                                    northstar.VOL_SPAN / (res - 1)), 5)
            for res, _, _ in settings.ladder}


def northstar_phase(failures, keep_report=None):
    """Phase n: case n1, the shipped ladder uncut (10,485,760 rays in 16
    microbatches of 655,360 at 129^3, f32, the real 65^3 volume resampled),
    each stage from 17^3 within ``NS_BAND`` of the JAX record's ``rel_norm``,
    falling, the end at most ``NS_FINAL_MAX``; then K2, K3, K5 and K6 held
    against their plain versions (:func:`stage_check`) on the whole third
    129^3 microbatch through the recovered field.  Case n2, the JAX record's
    final stage resumed from its 65^3 field (``NS_INIT``), and its control,
    n1's own 65^3 field resumed the same way: n2 is held to the control
    (``NS_CONTROL_BAND``, ``NS_RESUME_CLIMB``); its end beside the band of
    ``NS_RESUME_BAND`` around the record's is printed with its verdict, not
    held (a resume starts Adam afresh, where the record's 129^3 stage went
    on from the moments of 700 iterations; ``PERF.md`` §6).  Then the ray
    order's ms a microbatch at each grid.  ``keep_report``: where to copy n1's
    ``report.json``."""
    shipped = northstar.Settings()
    res = shipped.ladder[-1][0]
    with tempfile.TemporaryDirectory() as out:
        for sub in ("n1", "n2", "n2_control"):
            os.makedirs(os.path.join(out, sub))
        n1, eta = northstar_path(shipped, "n1, shipped stages", failures,
                                 os.path.join(out, "n1"))
        if keep_report:  # phase r's head-to-head and sweeps read it
            shutil.copy(os.path.join(out, "n1", "report.json"), keep_report)
        bands = {r: NS_JAX_REL_NORM[r] for r, _, _ in shipped.ladder[1:]}
        got = {st["res"]: st["rel_norm"] for st in n1["per_stage"]}
        for r, want in bands.items():
            if not abs(got[r] - want) <= NS_BAND * want:
                failures.append(f"northstar n1: rel_norm {got[r]:.4f} at {r}^3 is outside "
                                f"{100 * NS_BAND:.0f} % of the JAX record's {want:.4f}")
        seq = [got[r] for r in bands]
        if not all(b < a for a, b in zip(seq, seq[1:])) or not n1["rel_norm"] <= NS_FINAL_MAX:
            failures.append(f"northstar n1: rel_norm {seq} does not fall from 17^3 on, or "
                            f"ends above {NS_FINAL_MAX}")
        # one whole 129^3 microbatch (the third), through the recovered field
        rays = northstar.measurement_set(device="cuda")
        chunk = rays.x.shape[0] // northstar.NCHUNKS
        s = slice(2 * chunk, 3 * chunk)
        x0, v0 = rays.x[s].contiguous(), rays.v[s].contiguous()
        check_row, _ = stage_check(eta.contiguous(), northstar.VOL_SPAN / (res - 1),
                                   shipped.stage_ds(res), x0, v0, failures,
                                   f"f32 {res}^3, a north-star microbatch")
        check_row.pop("exact", None)
        del eta, x0, v0
        torch.cuda.empty_cache()
        resume = dict(stages=NS_RESUME_STAGES, lr=NS_RESUME_LR)
        cases = {"n2": (NS_INIT, "n2, the JAX record's 129^3 stage resumed"),
                 "n2_control": (os.path.join(out, "n1", "eta_65.npy"),
                                "n2 control, n1's own 65^3 field resumed")}
        gt = G.upres_volume(voxel_scenes.fuel_injection_rif(northstar.FUEL_VAL, torch.float32,
                                                            "cuda"), (res,) * 3)
        recs = {}
        for key, (init, label) in cases.items():
            settings = northstar.Settings(init=init, **resume)
            start = fuel_injection.reconstruction_error(
                northstar.initial_field(settings, torch.float32, "cuda"), gt,
                background=northstar.BG)["rel_norm"]
            recs[key], _ = northstar_path(settings, label, failures, os.path.join(out, key))
            recs[key]["rel_norm_start"] = start
        del gt
    n2, control = recs["n2"], recs["n2_control"]
    for when in ("rel_norm_start", "rel_norm"):
        if not abs(n2[when] - control[when]) <= NS_CONTROL_BAND * control[when]:
            failures.append(f"northstar n2: {when} {n2[when]:.4f} is outside "
                            f"{100 * NS_CONTROL_BAND:.0f} % of the control's {control[when]:.4f}")
    for key, rec in recs.items():
        if not rec["rel_norm"] <= NS_RESUME_CLIMB * rec["rel_norm_start"]:
            failures.append(f"northstar {key}: rel_norm climbed from {rec['rel_norm_start']:.4f} "
                            f"to {rec['rel_norm']:.4f}, past {NS_RESUME_CLIMB} times its start")
    want = NS_JAX_REL_NORM[res]
    n2["inside_band"] = abs(n2["rel_norm"] - want) <= NS_RESUME_BAND * want
    print(f"northstar n2: rel_norm {n2['rel_norm_start']:.4f} -> {n2['rel_norm']:.4f} "
          f"(loss {n2['per_stage'][0]['loss_first']:.6g} -> "
          f"{n2['per_stage'][0]['loss_last']:.6g}), the control from n1's own 65^3 field "
          f"{control['rel_norm_start']:.4f} -> {control['rel_norm']:.4f} (loss "
          f"{control['per_stage'][0]['loss_first']:.6g} -> "
          f"{control['per_stage'][0]['loss_last']:.6g}), held within "
          f"{100 * NS_CONTROL_BAND:.0f} % of each other and each end at most "
          f"{NS_RESUME_CLIMB} times its start; n1's continuous 129^3 stage {n1['rel_norm']:.4f}; "
          f"n2's end {'inside' if n2['inside_band'] else 'OUTSIDE'} "
          f"{100 * NS_RESUME_BAND:.0f} % of the JAX record's {want:.4f} (not held)", flush=True)
    order = northstar_order_ms(shipped, rays)
    del rays
    print(f"northstar: the ray order on a microbatch of {chunk} rays "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in order.items())
          + f"; {n1['card']}", flush=True)
    return dict(n1=n1, stage_check=check_row, n2=n2, n2_control=control, order_ms=order)


# ---------------------------------------------------------------------------
# phase r: the JAX system's last repo-root drivers (experiments/image_flagship,
# image_singleview, fiber_ladder, fuel_headtohead, fuel2008_sweep)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# the JAX records each run is held to (results/*/report.json); the port draws
# other rays, so its own runs are held to bands around them, written in
# PERF.md before the first run
R_FLAGSHIP_ITERS = 40            # 40 x (1 + ... + 7) = 1,120 steps, the record's
R_FLAGSHIP_RECORD = dict(corr_einstein=0.7445039749145508, corr_turing=0.5232304334640503,
                         corr4x_einstein=0.7632321715354919, corr4x_turing=0.5608484148979187)
R_FLAGSHIP_BAND = 0.10           # r1's own field, each correlation
R_JAX_FIELD = os.path.join(REPO, "results", "einstein_turing_r4", "result.npz")
R_JAX_FIELD_BAND = 0.02          # the JAX record's own field: only the draw differs
R_SINGLEVIEW_RECORD, R_SINGLEVIEW_BAND = 0.7138294577598572, 0.10
R_FIBER_L1 = (0.08, 0.20)        # the ladder's and every refinement's L1 to sqrt(2 - r^2)
R_FIBER_INIT = os.path.join(REPO, "results", "fiber_129_refine", "profile_refine0.npy")
R_FIBER_INIT_L1, R_FIBER_INIT_TOL = 0.14417900145053864, 1e-6   # its record, relative
# ROADMAP C13: a ray of that profile's refinement at lr 1e-5, spp 2 (the JAX
# record's results/fiber_129_refine_r4, whose refine1 turned NaN) whose f32
# adjoint overflows near the axis; that refinement is not run here
R_AXIAL_RAY = os.path.join(REPO, "tests", "data", "fiber_axial_ray.json")
# r4: the head-to-head cut to configuration 10's rays and grid, its own path model
R_H2H_PROTOCOL = dict(nviews=32, nbins=64, spp=4, int_res=175, recon_res=16, seed=0)
R_H2H_BAND = (0.80, 0.95)
# r5: the four sweeps on a tiny screening protocol, the volume at 17^3
R_SWEEP_SCREEN = dict(nviews=4, nbins=8, spp=1, int_res=32, seed=0)
R_SWEEP_RES, R_SWEEP_GRIDS = 17, (8, 12, 16)
R_SWEEP_ROW_KEYS = os.path.join(REPO, "results", "fuel2008_sweep", "sweep.jsonl")


def render_launches(params, escalated):
    """The renders ``image.multires_exp``'s log function makes (one at every
    ``record_iters``-th step, before the step): one K2 each before the stage
    escalation, one K5 (``trace_exact`` with no gradient) from it on.  Returns
    each stage's launches."""
    res_list, iters, rec = params["res_list"], params["optim_iters"], params["record_iters"]
    first_exact = len(res_list) if escalated is None else escalated
    out, start = [], 0
    for s in range(len(res_list)):
        n = iters * (s + 1)
        k = {name: 0 for name in build.KERNELS}
        renders = 0 if rec > 10 ** 8 else sum(1 for i in range(start, start + n) if i % rec == 0)
        k["trace_ckpt" if s >= first_exact else "trace_fwd"] += renders
        out.append(k)
        start += n
    return out


def image_root_path(label, params, nrays, run_fn, after, failures):
    """An image driver run through its root twin, ``run_fn(stat_fn, metrics)``,
    held to the launches the code implies: ``expected_launches`` for the stage
    the escalation fired at, the log function's renders, and after the last
    step ``after`` (the report's correlation: one K2).  Appends to
    ``failures``; returns the record and ``run_fn``'s result."""
    step_rows, events = [], []

    def stat(it, loss, secs):
        step_rows.append((it, loss, secs, len(events)))

    metrics = MetricsLogger()
    K.reset_launches()
    K.record_events(events)
    t0 = time.time()
    try:
        out = run_fn(stat, metrics)
        torch.cuda.synchronize()
    finally:
        K.record_events(None)
    seconds = time.time() - t0
    launches, paths = dict(K.LAUNCHES), kernel_paths()
    escalated = escalation_stage(metrics)
    nbuckets = run_buckets(metrics, nrays)
    steps, want, want_paths, want_stages = expected_launches(params, escalated, nrays, 0,
                                                             nbuckets)
    for k, r in zip(want_stages, render_launches(params, escalated)):
        for name in k:
            k[name] += r[name]
            want[name] += r[name]
    for name in after:
        want[name] += 1
    got_stages, rest = stage_launches(events, step_rows, params)
    if launches != want or paths != want_paths or got_stages != want_stages \
            or [n_ for n_, _, _ in rest] != list(after):
        failures.append(f"{label} must launch {want}, by path {want_paths}, by stage "
                        f"{want_stages} and {list(after)} after the last step; counted "
                        f"{launches}, {paths}, {got_stages} and {[n_ for n_, _, _ in rest]}")
    if len(step_rows) != steps or not all(math.isfinite(r[1]) for r in step_rows):
        failures.append(f"{label}: steps lost or a loss not finite")
    per_stage, first = [], 0
    for s, res in enumerate(params["res_list"]):
        rows = step_rows[first:first + params["optim_iters"] * (s + 1)]
        first += len(rows)
        per_stage.append(dict(res=res, steps=len(rows),
                              step_ms_median=median([1e3 * r[2] for r in rows]),
                              loss_last=rows[-1][1]))
    print(f"{label}: {steps} steps of {nrays} rays in {seconds:.2f} s; escalation at stage "
          f"{escalated}; launches {launches}; K3 by path {paths}; per stage "
          + ", ".join(f"{st['res']}^3 {st['step_ms_median']:.3f} ms a step" for st in per_stage)
          + f"; {smi_line()}", flush=True)
    return dict(seconds=seconds, steps=steps, escalated=escalated, launches=launches,
                paths=paths, per_stage=per_stage), out


def r_band(failures, label, got, want, band):
    ok = abs(got - want) <= band
    print(f"  {label}: {got:.4f} (record {want:.4f}, band +-{band}): "
          f"{'inside' if ok else 'OUTSIDE'}", flush=True)
    if not ok:
        failures.append(f"{label} {got:.4f} lies outside {want:.4f} +- {band}")


def flagship_phase(out, failures):
    """r1: ``image_flagship.run`` uncut (IMG_ITERS 40: the record's 1,120 steps,
    2 views x 128^2 x 8 spp, 3^3 .. 129^3), each correlation within
    ``R_FLAGSHIP_BAND`` of the record's; then ``--report-only`` on the JAX
    record's own field, within ``R_JAX_FIELD_BAND``."""
    settings = image_flagship.Settings(result_dir=os.path.join(out, "r1"),
                                       iters=R_FLAGSHIP_ITERS)
    params = dict(image_flagship.run_params(settings), grad_spotcheck=True, auto_exact=True)
    nrays = 2 * image_flagship.RESOLUTION ** 2 * params["spp"]
    rec, (eta, hist, report) = image_root_path(
        "r1[image_flagship, IMG_ITERS 40]", params, nrays,
        lambda stat, metrics: image_flagship.run(settings, device="cuda", stat_fn=stat,
                                                 metrics=metrics), ("trace_fwd",), failures)
    if len(hist) != 1120 or eta.shape != (129,) * 3 or not bool(torch.isfinite(eta).all()):
        failures.append("r1: the flagship did not run its 1,120 steps to a finite 129^3 field")
    for key, want in R_FLAGSHIP_RECORD.items():
        r_band(failures, f"r1 {key}", report[key], want, R_FLAGSHIP_BAND)
    K.reset_launches()
    t0 = time.time()
    jax_report = image_flagship.main(["--report-only", "--checkpoint", R_JAX_FIELD],
                                     dict(IMG_DIR=os.path.join(out, "r1_jax_field")))
    torch.cuda.synchronize()
    report_s = time.time() - t0
    if dict(K.LAUNCHES) != {**{n: 0 for n in build.KERNELS}, "trace_fwd": 1}:
        failures.append(f"r1 --report-only must launch one K2, counted {dict(K.LAUNCHES)}")
    print(f"r1 --report-only on {R_JAX_FIELD} ({jax_report['n_iters']} steps, "
          f"{jax_report['stage_res']}^3) in {report_s:.2f} s:", flush=True)
    for key, want in R_FLAGSHIP_RECORD.items():
        r_band(failures, f"r1 JAX field {key}", jax_report[key], want, R_JAX_FIELD_BAND)
    return dict(rec, report=report, jax_field_report=jax_report, report_only_s=report_s)


def singleview_phase(out, failures):
    """r2: ``image_singleview.run`` uncut (630 steps to 65^3, one view of
    128^2 x 8 spp), its correlation within ``R_SINGLEVIEW_BAND`` of the
    record's."""
    settings = image_singleview.Settings(result_dir=os.path.join(out, "r2"))
    params = dict(image_singleview.run_params(settings, None), grad_spotcheck=True,
                  auto_exact=True)
    nrays = image_flagship.RESOLUTION ** 2 * params["spp"]
    rec, (eta, hist, report) = image_root_path(
        "r2[image_singleview]", params, nrays,
        lambda stat, metrics: image_singleview.run(settings, device="cuda", stat_fn=stat,
                                                   metrics=metrics), ("trace_fwd",), failures)
    if len(hist) != 630 or eta.shape != (65,) * 3:
        failures.append("r2: the single view did not run its 630 steps to 65^3")
    r_band(failures, "r2 corr_einstein_single_view", report["corr_einstein_single_view"],
           R_SINGLEVIEW_RECORD, R_SINGLEVIEW_BAND)
    return dict(rec, report=report)


class _Rows:
    """A run's ``metrics.jsonl`` rows as a logger's ``history``."""

    def __init__(self, path):
        with open(path) as f:
            self.history = [json.loads(line) for line in f if line.strip()]


def fiber_ladder_path(label, settings, failures):
    """A ``fiber_ladder.run`` on the card: each phase's run held to
    ``expected_fiber_launches`` for the stage its escalation fired at (read
    from its ``metrics.jsonl``), its L1 finite (a NaN fails the phase) and in
    ``R_FIBER_L1``; the files the script writes."""
    snaps, phases, t_phase = [], [], []
    t0 = time.time()
    K.reset_launches()

    def on_phase(phase, params):
        torch.cuda.synchronize()
        snaps.append(dict(K.LAUNCHES))
        phases.append((phase, params))
        t_phase.append(time.time())

    n, report = fiber_ladder.run(settings, device="cuda", on_phase=on_phase)
    seconds = time.time() - t0
    prev, rows = {name: 0 for name in build.KERNELS}, []
    for (phase, params), snap, t_end in zip(phases, snaps, t_phase):
        got = {name: snap[name] - prev[name] for name in snap}
        prev = snap
        name = phase["phase"]
        if params is None:  # init: a profile loaded, nothing launched
            want = {k: 0 for k in build.KERNELS}
            escalated = None
        else:
            sub = settings.result_dir if name == "ladder" else os.path.join(
                settings.result_dir, name)
            escalated = escalation_stage(_Rows(os.path.join(sub, "metrics.jsonl")))
            nrays = fiber.gen_start_rays(params, torch.Generator(device="cuda").manual_seed(1)) \
                .x.shape[0]
            _, want, _ = expected_fiber_launches(params, escalated, nrays)
        if got != want:
            failures.append(f"{label} {name} must launch {want}, counted {got}")
        l1 = phase["l1_vs_gt"]
        if name != "init" and not (math.isfinite(l1) and R_FIBER_L1[0] <= l1 <= R_FIBER_L1[1]):
            failures.append(f"{label} {name}: L1 {l1} is NaN or outside {R_FIBER_L1}")
        rows.append(dict(phase=name, l1_vs_gt=l1, escalated=escalated,
                         last_loss=phase.get("last_loss"), launches=got,
                         seconds=t_end - (t_phase[len(rows) - 1] if rows else t0)))
        print(f"{label} {name}: L1 {l1!r}, loss {phase.get('last_loss')}, escalation at stage "
              f"{escalated}, {rows[-1]['seconds']:.2f} s, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
    files = sorted(f for f in os.listdir(settings.result_dir) if f.endswith((".npy", ".json")))
    want_files = sorted(["final_profile.npy", "report.json"]
                        + [f"profile_refine{i}.npy" for i in range(len(settings.refine))])
    if files != want_files or not bool(torch.isfinite(n).all()):
        failures.append(f"{label} wrote {files}, not {want_files}, or a profile not finite")
    print(f"{label}: {len(rows)} phases in {seconds:.2f} s, final L1 {report['l1_vs_gt']!r}; "
          f"{smi_line()}", flush=True)
    return dict(seconds=seconds, phases=rows, l1_vs_gt=report["l1_vs_gt"],
                launches=dict(K.LAUNCHES))


def axial_ray_check(failures):
    """ROADMAP C13: K8 against its plain version on the near-axial ray of
    ``R_AXIAL_RAY`` (its profile, closest approach and cotangents), in f32 and
    in f64.  The bins where the kernel's gradient is not finite must be the
    plain version's, and the finite ones agree within ``TOL_F32_GRAD`` (f32,
    beside the plain version's f64 sum of its f32 terms) or ``TOL_F64`` of the
    largest.  Returns the gradients' first bins, which the ray's adjoint
    overflows in f32."""
    with open(R_AXIAL_RAY) as f:
        case = json.load(f)
    radius, length, ds, steps = case["radius"], case["length"], case["ds"], case["max_steps"]
    rec = {}
    for dtype, tol in ((torch.float32, TOL_F32_GRAD), (torch.float64, TOL_F64)):
        prof = torch.tensor(case["profile"], dtype=torch.float32, device="cuda").to(dtype)
        xt, vt, dx, dv = (torch.tensor(case[k], dtype=torch.float32, device="cuda")
                          .to(dtype).reshape(1, 3) for k in ("xt", "vt", "dx", "dv"))
        want = E.backtrace_cable(CylinderField(prof, radius, length), xt, vt, dx, dv, ds,
                                 steps, acc_dtype=torch.float64)
        got = K.backtrace_cable(prof, radius, length, xt, vt, dx, dv, ds, steps,
                                G.snap_tol(dtype) * radius)
        fin = torch.isfinite(want)
        scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
        name = str(dtype).split(".")[-1]
        rec[name] = dict(kernel=got[:3].tolist(), plain=want[:3].tolist(),
                         nonfinite_bins=torch.nonzero(~fin).flatten().tolist(), abs_err=err)
        if not torch.equal(torch.isfinite(got), fin) or err > tol * max(scale, 1e-300):
            failures.append(f"r3 axial ray ({name}): K8 {got[:3].tolist()} departs from its "
                            f"plain version {want[:3].tolist()} (err {err}, scale {scale})")
        print(f"r3 axial ray ({name}): K8 {got[:3].tolist()}, plain {want[:3].tolist()}, "
              f"non-finite bins {rec[name]['nonfinite_bins']}", flush=True)
    return rec


def fiber_ladder_phase(out, failures):
    """r3: K8 against its plain version on the near-axial ray of ROADMAP C13
    (:func:`axial_ray_check`); the shipped ladder uncut (100 steps a stage,
    spp 2, 3 -> 129 bins) and the shipped refinement; then ``FIBER_INIT`` on
    the JAX record's refined profile, its L1 equal to the record's within
    ``R_FIBER_INIT_TOL``."""
    axial = axial_ray_check(failures)
    shipped = fiber_ladder_path("r3[fiber_ladder, shipped]",
                                fiber_ladder.Settings(result_dir=os.path.join(out, "r3")),
                                failures)
    init = fiber_ladder_path("r3[fiber_ladder, FIBER_INIT]", fiber_ladder.Settings(
        result_dir=os.path.join(out, "r3_init"), init=R_FIBER_INIT, refine=()), failures)
    l1 = init["phases"][0]["l1_vs_gt"]
    if not abs(l1 - R_FIBER_INIT_L1) <= R_FIBER_INIT_TOL * R_FIBER_INIT_L1:
        failures.append(f"r3 FIBER_INIT: L1 {l1!r} is not the record's {R_FIBER_INIT_L1!r}")
    print(f"r3 FIBER_INIT: L1 {l1!r} against the record's {R_FIBER_INIT_L1!r} (relative "
          f"{abs(l1 - R_FIBER_INIT_L1) / R_FIBER_INIT_L1:.2e}, tol {R_FIBER_INIT_TOL})",
          flush=True)
    launches = {k: shipped["launches"][k] + init["launches"][k] for k in build.KERNELS}
    return dict(axial_ray=axial, shipped=shipped, init=init, launches=launches)


def headtohead_phase(out, ns_report, failures):
    """r4: ``fuel_headtohead.run`` cut to ``R_H2H_PROTOCOL``, beside the north
    star's report that phase n wrote in this run: one K2 and one K1, the 2008
    ``rel_norm`` in ``R_H2H_BAND``, every ratio the report's numbers'."""
    final, ns_final, per_stage = northstar.read_report(ns_report)
    K.reset_launches()
    t0 = time.time()
    recon, table = fuel_headtohead.run(protocol=R_H2H_PROTOCOL, northstar_report=ns_report,
                                       out_dir=os.path.join(out, "r4"), device="cuda")
    seconds = time.time() - t0
    launches = dict(K.LAUNCHES)
    if launches != {**{n: 0 for n in build.KERNELS}, "trace_fwd": 1, "eval_grad": 1}:
        failures.append(f"r4 must launch one K2 and one K1, counted {launches}")
    lin = table["linear_2008"]["rel_norm"]
    ns = {**per_stage, final: ns_final}
    want = {f"adjoint_{a}_vs_2008_recon16": lin / ns[a] for a in (17, final)}
    if table["advantage"] != want or recon.shape != (16,) * 3:
        failures.append(f"r4: advantage {table['advantage']}, not {want}")
    if not R_H2H_BAND[0] <= lin <= R_H2H_BAND[1]:
        failures.append(f"r4: the 2008 rel_norm {lin:.4f} lies outside {R_H2H_BAND}")
    print(f"r4[fuel_headtohead, {R_H2H_PROTOCOL}] in {seconds:.2f} s: linear "
          + json.dumps({k: table["linear_2008"][k] for k in (
              "rays", "rel_norm", "phi_nnz", "trace_time_s", "phi_time_s", "solve_time_s",
              "integration_time_s", "total_time_s")})
          + f"; advantage {json.dumps(table['advantage'])}; launches {launches}; {smi_line()}",
          flush=True)
    return dict(seconds=seconds, launches=launches, linear=table["linear_2008"],
                advantage=table["advantage"])


def sweeps_phase(out, ns_report, failures):
    """r5: the four sweeps in turn on ``R_SWEEP_SCREEN`` through the fuel
    volume at 17^3 (grids ``R_SWEEP_GRIDS``): each row's keys the JAX rows',
    no row an error, each best row the least ``rel_norm`` of the rows before
    it, its full-protocol row that configuration at 16 spp; one K2 and one K1
    a row, one K20 more for the true paths."""
    with open(R_SWEEP_ROW_KEYS) as f:
        row_keys = {tuple(json.loads(line)) for line in f if line.strip()}
    gt = G.upres_volume(fuel2008_sweep.ground_truth("cuda"), (R_SWEEP_RES,) * 3)
    d = os.path.join(out, "r5")
    common_kw = dict(out_dir=d, screen=R_SWEEP_SCREEN, device="cuda")
    calls = (("sweep", dict(northstar_report=ns_report)), ("sweep2", dict(grids=R_SWEEP_GRIDS)),
             ("sweep3", dict(northstar_report=ns_report, grids=R_SWEEP_GRIDS)),
             ("finish", dict(northstar_report=ns_report)))
    K.reset_launches()
    t0, seconds, nrows = time.time(), {}, 0
    for name, kw in calls:
        t1 = time.time()
        report = fuel2008_sweep.SWEEPS[name](gt, **common_kw, **kw)
        seconds[name] = time.time() - t1
        rows = report["rows"]
        best = min((r for r in rows[:-1] if "rel_norm" in r), key=lambda r: r["rel_norm"])
        keys = {tuple(r) for r in rows}
        if keys != row_keys or any("error" in r for r in rows):
            failures.append(f"r5 {name}: row keys {keys}, not the JAX rows' {row_keys}, or an "
                            "error")
        if report["best_screening"] != best or rows[-1]["cfg"] != dict(best["cfg"], spp=16) \
                or report["best_full_protocol"] != rows[-1]:
            failures.append(f"r5 {name}: the best row is not the least rel_norm's")
        print(f"r5[{name}] {len(rows)} rows in {seconds[name]:.2f} s, best "
              f"{best['name']} {best['rel_norm']:.4f}, full protocol "
              f"{rows[-1]['rel_norm']:.4f}", flush=True)
    with open(os.path.join(d, "sweep.jsonl")) as f:
        on_file = [json.loads(line) for line in f if line.strip()]
    nrows = len(on_file)
    launches = dict(K.LAUNCHES)
    true_rows = sum(1 for r in on_file if r["cfg"].get("spline") == "true")
    want = {**{n: 0 for n in build.KERNELS}, "trace_fwd": nrows, "eval_grad": nrows,
            "record_paths": true_rows}
    if launches != want:
        failures.append(f"r5 must launch {want}, counted {launches}")
    print(f"r5: {nrows} rows in {time.time() - t0:.2f} s; launches {launches}", flush=True)
    return dict(seconds=seconds, rows=nrows, launches=launches)


def roots_phase(ns_report, failures):
    """Phase r: r1-r5, each into a temporary directory (never ``results/``);
    r4 and r5 read the north star's report of phase n's n1 (``ns_report``)."""
    recs, times = {}, {}
    with tempfile.TemporaryDirectory() as out:
        for key, fn, args in (("flagship", flagship_phase, ()), ("singleview", singleview_phase, ()),
                              ("fiber_ladder", fiber_ladder_phase, ()),
                              ("headtohead", headtohead_phase, (ns_report,)),
                              ("sweeps", sweeps_phase, (ns_report,))):
            t0 = time.time()
            recs[key] = fn(out, *args, failures)
            times[key] = time.time() - t0
            torch.cuda.empty_cache()
    print("phase r seconds: " + json.dumps(times), flush=True)
    return dict(recs, seconds=times)


# ---------------------------------------------------------------------------
# the stencil's f32 division (kernels/csrc/trilinear.cuh, div_h) and what the
# compiler made of the forward loop
# ---------------------------------------------------------------------------

def grid_spans():
    """{name: (span, grid sides)} of the script's grids: the bench scene and
    its 17^3 cut (span 20), configuration 14's 1025^3, every stage of the
    fuel trainer, ``fuel-128`` and the four drivers, and each span's 17^3
    grid (the compaction check's, the late sdf crossing's)."""
    spans = {"bench": (20.0, (RES, 17, SLAB_RES)), "fuel": (fuel_params()["vol_span"],
                                                           fuel_params()["res_list"]),
             "fuel-128": (fuel128_params()["vol_span"], fuel128_params()["res_list"]),
             "northstar": (northstar.VOL_SPAN, [r for r, _, _ in northstar.SHIPPED_STAGES])}
    for name in DRIVERS:
        p = driver_params(name)
        spans[name] = (p["vol_span"], p["res_list"])
    return {name: (span, sorted(set(res_list) | {17})) for name, (span, res_list) in spans.items()}


def stencil_spacings():
    """The f32 grid spacings the script's grids use (:func:`grid_spans`), {h:
    where}.  The kernels take h as the f32 rounding of ``span / (res - 1)``."""
    hs = {}
    for name, (span, res_list) in grid_spans().items():
        for res in res_list:
            h = float(np.float32(span / (res - 1)))
            hs.setdefault(h, []).append(f"{name} {res}^3")
    return hs


# the 2008 baseline's f64 grids: the 65^3 fuel volume, the small check's 17^3
# bump (span 1), and the non-power-of-two spacing record_paths_checks steps
# the fuel volume at
F2008_SPACINGS = {1.0 / 64: "fuel2008 65^3", 1.0 / 16: "fuel2008 small 17^3"}
K20_OPERATOR_H = 0.9 / 64


def stencil_spacings64():
    """The f64 grid spacings the script's grids use, {h: where}: those of
    :func:`grid_spans` in f64, the 2008 baseline's (``F2008_SPACINGS``) and
    ``K20_OPERATOR_H``."""
    hs = {}
    for name, (span, res_list) in grid_spans().items():
        for res in res_list:
            hs.setdefault(span / (res - 1), []).append(f"{name} {res}^3")
    for h, where in F2008_SPACINGS.items():
        hs.setdefault(h, []).append(where)
    hs.setdefault(K20_OPERATOR_H, []).append("K20 at a spacing not a power of two")
    return hs


def stencil_div64_checks():
    """The f64 stencil's division (``div_h``: the exact multiply where the
    spacing is a power of two, else the operator) against the operator at
    every spacing of :func:`stencil_spacings64`, on the card, for the edge
    dividends and 2^32 random ones (``wrappers.stencil_div64_check``): any
    difference fails the run, as does a grid that took the multiply where
    ``wrappers.exact_reciprocal`` (the host's twin) says it may not, or the
    other way round."""
    failures, rows = [], {}
    t0 = time.time()
    for h, where in stencil_spacings64().items():
        n, first, exact = K.stencil_div64_check(h)
        rows[h] = (n, exact)
        if n:
            failures.append(f"the f64 div_h differs from the operator on {n} dividends at h = "
                            f"{h!r} ({', '.join(where)}): first {first}")
        if exact != K.exact_reciprocal(h):
            failures.append(f"at h = {h!r} the f64 grid took the "
                            f"{'multiply' if exact else 'operator'}; exact_reciprocal says "
                            f"{K.exact_reciprocal(h)}")
    torch.cuda.synchronize()
    kinds = {exact for _, exact in rows.values()}
    if kinds != {True, False}:
        failures.append(f"the f64 division check ran only the {kinds} branch")
    print(f"stencil division f64: div_h against the operator on {len(K.DIV64_EDGES)} edge and "
          f"2^32 random dividends at {len(rows)} spacings in {time.time() - t0:.1f} s; "
          f"quotients that differ: " + ", ".join(
              f"h = {h:.9g} ({'multiply' if e else 'operator'}): {n}"
              for h, (n, e) in rows.items()), flush=True)
    return failures


def stencil_div_checks():
    """``div_h`` against the operator over all 2^32 f32 dividends at every
    spacing of :func:`stencil_spacings`, on the card: how many quotients
    differ and their first dividends.  Expected none (trilinear.cuh's
    argument); any difference fails the run."""
    failures, rows = [], {}
    t0 = time.time()
    for h, where in stencil_spacings().items():
        n, first = K.stencil_div_check(h)
        rows[h] = n
        if n:
            failures.append(f"div_h differs from the operator on {n} of the 2^32 f32 dividends "
                            f"at h = {h!r} ({', '.join(where)}): first dividends "
                            + ", ".join(f"{np.array(b, dtype=np.uint32).view(np.float32)!r} "
                                        f"(0x{b:08x})" for b in first))
    torch.cuda.synchronize()
    print(f"stencil division: div_h against the operator over all 2^32 f32 dividends at "
          f"{len(rows)} spacings in {time.time() - t0:.1f} s; quotients that differ: "
          + ", ".join(f"h = {h:.9g}: {n}" for h, n in rows.items()), flush=True)
    return failures


def demangle(text):
    """``text`` with the C++ names in it demangled, where the toolkit has cu++filt."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cu++filt")
    names = sorted(set(re.findall(r"_Z\w+", text)), key=len, reverse=True)
    if not os.path.exists(tool) or not names:
        return text
    out = subprocess.run([tool, *names], capture_output=True, text=True)
    if out.returncode != 0:
        return text
    for name, plain in zip(names, out.stdout.splitlines()):
        text = text.replace(name, plain)
    return text


def sass_functions(lib_path):
    """``{demangled kernel name: its cuobjdump -sass text}`` of a library."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    return {demangle(part.split("\n", 1)[0].strip()): part
            for part in re.split(r"\n\s*Function : ", sass)[1:]}


#: the step loop's instructions counted apart (step_loop)
STEP_OPS = ("FCHK", "CALL", "BSSY", "MUFU", "LDG", "STG", "F2F", "DFMA", "DMUL")
#: the forward kernels' f32 instantiations in trace_fwd.cu's machine code
#: (patterns of their demangled names: cu++filt writes a bool argument as
#: (bool)0 / (bool)1)
FWD_KERNELS = {
    label: rf"{kern}<float, (?:\(bool\){int(ckpt == 'true')}|{ckpt}), anrt::{rule}, "
           r"anrt::FwdLoop>"
    for label, kern, ckpt, rule in (
        ("trace_fwd", "trace_fwd_kernel", "false", "VolumeRule<float>"),
        ("trace_ckpt", "trace_fwd_kernel", "true", "VolumeRule<float>"),
        ("trace_plane", "trace_fwd_kernel", "false", "PlaneRule<float>"),
        ("trace_plane_ckpt", "trace_fwd_kernel", "true", "PlaneRule<float>"),
        ("trace_target", "trace_fwd_kernel", "false", "TargetRule<float>"),
        ("trace_target_ckpt", "trace_fwd_kernel", "true", "TargetRule<float>"),
        ("trace_target pass 2", "trace_horizon_kernel", "false", "TargetRule<float>"),
        ("trace_target_ckpt pass 2", "trace_horizon_kernel", "true", "TargetRule<float>"),
        ("trace_sdf", "trace_fwd_kernel", "false", r"SdfRule<float, (?:\(int\))?3>"))}
#: K20's f64 kernel: its step loop at the 2008 volume's spacing, the smaller
#: of its two (the multiply's; the operator's is the other)
FWD_KERNELS["record_paths (f64)"] = r"record_paths_kernel<double, anrt::FwdLoop>"


def step_loop(sass, corners=True):
    """One iteration of a kernel's step loop in its machine code: the
    smallest backward branch's range that holds the stencil's 8 corner
    loads, its instructions over its loads / 8 (in case the compiler
    unrolled it); with ``corners`` False (pass 2 reads no grid) the largest
    backward branch's range.  Returns {op: count an iteration, "total": ...}."""
    lines = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", sass)]
    best = None
    for addr, op, rest in lines:
        t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if not t or int(t.group(1), 16) >= addr:
            continue
        body = [o for a, o, _ in lines if int(t.group(1), 16) <= a <= addr]
        ldg = sum(o.startswith("LDG") for o in body)
        if (corners and ldg >= 8 and (best is None or len(body) < len(best))) or \
                (not corners and (best is None or len(body) > len(best))):
            best = body
    if best is None:
        return None
    per = max(1, sum(o.startswith("LDG") for o in best) // 8) if corners else 1
    counts = {"total": len(best) / per}
    counts.update({op: sum(o.split(".")[0] == op for o in best) / per for op in STEP_OPS})
    return counts


def step_instructions(lib_path=None, kernels=FWD_KERNELS):
    """The step loop's machine code (:func:`step_loop`) of the forward
    kernels in ``lib_path`` (the built ``trace_fwd.cu`` by default)."""
    funcs = sass_functions(lib_path or build.load("trace_fwd")._name)
    res = {}
    for label, pat in kernels.items():
        text = next((t for name, t in funcs.items() if re.search(pat, name)), None)
        res[label] = step_loop(text, "horizon" not in pat) if text else None
    return res


def target_retirement(f, x0, v0, tgt, ds, max_steps):
    """The target forward's escaped rays under K12's and K16's retirement
    rule (``wrappers.target_retired_plain``), in plain torch: the steps they
    take after their escape with it and without it (to the batch's horizon,
    as before), the rays that retire before the horizon, and the steps at or
    after a ray's retirement that came strictly closer to its target than
    its running minimum (the rule says none)."""
    ds_t = G._scalar(ds, x0)
    x, v = x0, v0
    inside = G.inbounds(f, x0)
    esc = torch.zeros_like(inside)
    retired = torch.zeros_like(inside)
    d2 = E.sum_sq3(x0 - tgt)
    ballistic = needed = closer = step = 0
    while step < max_steps and not bool(esc.all()):
        retired = retired | (esc & K.target_retired_plain(x, v, tgt))
        ballistic += int(esc.sum())
        needed += int((esc & ~retired).sum())
        x, v = E.forward_step(f, x, v, inside, ds_t)
        cur = E.sum_sq3(x - tgt)
        closer += int((retired & (cur < d2)).sum())
        d2 = torch.where(cur < d2, cur, d2)
        cur_inside = G.inbounds(f, x)
        esc = esc | (inside & ~cur_inside) | G.escaped(f, x, v)
        inside = cur_inside
        step += 1
    return dict(horizon=step, ballistic_steps=ballistic, ballistic_needed=needed,
                saved=ballistic - needed, retired=int(retired.sum()),
                closer_after_retirement=closer)


def retirement_line(ret):
    return (f"retirement: {ret['retired']} rays retired before the horizon {ret['horizon']}, "
            f"saving {ret['saved']} of {ret['ballistic_steps']} steps after escape "
            f"({ret['ballistic_needed']} left); steps after a retirement that came closer: "
            f"{ret['closer_after_retirement']}")


MAIN_PATH_PASSES = 1 + BENCH_ITERS + 1


def main_path():
    """The bench scene through the entry points a user calls.

    ``bench.run`` and ``api.trace`` + ``backward`` launch K2 and K3 once per
    pass and never K1; ``tracer.trace_exact`` + ``backward`` launches K5 and
    K6 once; ``fields.grid.eval_grad``, the port's field evaluation for
    callers outside the steppers, launches K1 once.
    """
    events = []
    K.record_events(events)  # K2 and K3 of each pass, from events around the launches
    try:
        rec = bench.run(res=RES, nrays=NRAYS, iters=BENCH_ITERS)
    finally:
        K.record_events(None)
    torch.cuda.synchronize()
    timed = events[2:]  # the warm-up pass launched the first two
    for name in ("trace_fwd", "backtrace"):
        ms = sorted(a.elapsed_time(b) for n, a, b in timed if n == name)
        rec[f"{name}_ms_median"] = ms[len(ms) // 2]
    if not rec["grad_finite"]:
        raise AssertionError("bench.run: the gradient is not finite")

    rif, x0, v0, span = build_case(res=RES, nrays=NRAYS, device="cuda")
    rif.requires_grad_(True)
    x0.requires_grad_(True)
    v0.requires_grad_(True)
    loss = bench.bench_loss(rif, x0, v0, span)
    loss.backward()
    g = rif.grad
    if g is None or g.shape != rif.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError("the voxel gradient is missing, misshapen or not finite")
    if not float(g.abs().max()) > 0 or not bool(torch.isfinite(loss)):
        raise AssertionError("the voxel gradient is all zero or the loss is not finite")
    if x0.grad is not None or v0.grad is not None:
        raise AssertionError("x and v must receive no gradient")

    # the same loss through the exact gradient, as the trainer runs it once
    # the adjoint drifts: one K5 and one K6 launch
    h = span / (RES - 1)
    r_ex = rif.detach().clone().requires_grad_(True)
    target = torch.tensor([span / 2, span * 1.1, span / 2], dtype=rif.dtype, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    xt_ex, vt_ex = tracer.trace_exact(r_ex, x0.detach(), v0.detach(), h, h / 2)
    loss_ex = ((xt_ex - target) ** 2).sum() + vt_ex.sum()
    loss_ex.backward()
    torch.cuda.synchronize()
    rec["exact_ms"] = 1e3 * (time.time() - t0)
    g_ex = r_ex.grad
    if g_ex is None or not bool(torch.isfinite(g_ex).all()) or not float(g_ex.abs().max()) > 0:
        raise AssertionError("trace_exact: the voxel gradient is missing, not finite or zero")
    if float(loss_ex.detach()) != float(loss.detach()):
        raise AssertionError("trace_exact's loss differs from api.trace's: the exit states differ")
    rec["exact_vs_adjoint_rel_l2"] = float(torch.linalg.norm(g_ex - g) / torch.linalg.norm(g_ex))

    after_trace = dict(K.LAUNCHES)

    # the field and its gradient along the rays, as a user inspects a volume
    with torch.no_grad():
        f = G.GridField(rif.detach(), span / (RES - 1))
        p = (x0 + (0.5 * span) * v0).contiguous()
        inside = G.inbounds(f, p)
        n, grad = G.eval_grad(f, p, inside)
    if n.shape != (NRAYS,) or grad.shape != (NRAYS, 3):
        raise AssertionError("eval_grad: wrong shapes")
    if not bool(torch.isfinite(n).all() and torch.isfinite(grad).all()):
        raise AssertionError("eval_grad: values not finite")
    lo, hi = float(f.data.min()) - 1e-5, float(f.data.max()) + 1e-5
    if not bool(inside.any()) or not bool(((n[inside] >= lo) & (n[inside] <= hi)).all()):
        raise AssertionError("eval_grad: an interpolated value leaves the grid's range")
    if bool((n[~inside] != 0).any()):
        raise AssertionError("eval_grad: a masked point is not zero")
    torch.cuda.synchronize()
    rec.update(loss=float(loss.detach()), grad_abs_max=float(g.abs().max()),
               points_inside=int(inside.sum()))
    return rec, after_trace


def main():
    t_start = time.time()
    card = smi_line()
    if card is None:
        raise RuntimeError("nvidia-smi does not read the card's name and power limit")
    print(f"device: {card}", flush=True)

    t0 = time.time()
    for name in build.KERNELS:
        build.load(name)
    print(f"build: {len(build.KERNELS)} kernels for sm_90a in {time.time() - t0:.1f} s "
          f"({' '.join(build.NVCC_FLAGS)})", flush=True)
    for name, log in build.build_logs().items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "arning")):
                print(f"  nvcc[{name}] {line.strip()}")
    div_failures = stencil_div_checks() + stencil_div64_checks()

    small = scene(17, 512, "float64", noise=0.02)
    compare_kernels(small, TOL_F64, TOL_F64, "f64 17^3 x 512")

    def bench_cot(s):
        return lambda xt, vt: (2.0 * (xt - s["target"]), torch.ones_like(vt))

    _, failures = exact_check(small["rif"], small["h"], small["ds"], small["x0"], small["v0"],
                              bench_cot(small), "f64 17^3", TOL_F64)
    failures += div_failures
    api_small_check()
    exact_api_check()
    full = scene(RES, NRAYS, "float32")
    cmp = compare_kernels(full, TOL_F32_STATE, TOL_F32_GRAD, f"f32 {RES}^3 x {NRAYS}")
    times = time_kernels(full, cmp)
    ex_bench, ex_failures = exact_check(full["rif"], full["h"], full["ds"], full["x0"],
                                        full["v0"], bench_cot(full), f"f32 {RES}^3",
                                        TOL_F32_GRAD, times=True)
    failures += ex_failures
    plain_fwd_ms, plain_bwd_ms = exact_plain_ms(full["rif"], full["h"], full["ds"], full["x0"],
                                                full["v0"], bench_cot(full))
    times["trace_ckpt"] = dict(ex_bench["k5"], plain_ms=plain_fwd_ms, library_ms=None)
    times["backtrace_exact"] = dict(ex_bench["k6"], plain_ms=plain_bwd_ms, library_ms=None)
    print(f"work[f32 full width] forward ray-steps {cmp['fstats']['ray_steps']} "
          f"(evaluating {cmp['fstats']['evals']}), backward ray-steps "
          f"{cmp['bstats']['ray_steps']} (evaluating {cmp['bstats']['evals']}), "
          f"splats {cmp['bstats']['splats']} ({8 * cmp['bstats']['splats']} adds a splat each "
          f"would issue), runs {cmp['bstats']['flushes']} ({8 * cmp['bstats']['flushes']} adds "
          f"one a run would issue), issued after the warp sums {cmp['issued']} "
          f"({8 * cmp['issued']} atomic adds)", flush=True)
    work, stage_rows, stage_failures = stage_checks(fuel_params())
    failures += stage_failures
    cable_small, cable_failures = cable_check(cable_scene(*CABLE_SMALL, torch.float64),
                                              f"f64 {CABLE_SMALL[0]} bins")
    failures += cable_failures
    full_bins = fiber_params()["res_list"][-1]
    cable_full, cable_failures = cable_check(
        cable_scene(full_bins, None, torch.float32, both_passes=True),
        f"f32 {full_bins} bins, a fiber step's two passes", times=True)
    failures += cable_failures
    times.update(cable_full["times"])
    failures += cable_seg_check(cable_scene(*CABLE_SMALL, torch.float64),
                                f"f64 {CABLE_SMALL[0]} bins")
    failures += cable_seg_check(cable_scene(full_bins, None, torch.float32, both_passes=True),
                                f"f32 {full_bins} bins, a fiber step's two passes")
    cable_api_check()
    failures += cable_block_path_check()
    k20, k20_failures = record_paths_checks()
    failures += k20_failures
    times["record_paths"] = k20
    t_m = time.time()
    mesh_rec, mesh_failures = mesh_bench_check()
    failures += mesh_failures
    phase_m_checks_s = time.time() - t_m

    # phase v: the variants K11-K14 against their plain versions
    t_v = time.time()
    var_small = variant_scene(17, 512, "float64", noise=0.02)
    var_small_row, var_failures = variant_check(var_small, "f64 17^3", TOL_F64)
    failures += var_failures
    failures += variant_ragged_check(var_small, "f64 17^3")[1]
    var_full = variant_scene(RES, NRAYS, "float32")
    var_row, var_failures = variant_check(var_full, f"f32 {RES}^3", TOL_F32_GRAD, times=True)
    failures += var_failures
    var_ragged, var_failures = variant_ragged_check(var_full, f"f32 {RES}^3")
    failures += var_failures
    for dtype in ("float64", "float32"):
        failures += sdf_late_check(dtype)
    times.update(var_row["times"])
    phase_v_checks_s = time.time() - t_v

    gather = gather_check_and_time()
    times["gather_rows"] = gather

    K.reset_launches()
    rec, after_trace = main_path()
    bench_launches = dict(K.LAUNCHES)
    bench_paths = kernel_paths()
    print(f"main path: {json.dumps(rec)}", flush=True)
    k2, k3 = rec["trace_fwd_ms_median"], rec["backtrace_ms_median"]
    print(f"bench split: {rec['ms_per_iter']:.3f} ms an iteration = K2 {k2:.3f} + K3 {k3:.3f} "
          f"+ {rec['ms_per_iter'] - k2 - k3:.3f} ms of the rest, of which the ray order takes "
          f"about {times['order_ms']:.3f} ms (timed alone above)", flush=True)
    print(f"exact on the bench scene: tracer.trace_exact forward + backward "
          f"{rec['exact_ms']:.3f} ms on the host clock; its gradient against the adjoint's: "
          f"rel-L2 {rec['exact_vs_adjoint_rel_l2']:.3e}", flush=True)
    print(f"launches after bench.run, api.trace and trace_exact: {after_trace}; "
          f"after fields.grid.eval_grad as well: {bench_launches}", flush=True)
    want = {**{name: 0 for name in build.KERNELS}, "trace_fwd": MAIN_PATH_PASSES,
            "backtrace": MAIN_PATH_PASSES, "trace_ckpt": 1, "backtrace_exact": 1}
    if after_trace != want:
        raise AssertionError(f"{MAIN_PATH_PASSES} forward + adjoint passes and one exact pass "
                             f"must launch {want}, counted {after_trace}")
    if bench_launches != {**want, "eval_grad": 1}:
        raise AssertionError(f"fields.grid.eval_grad must launch K1 once, counted "
                             f"{bench_launches}")
    bench_path = K.backtrace_path(RES ** 3, torch.float32)
    want_paths = {"backtrace": {"shared": 0, "global": 0}}
    want_paths["backtrace"][bench_path] = MAIN_PATH_PASSES
    if bench_paths != want_paths:
        raise AssertionError(f"K3 on the bench scene must take {want_paths}, counted "
                             f"{bench_paths}")

    probe_launches = gather_probe_path()
    fuel = fuel_path(FUEL_ITERS, f"f32 full width, optim_iters cut to {FUEL_ITERS}", work)
    fuel_small_check()
    print(f"fuel: the {fuel['steps']}-step run took {fuel['seconds']:.1f} s, so the shipped "
          f"{FUEL_ITERS_SHIPPED} iterations a stage are predicted at "
          f"{fuel['seconds'] * FUEL_ITERS_SHIPPED / FUEL_ITERS:.0f} s", flush=True)
    drivers = {}
    for name in DRIVERS:
        drivers[name] = driver_path(name)
        if name in ("image", "focalstack"):
            drivers[name]["splat"] = splat_times(name, driver_params(name), drivers[name]["eta"])
    big_row = big_stage_check(drivers["luneburg"]["eta"], failures)
    comp, comp_failures = compaction_check(drivers["luneburg"]["eta"])
    failures += comp_failures
    comp["luneburg_adjoint_stages_ms_a_step"] = luneburg_bucket_steps()
    for name in DRIVERS:
        drivers[name].pop("eta")
        driver_small_check(name)
    fiber_rec = fiber_path()
    fiber_exact = fiber_path("exact")
    print("fiber, exact against adjoint: " + "; ".join(
        f"{k} {fiber_exact[k]:.6g} against {fiber_rec[k]:.6g}"
        for k in ("loss_last", "l2_to_ground_truth", "seconds")), flush=True)
    fiber_small_check()
    fiber_small_check("exact")
    t_v = time.time()
    variants = variants_path(var_full)
    phase_v_s = phase_v_checks_s + time.time() - t_v

    # phase x: the variants' exact gradients, K15-K19 (K6 for the target)
    t_x = time.time()
    variant_exact_rows = []
    for s_, dtype, tol in ((var_small, "float64", TOL_F64), (var_full, "float32", TOL_F32_GRAD)):
        label = f"{'f64 17' if dtype == 'float64' else f'f32 {RES}'}^3"
        for variant in EXACT_VARIANTS:
            for chunk in (0, EXACT_CHECK_CHUNK[dtype]):
                row, x_failures = exact_variant_check(
                    exact_case(s_, variant), label, tol, chunk,
                    times=dtype == "float32" and chunk == 0)
                variant_exact_rows.append(row)
                failures += x_failures
    # the ragged target batch (one more ray, at rest outside the grid: the
    # horizon is max_steps, whichever chunk holds that ray) and the sdf's late
    # crossing (rays that leave the grid inside the sdf), whole and chunked
    still = torch.full((1, 3), -var_small["h"], dtype=torch.float64, device="cuda")
    ragged = exact_case(var_small, "target", x=torch.cat([var_small["x0"], still]),
                        v=torch.cat([var_small["v0"], torch.zeros_like(still)]),
                        tgt=torch.cat([var_small["tgt"], var_small["tgt"][:1]]))
    for chunk in (0, EXACT_CHECK_CHUNK["float64"]):
        row, x_failures = exact_variant_check(ragged, "f64 17^3, ragged", TOL_F64, chunk)
        failures += x_failures
        if row["horizon"] != var_small["nf"]:
            failures.append(f"the ragged target batch did not run to max_steps: {row['horizon']}")
        variant_exact_rows.append(row)
    for dtype, tol in (("float64", TOL_F64), ("float32", TOL_F32_GRAD)):
        late = late_sdf_scene(dtype)
        for chunk in (0, 10):  # 64 rays: 7 chunks, the last padded with 6 copies of ray 0
            row, x_failures = exact_variant_check(
                exact_case(late, "sdf", x=late["x0"], v=late["v0"]),
                f"{dtype} 17^3, late sdf crossing", tol, chunk)
            failures += x_failures
            variant_exact_rows.append(row)
    # the plane's and the target's rows at other segment lengths: 48 and 7
    # (a horizon and capture steps that fall inside segments)
    for variant in ("plane", "target"):
        for seg in EXACT_CHECK_SEGS:
            row, x_failures = exact_variant_check(dict(exact_case(var_full, variant), seg=seg),
                                                  f"f32 {RES}^3, seg {seg}", TOL_F32_GRAD)
            failures += x_failures
            variant_exact_rows.append(row)
    failures += exact_variants_api_check(var_small)
    var_big = variant_scene(RES, EXACT_CHUNKED_RAYS, "float32")
    exact_path = exact_variants_path(var_full, var_big)
    del var_big
    phase_x_s = time.time() - t_x
    for row in variant_exact_rows:
        for name, rec in row.pop("times", {}).items():
            if name in EXACT_VARIANT_KERNELS:
                times[name] = rec
            else:  # the target's K6
                exact_path[f"{name} (target)"] = rec
    t_p = time.time()
    fuel2008_small_check()
    f2008 = fuel2008_path()
    fuel2008_small_check("true")
    f2008_true = fuel2008_path(F2008_TRUE_CONFIG, "combo_recon16_true", F2008_TRUE_BAND,
                               F2008_TRUE_JAX_REL_NORM)
    phase_p_s = time.time() - t_p
    t_m = time.time()
    fuel128 = fuel128_path()
    fuel128_small_check()
    phase_m_s = phase_m_checks_s + time.time() - t_m
    # phase s: the sharded variants and the z-slab ring, K21 and K22
    t_s = time.time()
    sharded, sharded_launches, s_failures = sharded_variants_check(
        var_full, cable_scene(full_bins, None, torch.float32, both_passes=True))
    failures += s_failures
    del var_full
    slab_checks = []
    for dtype, tol, cap in (("float64", TOL_F64, None), ("float32", TOL_F32_GRAD, None),
                            ("float32", TOL_F32_GRAD, SLAB_CHECK_CAP)):
        row, s_failures = slab_kernel_check(dtype, tol, cap)
        slab_checks.append(row)
        failures += s_failures
    torch.cuda.empty_cache()
    slab_rec, slab_launches, slab_times, s_failures = slab_path()
    failures += s_failures
    times.update(slab_times)
    phase_s_s = time.time() - t_s
    # phase q: the measurement modules
    torch.cuda.empty_cache()
    t_q = time.time()
    measure, measure_launches, q_failures = measure_path()
    failures += q_failures
    phase_q_s = time.time() - t_q
    # phase n: the fuel north star
    torch.cuda.empty_cache()
    t_n = time.time()
    with tempfile.TemporaryDirectory() as keep:
        ns_report = os.path.join(keep, "northstar_report.json")
        ns = northstar_phase(failures, keep_report=ns_report)
        phase_n_s = time.time() - t_n
        # phase r: the JAX system's last repo-root drivers, as port modules
        torch.cuda.empty_cache()
        t_r = time.time()
        roots = roots_phase(ns_report, failures)
        phase_r_s = time.time() - t_r
    print(f"phases: v (variants) {phase_v_s:.1f} s, x (exact variants) {phase_x_s:.1f} s, "
          f"p (fuel2008) {phase_p_s:.1f} s, m (mesh, fuel-128) {phase_m_s:.1f} s, "
          f"s (sharded variants, slab ring) {phase_s_s:.1f} s, q (measurement modules) "
          f"{phase_q_s:.1f} s, n (north star) {phase_n_s:.1f} s, r (root drivers) "
          f"{phase_r_s:.1f} s", flush=True)
    full_run = fuel_path(FUEL_ITERS_SHIPPED, "f32 full width, shipped optim_iters", work)
    print(f"fuel[shipped] {full_run['steps']} steps in {full_run['seconds']:.1f} s, escalated "
          f"at stage {full_run['escalated']}, rel_norm {full_run['rel_norm']:.4f}", flush=True)
    print("drivers: " + json.dumps(drivers), flush=True)
    print("fiber: " + json.dumps(fiber_rec), flush=True)
    print("fiber exact: " + json.dumps(fiber_exact), flush=True)
    print("variants: " + json.dumps({k: v for k, v in variants.items() if k != "launches"}),
          flush=True)
    print("exact variants: " + json.dumps({k: v for k, v in exact_path.items()
                                            if k != "launches"}), flush=True)
    print("mesh: " + json.dumps(mesh_rec), flush=True)
    print("fuel128: " + json.dumps(fuel128), flush=True)
    print("slab: " + json.dumps(slab_rec), flush=True)
    print("compaction: " + json.dumps(comp), flush=True)
    print("measure: " + json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "result"}
                                    for k, v in measure.items()}), flush=True)
    print("northstar: " + json.dumps(ns), flush=True)
    print("roots: " + json.dumps(roots), flush=True)

    paths = {"bench": bench_launches, "probe": probe_launches, "fuel": fuel["launches"],
             **{name: d["launches"] for name, d in drivers.items()},
             "fiber": fiber_rec["launches"], "fiber_exact": fiber_exact["launches"],
             "variants": variants["launches"], "variants_exact": exact_path["launches"],
             "fuel2008": f2008["launches"], "fuel2008_true": f2008_true["launches"],
             "fuel128": fuel128["launches"], "sharded": sharded_launches, "slab": slab_launches,
             "measure": measure_launches, "northstar": ns["n1"]["launches"],
             "northstar_n2": ns["n2"]["launches"],
             "northstar_n2_control": ns["n2_control"]["launches"],
             **{f"r_{key}": roots[key]["launches"] for key in (
                 "flagship", "singleview", "fiber_ladder", "headtohead", "sweeps")}}
    replaces = {
        "eval_grad": "adjointnonlinearraytracing_tpu/benchmarks/probe_evalmath.py:107",
        "trace_fwd": "adjointnonlinearraytracing_tpu/tracer/paired.py:64",
        "backtrace": "adjointnonlinearraytracing_tpu/tracer/paired.py:260",
        "gather_rows": "adjointnonlinearraytracing_tpu/benchmarks/probe_dma_gather.py:47",
        "trace_ckpt": "adjointnonlinearraytracing_tpu/tracer/checkpointed.py:107",
        "backtrace_exact": "adjointnonlinearraytracing_tpu/tracer/checkpointed.py:209",
        "trace_cable": "adjointnonlinearraytracing_tpu/tracer/eikonal.py:187",
        "backtrace_cable": "adjointnonlinearraytracing_tpu/tracer/eikonal.py:327",
        "trace_cable_ckpt": "adjointnonlinearraytracing_tpu/tracer/checkpointed.py:724",
        "backtrace_cable_exact": "adjointnonlinearraytracing_tpu/tracer/checkpointed.py:780",
        "trace_plane": "adjointnonlinearraytracing_tpu/tracer/paired.py:90",
        "trace_target": "adjointnonlinearraytracing_tpu/tracer/paired.py:140",
        "trace_sdf": "adjointnonlinearraytracing_tpu/tracer/paired.py:201",
        "backtrace_sdf": "adjointnonlinearraytracing_tpu/tracer/paired.py:336",
        **{name: "adjointnonlinearraytracing_tpu/tracer/checkpointed.py:107"
           for name in ("trace_plane_ckpt", "trace_target_ckpt", "trace_sdf_ckpt")},
        **{name: "adjointnonlinearraytracing_tpu/tracer/checkpointed.py:209"
           for name in ("backtrace_plane_exact", "backtrace_sdf_exact")},
        "record_paths": "adjointnonlinearraytracing_tpu/pathmatrix/fuel2008.py:55",
        "slab_trace_phase": "adjointnonlinearraytracing_tpu/parallel/slabs.py:257",
        "slab_backtrace_phase": "adjointnonlinearraytracing_tpu/parallel/slabs.py:335",
    }
    errs = dict(zip(("eval_grad", "trace_fwd", "backtrace"), zip(cmp["abs_err"], cmp["rel_err"])))
    errs["gather_rows"] = (gather["max_abs_err"], gather["max_abs_err"])
    errs["trace_ckpt"] = (ex_bench["fwd_abs_err"], ex_bench["fwd_rel_err"])  # bitwise, asserted
    errs["backtrace_exact"] = (ex_bench["abs_err"], ex_bench["rel_err"])
    for name in CABLE_KERNELS:  # K7 and K9 bitwise, asserted
        e = cable_full["errs"][name]
        errs[name] = (e["abs_err"], e["rel_err"])
    for name in ("trace_plane", "trace_target", "trace_sdf"):  # bitwise, asserted
        errs[name] = var_row["fwd_err"][name]
    errs["backtrace_sdf"] = (var_row["backtrace_sdf_abs_err"], var_row["backtrace_sdf_rel_err"])
    errs["record_paths"] = (k20["max_abs_err"], k20["max_abs_err"])  # bitwise, asserted
    errs["slab_trace_phase"] = (  # bitwise, asserted
        max([r["fwd_abs_err"] for r in slab_checks] + [slab_rec["out_abs_err"]]),
        max([r["fwd_rel_err"] for r in slab_checks] + [slab_rec["out_rel_err"]]))
    errs["slab_backtrace_phase"] = tuple(  # f32: one launch and the band sweep
        max(slab_checks[1][pre + key] for pre in ("", "band_"))
        for key in ("grad_abs_err", "grad_rel_err"))
    for variant, (fname, bname) in EXACT_VARIANTS.items():  # the f32 checks at full width
        rows_b = [r for r in variant_exact_rows
                  if r["variant"] == variant and r["label"] == f"f32 {RES}^3"]
        errs[fname] = (max(r["fwd_abs_err"] for r in rows_b),
                       max(r["fwd_rel_err"] for r in rows_b))
        if bname in EXACT_VARIANT_KERNELS:
            errs[bname] = (max(r["abs_err"] for r in rows_b), max(r["rel_err"] for r in rows_b))
    stage_rows += [big_row, ns["stage_check"]]
    exact_rows = [row.pop("exact") for row in stage_rows if "exact" in row]
    fuel_stage_ms = {}
    for kf, kb, grad in (("trace_fwd", "backtrace", "adjoint"),
                         ("trace_ckpt", "backtrace_exact", "exact")):
        fuel_stage_ms[kf] = {f"{st['res']}^3": st["fwd_ms_median"]
                             for st in fuel["per_stage"] if st["gradient"] == grad}
        fuel_stage_ms[kb] = {f"{st['res']}^3": st["bwd_ms_median"]
                             for st in fuel["per_stage"] if st["gradient"] == grad}
    # tolerance on the error relative to the plain version's largest magnitude,
    # and the data-dependent work this run's inputs needed
    extra = {
        "eval_grad": {"rel_tol": TOL_F32_STATE, "points": NRAYS,
                      "probe": {k: measure["probe_evalmath"]["result"][k]
                                for k in ("ms", "bound_ms", "share_of_bound", "bitwise")},
                      "before": times["eval_grad"]["before"],
                      "ms_dirty_flush": times["eval_grad"]["ms_dirty_flush"],
                      "library_ms_dirty_flush": times["eval_grad"]["library_ms_dirty_flush"],
                      "launched_by": "fields.grid.eval_grad, benchmarks.probe_evalmath.run"},
        "trace_fwd": {"rel_tol": 0.0, **cmp["fstats"],
                      "ms_unordered": times["trace_fwd"]["ms_unordered"],
                      "order_ms": times["order_ms"],
                      "fuel_ms_by_stage": fuel_stage_ms["trace_fwd"],
                      "northstar_ms_by_stage": {f"{st['res']}^3": st["k2_ms"]
                                                for st in ns["n1"]["per_stage"]},
                      "launched_by": "bench.run, tracer.api.trace, the spot checks, "
                                     "experiments.fuel_injection.run_opt, the drivers "
                                     "before their escalation, the measurement modules, "
                                     "experiments.northstar.run"},
        "backtrace": {"rel_tol": TOL_F32_GRAD, **cmp["bstats"],
                      "atomic_adds": 8 * cmp["issued"],
                      "ms_unordered": times["backtrace"]["ms_unordered"],
                      "fuel_ms_by_stage": fuel_stage_ms["backtrace"],
                      "northstar_ms_by_stage": {f"{st['res']}^3": st["k3_ms"]
                                                for st in ns["n1"]["per_stage"]},
                      "launches_by_k3_path": {"bench": bench_paths["backtrace"],
                                              "fuel": fuel["paths"]["backtrace"],
                                              "northstar": ns["n1"]["paths"]["backtrace"]},
                      "stage_checks": stage_rows,
                      "variant_checks": {
                          "f64 17^3": var_small_row["backtrace_on_variants"],
                          f"f32 {RES}^3 (against the f64 sum of the same terms)":
                              var_row["backtrace_on_variants"]},
                      "launched_by": "bench.run, tracer.api.trace, the spot checks, "
                                     "experiments.fuel_injection.run_opt, the drivers "
                                     "before their escalation, compat.BackPlaneTracerC and "
                                     "BackTargetTracerC (backward), the measurement modules, "
                                     "experiments.northstar.run"},
        "trace_ckpt": {"rel_tol": 0.0, **ex_bench["fwd"],
                       "fuel_ms_by_stage": fuel_stage_ms["trace_ckpt"],
                       "fuel_ms_by_stage_alone": {r["label"]: r["k5_ms"] for r in exact_rows},
                       "fuel_share_of_bound_by_stage": {r["label"]: r["k5"]["share_of_bound"]
                                                        for r in exact_rows},
                       "checkpoint_mb": ex_bench["ckpt_mb"],
                       "launched_by": "tracer.trace_exact: the spot checks, every "
                                      "driver after its stage escalation, "
                                      "benchmarks.ds_study and probe_exact_envelope"},
        "backtrace_exact": {"rel_tol": TOL_F32_GRAD, **ex_bench["bwd"],
                            "fuel_ms_by_stage": fuel_stage_ms["backtrace_exact"],
                            "stage_checks": [
                                {**{k: r[k] for k in ("label", "path", "rel_err", "tol", "runs",
                                                      "issued", "k6_ms", "bitwise")},
                                 "bound_ms": r["k6"]["bound_ms"],
                                 "share_of_bound": r["k6"]["share_of_bound"]}
                                for r in exact_rows],
                            "target_exact_checks": [
                                {k: r[k] for k in ("label", "chunk", "rel_err", "tol", "runs",
                                                   "horizon")}
                                for r in variant_exact_rows if r["variant"] == "target"],
                            "target_exact_times": exact_path.get("backtrace_exact (target)"),
                            "launched_by": "tracer.trace_exact: the spot checks, "
                                           "every driver after its stage escalation, "
                                           "benchmarks.ds_study and probe_exact_envelope; "
                                           "tracer.trace_target_exact (backward)"},
        **{name: {"rel_tol": TOL_F32_GRAD if name.startswith("backtrace") else 0.0,
                  "rel_tol_against": ("the f64 sum of the plain version's f32 terms"
                                      if name.startswith("backtrace") else "bitwise"),
                  "scene": f"fiber source, 4096 rays twice (near and hop targets), "
                           f"{full_bins} bins, f32",
                  "work": cable_full["work"], "f64_check": cable_small["errs"],
                  **({"launches_by_k8_path": fiber_rec["k8_paths"]}
                     if name == "backtrace_cable" else {}),
                  **({"launches_by_k10_path": {"fiber": fiber_rec["k10_paths"],
                                               "fiber_exact": fiber_exact["k10_paths"]}}
                     if name == "backtrace_cable_exact" else {}),
                  "launched_by": "experiments.fiber.multires_exp through runner.run: "
                                 + ("the steps before the escalation and the spot checks"
                                    if name in ("trace_cable", "backtrace_cable") else
                                    "the steps from the escalation on (every step with "
                                    "gradient exact) and the stage checks")}
           for name in CABLE_KERNELS},
        **{name: {"rel_tol": TOL_F32_GRAD if name == "backtrace_sdf" else 0.0,
                  "rel_tol_against": ("the f64 sum of the plain version's f32 terms"
                                      if name == "backtrace_sdf" else "bitwise"),
                  "scene": (f"bench scene {RES}^3 f32; " + (
                      f"{NRAYS} rays spawned on a sphere sdf (radius 0.4 span) by get_pts_sdf"
                      if name.endswith("sdf") else
                      f"{NRAYS} bench rays, planes at y = 0.6 span, targets at y = 1.05 span")),
                  "work": var_row["work"][name], "f64_check": var_small_row["bitwise"]
                  if name != "backtrace_sdf" else var_small_row["backtrace_sdf_rel_err"],
                  "ragged": var_ragged,
                  "launches_per_call": variants["launches"][name] // VARIANT_PASSES,
                  "ms_per_launch_on_path": {k: v for k, v in variants["ms_per_launch"].items()
                                            if k.startswith(name)},
                  **({"launches_by_k14_path": variants["paths"]["backtrace_sdf"]}
                     if name == "backtrace_sdf" else {}),
                  "launched_by": "compat." + {"trace_plane": "BackPlaneTracerC",
                                              "trace_target": "BackTargetTracerC",
                                              "trace_sdf": "BackSDFTracerC",
                                              "backtrace_sdf": "BackSDFTracerC (backward)"}[name]
                                 + " (tracer.api." + name.replace("backtrace", "trace") + ")"}
           for name in VARIANT_KERNELS},
        **{name: {"rel_tol": 0.0 if name.endswith("ckpt") else TOL_F32_GRAD,
                  "rel_tol_against": ("bitwise (outputs, capture steps, codes, horizon, the "
                                      "checkpoint rows read)" if name.endswith("ckpt") else
                                      "the f64 sum of the plain version's f32 terms"),
                  "scene": (f"bench scene {RES}^3 f32, {NRAYS} rays; "
                            + ("spawned on a sphere sdf (radius 0.4 span) by get_pts_sdf"
                               if "sdf" in name else "planes at y = 0.6 span"
                               if "plane" in name else "targets at y = 1.05 span")),
                  "checks": [{k: r[k] for k in ("label", "chunk", "bitwise", "rel_err", "tol",
                                                "runs", "horizon", "fwd", "bwd")}
                             for r in variant_exact_rows if EXACT_VARIANTS[r["variant"]][
                                 0 if name.endswith("ckpt") else 1] == name],
                  "launches_per_call_2^18": exact_path["launches_2^18"][name] // VARIANT_PASSES,
                  "ms_per_launch_on_path": {k: v for k, v in exact_path["ms_per_launch"].items()
                                            if k.startswith(name)},
                  "launched_by": "tracer." + {"plane": "trace_plane_exact",
                                              "target": "trace_target_exact",
                                              "sdf": "trace_sdf_exact"}[
                                     name.split("_")[1]] + (" (backward)" if name.startswith(
                                         "backtrace") else "")}
           for name in EXACT_VARIANT_KERNELS},
        "record_paths": {"rel_tol": 0.0, "rel_tol_against": "bitwise (the float32 records)",
                         "scene": f"combo_recon16_true: the 65^3 fuel volume, f64, {k20['rays']} "
                                  f"rays, {k20['records']} records of {k20['stride']} steps",
                         **{k: k20[k] for k in ("ms_ordered", "work", "bytes_bound_ms",
                                                "ops_bound_ms", "record_mb")},
                         "peak_flops": "f64, 34 TFLOP/s",
                         "launched_by": "pathmatrix.fuel2008.fuel_reconstruction "
                                        "(spline 'true')"},
        **{name: {"rel_tol": 0.0 if name == "slab_trace_phase" else TOL_F32_GRAD,
                  "rel_tol_against": ("bitwise (every state tensor; the rays outside the slab "
                                      "frozen)" if name == "slab_trace_phase" else
                                      "the plain phase's gradient slab (x, v, active, steps "
                                      "bitwise)"),
                  "checks": slab_checks,
                  "scene": f"configuration 14: the bench field at {SLAB_RES}^3 f32, {NRAYS} "
                           f"rays crossing z, one rank (the first phase's work)",
                  "path": {k: slab_rec[k] for k in ("phases", "budget", "bitwise",
                                                    "grad_rel_err", "slab_ms", "slab_ms_untimed",
                                                    "api_trace_ms", "peak_gb", "slab_gb")},
                  "per_phase": slab_rec["per_phase"][name],
                  "work": slab_rec["work"][name],
                  "bytes_counted": "the 32-byte sectors of the slab that the phase's stencils "
                                   "read (K22: and of the gradient slab that its splats "
                                   "reach), and the ray state read and written once",
                  "launched_by": "parallel.make_slab_trace_zsharded (a ring phase a sweep of "
                                 "z-bands, parallel.slabs.sweep_bands; ms summed over a "
                                 "phase's launches)"}
           for name in SLAB_KERNELS},
        "gather_rows": {"rel_tol": 0.0, "rows": GATHER_N, "table_rows": GATHER_ROWS,
                        "ms_dirty_flush": gather["ms_dirty_flush"],
                        "library_ms_dirty_flush": gather["library_ms_dirty_flush"],
                        "launched_by": "benchmarks.probe_dma_gather.run"},
    }
    kernels = []
    for name in build.KERNELS:
        rec_k = times[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        if sum(by_path.values()) < 1:
            raise AssertionError(f"{name} was launched by none of the main paths")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adjointnonlinearraytracing_tpu_torch/kernels/csrc/{build.SOURCE[name]}.cu",
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_by_api_trace": after_trace[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1], "ms": rec_k["ms"],
            "plain_ms": rec_k["plain_ms"], "bound_ms": rec_k["bound_ms"],
            "bound_by": rec_k["bound_by"], "share_of_bound": rec_k["bound_ms"] / rec_k["ms"],
            "library_ms": rec_k["library_ms"],
            "ms_per_launch_by_driver_stage": {
                **{path: {f"{st['res']}^3": st["ms_per_launch"][name] for st in d["per_stage"]
                          if name in st["ms_per_launch"]} for path, d in drivers.items()},
                **{path: {f"{st['res']} bins": st["ms_per_launch"][name]
                          for st in rec_f["per_stage"] if name in st["ms_per_launch"]}
                   for path, rec_f in (("fiber", fiber_rec), ("fiber_exact", fiber_exact))}},
            **extra[name],
        })
    if failures:
        raise AssertionError("checks failed:\n" + "\n".join(failures))
    print(f"elapsed: {time.time() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
