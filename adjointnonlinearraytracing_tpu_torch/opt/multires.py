"""Coarse-to-fine (multi-resolution) Adam optimisation.

Twin of ``adjointnonlinearraytracing_tpu/opt/multires.py``: an outer loop over
a resolution ladder (e.g. 3 -> 5 -> 9 -> 17 -> 33 -> 65) with, per stage,

* ``iterations * (stage + 1)`` Adam steps,
* boundary-voxel gradient freezing,
* projection ``n = max(n, clamp_min)`` (then ``min(n, clamp_max)``) after
  each step,
* checkpointing of (field, Adam state, loss history, generator state),

and between stages the **optimiser-state upsampling**: Adam's first and second
moments are trilinearly resampled onto the finer grid, its step count is kept,
and the learning rate is decayed, so the fine stages inherit the coarse
stages' adaptive scaling.

The Adam update is written out on tensors (:func:`adam_update`) with the
constants and the order of operations of ``optax.adam``: both bias
corrections, ``m_hat / (sqrt(v_hat) + 1e-8)``, no weight decay.  A step is
eager PyTorch: the user loss (whose ``tracer.trace`` calls carry the adjoint
as their backward), ``torch.autograd.grad``, masked gradient, Adam update and
projection in place on a leaf tensor.  Randomness reaches the loss as the one
``torch.Generator`` of the run.

The JAX package's orbax checkpoint backend has no counterpart here: only the
``npz`` form exists, with the same field names, so a checkpoint written by
one package resumes in the other (``convert.checkpoint_from_jax_npz``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import require_device
from ..fields.grid import upres_volume

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    """Adam's step count and moments (``optax.ScaleByAdamState``'s fields)."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass
class MultiresResult:
    """A ladder's final field and its loss history (the JAX module's record
    type; :func:`multires_opt` returns the pair as a tuple)."""

    n: torch.Tensor
    loss_hist: List[float]


def adam_init(n: torch.Tensor) -> AdamState:
    return AdamState(0, torch.zeros_like(n), torch.zeros_like(n))


def adam_update(n: torch.Tensor, g: torch.Tensor, state: AdamState,
                lr: float) -> Tuple[torch.Tensor, AdamState]:
    """One Adam step as ``optax.adam(lr)`` takes it; returns ``(n_new, state_new)``."""
    count = state.count + 1
    mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu
    mu_hat = mu / (1 - ADAM_B1 ** count)
    nu_hat = nu / (1 - ADAM_B2 ** count)
    return n + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)), AdamState(count, mu, nu)


def boundary_interior_mask(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """1.0 on interior voxels, 0.0 on the boundary shell."""
    mask = torch.zeros(tuple(shape), dtype=dtype, device=device)
    mask[tuple(slice(1, -1) for _ in shape)] = 1.0
    return mask


def upres_scene(n: torch.Tensor, res: int) -> torch.Tensor:
    """Resample the field to ``res`` per axis, in ``n``'s own dtype (f64 for f64)."""
    return upres_volume(n, tuple(res for _ in n.shape))


def upres_adam_state(state: AdamState, res: int) -> AdamState:
    """Trilinearly upsample Adam's moments and keep the step count."""
    return AdamState(state.count, upres_scene(state.mu, res), upres_scene(state.nu, res))


def _require_npz(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError(
            "the orbax checkpoint backend has no PyTorch counterpart; use ckpt_backend='npz'")
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def multires_opt(
    loss_fn: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
    eta: torch.Tensor,
    iterations: int,
    res_list: Sequence[int],
    log_fn: Optional[Callable[[int, torch.Tensor], None]] = None,
    lr: float = 1e-3,
    statename: Optional[str] = None,
    key: Optional[torch.Generator] = None,
    clamp_min: Optional[float] = 1.0,
    clamp_max: Optional[float] = None,
    freeze_boundary: bool = True,
    lr_decay: float = 0.5,
    save_fn: Optional[Callable] = None,
    resume_from: Optional[str] = None,
    ckpt_backend: str = "npz",
    stat_fn: Optional[Callable[[int, float, float], None]] = None,
    sync_every: Optional[int] = None,
    stage_fn: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Tuple[torch.Tensor, List[float]]:
    """Run the multi-resolution Adam loop on ``eta``'s device.

    ``loss_fn(n, key) -> scalar`` gets the run's generator ``key`` on every
    iteration (default: one seeded with 0 on ``eta``'s device).
    ``resume_from`` restores a checkpoint written by :func:`save_checkpoint`
    (or by the JAX package's): the ladder continues from the checkpoint's
    resolution, stages coarser than it are skipped.  ``stat_fn(iteration,
    loss, seconds_per_step)`` is called as losses are read back, every
    ``sync_every`` steps (``ANRT_SYNC_EVERY``, default 1); a checkpoint is
    also written mid-stage every ``ANRT_CKPT_SECS`` seconds (default 180)
    when ``statename`` is given.  Returns ``(final_field, loss_history)``.
    """
    _require_npz(ckpt_backend)
    n = eta.detach().clone()
    if key is None:
        key = torch.Generator(device=n.device).manual_seed(0)
    loss_hist: List[float] = []
    iteration_count = 0
    stage_lr = lr
    adam = adam_init(n)

    start_stage = 0
    if resume_from is not None:
        # continue at the checkpoint's resolution stage with its stage lr
        n, adam, loss_hist, key_state = load_checkpoint(resume_from, device=n.device)
        if key_state is not None:
            key.set_state(key_state)
        iteration_count = len(loss_hist)
        matching = [i for i, r in enumerate(res_list) if r >= n.shape[0]]
        start_stage = matching[0] if matching else len(res_list) - 1
        stage_lr = (lr_decay ** max(start_stage - 1, 0)) * lr if start_stage else lr

    for res_iter in range(start_stage, len(res_list)):
        if stage_fn is not None:
            # stage-start hook (gradient-drift spot check / escalation): runs
            # before the stage's first step so a mode flip takes effect at once
            stage_fn(res_iter, n)
        mask = (boundary_interior_mask(n.shape, n.dtype, n.device)
                if freeze_boundary else None)
        n.requires_grad_(True)  # a leaf; updated in place below

        def step(n, adam):
            loss = loss_fn(n, key)
            (g,) = torch.autograd.grad(loss, n)
            if mask is not None:
                g = g * mask
            with torch.no_grad():
                new, adam = adam_update(n, g, adam, stage_lr)
                if clamp_min is not None:
                    new = torch.clamp(new, min=clamp_min)
                if clamp_max is not None:
                    # upper projection: keeps a large-lr excursion from
                    # leaving the range the steppers are meant for
                    new = torch.clamp(new, max=clamp_max)
                n.copy_(new)
            return adam, loss.detach()

        # time-based mid-stage checkpointing: a run bounded by a wall clock
        # keeps its partial stage
        last_save = time.perf_counter()
        save_every = float(os.environ.get("ANRT_CKPT_SECS", "180"))
        # host-sync cadence: reading a loss blocks on the device; every K
        # steps instead of every step lets the host run K steps ahead.  K=1
        # keeps exact per-step timing; otherwise stat_fn rows carry the
        # window-average step time.
        every = sync_every if sync_every is not None else int(
            os.environ.get("ANRT_SYNC_EVERY", "1"))
        every = max(every, 1)
        pending: List[Tuple[int, torch.Tensor]] = []
        t_window = time.perf_counter()

        def drain():
            nonlocal t_window
            if not pending:
                return
            # synchronise FIRST: float() blocks until the device has finished
            # the window's steps, so the clock read below includes them
            vals = [float(lv) for _, lv in pending]
            secs = (time.perf_counter() - t_window) / len(pending)
            for (it, _), lf in zip(pending, vals):
                loss_hist.append(lf)
                if stat_fn is not None:
                    stat_fn(it, lf, secs)
            pending.clear()
            t_window = time.perf_counter()

        for _ in range(iterations * (res_iter + 1)):
            if log_fn is not None:
                log_fn(iteration_count, n.detach())
            adam, loss = step(n, adam)
            pending.append((iteration_count, loss))
            iteration_count += 1
            if len(pending) >= every:
                drain()
            if (statename is not None and save_every > 0
                    and time.perf_counter() - last_save > save_every):
                drain()
                save_checkpoint(statename, n, adam, loss_hist, key, backend=ckpt_backend)
                last_save = time.perf_counter()
        drain()
        n = n.detach()

        if statename is not None:
            save_checkpoint(statename, n, adam, loss_hist, key, backend=ckpt_backend)
        if save_fn is not None:
            save_fn(res_iter, n, adam, loss_hist)

        if res_iter < len(res_list) - 1:
            new_res = res_list[res_iter + 1]
            n = upres_scene(n, new_res)
            # the decay uses the stage just finished, so stages 0 and 1 share
            # lr: the reference's schedule, kept
            stage_lr = (lr_decay ** res_iter) * lr
            adam = upres_adam_state(adam, new_res)

    return n, loss_hist


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, n, adam: AdamState, loss_hist, key: torch.Generator,
                    backend: str = "npz"):
    """Persist (field, Adam state, loss history, generator state) as ``path``.npz.

    The field names are the JAX package's: ``rif``, ``adam_count``,
    ``adam_mu``, ``adam_nu``, ``loss_hist``, ``key`` (here the generator's
    state bytes).
    """
    _require_npz(backend)
    # write-then-rename: mid-stage saves exist to survive a kill, so a signal
    # landing during the write must not corrupt the only copy
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            rif=n.detach().cpu().numpy(),
            adam_count=np.asarray(adam.count, dtype=np.int32),
            adam_mu=adam.mu.detach().cpu().numpy(),
            adam_nu=adam.nu.detach().cpu().numpy(),
            loss_hist=np.asarray(loss_hist, dtype=np.float64),
            key=key.get_state().numpy(),
        )
    os.replace(tmp, final)


def load_checkpoint(path: str, device="cuda"):
    """Restore ``(field, AdamState, loss history, generator state)`` from an npz.

    The generator state is a byte tensor for ``torch.Generator.set_state``.
    A file written by the JAX package holds a JAX key there, which has no
    meaning for a ``torch.Generator``: it comes back as ``None`` and the
    caller keeps its own generator.
    """
    dev = require_device(device)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint); only the npz form is supported")
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        n = torch.from_numpy(z["rif"]).to(dev)
        adam = AdamState(int(z["adam_count"]), torch.from_numpy(z["adam_mu"]).to(dev),
                         torch.from_numpy(z["adam_nu"]).to(dev))
        loss_hist = [float(v) for v in z["loss_hist"]]
        key = z["key"]
    key_state = torch.from_numpy(key.copy()) if key.dtype == np.uint8 else None
    return n, adam, loss_hist, key_state
