"""K10's path rule and shared-memory plan, and the exact cable gradient at
segment lengths beside K10's replay buffer.

CPU, f64 (conftest enables x64).  The scene is ``test_torch_cable``'s: 250
rays of every kind at 17 bins, 204 steps.  ``trace_cable_exact`` runs its
plain version here and is held against the JAX package's at ``seg`` 1, 7
and 48 (48 is longer than K10's buffer of 32 steps, so K10 replays such a
segment in two stretches; ``chip_smoke.py`` holds K10 there on the card):
the closest approach to 1e-12, the gradient to 1e-9 of the largest entry.
The JAX references are jitted and computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu_torch import tracer as TT
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as TCK
from test_torch_cable import DS, LENGTH, RADIUS, STEPS, _close, _field, _loss, _profile, _rays

SEGS = (1, 7, 48)


@pytest.fixture(scope="module")
def scene():
    return (_profile(), *_rays())


@pytest.fixture(scope="module")
def jax_refs(scene):
    """JAX ``trace_cable_exact``'s closest approach and gradient at each seg."""
    prof, x, v, tgt = (jnp.asarray(a) for a in scene)
    mp = pytest.MonkeyPatch()
    mp.setenv("ANRT_EXACT_CHUNK", "0")
    try:
        out = {}
        for seg in SEGS:
            def fwd(p, seg=seg):
                return JT.trace_cable_exact(p, RADIUS, LENGTH, x, v, tgt, DS, seg)

            out[seg] = (jax.jit(fwd)(prof), jax.jit(jax.grad(lambda p: _loss(*fwd(p)[:2])))(prof))
        return jax.tree_util.tree_map(np.asarray, out)
    finally:
        mp.undo()


@pytest.mark.parametrize("seg", SEGS)
def test_trace_cable_exact_matches_jax_at_seg(scene, jax_refs, seg):
    """The plain forward and backward passes at ``seg``; the backward pass
    runs every gated-on step once (its ``ray_steps`` is the capture steps'
    sum) whatever the segment length."""
    prof, x, v, tgt = scene
    r = torch.from_numpy(prof).requires_grad_(True)
    xt, vt, d2 = TT.trace_cable_exact(r, RADIUS, LENGTH, torch.from_numpy(x),
                                      torch.from_numpy(v), torch.from_numpy(tgt), DS, seg)
    _loss(xt, vt).backward()
    fwd, grad = jax_refs[seg]
    for got, want in zip((xt, vt, d2), fwd):
        _close(got, want, 1e-12)
    _close(r.grad, grad, 1e-9)
    assert np.abs(grad).max() > 0
    f = _field(prof)
    xs, vs, ts = (torch.from_numpy(a) for a in (x, v, tgt))
    _, _, _, c, ck = TCK._fwd_ckpts_cable(f, xs, vs, ts, DS, STEPS, seg)
    assert ck.shape == (-(-STEPS // seg), 7, x.shape[0])
    st = {}
    TCK._bwd_segments_cable(f, ck, c, xt.detach(), vt.detach(), DS, seg, stats=st)
    assert st["ray_steps"] == int(c.sum())


@pytest.mark.parametrize("dtype, last_columns, last_block",
                         [(torch.float32, 763, 9685), (torch.float64, 635, 5811)])
def test_k10_takes_columns_while_they_fit_beside_its_buffers(dtype, last_columns, last_block):
    """K10's path follows from the profile's size and type alone, by K8's rule
    with its two replay buffers counted in: a buffer holds the positions of
    32 steps of 32 rays and a word a ray (12,416 bytes in f32, 24,704 in
    f64); the columns of its 32 adjoint lanes and the buffers fit up to
    ``last_columns`` bins.  The block path keeps its buffers in device memory
    (two a block, at most ``CABLE_EXACT_BLOCK_GRID`` blocks), so its shared
    memory is K8's block path's, one gradient beside the table, up to
    ``last_block`` bins: K10 takes every profile K8 takes."""
    item = torch.empty((), dtype=dtype).element_size()
    assert K.cable_replay_bytes(dtype) == {4: 12416, 8: 24704}[item]
    buffers = 2 * 32 * (K.CABLE_REPLAY * 3 * item + 4)
    cols = K.CABLE_COLUMN_THREADS
    assert K.cable_exact_shared_bytes(129, dtype, cols) == 129 * (4 * item + 8 * cols) + buffers
    assert K.cable_exact_shared_bytes(last_columns, dtype, cols) \
        <= K.SHARED_BYTES_MAX < K.cable_exact_shared_bytes(last_columns + 1, dtype, cols)
    assert K.cable_shared_bytes(last_block, dtype, 1) \
        <= K.SHARED_BYTES_MAX < K.cable_shared_bytes(last_block + 1, dtype, 1)
    assert K.backtrace_cable_exact_path(129, dtype) == "columns"
    assert K.backtrace_cable_exact_path(last_columns, dtype) == "columns"
    assert K.backtrace_cable_exact_path(last_columns + 1, dtype) == "block"
    assert K.backtrace_cable_exact_path(1025, dtype) == "block"
    assert K.backtrace_cable_exact_path(last_block, dtype) == "block"
    # the buffers move K10's boundary below K8's, and its block path's
    # buffers in device memory stay within a hundred MB
    assert K.backtrace_cable_path(last_columns + 1, dtype) == "columns"
    assert 2 * K.CABLE_EXACT_BLOCK_GRID * K.cable_replay_bytes(dtype) <= 102 * 2 ** 20


@pytest.mark.parametrize("dtype, last_block", [(torch.float32, 9685), (torch.float64, 5811)])
def test_k10_refuses_a_profile_neither_path_holds(dtype, last_block):
    """Past the block path's last bin K10's wrapper raises for the size before
    it asks where the tensors are; at the last bin only for the device.  K8
    draws the line at the same bin."""
    n = 4
    ck = torch.zeros((1, 7, n), dtype=dtype)
    c = torch.zeros((n,), dtype=torch.int32)
    d = torch.zeros((n, 3), dtype=dtype)
    K.reset_launches()
    with pytest.raises(ValueError, match="bytes of a block's shared memory"):
        K.backtrace_cable_exact(torch.ones(last_block + 1, dtype=dtype), RADIUS, LENGTH, ck, c,
                                d, d, DS, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.backtrace_cable_exact(torch.ones(last_block, dtype=dtype), RADIUS, LENGTH, ck, c, d, d,
                                DS, 32)
    for res, match in ((last_block + 1, "bytes of a block's shared memory"),
                       (last_block, "CUDA tensors")):
        with pytest.raises(ValueError, match=match):
            K.backtrace_cable(torch.ones(res, dtype=dtype), RADIUS, LENGTH, d, d, d, d, DS, 8,
                              1e-6)
    assert K.LAUNCHES["backtrace_cable_exact"] == 0
    assert K.BACKTRACE_CABLE_EXACT_PATHS == {"columns": 0, "block": 0}
