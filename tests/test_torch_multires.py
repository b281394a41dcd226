"""The port's multires Adam loop against the JAX package's (optax) step for step.

CPU, f64 (conftest enables x64).  Both packages run ``multires_opt`` on the
same loss from the same start; ``log_fn`` records the field before every step
and ``save_fn`` the Adam state at the end of every stage.  Tolerance ``1e-10``
relative to the largest magnitude for field, moments and losses: the same f64
arithmetic in another order, over at most 12 Adam steps whose division by
``sqrt(nu_hat) + 1e-8`` amplifies rounding where a gradient is near zero.
Each JAX reference run is made once per module.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.opt import multires as JM
from adjointnonlinearraytracing_tpu_torch import convert
from adjointnonlinearraytracing_tpu_torch.opt import multires as TM
from adjointnonlinearraytracing_tpu_torch.tracer import api as TA

RTOL = 1e-10
RES_LIST, ITERS, LR = [3, 5, 9], 2, 0.05
CLAMP_MIN, CLAMP_MAX = 1.0, 1.25
SPAN = 1.0
DS = SPAN / 8 / 2


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _targets():
    """Per-resolution targets and weights; targets leave [CLAMP_MIN, CLAMP_MAX] on both sides."""
    rng = np.random.default_rng(0)
    return {r: (rng.uniform(0.8, 1.5, (r, r, r)), rng.uniform(0.5, 2.0, (r, r, r)))
            for r in RES_LIST}


def _rays(n=48):
    rng = np.random.default_rng(1)
    xz = rng.uniform(0.2 * SPAN, 0.8 * SPAN, (n, 2))
    tilt = 0.15 * rng.standard_normal((n, 2))
    v = np.stack([tilt[:, 0], np.ones(n), tilt[:, 1]], axis=-1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return np.stack([xz[:, 0], np.zeros(n), xz[:, 1]], axis=-1), v


def _start(res=3):
    return 1.1 + 0.05 * np.random.default_rng(2).uniform(size=(res, res, res))


def _jax_losses():
    tg = _targets()
    x, v = map(jnp.asarray, _rays())

    def quadratic(n, key):
        t, w = tg[n.shape[0]]
        return jnp.sum(w * (n - t) ** 2)

    def traced(n, key):
        xt, vt = JT.trace(n, x, v, SPAN / (n.shape[0] - 1), DS)
        return jnp.sum((xt - 0.4) ** 2) + jnp.sum(vt)

    return dict(quadratic=quadratic, traced=traced)


def _torch_losses():
    tg = {r: tuple(map(torch.from_numpy, tw)) for r, tw in _targets().items()}
    x, v = map(torch.from_numpy, _rays())

    def quadratic(n, key):
        t, w = tg[n.shape[0]]
        return (w * (n - t) ** 2).sum()

    def traced(n, key):
        xt, vt = TA.trace(n, x, v, SPAN / (n.shape[0] - 1), DS)
        return ((xt - 0.4) ** 2).sum() + vt.sum()

    return dict(quadratic=quadratic, traced=traced)


def _jax_adam(opt_state):
    adam = next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))
    return int(adam.count), np.asarray(adam.mu), np.asarray(adam.nu)


def _run(package, loss, res_list, **kwargs):
    """One ``multires_opt`` run; returns the fields before each step, the Adam
    state after each stage, the loss history and the final field."""
    fields, stages = [], []
    if package == "jax":
        out, hist = JM.multires_opt(
            _jax_losses()[loss], jnp.asarray(_start()), ITERS, res_list,
            log_fn=lambda it, n: fields.append(np.asarray(n)),
            save_fn=lambda s, n, st, h: stages.append(_jax_adam(st)),
            lr=LR, clamp_min=CLAMP_MIN, clamp_max=CLAMP_MAX, **kwargs)
        return fields, stages, list(map(float, hist)), np.asarray(out)
    out, hist = TM.multires_opt(
        _torch_losses()[loss], torch.from_numpy(_start()), ITERS, res_list,
        log_fn=lambda it, n: fields.append(n.clone().numpy()),
        save_fn=lambda s, n, st, h: stages.append((st.count, st.mu.numpy(), st.nu.numpy())),
        lr=LR, clamp_min=CLAMP_MIN, clamp_max=CLAMP_MAX, **kwargs)
    assert not out.requires_grad
    return fields, stages, hist, out.numpy()


@pytest.fixture(scope="module")
def jax_runs():
    return {"quadratic": _run("jax", "quadratic", RES_LIST),
            "traced": _run("jax", "traced", RES_LIST[:2])}


@pytest.mark.parametrize("loss,res_list", [("quadratic", RES_LIST), ("traced", RES_LIST[:2])])
def test_steps_and_stage_changes_match_optax(jax_runs, loss, res_list):
    """Field before every step, moments and count after every stage, losses, result."""
    want_fields, want_stages, want_hist, want_out = jax_runs[loss]
    fields, stages, hist, out = _run("torch", loss, res_list)
    steps = sum(ITERS * (s + 1) for s in range(len(res_list)))
    assert len(fields) == len(want_fields) == len(hist) == len(want_hist) == steps
    for got, want in zip(fields, want_fields):
        _close(got, want)
    assert [f.shape[0] for f in fields] == sum(
        ([r] * (ITERS * (s + 1)) for s, r in enumerate(res_list)), [])
    for (count, mu, nu), (want_count, want_mu, want_nu) in zip(stages, want_stages):
        assert count == want_count  # survives the stage change
        _close(mu, want_mu)
        _close(nu, want_nu)
    assert stages[-1][0] == steps
    _close(np.asarray(hist), np.asarray(want_hist))
    _close(out, want_out)
    if loss == "quadratic":  # both projections bind, and the shell never moved
        assert out.max() == CLAMP_MAX and out.min() == CLAMP_MIN
        assert want_out.max() == CLAMP_MAX and want_out.min() == CLAMP_MIN


def test_adam_update_is_optax_adam():
    rng = np.random.default_rng(3)
    n, state = rng.uniform(size=(4, 5)), None
    opt = optax.adam(0.01)
    jn, jstate = jnp.asarray(n), opt.init(jnp.asarray(n))
    tn, state = torch.from_numpy(n), TM.adam_init(torch.from_numpy(n))
    for _ in range(5):
        g = rng.standard_normal((4, 5)) * 10.0 ** rng.integers(-6, 2)
        upd, jstate = opt.update(jnp.asarray(g), jstate, jn)
        jn = optax.apply_updates(jn, upd)
        tn, state = TM.adam_update(tn, torch.from_numpy(g), state, 0.01)
        _close(tn, jn, 1e-14)
    count, mu, nu = _jax_adam(jstate)
    assert state.count == count == 5
    _close(state.mu, mu, 1e-14)
    _close(state.nu, nu, 1e-14)


def test_learning_rate_schedule_shares_lr_between_stages_0_and_1():
    """With a constant gradient an Adam step moves every voxel by the stage's lr."""
    fields = []
    TM.multires_opt(lambda n, key: n.sum(), torch.full((3, 3, 3), 2.0, dtype=torch.float64), 1,
                    [3, 5, 9, 17], log_fn=lambda it, n: fields.append(float(n[1, 1, 1])),
                    lr=0.1, clamp_min=None, freeze_boundary=False, lr_decay=0.5)
    # the field is uniform, so resampling keeps it and successive logs differ by one step
    lr_of_step = [0.1] * 1 + [0.1] * 2 + [0.05] * 3 + [0.025] * 4
    np.testing.assert_allclose(-np.diff(fields), lr_of_step[:-1], rtol=0, atol=1e-8)


@pytest.mark.parametrize("freeze", [True, False])
def test_boundary_shell_is_frozen(freeze):
    out, _ = TM.multires_opt(_torch_losses()["quadratic"],
                             torch.full((3, 3, 3), 1.1, dtype=torch.float64), ITERS, RES_LIST,
                             lr=LR, freeze_boundary=freeze)
    interior = TM.boundary_interior_mask(out.shape, torch.bool)
    assert interior.sum() == 7 ** 3 and interior.dtype == torch.bool
    shell = out[~interior]
    if freeze:
        assert float((shell - 1.1).abs().max()) <= 1e-15
    else:
        assert float((shell - 1.1).abs().max()) > 1e-3
    assert float((out[interior] - 1.1).abs().max()) > 1e-3


def test_hooks_sync_cadence_and_stats(monkeypatch):
    loss = _torch_losses()["quadratic"]
    start = torch.from_numpy(_start())
    seen, stats = [], []
    _, hist = TM.multires_opt(loss, start, ITERS, RES_LIST, lr=LR,
                              stage_fn=lambda s, n: seen.append((s, n.shape[0])),
                              stat_fn=lambda it, lf, secs: stats.append((it, lf, secs)))
    assert seen == list(enumerate(RES_LIST))
    assert [s[0] for s in stats] == list(range(12)) and [s[1] for s in stats] == hist
    assert all(s[2] > 0 for s in stats)
    stats4 = []
    _, hist4 = TM.multires_opt(loss, start, ITERS, RES_LIST, lr=LR, sync_every=4,
                               stat_fn=lambda it, lf, secs: stats4.append(secs))
    assert hist4 == hist and len(stats4) == 12
    assert stats4[2] == stats4[3] == stats4[4] == stats4[5]  # one window's average
    monkeypatch.setenv("ANRT_SYNC_EVERY", "5")
    assert TM.multires_opt(loss, start, ITERS, RES_LIST, lr=LR)[1] == hist
    assert start.grad is None and not start.requires_grad  # the caller's tensor is not touched


def test_orbax_backend_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        TM.multires_opt(lambda n, key: n.sum(), torch.ones(3, 3, 3), 1, [3], ckpt_backend="orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        TM.save_checkpoint(str(tmp_path / "c"), torch.ones(3), TM.adam_init(torch.ones(3)), [],
                           torch.Generator(), backend="orbax")
    (tmp_path / "dir").mkdir()
    with pytest.raises(NotImplementedError, match="npz"):
        TM.load_checkpoint(str(tmp_path / "dir"), device="cpu")


def test_checkpoint_round_trip_keeps_fields_and_generator(tmp_path):
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    n = torch.from_numpy(_start(5))
    adam = TM.AdamState(7, n * 0.5, n * 0.25)
    TM.save_checkpoint(str(tmp_path / "ck"), n, adam, [3.0, 2.0], gen)
    with np.load(tmp_path / "ck.npz") as z:
        assert set(z.files) == {"rif", "adam_count", "adam_mu", "adam_nu", "loss_hist", "key"}
    n2, adam2, hist2, state = TM.load_checkpoint(str(tmp_path / "ck"), device="cpu")
    assert torch.equal(n2, n) and adam2.count == 7
    assert torch.equal(adam2.mu, adam.mu) and torch.equal(adam2.nu, adam.nu) and hist2 == [3.0, 2.0]
    fresh = torch.Generator()
    fresh.set_state(state)
    assert torch.equal(torch.rand(4, generator=fresh), torch.rand(4, generator=gen))
    with pytest.raises(ValueError, match="written by the port"):
        convert.checkpoint_from_jax_npz(str(tmp_path / "ck"), device="cpu")


@pytest.fixture(scope="module")
def jax_resumed(tmp_path_factory):
    """A JAX run to 5^3 with a checkpoint, and its resumption over [3, 5, 9]."""
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_state")
    first = _run("jax", "quadratic", RES_LIST[:2], statename=path)
    return path, first, _run("jax", "quadratic", RES_LIST, resume_from=path)


def test_resume_from_own_checkpoint_takes_the_same_steps(jax_resumed, tmp_path):
    """npz save -> resume: stage 1 is re-entered at the checkpoint's resolution
    with lr * decay^max(stage - 1, 0), exactly as the JAX package resumes."""
    _, _, (want_fields, want_stages, want_hist, want_out) = jax_resumed
    path = str(tmp_path / "torch_state")
    _run("torch", "quadratic", RES_LIST[:2], statename=path)
    fields, stages, hist, out = _run("torch", "quadratic", RES_LIST, resume_from=path)
    assert len(hist) == len(want_hist) == 6 + 4 + 6  # the file's 6, stage 1 again, stage 2
    assert [f.shape[0] for f in fields] == [5] * 4 + [9] * 6
    for got, want in zip(fields, want_fields):
        _close(got, want)
    _close(np.asarray(hist), np.asarray(want_hist))
    assert [s[0] for s in stages] == [s[0] for s in want_stages] == [10, 16]
    _close(out, want_out)


def test_resume_from_a_checkpoint_written_by_the_jax_package(jax_resumed):
    path, (_, first_stages, first_hist, first_out), (want_fields, _, want_hist, want_out) = \
        jax_resumed
    n, adam, hist = convert.checkpoint_from_jax_npz(path, device="cpu")
    assert n.dtype == torch.float64 and adam.count == first_stages[-1][0] == 6
    assert np.array_equal(n.numpy(), first_out) and hist == first_hist
    assert np.array_equal(adam.mu.numpy(), first_stages[-1][1])
    assert np.array_equal(adam.nu.numpy(), first_stages[-1][2])
    fields, _, hist, out = _run("torch", "quadratic", RES_LIST, resume_from=path)
    for got, want in zip(fields, want_fields):
        _close(got, want)
    _close(np.asarray(hist), np.asarray(want_hist))
    _close(out, want_out)


def test_upres_scene_and_adam_state_keep_dtype_and_count():
    n32 = torch.from_numpy(_start()).float()
    assert TM.upres_scene(n32, 5).dtype == torch.float32
    n64 = torch.from_numpy(_start())
    up = TM.upres_adam_state(TM.AdamState(4, n64, n64 ** 2), 5)
    assert up.count == 4 and up.mu.shape == (5, 5, 5) and up.nu.dtype == torch.float64
    _close(up.mu, JM.upres_scene(jnp.asarray(_start()), 5), 1e-12)
