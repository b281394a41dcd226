"""The port's row gather against the Pallas kernel it replaces.

``gather_rows_plain`` (the plain version of CUDA kernel K4, and what CPU
tensors get) against ``probe_dma_gather.dma_gather`` run in interpret mode at
the probe's own interpret sizes (``R, N, chunk, slots = 97, 256, 64, 4``).  A
gather moves bits, so equality is exact.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.benchmarks import probe_dma_gather as JP
from adjointnonlinearraytracing_tpu_torch.benchmarks import probe_dma_gather as TP
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers

R, N, CHUNK, SLOTS = 97, 256, 64, 4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((R, JP.LANES)).astype(np.float32)
    idx = rng.integers(0, R, N).astype(np.int32)
    idx[:3] = [0, R - 1, R - 1]  # both ends, and a duplicate
    return table, idx


def test_plain_gather_equals_the_pallas_ring_kernel(case, monkeypatch):
    table, idx = case
    # the module reads its flag at call time; importing it with the flag unset
    # has left the JAX settings of this process alone
    monkeypatch.setattr(JP, "INTERPRET", True)
    want = np.asarray(JP.dma_gather(jnp.asarray(table), jnp.asarray(idx), chunk=CHUNK,
                                    slots=SLOTS))
    assert want.shape == (N, JP.LANES) and np.array_equal(want, table[idx])
    for fn in (TP.gather_rows_plain, TP.gather_rows):  # CPU tensors take the plain version
        got = fn(torch.from_numpy(table), torch.from_numpy(idx))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert wrappers.LAUNCHES["gather_rows"] == 0


@pytest.mark.parametrize("dtype,idx_dtype", [(np.float64, np.int64), (np.float32, np.int64),
                                             (np.float64, np.int32)])
def test_plain_gather_other_types(case, dtype, idx_dtype):
    table, idx = case[0].astype(dtype), case[1].astype(idx_dtype)
    got = TP.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), table[idx]) and got.dtype == torch.from_numpy(table).dtype


def test_kernel_wrapper_checks_its_arguments(case):
    table, idx = map(torch.from_numpy, case)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.gather_rows(table, idx)
    with pytest.raises(TypeError, match="float32 or float64"):
        wrappers.gather_rows(table.half(), idx)
    with pytest.raises(ValueError, match="whole 16-byte vectors"):
        wrappers.gather_rows(table[:, :126].contiguous(), idx)
    with pytest.raises(ValueError, match="whole 16-byte vectors"):
        wrappers.gather_rows(table.double()[:, :3].contiguous(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        wrappers.gather_rows(table[:, ::2], idx)
    with pytest.raises(TypeError, match="int32 or int64"):
        wrappers.gather_rows(table, idx.to(torch.int16))
    with pytest.raises(ValueError, match=r"\(N,\)"):
        wrappers.gather_rows(table, idx[None])
    assert wrappers.LAUNCHES["gather_rows"] == 0


def test_probe_entry_point_on_the_cpu_checks_and_times_nothing(monkeypatch, capsys):
    rec = TP.run(R=R, N=N, reps=2, device="cpu")
    assert rec == {"R": R, "N": N, "reps": 2, "device": "cpu", "max_abs_err": 0.0}
    if not torch.cuda.is_available():
        monkeypatch.setenv("PROBE_R", "50")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.main()
        assert capsys.readouterr().out == ""
    json.dumps(rec)
