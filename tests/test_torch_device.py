"""The port's no-wait tensor helpers (`vslam_tpu_torch.ops.device`) against
plain PyTorch indexing and `torch.tensor`, on the CPU. They move values
only, so results must be equal."""

import numpy as np
import pytest
import torch

from vslam_tpu_torch.ops import device


@pytest.mark.parametrize("shape", [(7,), (5, 3), (4, 3, 3)])
def test_take_and_put_match_indexing(shape):
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=shape[1:]).astype(np.float32))
    for i in range(shape[0]):
        ii = torch.tensor(i, dtype=torch.int32)
        assert torch.equal(device.take(x, ii), x[i])
        a, b = x.clone(), x.clone()
        device.put_(a, ii, v)
        b[i] = v
        assert torch.equal(a, b)


def test_put_python_value_and_dtype():
    a = torch.zeros(6, dtype=torch.bool)
    device.put_(a, torch.tensor(4), True)
    assert a.tolist() == [False] * 4 + [True, False]
    ids = torch.zeros(3, dtype=torch.int32)
    device.put_(ids, torch.tensor(1), torch.tensor(7, dtype=torch.int64))
    assert ids.dtype == torch.int32 and ids.tolist() == [0, 7, 0]


def test_constant_is_cached_and_equal():
    vals = ((525.0, 0.0, 319.5), (0.0, 525.0, 239.5), (0.0, 0.0, 1.0))
    a = device.constant(vals, torch.float32, "cpu")
    assert torch.equal(a, torch.tensor(vals, dtype=torch.float32))
    assert device.constant(vals, torch.float32, torch.device("cpu")) is a


@pytest.mark.parametrize("idx_shape", [(), (5,), (2, 3)])
def test_rows_match_indexing_without_reads(idx_shape):
    """`rows(table, idx)` equals `table[idx]` for an index of any shape and
    reads nothing back (Python indexing with a 0-dim index would)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 4, size=idx_shape))
    reads = []

    class CountReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ == "_local_scalar_dense":
                reads.append(func)
            return func(*args, **(kwargs or {}))

    with CountReads():
        got = device.rows(table, idx)
    assert got.shape == idx.shape + (3,) and torch.equal(got, table[idx])
    assert not reads
