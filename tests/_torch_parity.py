"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the same numpy inputs go to the JAX package and to the port."""
import numpy as np
import torch


def t(a) -> torch.Tensor:
    """numpy / JAX array -> torch CPU tensor (uint32 bits viewed as int32)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True))


def n(x) -> np.ndarray:
    """JAX array or torch tensor -> numpy, uint32 bits viewed as int32."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_bits_equal(got, want):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def assert_close(got, want, rtol=1e-5):
    """Float parity: rtol plus an absolute floor of rtol * max|want|."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))
