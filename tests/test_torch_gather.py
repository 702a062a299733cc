"""The port's row gather (``msst_torch.ops.gather``, the twin of the CUDA
kernel ``msst_torch/csrc/gather_rows.cu``) against msst_tpu's Pallas
``onehot_gather_rows`` in interpret mode.

On finite tables the one-hot matmul gives exactly ``table[idx]``, so the
twin is held bit-equal to it, on the shapes of
tests/test_pallas_toolchain.py and with indices outside [0, H) (both clamp).
On the CPU the wrapper takes the twin and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch.ops import gather
from msst_tpu.ops.gather_pallas import onehot_gather_rows

RNG = np.random.default_rng(1)


def _case(H, W, N, lo=None, hi=None):
    table = RNG.normal(size=(H, W)).astype(np.float32)
    idx = RNG.integers(0 if lo is None else lo, H if hi is None else hi,
                       size=(N,)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("H,W,N", [(1000, 24, 700), (2048, 8, 2048),
                                   (300, 130, 100)])
def test_gather_rows_plain_equals_onehot_kernel(H, W, N):
    table, idx = _case(H, W, N)
    want = np.asarray(onehot_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                         tile=256, h_chunk=512,
                                         interpret=True))
    got = gather.gather_rows_plain(torch.from_numpy(table),
                                   torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[idx])


def test_gather_rows_clamps_like_onehot_kernel():
    """Negative indices read row 0 and indices >= H row H-1, in both."""
    table, idx = _case(300, 24, 400, lo=-50, hi=350)
    idx[:4] = [-1, -2**31, 300, 2**31 - 1]
    assert (idx < 0).sum() > 10 and (idx >= 300).sum() > 10
    want = np.asarray(onehot_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                         tile=256, h_chunk=512,
                                         interpret=True))
    got = gather.gather_rows_plain(torch.from_numpy(table),
                                   torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[np.clip(idx, 0, 299)])


def test_gather_rows_takes_the_twin_on_cpu():
    """The wrapper on CPU tensors returns the twin's result and counts no
    kernel launch; empty index lists give (0, W)."""
    table, idx = _case(64, 6, 51)
    before = gather.gather_rows.launches
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert gather.gather_rows.launches == before
    np.testing.assert_array_equal(got.numpy(), table[idx])
    empty = gather.gather_rows(torch.from_numpy(table),
                               torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 6)
