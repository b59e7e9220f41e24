"""The port's fused matvec + Gram (ops/matvec_gram.py) against the
reference's Pallas kernel and its XLA pair.

Inputs are made with numpy from a seed and fed to both sides. The
reference's ``matvec_gram_pallas`` runs in interpret mode on the CPU, where
the port's ``matvec_gram_auto`` takes the plain version. Tolerance: 1e-5
relative Frobenius error on ``w`` and on ``g`` (the same fp32 products,
summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.ops.pallas_gram import matvec_gram_pallas
from distributed_eigenspaces_tpu.solvers.distributed import (
    fused_factor_matvec as jax_fused_factor_matvec,
)
from distributed_eigenspaces_tpu_torch.ops import matvec_gram as tmg
from distributed_eigenspaces_tpu_torch.solvers.distributed import fused_factor_matvec

TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _operands(rng, d, f, k):
    c = rng.standard_normal((d, f)).astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)
    return c, v


@pytest.mark.parametrize("d,f,k,block_d", [(256, 64, 16, 64), (512, 32, 6, 128)])
def test_auto_on_cpu_matches_matvec_gram_pallas(rng, d, f, k, block_d):
    c, v = _operands(rng, d, f, k)
    jw, jg = matvec_gram_pallas(jnp.asarray(c), jnp.asarray(v), block_d=block_d,
                                interpret=True)
    before = tmg.launches
    w, g = tmg.matvec_gram_auto(torch.from_numpy(c), torch.from_numpy(v))
    assert tmg.launches == before  # the CPU takes the plain version
    assert w.shape == (d, k) and g.shape == (k, k)
    assert w.dtype == g.dtype == torch.float32
    assert _rel(w, np.asarray(jw)) <= TOL
    assert _rel(g, np.asarray(jg)) <= TOL


@pytest.mark.parametrize("d,f,k", [(300, 80, 13), (97, 5, 3)])
def test_fused_factor_matvec_matches_reference_on_ragged_shapes(rng, d, f, k):
    """Shapes no Pallas block divides: the reference takes its XLA pair,
    the port the same function (its kernel masks the ragged edges)."""
    c, v = _operands(rng, d, f, k)
    jw, jg = jax_fused_factor_matvec(jnp.asarray(c))(jnp.asarray(v))
    w, g = fused_factor_matvec(torch.from_numpy(c))(torch.from_numpy(v))
    assert _rel(w, np.asarray(jw)) <= TOL
    assert _rel(g, np.asarray(jg)) <= TOL


def test_plain_gram_is_the_gram_of_its_w(rng):
    """CholeskyQR finishes from ``g``: it must be ``w^T w`` of the returned
    ``w``, not of an exact ``C (C^T v)``."""
    c, v = _operands(rng, 200, 40, 9)
    w, g = tmg.matvec_gram_plain(torch.from_numpy(c), torch.from_numpy(v))
    np.testing.assert_allclose(g.numpy(), (w.T @ w).numpy(), rtol=0, atol=0)
    w64 = c.astype(np.float64) @ (c.T.astype(np.float64) @ v)
    assert _rel(w, w64) <= TOL


def test_cuda_wrapper_refuses_cpu_tensors_without_counting():
    before = tmg.launches
    with pytest.raises(ValueError, match="CUDA"):
        tmg.matvec_gram_cuda(torch.zeros((8, 4)), torch.zeros((8, 2)))
    assert tmg.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tmg.matvec_gram_auto(torch.zeros((8, 4), device="meta"),
                             torch.zeros((8, 2), device="meta"))
