"""The port's planted-subspace model (data/synthetic.py) against the
reference's ``planted_subspace``.

The basis is numpy's sign-fixed QR on both sides and must be bit-equal for
the same seed; the eigenvalues likewise. Samples come from each side's own
generator, so they are held to the model's covariance ``Q diag(lambda)
Q^T + noise^2 I`` instead: with N rows the sample covariance's largest
entrywise error is a few ``lambda_max sqrt(2 / N)``; the tolerance below is
``6 lambda_max / sqrt(N)``.
"""

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.data.synthetic import planted_subspace as jax_subspace
from distributed_eigenspaces_tpu_torch.data.synthetic import (
    PlantedSubspace,
    planted_subspace,
)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("d,r,gap,decay", [(64, 4, 10.0, 0.8), (300, 10, 20.0, 0.8),
                                           (512, 50, 20.0, max(0.8, 0.05 ** (1 / 49)))])
def test_basis_and_spectrum_bit_equal_to_the_reference(seed, d, r, gap, decay):
    ours = planted_subspace(d, k_planted=r, gap=gap, decay=decay, noise=0.01, seed=seed)
    theirs = jax_subspace(d, k_planted=r, gap=gap, decay=decay, noise=0.01, seed=seed)
    assert isinstance(ours, PlantedSubspace)
    assert ours.basis.dtype == np.float32 and ours.basis.shape == (d, r)
    np.testing.assert_array_equal(ours.basis, np.asarray(theirs.basis))
    np.testing.assert_array_equal(ours.eigenvalues, np.asarray(theirs.eigenvalues))
    assert ours.noise == theirs.noise == 0.01
    np.testing.assert_allclose(ours.basis.T @ ours.basis, np.eye(r), atol=1e-5)


def test_top_k_is_the_leading_columns_and_raises_above_the_rank():
    spec = planted_subspace(32, k_planted=4, seed=0)
    np.testing.assert_array_equal(spec.top_k(3), spec.basis[:, :3])
    np.testing.assert_array_equal(spec.top_k(4), np.asarray(jax_subspace(32, k_planted=4).top_k(4)))
    with pytest.raises(ValueError, match="exceeds planted rank 4"):
        spec.top_k(5)
    with pytest.raises(ValueError, match="exceeds planted rank 4"):
        jax_subspace(32, k_planted=4).top_k(5)


def _model_covariance(spec):
    q, lam = spec.basis.astype(np.float64), spec.eigenvalues.astype(np.float64)
    return (q * lam) @ q.T + spec.noise ** 2 * np.eye(q.shape[0])


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_sample_covariance_matches_the_model(source):
    spec = planted_subspace(24, k_planted=3, gap=5.0, decay=0.7, noise=0.3, seed=2)
    n = 200_000
    if source == "numpy":
        x = spec.sample(np.random.default_rng(5), n)
        assert isinstance(x, np.ndarray) and x.dtype == np.float32
    else:
        x = spec.sample(torch.Generator().manual_seed(5), n)
        assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
        x = x.numpy()
    assert x.shape == (n, 24)
    cov = x.astype(np.float64).T @ x.astype(np.float64) / n
    tol = 6 * spec.eigenvalues.max() / np.sqrt(n)
    assert np.abs(cov - _model_covariance(spec)).max() <= tol
    # the noise floor is isotropic: the planted directions carry lambda + noise^2
    rayleigh = np.einsum("dk,de,ek->k", spec.basis, cov, spec.basis)
    np.testing.assert_allclose(rayleigh, spec.eigenvalues + spec.noise ** 2, atol=tol)


def test_sample_draws_the_low_rank_part_then_the_noise():
    """``(z sqrt(lambda)) Q^T + noise * eps`` with z drawn first, then eps,
    from the same generator (what a caller reproducing a draw relies on)."""
    spec = planted_subspace(16, k_planted=2, noise=0.5, seed=0)
    gen = torch.Generator().manual_seed(7)
    z = torch.randn((5, 2), generator=gen)
    eps = torch.randn((5, 16), generator=gen)
    want = (z * torch.sqrt(torch.from_numpy(spec.eigenvalues))) @ torch.from_numpy(spec.basis).T
    want = want + 0.5 * eps
    got = spec.sample(torch.Generator().manual_seed(7), 5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert spec.sample(np.random.default_rng(0), 3, dtype=np.float64).dtype == np.float64
