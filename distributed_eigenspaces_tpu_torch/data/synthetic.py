"""Planted-spectrum and planted-subspace Gaussian data: the correctness
reference.

Counterpart of ``planted_spectrum`` and ``planted_subspace`` in
``distributed_eigenspaces_tpu/data/synthetic.py``. Bases and spectra are
built in numpy exactly as the reference builds them (same seed, same
arrays). Samples are drawn from a numpy ``Generator`` (numpy out) or a
``torch.Generator`` (a tensor on the generator's device, so large draws can
be made on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PlantedSpectrum(NamedTuple):
    basis: np.ndarray  # (d, d) orthonormal columns, descending eigenvalues
    eigenvalues: np.ndarray  # (d,) descending

    def top_k(self, k: int) -> np.ndarray:
        """True top-k principal subspace (d, k)."""
        return self.basis[:, :k]

    def sample(self, rng, n: int, dtype=np.float32):
        """Draw n rows with covariance ``Q diag(lambda) Q^T``: numpy rows for
        a ``numpy.random.Generator``, a float32 tensor on the generator's
        device for a ``torch.Generator``."""
        d = self.basis.shape[0]
        if isinstance(rng, torch.Generator):
            dev = rng.device
            q = torch.as_tensor(self.basis, dtype=torch.float32, device=dev)
            lam = torch.as_tensor(self.eigenvalues, dtype=torch.float32, device=dev)
            z = torch.randn((n, d), generator=rng, device=dev, dtype=torch.float32)
            return torch.matmul(z * torch.sqrt(lam)[None, :], q.mT)
        z = rng.standard_normal((n, d), dtype=np.float32)
        x = (z * np.sqrt(self.eigenvalues)[None, :]) @ self.basis.T
        return x.astype(dtype)


def planted_spectrum(
    d: int,
    *,
    k_planted: int = 8,
    gap: float = 10.0,
    decay: float = 0.8,
    noise: float = 0.05,
    seed: int = 0,
) -> PlantedSpectrum:
    """``k_planted`` strong directions ``gap * decay**i`` over a noise floor
    decaying from ``noise``, on a Haar-random orthogonal basis."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((d, d)))
    q = q * np.sign(np.diag(r))[None, :]  # Haar correction
    lead = gap * decay ** np.arange(k_planted)
    tail = noise * (0.99 ** np.arange(d - k_planted))
    lam = np.concatenate([lead, tail])
    return PlantedSpectrum(
        basis=q.astype(np.float32), eigenvalues=lam.astype(np.float32)
    )


class PlantedSubspace(NamedTuple):
    """Low-rank planted model: covariance ``Q diag(lambda) Q^T + noise^2 I``
    with ``Q (d, r)`` orthonormal, the large-d twin of
    :class:`PlantedSpectrum`: it keeps O(d r) state instead of a d x d
    basis, and samples in O(n (d + r^2))."""

    basis: np.ndarray  # (d, r) orthonormal, descending eigenvalue order
    eigenvalues: np.ndarray  # (r,) descending, on top of the noise floor
    noise: float

    def top_k(self, k: int) -> np.ndarray:
        """True top-k principal subspace (d, k); requires k <= r."""
        if k > self.basis.shape[1]:
            raise ValueError(
                f"k={k} exceeds planted rank {self.basis.shape[1]}"
            )
        return self.basis[:, :k]

    def sample(self, rng, n: int, dtype=np.float32):
        """Draw n rows with covariance ``Q diag(lambda) Q^T + noise^2 I``:
        ``z (n, r)`` then the noise ``(n, d)``, both standard normal, as
        ``(z sqrt(lambda)) Q^T + noise * eps``. numpy rows for a
        ``numpy.random.Generator``; for a ``torch.Generator`` a float32
        tensor drawn and computed on the generator's device."""
        d, r = self.basis.shape
        if isinstance(rng, torch.Generator):
            dev = rng.device
            q = torch.as_tensor(self.basis, dtype=torch.float32, device=dev)
            lam = torch.as_tensor(self.eigenvalues, dtype=torch.float32, device=dev)
            z = torch.randn((n, r), generator=rng, device=dev, dtype=torch.float32)
            x = torch.matmul(z * torch.sqrt(lam)[None, :], q.mT)
            eps = torch.randn((n, d), generator=rng, device=dev, dtype=torch.float32)
            return x + self.noise * eps
        z = rng.standard_normal((n, r), dtype=np.float32)
        x = (z * np.sqrt(self.eigenvalues)[None, :]) @ self.basis.T
        x = x + np.float32(self.noise) * rng.standard_normal((n, d), dtype=np.float32)
        return x.astype(dtype)


def planted_subspace(
    d: int,
    *,
    k_planted: int = 8,
    gap: float = 10.0,
    decay: float = 0.8,
    noise: float = 0.05,
    seed: int = 0,
) -> PlantedSubspace:
    """``k_planted`` strong directions ``gap * decay**i`` on an isotropic
    ``noise``-level floor, on the sign-fixed numpy QR of a ``(d,
    k_planted)`` Gaussian: the same leading spectrum as
    :func:`planted_spectrum`; the true top-k subspace is exact for any
    ``k <= k_planted``."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((d, k_planted)))
    q = q * np.sign(np.diag(r))[None, :]
    lead = gap * decay ** np.arange(k_planted)
    return PlantedSubspace(
        basis=q.astype(np.float32),
        eigenvalues=lead.astype(np.float32),
        noise=float(noise),
    )
