"""Planted-spectrum Gaussian data: the correctness reference.

Counterpart of ``planted_spectrum`` in ``distributed_eigenspaces_tpu/data/
synthetic.py``. The basis and spectrum are built in numpy exactly as the
reference builds them (same seed, same arrays). Samples are drawn from a
numpy ``Generator`` (numpy out) or a ``torch.Generator`` (a tensor on the
generator's device, so large draws can be made on the card).
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
