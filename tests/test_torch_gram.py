"""The port's Gram (ops/gram.py) against the reference's Pallas kernel.

Inputs are made with numpy from a seed and fed to both sides. The
reference's ``gram_pallas`` runs in interpret mode on the CPU. Tolerances
are relative Frobenius errors: 1e-5 for fp32 and 1e-4 for bf16 inputs
(the same exact products, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.ops.linalg import gram as jax_gram
from distributed_eigenspaces_tpu.ops.pallas_gram import gram_pallas
from distributed_eigenspaces_tpu_torch.ops import gram as tgram

TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``
    (both round fp32 -> bf16 to nearest even)."""
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(
        np.asarray(jx.astype(jnp.float32)), tx.float().numpy()
    )
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,bn,bd", [(256, 128, 128, 128), (512, 256, 256, 128)])
def test_gram_plain_matches_gram_pallas(rng, dtype, n, d, bn, bd):
    x = rng.standard_normal((n, d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = np.asarray(gram_pallas(jx, block_n=bn, block_d=bd, interpret=True))
    got = tgram.gram_plain(tx)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [True, False])
def test_gram_plain_matches_linalg_gram(rng, dtype, normalize):
    x = rng.standard_normal((3, 100, 72)).astype(np.float32)
    for w in range(3):
        jx, tx = _pair(x[w], dtype)
        want = np.asarray(jax_gram(jx, normalize=normalize))
        got = tgram.gram_plain(tx, normalize=normalize)
        assert _rel(got, want) <= TOL[dtype]
    # batched: one call over the worker axis equals the per-worker calls
    _, tall = _pair(x, dtype)
    batched = tgram.gram_plain(tall, normalize=normalize)
    for w in range(3):
        np.testing.assert_allclose(
            batched[w].numpy(),
            tgram.gram_plain(tall[w], normalize=normalize).numpy(),
            rtol=1e-6, atol=1e-6,
        )


def test_gram_plain_bf16_is_not_rounded_to_bf16(rng):
    """A bf16 Gram comes out fp32 at fp32 accuracy: a bf16 matmul, whose
    output is rounded to bf16, misses the tolerance by orders of magnitude."""
    x = rng.standard_normal((256, 64)).astype(np.float32)
    jx, tx = _pair(x, "bfloat16")
    want = np.asarray(jax_gram(jx))
    assert _rel(tgram.gram_plain(tx), want) <= TOL["bfloat16"]
    naive = (torch.matmul(tx.mT, tx) / 256).float()
    assert _rel(naive, want) > 10 * TOL["bfloat16"]


def test_gram_auto_cpu_takes_plain_without_launch(rng):
    x = torch.from_numpy(rng.standard_normal((2, 40, 24)).astype(np.float32))
    before = tgram.launches
    got = tgram.gram_auto(x)
    assert tgram.launches == before
    torch.testing.assert_close(got, tgram.gram_plain(x), rtol=0, atol=0)


def test_gram_cuda_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgram.gram_cuda(torch.zeros((2, 8, 8)))

