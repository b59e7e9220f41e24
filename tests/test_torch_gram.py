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
    before = (tgram.launches, tgram.launches_tma)
    got = tgram.gram_auto(x)
    assert (tgram.launches, tgram.launches_tma) == before
    torch.testing.assert_close(got, tgram.gram_plain(x), rtol=0, atol=0)
    xb = x.to(torch.bfloat16)  # a TMA shape on the card: still plain here
    torch.testing.assert_close(tgram.gram_auto(xb), tgram.gram_plain(xb), rtol=0, atol=0)
    assert (tgram.launches, tgram.launches_tma) == before


def test_gram_cuda_refuses_cpu_tensor():
    before = (tgram.launches, tgram.launches_tma)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgram.gram_cuda(torch.zeros((2, 8, 8)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgram.gram_cuda(torch.zeros((2, 8, 8), dtype=torch.bfloat16))
    assert (tgram.launches, tgram.launches_tma) == before


@pytest.mark.parametrize("d,dtype,aligned,tma", [
    (3072, torch.bfloat16, True, True), (136, torch.bfloat16, True, True),
    (129, torch.bfloat16, True, False), (3072, torch.bfloat16, False, False),
    (3072, torch.float32, True, False), (1, torch.bfloat16, True, False)])
def test_gram_shape_rule(d, dtype, aligned, tma):
    """Which kernel a launch takes is decided from the shape, the dtype
    and the base's alignment before the launch: bf16 rows TMA can read
    (16-byte strides and base) take the TMA kernel."""
    assert tgram.takes_tma(d, dtype, aligned) is tma
    kernel = tgram.gram_launch(2, 64, d, dtype, aligned).kernel
    assert (kernel == "gram_bf16_tma_kernel") is tma



# -- the s8 Gram (int8 blocks) -------------------------------------------------


def test_gram_s8_cuda_refuses_what_the_kernel_does_not_take():
    before = tgram.launches_s8
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgram.gram_s8_cuda(torch.zeros((2, 8, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgram.gram_s8_transpose_cuda(torch.zeros((2, 8, 8), dtype=torch.int8))
    assert tgram.launches_s8 == before


@pytest.mark.parametrize("n", [1, 15, 16, 1000, 2048])
def test_gram_s8_transpose_plain_pads_n_with_zero_rows(rng, n):
    """What the transpose kernel writes: x^T ``(m, d, n_pad)`` with n_pad
    the next multiple of 16 (the TMA kernel's 16-byte row strides), the
    columns from n on zero, against numpy; its Gram over n_pad is the
    block's."""
    m, d = 3, 37
    x = rng.integers(-127, 128, size=(m, n, d)).astype(np.int8)
    n_pad = tgram.s8_pad(n)
    assert n_pad % 16 == 0 and n <= n_pad < n + 16
    assert n_pad == {1: 16, 15: 16, 16: 16, 1000: 1008, 2048: 2048}[n]
    got = tgram.gram_s8_transpose_plain(torch.from_numpy(x))
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, d, n_pad)
    want = np.zeros((m, d, n_pad), np.int8)
    want[:, :, :n] = np.swapaxes(x, 1, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[..., n:].any()
    # a single block, and the Gram over the padded rows equals the block's
    np.testing.assert_array_equal(
        tgram.gram_s8_transpose_plain(torch.from_numpy(x[0])).numpy(), want[0])
    wide = got.long()
    np.testing.assert_array_equal(
        torch.matmul(wide, wide.mT).numpy(),
        torch.matmul(torch.from_numpy(x).long().mT, torch.from_numpy(x).long()).numpy())


def test_gram_auto_int8_on_cpu_takes_the_plain_version(rng):
    """An int8 CPU batch takes the s8 plain version (exact), launches no
    kernel, and is never widened to bf16."""
    x = torch.from_numpy(rng.integers(-127, 128, size=(3, 50, 20)).astype(np.int8))
    before = (tgram.launches, tgram.launches_tma, tgram.launches_s8)
    got = tgram.gram_auto(x)
    assert (tgram.launches, tgram.launches_tma, tgram.launches_s8) == before
    torch.testing.assert_close(got, tgram.gram_s8_plain(x), rtol=0, atol=0)
    exact = torch.matmul(x.long().mT, x.long()).double() / 50
    torch.testing.assert_close(got, exact.float(), rtol=0, atol=0)
    assert tgram.widen_int(x) is x
