"""Card-only tests of the PyTorch port: the hand-written kernels on a CUDA
device, against their plain PyTorch versions and against the CPU path.

Every test here carries the ``cuda`` marker and skips, with its reason,
where ``torch.cuda.is_available()`` is False. The file imports neither JAX
nor the JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: the Gram kernel's relative Frobenius error against the plain
version is at most 1e-5 for fp32 and 1e-4 for bf16 inputs (the same exact
products, summed in another order); whole rounds on the card and on the
CPU agree to 1e-4 absolute in ``sigma_tilde`` and 0.05 degrees in bases.
"""

import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu_torch.ops import gram as tgram
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import worker_pool as twp

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only on the card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _x(shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape", [(4, 128, 256), (3, 1000, 3000), (2, 37, 129), (1, 1, 1)]
)
def test_gram_cuda_matches_plain(cuda_device, dtype, shape):
    x = _x(shape).to(device=cuda_device, dtype=getattr(torch, dtype))
    before = tgram.launches
    got = tgram.gram_cuda(x)
    torch.cuda.synchronize()
    assert tgram.launches == before + 1
    want = tgram.gram_plain(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= TOL[dtype]
    assert torch.equal(got, got.mT)
    unnormalized = tgram.gram_cuda(x, normalize=False)
    assert _rel(unnormalized, tgram.gram_plain(x, normalize=False)) <= TOL[dtype]


def test_gram_auto_on_cuda_launches_or_raises(cuda_device):
    x = _x((2, 64, 96)).to(cuda_device)
    before = tgram.launches
    tgram.gram_auto(x)
    assert tgram.launches == before + 1
    # the unbatched (n, d) form is one worker
    assert tgram.gram_auto(x[0]).shape == (96, 96)
    # no fallback: what the kernel does not take is refused
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tgram.gram_auto(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        tgram.gram_auto(x.mT)
    assert tgram.launches == before + 2


@pytest.mark.parametrize(
    "solver,iters,launches", [("subspace", 12, 1), ("subspace", 2, 0), ("eigh", 12, 1)]
)
def test_local_eigenspaces_on_card_matches_cpu(cuda_device, solver, iters, launches):
    m, n, d, k = 3, 96, 64, 4
    q = np.linalg.qr(np.random.default_rng(1).standard_normal((d, d)))[0]
    lam = np.concatenate([8.0 * 0.8 ** np.arange(k), 0.05 * np.ones(d - k)])
    x = torch.from_numpy(
        ((_x((m, n, d), seed=2).numpy() * np.sqrt(lam)) @ q.T).astype(np.float32)
    )
    v0 = _x((d, k), seed=3)
    want = twp._local_eigenspaces(x, k, solver, iters, v0=v0)
    before = tgram.launches
    got = twp._local_eigenspaces(x.to(cuda_device), k, solver, iters, v0=v0.to(cuda_device))
    torch.cuda.synchronize()
    assert tgram.launches == before + launches
    for w in range(m):
        assert float(principal_angles_degrees(got[w].cpu(), want[w]).max()) <= 0.05


def test_entry_step_on_card_matches_cpu(cuda_device):
    step, (state, x) = dett.entry(device=cuda_device)
    before = tgram.launches
    state, v = step(state, x)
    torch.cuda.synchronize()
    assert tgram.launches == before + 1
    cpu_step, (cpu_state, cpu_x) = dett.entry(device="cpu")
    cpu_state, cpu_v = cpu_step(cpu_state, cpu_x)
    assert float((state.sigma_tilde.cpu() - cpu_state.sigma_tilde).abs().max()) <= 1e-4
    assert float(principal_angles_degrees(v.cpu(), cpu_v).max()) <= 0.05
