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
The serve kernels agree with their plain versions to 1e-5 relative (exact
products of bf16-rounded operands, fp32 sums in another order), and a
zero-padded launch gives every real row the same bits as an unpadded one;
so does the fixed-order fp32 projection, which makes a served fp32 row equal
its direct projection bit for bit. The fused matvec + Gram kernel agrees
with its plain version to 1e-5 relative on ``w`` and ``g``, its ``g`` is
exactly symmetric and two launches give the same bits; a fused solve on the
card lands within 1e-3 degrees of the same solve on the CPU.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu_torch.ops import gram as tgram
from distributed_eigenspaces_tpu_torch.ops import matvec_gram as tmg
from distributed_eigenspaces_tpu_torch.ops import serve_project as tsp
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import worker_pool as twp
from distributed_eigenspaces_tpu_torch.serving import (
    EigenbasisRegistry,
    QueryServer,
    TransformEngine,
)
from distributed_eigenspaces_tpu_torch.solvers import distributed as tdist

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


def _serve_operands(rows, d, k, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    v = torch.from_numpy(np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32))
    return x, v


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "rows,d,k", [(1000, 3000, 10), (37, 129, 3), (64, 256, 8), (5, 1100, 19), (1, 1, 1)]
)
def test_serve_kernels_match_plain(cuda_device, x_dtype, rows, d, k):
    x, v = _serve_operands(rows, d, k)
    x = x.to(device=cuda_device, dtype=getattr(torch, x_dtype))
    v = v.to(cuda_device)
    q, s = tsp.quantize_basis_i8(v)
    before = (tsp.launches, tsp.launches_i8)
    got = tsp.serve_project_cuda(x, v)
    got_i8 = tsp.serve_project_i8_cuda(x, q, s)
    torch.cuda.synchronize()
    assert (tsp.launches, tsp.launches_i8) == (before[0] + 1, before[1] + 1)
    assert got.shape == (rows, k) and got.dtype == torch.float32
    assert _rel(got, tsp.serve_project_plain(x, v)) <= 1e-5
    assert _rel(got_i8, tsp.serve_project_i8_plain(x, q, s)) <= 1e-5
    # padded rows: a longer launch gives the first rows the same bits
    pad = torch.zeros((rows + 45, d), dtype=x.dtype, device=cuda_device)
    pad[:rows] = x
    assert torch.equal(tsp.serve_project_cuda(pad, v)[:rows], got)
    assert torch.equal(tsp.serve_project_i8_cuda(pad, q, s)[:rows], got_i8)


def test_serve_auto_on_cuda_launches_and_cuda_wrappers_refuse_cpu(cuda_device):
    x, v = _serve_operands(33, 300, 10)
    q, s = tsp.quantize_basis_i8(v)
    before = (tsp.launches, tsp.launches_i8)
    tsp.serve_project_auto(x.to(cuda_device), v.to(cuda_device))
    tsp.serve_project_i8_auto(x.to(cuda_device), q.to(cuda_device), s.to(cuda_device))
    assert (tsp.launches, tsp.launches_i8) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.serve_project_cuda(x, v)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.serve_project_i8_cuda(x, q, s)
    with pytest.raises(ValueError, match="contiguous"):
        tsp.serve_project_auto(x.to(cuda_device).mT.contiguous().mT, v.to(cuda_device))
    assert (tsp.launches, tsp.launches_i8) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("serve_dtype", ["bfloat16", "int8"])
def test_query_server_on_card_launches_once_per_dispatch(cuda_device, serve_dtype):
    d, k = 256, 8
    _, v = _serve_operands(1, d, k)
    reg = EigenbasisRegistry()
    reg.publish(v.numpy())
    cfg = dett.PCAConfig(dim=d, k=k, serve_dtype=serve_dtype)
    rng = np.random.default_rng(1)
    qs = [(rng.standard_normal((r, k)) @ v.numpy().T
           + 0.1 * rng.standard_normal((r, d))).astype(np.float32) for r in (1, 8, 64)]
    with QueryServer(reg, cfg, device=cuda_device) as srv:
        tsp.launches = tsp.launches_i8 = 0
        project_calls = srv.engine.compile_misses + srv.engine.cache_hits
        res = [srv.submit(q).result(timeout=60) for q in qs]
        dispatches = srv.engine.compile_misses + srv.engine.cache_hits - project_calls
    launched = tsp.launches_i8 if serve_dtype == "int8" else tsp.launches
    assert launched == dispatches // 2  # one project and one residual per batch
    for q, r in zip(qs, res):
        z_ref = q @ v.numpy()
        cos = (r.z * z_ref).sum(1) / np.linalg.norm(r.z, axis=1) / np.linalg.norm(z_ref, axis=1)
        assert float(np.degrees(np.arccos(np.clip(cos, -1, 1))).max()) <= 0.2


def test_launch_counters_survive_threads(cuda_device):
    """Serve lanes launch from their own threads: a counter that lost an
    update would break the launch gates of chip_smoke.py."""
    x, v = _serve_operands(64, 256, 8)
    x, v = x.to(cuda_device), v.to(cuda_device)
    q, s = tsp.quantize_basis_i8(v)
    xg = x.reshape(1, 64, 256)
    before = (tsp.launches, tsp.launches_i8, tgram.launches)
    threads, reps = 12, 40

    def work():
        for _ in range(reps):
            tsp.serve_project_cuda(x, v)
            tsp.serve_project_i8_cuda(x, q, s)
            tgram.gram_cuda(xg)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    n = threads * reps
    assert (tsp.launches, tsp.launches_i8, tgram.launches) == (
        before[0] + n, before[1] + n, before[2] + n)


@pytest.mark.parametrize(
    "rows,d,k", [(1000, 3000, 10), (37, 129, 3), (5, 1100, 19), (1, 1, 1)]
)
def test_serve_f32_kernel_matches_plain_and_keeps_padded_rows(cuda_device, rows, d, k):
    x, v = _serve_operands(rows, d, k, seed=4)
    x, v = x.to(cuda_device), v.to(cuda_device)
    before = tsp.launches_f32
    got = tsp.serve_project_f32_cuda(x, v)
    torch.cuda.synchronize()
    assert tsp.launches_f32 == before + 1
    assert _rel(got, tsp.serve_project_f32_plain(x, v)) <= 1e-5
    pad = torch.zeros((rows + 45, d), device=cuda_device)
    pad[:rows] = x
    assert torch.equal(tsp.serve_project_f32_cuda(pad, v)[:rows], got)
    for r in range(min(rows, 3)):  # a row alone gets the bits it gets in the batch
        assert torch.equal(tsp.serve_project_f32_cuda(x[r:r + 1].contiguous(), v)[0], got[r])
    with pytest.raises(ValueError, match="float32 x"):
        tsp.serve_project_f32_cuda(x.to(torch.bfloat16), v)


def test_padded_project_bit_equals_direct_on_card(cuda_device):
    """The reference's served-equals-direct contract, on the card: the
    engine's padded fp32 bucket against ``est.transform`` at the query's own
    row count (cf. tests/test_serving.py)."""
    d, k = 96, 5
    spec = dett.planted_spectrum(d, k_planted=k, seed=0)
    data = spec.sample(np.random.default_rng(0), 4 * 64 * 3)
    cfg = dett.PCAConfig(dim=d, k=k, num_workers=4, rows_per_worker=64, num_steps=3,
                         solver="subspace")
    est = dett.OnlineDistributedPCA(cfg, device=cuda_device).fit(data)
    eng = TransformEngine(d, k, device=cuda_device)
    assert eng.self_check(est.components_) == 0.0
    w = est.components_.cpu().numpy()
    rng = np.random.default_rng(5)
    before = tsp.launches_f32
    for rows in (1, 3, 8, 11, 40):
        x = rng.standard_normal((rows, d)).astype(np.float32)
        z = eng.project(x, w).cpu().numpy()
        direct = est.transform(x).cpu().numpy()
        assert np.array_equal(z, direct), rows
    assert tsp.launches_f32 == before + 10  # both sides take the kernel
    one = est.transform(x[0])
    assert one.shape == (k,) and torch.equal(one, est.transform(x[:1])[0])


@pytest.mark.parametrize(
    "d,f,k", [(256, 64, 16), (3000, 80, 13), (12288, 200, 58), (97, 5, 70), (1, 1, 1)]
)
def test_matvec_gram_kernel_matches_plain(cuda_device, d, f, k):
    c = _x((d, f), seed=6).to(cuda_device)
    v = _x((d, k), seed=7).to(cuda_device)
    before = tmg.launches
    w, g = tmg.matvec_gram_cuda(c, v)
    torch.cuda.synchronize()
    assert tmg.launches == before + 1
    pw, pg = tmg.matvec_gram_plain(c, v)
    assert w.shape == (d, k) and g.shape == (k, k)
    assert _rel(w, pw) <= 1e-5 and _rel(g, pg) <= 1e-5
    assert torch.equal(g, g.mT)
    w2, g2 = tmg.matvec_gram_cuda(c, v)
    assert torch.equal(w, w2) and torch.equal(g, g2)


def test_matvec_gram_auto_on_cuda_launches_or_raises(cuda_device):
    c = _x((300, 40)).to(cuda_device)
    v = _x((300, 6), seed=1).to(cuda_device)
    before = tmg.launches
    tmg.matvec_gram_auto(c, v)
    assert tmg.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        tmg.matvec_gram_auto(c.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        tmg.matvec_gram_auto(c.mT.contiguous().mT, v)
    with pytest.raises(ValueError, match=f"k <= {tmg.MAX_K}"):
        tmg.matvec_gram_auto(c, _x((300, tmg.MAX_K + 1)).to(cuda_device))
    assert tmg.launches == before + 1


def test_fused_solve_on_card_matches_cpu(cuda_device):
    d, kk, k = 2048, 12, 4
    rng = np.random.default_rng(8)
    u = np.linalg.qr(rng.standard_normal((d, 16)))[0]
    c = torch.from_numpy((u * np.sqrt(2.0 * 0.6 ** np.arange(16))).astype(np.float32))
    v_init = _x((d, kk), seed=9)
    want = tdist.dist_subspace_eig(
        tdist.factor_matvec(c), d, k, iters=16, v_init=v_init, oversample=kk - k,
        matvec_gram=tdist.fused_factor_matvec(c))
    cc = c.to(cuda_device)
    tmg.launches = 0
    got, info = tdist.dist_subspace_eig(
        tdist.factor_matvec(cc), d, k, iters=16, v_init=v_init.to(cuda_device),
        oversample=kk - k, matvec_gram=tdist.fused_factor_matvec(cc), tol=1e-6,
        with_info=True)
    torch.cuda.synchronize()
    assert tmg.launches == info["iters_used"]
    assert float(principal_angles_degrees(got.cpu(), want).max()) <= 1e-3
