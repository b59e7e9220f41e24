"""Card-only tests of the PyTorch port: the hand-written kernels on a CUDA
device, against their plain PyTorch versions and against the CPU path.

Every test here carries the ``cuda`` marker and skips, with its reason,
where ``torch.cuda.is_available()`` is False. The file imports neither JAX
nor the JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: the Gram kernel's relative Frobenius error against the plain
version is at most 1e-5 for fp32 and 1e-4 for bf16 inputs (the same exact
products, summed in another order), and its output is exactly symmetric,
whichever of its kernels the shape rule picks (bf16 with d % 8 == 0 on an
aligned base: the TMA + wgmma kernel); whole rounds on the card and on the
CPU agree to 1e-4 absolute in ``sigma_tilde`` and 0.05 degrees in bases.
The serve kernels agree with their plain versions to 1e-5 relative (exact
products of bf16-rounded operands, fp32 sums in another order), repeat
bit for bit, and a zero-padded launch gives every real row the same bits as
an unpadded one, wherever the row sits;
so does the fixed-order fp32 projection, which makes a served fp32 row equal
its direct projection bit for bit. The fused matvec + Gram kernel agrees
with its plain version to 1e-5 relative on ``w`` and ``g``, its ``g`` is
exactly symmetric and two launches give the same bits; a fused solve on the
card lands within 1e-3 degrees of the same solve on the CPU. The analyzer's
one-CTA mutant agrees with ``torch.matmul`` to 1e-5 relative (FFMA in index
order against cuBLAS fp32), and ``torch.profiler`` reads every recorded
launch back with the grid, block and shared memory its record declares.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import distributed_eigenspaces_tpu_torch as dett
from distributed_eigenspaces_tpu_torch.ops import geometry as tgeo
from distributed_eigenspaces_tpu_torch.ops import gram as tgram
from distributed_eigenspaces_tpu_torch.ops import matvec_gram as tmg
from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as tmfb
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
    "shape", [(4, 128, 256), (3, 1000, 3000), (2, 37, 129), (1, 1, 1), (8, 1024, 3072),
              (2, 100, 136), (1, 64, 8), (3, 65, 264)]
)
def test_gram_cuda_matches_plain(cuda_device, dtype, shape):
    x = _x(shape).to(device=cuda_device, dtype=getattr(torch, dtype))
    before = (tgram.launches, tgram.launches_tma)
    tma = dtype == "bfloat16" and shape[2] % 8 == 0
    assert tgram.takes_tma(shape[2], x.dtype, x.data_ptr() % 16 == 0) == tma
    got = tgram.gram_cuda(x)
    torch.cuda.synchronize()
    assert (tgram.launches, tgram.launches_tma) == (before[0] + 1, before[1] + tma)
    want = tgram.gram_plain(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= TOL[dtype]
    assert torch.equal(got, got.mT)
    unnormalized = tgram.gram_cuda(x, normalize=False)
    assert _rel(unnormalized, tgram.gram_plain(x, normalize=False)) <= TOL[dtype]


@pytest.mark.parametrize("shape,offset", [
    ((4, 128, 256), 0), ((8, 256, 512), 0), ((8, 100, 510), 0), ((3, 1000, 3001), 0),
    ((3, 1000, 3000), 1), ((2, 1, 300), 0), ((5, 37, 130), 0), ((1, 1, 1), 0),
    ((8, 1024, 3072), 0)])
def test_gram_f32_every_tile_edge_and_copy_width(cuda_device, shape, offset):
    """fp32 x takes ``gram_f32_kernel<edge, vec>`` of the shape rule
    (``f32_tile``: 32, 64 or 128; ``f32_vec``: 16-byte copies on aligned rows
    with d % 4 == 0, else 4-byte), recorded as ``gram_launch`` declares, at
    1e-5 of the plain version and exactly symmetric; one launch per call."""
    flat = _x((int(np.prod(shape)) + offset,), seed=17).to(cuda_device)
    x = flat[offset:].view(shape)
    aligned = x.data_ptr() % 16 == 0
    assert aligned == (offset == 0)
    before = tgram.launches
    with tgeo.recording() as rec:
        got = tgram.gram_cuda(x)
    torch.cuda.synchronize()
    assert tgram.launches == before + 1
    want_launch = tgram.gram_launch(*shape, torch.float32, aligned)
    assert rec == [want_launch]
    assert want_launch.kernel == (f"gram_f32_kernel<{tgram.f32_tile(shape[0], shape[2])}, "
                                  f"{tgram.f32_vec(shape[2], aligned)}>")
    want = tgram.gram_plain(x)
    assert _rel(got, want) <= TOL["float32"]
    assert torch.equal(got, got.mT)
    assert torch.equal(tgram.gram_cuda(x), got)  # the same bits again


def test_gram_misaligned_bf16_takes_the_mma_sync_kernel(cuda_device):
    """The shape rule reads the base address too: a bf16 view 2 bytes off
    a 16-byte boundary cannot be read by TMA, so it takes the mma.sync
    kernel, with the same numbers; each launch notes its record."""
    buf = _x((2 * 96 * 64 + 1,)).to(device=cuda_device, dtype=torch.bfloat16)
    x = buf[1:].view(2, 96, 64)
    assert x.data_ptr() % 16 == 2 and x.is_contiguous()
    before = (tgram.launches, tgram.launches_tma)
    with tgeo.recording() as rec:
        got = tgram.gram_cuda(x)
        aligned = tgram.gram_cuda(x.clone())
    torch.cuda.synchronize()
    assert (tgram.launches, tgram.launches_tma) == (before[0] + 2, before[1] + 1)
    assert [r.kernel for r in rec] == ["gram_bf16_kernel", "gram_bf16_tma_kernel"]
    assert rec[0] == tgram.gram_launch(2, 96, 64, torch.bfloat16, aligned=False)
    assert rec[1] == tgram.gram_launch(2, 96, 64).resolved(rec[1].grid)
    assert 1 <= rec[1].grid[0] <= 2  # at most one CTA per tile
    want = tgram.gram_plain(x)
    assert _rel(got, want) <= TOL["bfloat16"] and _rel(aligned, want) <= TOL["bfloat16"]
    assert torch.equal(got, got.mT) and torch.equal(aligned, aligned.mT)


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


def _split_kernels(v, x_dtype=torch.bfloat16):
    """The serve routes as ``x -> z`` on basis ``v``: bf16 and int8, and
    for fp32 x the fp32 route too."""
    q, s = tsp.quantize_basis_i8(v)
    routes = {
        "bf16": (lambda a: tsp.serve_project_cuda(a, v),
                 lambda a: tsp.serve_project_plain(a, v)),
        "i8": (lambda a: tsp.serve_project_i8_cuda(a, q, s),
               lambda a: tsp.serve_project_i8_plain(a, q, s)),
    }
    if x_dtype == torch.float32:
        routes["f32"] = (lambda a: tsp.serve_project_f32_cuda(a, v),
                         lambda a: tsp.serve_project_f32_plain(a, v))
    return routes


@pytest.mark.parametrize("d", [3072, 12288])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["bf16", "i8"])
def test_serve_split_rows_keep_their_bits_in_any_launch(cuda_device, route, x_dtype, d):
    """The row-order contract at the engine's bucket sizes: 1, 3, 8, 64, 300
    and 512 rows alone give the bits they get at the head of a 512- and of a
    4096-row launch, and at an offset inside the 4096-row one. Up to 512
    rows a tile is one column pair with the basis staged whole; at 4096
    rows a tile holds all of k, and at d = 12288 its basis is staged in d
    chunks per item."""
    x, v = _serve_operands(4096, d, 10, seed=16)
    x = x.to(device=cuda_device, dtype=getattr(torch, x_dtype))
    run, _ = _split_kernels(v.to(cuda_device))[route]
    full = {n: run(x[:n]) for n in (512, 4096)}
    for rows in (1, 3, 8, 64, 300, 512):
        alone = run(x[:rows].contiguous())
        for n, z in full.items():
            assert torch.equal(alone, z[:rows]), (rows, n)
        inner = run(x[1001:1001 + rows].contiguous())
        assert torch.equal(inner, full[4096][1001:1001 + rows]), rows


@pytest.mark.parametrize("d", [3072, 12288])
def test_serve_f32_rows_keep_their_bits_in_any_launch(cuda_device, d):
    """The row-order contract of the fp32 route, which makes a served row
    equal its direct projection: rows 1 to 512 alone give the bits they get
    at the head of a 512- and of a 4096-row launch, and at an offset inside
    the 4096-row one (one-pair tiles up to 512 rows, whole-k tiles at 4096;
    at d = 12288 the whole-k basis is staged in d chunks per item)."""
    x, v = _serve_operands(4096, d, 10, seed=19)
    x, v = x.to(cuda_device), v.to(cuda_device)
    full = {n: tsp.serve_project_f32_cuda(x[:n], v) for n in (512, 4096)}
    assert _rel(full[4096], tsp.serve_project_f32_plain(x, v)) <= 1e-5
    for rows in (1, 2, 3, 8, 64, 255, 300, 511, 512):
        alone = tsp.serve_project_f32_cuda(x[:rows].contiguous(), v)
        for n, z in full.items():
            assert torch.equal(alone, z[:rows]), (rows, n)
        inner = tsp.serve_project_f32_cuda(x[1001:1001 + rows].contiguous(), v)
        assert torch.equal(inner, full[4096][1001:1001 + rows]), rows


@pytest.mark.parametrize("rows", [301, 2048])
@pytest.mark.parametrize("k", [1, 9, 10, 19, 33])
@pytest.mark.parametrize("d", [1, 129, 1100, 3000, 3072, 12288])
def test_serve_split_kernels_match_plain_and_repeat(cuda_device, d, k, rows):
    """The three routes (fp32 basis for fp32 x only) against their plain
    versions at ragged d and k: 1e-5 relative, and a second launch gives
    the same bits.
    At 301 rows every tile is one column pair; at 2048 rows a tile holds up
    to 16 columns (k = 19 and 33 take two and three, odd k a half-empty
    last pair), and at d = 12288 the basis is staged in d chunks per
    item."""
    x = _x((rows, d), seed=17)
    v = _x((d, k), seed=18).to(cuda_device)  # d < k has no orthonormal basis
    for x_dtype in (torch.float32, torch.bfloat16):
        xd = x.to(device=cuda_device, dtype=x_dtype)
        for route, (run, plain) in _split_kernels(v, x_dtype).items():
            got = run(xd)
            torch.cuda.synchronize()
            assert got.shape == (rows, k) and got.dtype == torch.float32
            assert _rel(got, plain(xd)) <= 1e-5, (route, x_dtype)
            assert torch.equal(run(xd), got), (route, x_dtype)


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
    "d,f,k", [(256, 64, 16), (3000, 80, 13), (12288, 200, 58), (97, 5, 70), (1, 1, 1),
              (100000, 8, 8), (12288, 400, 58), (4000, 37, 200), (1, 1, 220),
              (12288, 800, 58), (12288, 800, 108), (2048, 96, 840), (300, 1000, 61)]
)
def test_matvec_gram_kernel_matches_plain(cuda_device, d, f, k):
    """Both plans (the slab resident, or streamed: (12288, 400, 58) and the
    shapes after it, any f and k' up to 840 and beyond),
    ragged f and k', slabs of many chunks: 1e-5 of the plain version, ``g``
    exactly symmetric, the same bits twice, one launch per call on the
    plan's kernel."""
    c = _x((d, f), seed=6).to(cuda_device)
    v = _x((d, k), seed=7).to(cuda_device)
    before = tmg.launches
    with tgeo.recording() as rec:
        w, g = tmg.matvec_gram_cuda(c, v)
    torch.cuda.synchronize()
    assert tmg.launches == before + 1
    assert rec == [tmg.matvec_gram_launch(d, f, k).resolved(rec[0].grid)]
    assert rec[0].kernel == ("matvec_gram_kernel<12>" if tmg.matvec_gram_plan(d, f, k)["resident"]
                             else "matvec_gram_kernel<4>")
    pw, pg = tmg.matvec_gram_plain(c, v)
    assert w.shape == (d, k) and g.shape == (k, k)
    assert _rel(w, pw) <= 1e-5 and _rel(g, pg) <= 1e-5
    assert torch.equal(g, g.mT)
    w2, g2 = tmg.matvec_gram_cuda(c, v)
    assert torch.equal(w, w2) and torch.equal(g, g2)


@pytest.mark.parametrize("d,f,k", [(12288, 200, 58), (3000, 80, 13), (12288, 400, 58),
                                   (12288, 800, 58), (2048, 96, 840)])
def test_matvec_gram_bits_do_not_depend_on_the_grid(cuda_device, d, f, k):
    """Every sum's order is fixed by (d, f, k'): launches of one and of three
    pairs of blocks (each block taking many slabs in rounds, the resident
    plan loading its slabs again in phase C) give the wrapper's launch bit
    for bit; a grid that is not whole pairs is refused."""
    c = _x((d, f), seed=18).to(cuda_device)
    v = _x((d, k), seed=19).to(cuda_device)
    w, g = tmg.matvec_gram_cuda(c, v)
    lib = tmg._lib()
    ws = torch.empty((lib.det_matvec_gram_workspace(d, f, k),), dtype=torch.uint8,
                     device=cuda_device)
    w2, g2 = torch.empty_like(w), torch.empty_like(g)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream

    def launch(blocks):
        return lib.det_matvec_gram(c.data_ptr(), v.data_ptr(), w2.data_ptr(), g2.data_ptr(),
                                   ws.data_ptr(), d, f, k, blocks, stream)

    for blocks in (tmg.PAIR, 3 * tmg.PAIR):
        assert launch(blocks) == 0
        torch.cuda.synchronize()
        assert torch.equal(w, w2) and torch.equal(g, g2), blocks
    assert launch(tmg.PAIR + 1) != 0


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
    tmg.matvec_gram_auto(_x((300, 800)).to(cuda_device), _x((300, 58)).to(cuda_device))
    assert tmg.launches == before + 2  # any f: sixteen workers' factors at k = 50


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


@pytest.mark.parametrize(
    "rows,d,k", [(256, 1024, 8), (100, 1000, 5), (300, 64, 17), (1, 1, 1)]
)
def test_mutant_full_block_matches_plain(cuda_device, rows, d, k):
    x = _x((rows, d), seed=10).to(cuda_device)
    v = _x((d, k), seed=11).to(cuda_device)
    before = tmfb.launches
    with tgeo.recording() as rec:
        got = tmfb.mutant_full_block_cuda(x, v)
    torch.cuda.synchronize()
    assert tmfb.launches == before + 1
    assert rec == [tmfb.mutant_full_block_launch(rows, d, k)]
    assert got.shape == (rows, k) and got.dtype == torch.float32
    assert _rel(got, tmfb.mutant_full_block_plain(x, v)) <= 1e-5
    with pytest.raises(ValueError, match="CUDA"):
        tmfb.mutant_full_block_cuda(x.cpu(), v.cpu())
    with pytest.raises(ValueError, match="shared memory"):
        tmfb.mutant_full_block_cuda(x[:, :1].contiguous().expand(rows, 8000).contiguous(),
                                    _x((8000, k), seed=12).to(cuda_device))
    assert tmfb.launches == before + 1


def test_profiled_launch_geometry_equals_the_records(cuda_device, tmp_path):
    """What keeps the launch declarations honest: every kernel event the
    profiler records has the grid, block and shared memory of the
    ``KernelLaunch`` its wrapper recorded, and each record is what the
    module's ``*_launch`` function declares for the shapes."""
    from torch.profiler import ProfilerActivity, profile

    x, v = _serve_operands(300, 1000, 10, seed=13)
    x, v = x.to(cuda_device), v.to(cuda_device)
    q, s = tsp.quantize_basis_i8(v)
    c = _x((2000, 48), seed=14).to(cuda_device)
    w0 = _x((2000, 9), seed=15).to(cuda_device)
    xg = _x((3, 200, 384), seed=16).to(device=cuda_device, dtype=torch.bfloat16)
    calls = [
        lambda: tsp.serve_project_cuda(x, v),
        lambda: tsp.serve_project_cuda(x.to(torch.bfloat16), v),
        lambda: tsp.serve_project_i8_cuda(x, q, s),
        lambda: tsp.serve_project_f32_cuda(x, v),
        lambda: tmg.matvec_gram_cuda(c, w0),
        lambda: tmfb.mutant_full_block_cuda(x[:256].contiguous(), v),
        lambda: tgram.gram_cuda(xg),
        lambda: tgram.gram_cuda(xg.float()),
        lambda: tgram.gram_cuda(xg[:, :, :129].contiguous()),
    ]
    for call in calls:  # builds and first launches outside the window
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tgeo.recording() as rec:
            for call in calls:
                call()
        torch.cuda.synchronize()
    events = tgeo.profiled_kernels(prof, tgeo.RECORDED_KERNELS, tmp_path / "trace.json")
    bad = tgeo.geometry_mismatches(events, rec)
    assert not bad, (bad, [(e["name"], e["args"]) for e in events])
    assert rec[:4] == [
        tsp.serve_project_launch(300, 1000, 10, torch.float32, "bf16").resolved(rec[0].grid),
        tsp.serve_project_launch(300, 1000, 10, torch.bfloat16, "bf16").resolved(rec[1].grid),
        tsp.serve_project_launch(300, 1000, 10, torch.float32, "i8").resolved(rec[2].grid),
        tsp.serve_project_launch(300, 1000, 10, torch.float32, "f32").resolved(rec[3].grid),
    ]
    # the persistent grid: at most one CTA per 4-row item, by column tiles
    tiles = tsp.split_plan(300, 1000, 10)["tiles"]
    assert all(1 <= r.grid[0] <= 75 and r.grid[1:] == (tiles, 1) for r in rec[:4])
    assert rec[6:] == [
        tgram.gram_launch(3, 200, 384).resolved(rec[6].grid),
        tgram.gram_launch(3, 200, 384, torch.float32),
        tgram.gram_launch(3, 200, 129),
    ]
    assert 1 <= rec[6].grid[0] <= 18  # at most one CTA per tile: 3 workers x 6
    assert rec[4] == tmg.matvec_gram_launch(2000, 48, 9).resolved(rec[4].grid)
    assert rec[5] == tmfb.mutant_full_block_launch(256, 1000, 10)
    mutant = [e for e in events if e["symbol"] == "mutant_full_block_kernel"]
    assert [e["grid"] for e in mutant] == [(1, 1, 1)]
