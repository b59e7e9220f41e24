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
The s8 Gram (a transpose, then the TMA + wgmma kernel) equals its plain
version bit for bit (exact int32 sums, one rounding to fp32, a true
division by n), and the transpose equals its plain version, pad rows
included; past its guard an int8 batch is widened and its fp32 Gram is
held to the float64 truth at 1e-3. The segmented trainer on int8 windows
from the prefetch thread resumes from a checkpoint bit for bit, agrees
with the CPU path to 1e-4 / 0.05 degrees, and the checkpointed estimator
equals its scan fit bit for bit. A padded fleet of bf16 tenants makes one
Gram launch for the whole fit and agrees with the CPU fleet to 1e-4 /
0.05 degrees; ``FleetServer`` on the card serves a full and a deadline
bucket equal to ``fit_fleet`` called directly.
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


def _profiler_warm(device) -> None:
    """A few small kernels at the start of a ``torch.profiler`` window: the
    profiler can leave a window's first kernel events out (as
    ``chip_smoke.profiler_warm`` finds), so the launches under test come
    after these."""
    for _ in range(4):
        torch.ones(256, device=device).sum()
        torch.cuda.synchronize()


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
        _profiler_warm(cuda_device)
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


# -- the s8 Gram (int8 blocks) -------------------------------------------------


def _i8(shape, seed=0, offset=0):
    """int8 values in [-127, 127], as a view ``offset`` bytes into its
    buffer (offset 1 breaks the 16-byte alignment)."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(-127, 128, size=int(np.prod(shape)) + offset).astype(np.int8)
    return torch.from_numpy(flat)


# the s8 parity shapes: the CIFAR-10, synthetic1024 and mnist784 blocks (a
# 16-column last tile), n = 1000 (n_pad 1008) and d below one tile, each on
# an aligned base and one byte off it; then smaller corners
S8_SHAPES = [((8, 1024, 3072), 0), ((8, 2048, 1024), 0), ((8, 1024, 784), 0),
             ((3, 1000, 1000), 0), ((1, 1000, 9), 0), ((8, 1024, 3072), 1), ((8, 2048, 1024), 1),
             ((8, 1024, 784), 1), ((3, 1000, 1000), 1), ((1, 1000, 9), 1), ((1, 37, 9), 0),
             ((1, 5, 15), 0), ((2, 130, 48), 1), ((4, 64, 256), 0), ((2, 1, 1), 0),
             ((3, 200, 3001), 0)]


def _s8_view(shape, seed, offset, device):
    return _i8(shape, seed=seed, offset=offset).to(device)[offset:].view(shape)


@pytest.mark.parametrize("shape,offset", S8_SHAPES)
def test_gram_s8_bit_equal_to_plain(cuda_device, shape, offset):
    """The s8 pair (the transpose, then the TMA + wgmma kernel) against its
    plain version (float64 sums, one rounding, a true division): equal bit
    for bit, exactly symmetric, at aligned and unaligned bases, n = 2048
    (where fp32 sums would no longer be exact), n not a multiple of 16, m =
    1 with d below one tile, and d % 4 != 0 (the register epilogue); n not
    a power of two takes the division, the others the exact reciprocal."""
    x = _s8_view(shape, sum(shape), offset, cuda_device)
    before = (tgram.launches, tgram.launches_s8)
    with tgeo.recording() as rec:
        got = tgram.gram_s8_cuda(x)
    torch.cuda.synchronize()
    assert (tgram.launches, tgram.launches_s8) == (before[0], before[1] + 1)
    transpose, tma = tgram.gram_s8_launch(*shape, aligned=offset == 0)
    assert rec == [transpose, tma.resolved(rec[1].grid)]
    vec = 16 if offset == 0 and shape[2] % 16 == 0 else 1
    assert [r.kernel for r in rec] == [
        f"gram_s8_transpose_kernel<{vec}>",
        f"gram_s8_tma_kernel<{'true' if shape[2] % 4 == 0 else 'false'}>"]
    want = tgram.gram_s8_plain(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(got, got.mT)
    assert torch.equal(tgram.gram_s8_cuda(x, normalize=False),
                       tgram.gram_s8_plain(x, normalize=False))
    assert torch.equal(got.cpu(), tgram.gram_s8_plain(x.cpu()))


@pytest.mark.parametrize("shape,offset", S8_SHAPES)
def test_gram_s8_transpose_bit_equal_to_plain(cuda_device, shape, offset):
    """The transpose kernel alone against its plain version: x^T with its
    rows padded to n_pad, the pad written as zeros although the scratch
    comes from ``torch.empty`` (filled with 0x7f here first)."""
    x = _s8_view(shape, sum(shape) + 1, offset, cuda_device)
    torch.full((64 << 20,), 127, dtype=torch.int8, device=cuda_device)  # dirty the allocator
    with tgeo.recording() as rec:
        got = tgram.gram_s8_transpose_cuda(x)
    torch.cuda.synchronize()
    assert rec == [tgram.gram_s8_launch(*shape, aligned=offset == 0)[0]]
    want = tgram.gram_s8_transpose_plain(x)
    assert got.shape == (shape[0], shape[2], tgram.s8_pad(shape[1]))
    assert torch.equal(got, want)
    assert not got[..., shape[1]:].any()


def test_gram_s8_profiled_geometry_equals_the_record(cuda_device, tmp_path):
    """Both launches of a call, profiled: grid, block and shared memory equal
    to the record, the transpose first."""
    from torch.profiler import ProfilerActivity, profile

    shapes = ((8, 1024, 3072), (3, 1000, 1000), (8, 1024, 784))
    xs = [_i8(s, seed=3).to(cuda_device).view(s) for s in shapes]
    for x in xs:
        tgram.gram_s8_cuda(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _profiler_warm(cuda_device)
        with tgeo.recording() as rec:
            for x in xs:
                tgram.gram_s8_cuda(x)
        torch.cuda.synchronize()
    events = tgeo.profiled_kernels(prof, tgeo.RECORDED_KERNELS, tmp_path / "trace.json")
    bad = tgeo.geometry_mismatches(events, rec)
    assert not bad, (bad, [(e["name"], e["args"]) for e in events])
    want = []
    for i, shape in enumerate(shapes):
        transpose, tma = tgram.gram_s8_launch(*shape)
        want += [transpose, tma.resolved(rec[2 * i + 1].grid)]
    assert rec == want
    assert [e["symbol"].split("<")[0] for e in events] == [
        "gram_s8_transpose_kernel", "gram_s8_tma_kernel"] * 3
    assert [e["grid"] for e in events][::2] == [(8, 24, 8), (8, 8, 3), (8, 7, 8)]
    assert all(1 <= e["grid"][0] <= 132 and e["grid"][1:] == (1, 1) for e in events[1::2])


def test_gram_auto_int8_routes_by_the_guard(cuda_device):
    """An int8 CUDA batch reaches the s8 kernel within n * 127^2 < 2^31 and
    the fp32 kernel past it (widened, as the reference widens); never a
    bf16 kernel, never a plain version."""
    x = _i8((2, 300, 64), seed=5).to(cuda_device).view(2, 300, 64)
    before = (tgram.launches, tgram.launches_tma, tgram.launches_s8)
    got = tgram.gram_auto(x)
    torch.cuda.synchronize()
    assert (tgram.launches, tgram.launches_tma, tgram.launches_s8) == (
        before[0], before[1], before[2] + 1)
    assert torch.equal(got, tgram.gram_s8_plain(x))
    big = _i8((1, 133_200, 32), seed=6).to(cuda_device).view(1, 133_200, 32)
    assert not tgram.s8_exact(133_200)
    with tgeo.recording() as rec:
        wide = tgram.gram_auto(big)
    torch.cuda.synchronize()
    assert (tgram.launches, tgram.launches_tma, tgram.launches_s8) == (
        before[0] + 1, before[1], before[2] + 1)
    assert [r.kernel.split("<")[0] for r in rec] == ["gram_f32_kernel"]
    exact = tgram.gram_s8_plain(big)  # float64 sums: the truth
    # fp32 sums of 133,200 products in n order: sequential fp32 sums of
    # these data lose 1.3e-4 relative (numpy's float32 accumulate on the
    # host gives the same; the reference's XLA contraction on the CPU
    # loses as much), hence 1e-3
    assert _rel(wide, exact) <= 1e-3
    with pytest.raises(ValueError, match="2\\^31"):
        tgram.gram_s8_cuda(big)


def test_eval_settings_fit_makes_one_s8_launch(cuda_device):
    """A fit with the cifar10 eval's settings (int8 stage, ns warm rounds,
    bf16, subspace 12 cold / 2 warm) on the card: the cold step's Gram is
    one s8 launch, no bf16 Gram kernel runs, and the fit recovers the
    planted top-k within 1 degree (its default device is the card)."""
    d, k, m, n, steps = 512, 8, 4, 256, 5
    cfg = dett.PCAConfig(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=steps,
                         solver="subspace", subspace_iters=12, warm_start_iters=2,
                         compute_dtype="bfloat16", stage_dtype="int8", warm_orth_method="ns")
    spec = dett.planted_subspace(d, k_planted=k, gap=20.0, decay=0.8, noise=0.01, seed=0)
    data = spec.sample(torch.Generator(device=cuda_device).manual_seed(0), steps * m * n)
    tgram.launches = tgram.launches_tma = tgram.launches_s8 = 0
    est = dett.OnlineDistributedPCA(cfg).fit(data)
    torch.cuda.synchronize()
    assert est.device.type == "cuda" and est.trainer_used_ == "scan"
    assert (tgram.launches, tgram.launches_tma, tgram.launches_s8) == (0, 0, 1)
    angle = float(principal_angles_degrees(est.components_.cpu(),
                                           torch.from_numpy(spec.top_k(k))).max())
    assert angle <= 1.0


# k = 64 at 2 warm iterations keeps every step on the Gram route (2 k iters
# >= d), so each step is one s8 call, as clip768's
SEG_CFG = dict(dim=256, k=64, num_workers=4, rows_per_worker=512, num_steps=6,
               solver="subspace", subspace_iters=8, warm_start_iters=2,
               compute_dtype="bfloat16", backend="local")


def _int8_windows(seed, steps=6, window=2):
    x = np.random.default_rng(seed).integers(-127, 128, (steps, 4, 512, 256), dtype=np.int8)
    return [torch.from_numpy(x[t:t + window]) for t in range(0, steps, window)]


@pytest.mark.parametrize("kw", [dict(), dict(merge_interval=2)], ids=["s1", "s2"])
def test_segmented_resume_on_card_is_bit_equal(cuda_device, kw, tmp_path):
    """Int8 windows through the prefetch thread on the card: a run
    checkpointed after its first window, restored and continued equals the
    unkilled run bit for bit, one s8 call a step."""
    from distributed_eigenspaces_tpu_torch.runtime.prefetch import prefetch_stream
    from distributed_eigenspaces_tpu_torch.utils.checkpoint import Checkpointer

    cfg = dett.PCAConfig(**SEG_CFG, **kw)
    windows = _int8_windows(0)
    fit = dett.make_segmented_fit(cfg, segment=2)
    tgram.launches_s8 = 0
    whole = fit.fit_windows(dett.SegmentState.initial(256, 64),
                            prefetch_stream(iter(windows), depth=1))
    torch.cuda.synchronize()
    assert tgram.launches_s8 == 6 and whole.step == 6
    ck = Checkpointer(str(tmp_path), rows_per_step=4 * 512)
    fit.fit_windows(dett.SegmentState.initial(256, 64), prefetch_stream(iter(windows[:1])),
                    on_segment=ck.on_step)
    state, cursor = ck.latest()
    assert cursor == 2 * 4 * 512 and state.sigma_tilde.is_cuda
    resumed = dett.make_segmented_fit(cfg, segment=2).fit_windows(
        state, prefetch_stream(iter(windows[1:]), depth=1))
    assert torch.equal(resumed.sigma_tilde, whole.sigma_tilde)
    assert torch.equal(resumed.v_prev, whole.v_prev)


def test_segmented_fit_on_card_matches_cpu(cuda_device):
    """The same int8 windows on the card (s8 kernel) and on the CPU (plain
    version): sigma_tilde within 1e-4, v_prev within 0.05 degrees."""
    cfg = dett.PCAConfig(**SEG_CFG)
    windows = _int8_windows(1)
    out = {}
    for dev in ("cuda", "cpu"):
        fit = dett.make_segmented_fit(cfg, segment=2, device=dev)
        out[dev] = fit.fit_windows(dett.SegmentState.initial(256, 64, device=dev),
                                   iter(windows))
    a, b = out["cuda"], out["cpu"]
    assert float((a.sigma_tilde.cpu() - b.sigma_tilde).abs().max()) <= 1e-4
    assert float(principal_angles_degrees(a.v_prev.cpu(), b.v_prev).max()) <= 0.05


def test_prefetch_places_host_windows_on_the_card(cuda_device):
    """The default placement: pinned copies on a side stream, each window
    on the card and equal to its host bytes, in order."""
    from distributed_eigenspaces_tpu_torch.runtime.prefetch import PrefetchStats, prefetch_stream

    windows = _int8_windows(2)
    stats = PrefetchStats()
    placed = list(prefetch_stream(iter(windows), depth=2, stats=stats))
    assert stats.yields == 3
    for got, want in zip(placed, windows):
        assert got.is_cuda and got.dtype == torch.int8
        assert torch.equal(got.cpu(), want)


def test_checkpointed_estimator_on_card_equals_its_scan(cuda_device, tmp_path):
    """The estimator with checkpoint_dir takes the segmented trainer; its
    sigma_tilde equals the scan fit's on the same data bit for bit."""
    cfg = dett.PCAConfig(**{**SEG_CFG, "stage_dtype": "int8"})
    data = torch.randn((6 * 4 * 512, 256), generator=torch.Generator().manual_seed(3))
    seg = dett.OnlineDistributedPCA(cfg, checkpoint_dir=str(tmp_path), segment=2).fit(data)
    scan = dett.OnlineDistributedPCA(cfg).fit(data)
    assert (seg.trainer_used_, scan.trainer_used_) == ("segmented", "scan")
    assert torch.equal(seg.state.sigma_tilde, scan.state.sigma_tilde)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004", "step_00000006"]


@pytest.mark.parametrize("shape", [(8, 160, 160), (2, 33, 33), (5, 256, 256), (1, 80, 80)])
def test_syev_batched_matches_torch_eigh(cuda_device, shape):
    """cuSOLVER's batched eigensolver (the port's on the card from 33 to
    256 wide) against float64 truth: eigenvalues ascending and within 1e-4
    of the largest, the residual ``||A v - v w||_F`` within 1e-4 of
    ``||A||_F`` and ``V^T V`` within 1e-4 of the identity: fp32 rounding at
    these n (a backward-stable fp32 solver's error grows as n eps ||A||).
    ``ops.cusolver.eigh`` takes it for a batch and for one matrix alike."""
    from distributed_eigenspaces_tpu_torch.ops import cusolver

    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda_device)
    a = x @ x.mT / shape[-1]
    calls = []
    syev = cusolver.syev_batched

    def counted(m):
        calls.append(tuple(m.shape))
        return syev(m)

    cusolver.syev_batched = counted
    try:
        w, v = cusolver.eigh(a)
        w1, v1 = cusolver.eigh(a[0])
    finally:
        cusolver.syev_batched = syev
    assert calls == [shape, (1,) + shape[1:]]
    assert float((w1 - w[0]).abs().max()) <= 1e-4 * float(w[0].abs().max())
    truth = torch.linalg.eigvalsh(a.cpu().double())
    scale = truth.abs().amax(dim=-1, keepdim=True)
    assert float(((w.cpu().double() - truth).abs() / scale).max()) <= 1e-4
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    ad, vd, wd = a.cpu().double(), v.cpu().double(), w.cpu().double()
    resid = torch.linalg.matrix_norm(ad @ vd - vd * wd[:, None, :]) / torch.linalg.matrix_norm(ad)
    assert float(resid.max()) <= 1e-4
    assert float((vd.mT @ vd - torch.eye(shape[-1], dtype=torch.float64)).abs().max()) <= 1e-4
    # another dtype, or a width outside the window, is torch's own
    w64, _ = cusolver.eigh(a.double())
    assert w64.dtype == torch.float64
    big = torch.eye(300, device=cuda_device)
    assert torch.equal(cusolver.eigh(big)[0], torch.linalg.eigh(big)[0])


@pytest.mark.parametrize("n", [40, 300])
def test_factorizations_fail_per_matrix_on_the_card(cuda_device, n):
    """A matrix of a batch that is not finite comes out NaN in its own batch
    element and the others as a batch without it gives them: the batched
    cuSOLVER call (n = 40) with no host sync, and torch's ``eigh`` (n = 300).
    A Gram that is not positive definite fails its CholeskyQR element alone,
    with no host sync either (the fleet's per-tenant failure)."""
    from distributed_eigenspaces_tpu_torch.ops import cusolver
    from distributed_eigenspaces_tpu_torch.ops.linalg import chol_qr

    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((3, n, n), generator=g, device=cuda_device)
    a = x @ x.mT / n
    bad = a.clone()
    bad[1, 3, 5] = float("nan")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error" if n == 40 else "default")
    try:
        w, v = cusolver.eigh(bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isnan(w[1]).all()) and bool(torch.isnan(v[1]).all())
    w2, v2 = cusolver.eigh(a[[0, 2]])
    torch.testing.assert_close(w[[0, 2]], w2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close((v[[0, 2]].mT @ v2).abs().diagonal(dim1=-2, dim2=-1)[..., -4:],
                               torch.ones((2, 4), device=cuda_device), rtol=0, atol=1e-3)
    q_in = torch.randn((3, 64, 4), generator=g, device=cuda_device)
    q_in[2] = 0.0
    torch.cuda.set_sync_debug_mode("error")
    try:
        q = chol_qr(q_in)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isnan(q[2]).all()) and bool(torch.isfinite(q[:2]).all())
    torch.testing.assert_close(q[:2], chol_qr(q_in[:2]), rtol=1e-6, atol=1e-6)


FLEET_CFG = dict(dim=256, k=4, num_workers=4, rows_per_worker=256, num_steps=4,
                 solver="subspace", subspace_iters=12, warm_start_iters=2,
                 compute_dtype="bfloat16", warm_orth_method="ns", backend="local")


def _fleet_problems(n_tenants, steps=4):
    rng = np.random.default_rng(5)
    spec = dett.planted_subspace(256, k_planted=4, gap=20.0, decay=0.8, noise=0.01, seed=1)
    return spec, [spec.sample(rng, steps * 4 * 256).reshape(steps, 4, 256, 256)
                  for _ in range(n_tenants)]


def test_fleet_on_card_makes_one_gram_launch_and_matches_cpu(cuda_device):
    """Three tenants (one ragged) padded to four on the card: one bf16 TMA
    Gram launch for the whole fit, and each tenant within 1e-4 / 0.05
    degrees of the same fleet on the CPU and 1 degree of the truth."""
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    cfg = dett.PCAConfig(**FLEET_CFG)
    spec, probs = _fleet_problems(3)
    probs[1] = probs[1][:3]
    tgram.launches = tgram.launches_tma = tgram.launches_s8 = 0
    card = fleet.fit_fleet(cfg, probs, mesh=None, pad_to=4)
    torch.cuda.synchronize()
    assert (tgram.launches, tgram.launches_tma, tgram.launches_s8) == (1, 1, 0)
    assert card.states.sigma_tilde.is_cuda and card.states.step.tolist() == [4, 3, 4]
    cpu = fleet.fit_fleet(cfg, probs, mesh=None, pad_to=4, device="cpu")
    for b in range(3):
        assert float((card.states.sigma_tilde[b].cpu() - cpu.states.sigma_tilde[b])
                     .abs().max()) <= 1e-4
        w = torch.from_numpy(card.components[b])
        assert float(principal_angles_degrees(w, torch.from_numpy(cpu.components[b])).max()) <= 0.05
        assert float(principal_angles_degrees(w, torch.from_numpy(spec.top_k(4))).max()) <= 1.0


def test_fleet_on_card_at_a_wide_merge_matches_cpu(cuda_device):
    """The merge at the width the evals give it: m k = 8 x 12 = 96 > 32,
    so every step's (B, 96, 96) merge is one cuSOLVER batched call on the
    card, and a solo fit's (96, 96) one too. Three tenants on the card
    within 1e-4 / 0.05 degrees of the same fleet on the CPU (LAPACK), of
    the solo scan on the card, and within 1 degree of the truth."""
    from distributed_eigenspaces_tpu_torch.ops import cusolver
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    cfg = dett.PCAConfig(**{**FLEET_CFG, "k": 12, "num_workers": 8})
    rng = np.random.default_rng(6)
    spec = dett.planted_subspace(256, k_planted=12, gap=20.0, decay=0.8, noise=0.01, seed=2)
    probs = [spec.sample(rng, 4 * 8 * 256).reshape(4, 8, 256, 256) for _ in range(3)]
    calls = []
    syev = cusolver.syev_batched

    def counted(m):
        calls.append(tuple(m.shape))
        return syev(m)

    cusolver.syev_batched = counted
    try:
        card = fleet.fit_fleet(cfg, probs, mesh=None)
        solo, _ = dett.make_scan_fit(cfg, device=cuda_device)(
            dett.OnlineState.initial(256, device=cuda_device),
            torch.from_numpy(probs[1]).to(cuda_device))
    finally:
        cusolver.syev_batched = syev
    assert (3, 96, 96) in calls and (1, 96, 96) in calls
    cpu = fleet.fit_fleet(cfg, probs, mesh=None, device="cpu")
    for b in range(3):
        assert float((card.states.sigma_tilde[b].cpu() - cpu.states.sigma_tilde[b])
                     .abs().max()) <= 1e-4
        w = torch.from_numpy(card.components[b])
        assert float(principal_angles_degrees(w, torch.from_numpy(cpu.components[b])).max()) <= 0.05
        assert float(principal_angles_degrees(w, torch.from_numpy(spec.top_k(12))).max()) <= 1.0
    assert float((card.states.sigma_tilde[1] - solo.sigma_tilde).abs().max()) <= 1e-4


def test_fleet_server_on_card_serves_full_and_deadline_buckets(cuda_device):
    """Three submits into buckets of two: a full bucket at once, the third
    on the deadline, each served result equal to ``fit_fleet`` called
    directly on the card, one Gram launch a bucket."""
    from dataclasses import replace

    from distributed_eigenspaces_tpu_torch.parallel import fleet

    cfg = replace(dett.PCAConfig(**FLEET_CFG), fleet_bucket_size=2, fleet_flush_s=0.05)
    _, probs = _fleet_problems(3)
    tgram.launches = 0
    with fleet.FleetServer(cfg) as srv:
        srv.prewarm()
        assert srv.wait_warm(timeout=300)
        served = [t.result(timeout=300) for t in [srv.submit(p) for p in probs]]
        log = [r for r in srv.metrics.fleet_records if r["fleet"] == "bucket"]
    assert [b["tenants"] for b in log] == [2, 1] and log[0]["compile_stall_ms"] == 0.0
    assert tgram.launches == 2
    direct = list(fleet.fit_fleet(cfg, probs[:2], mesh=None).components)
    direct += list(fleet.fit_fleet(cfg, probs[2:], mesh=None, pad_to=2).components)
    for got, want in zip(served, direct):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["ill", "fine"])
def test_ns_orth_guard_on_card_matches_cpu(cuda_device, case, monkeypatch):
    """Under DET_CHECKIFY=1 ``ns_orth``'s residual check fires on the card
    exactly where it fires on the CPU, and the card's result agrees with
    the CPU's to 1e-5 where it passes."""
    from distributed_eigenspaces_tpu_torch.ops.linalg import ns_orth
    from distributed_eigenspaces_tpu_torch.utils import guards

    v = _x((256, 8), seed=3)
    if case == "ill":
        v[:, 1] = v[:, 0] * 1.0001
    monkeypatch.setenv("DET_CHECKIFY", "1")
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        try:
            outs.append(ns_orth(v.to(dev)).cpu())
        except guards.CheckError:
            outs.append(None)
    assert (outs[0] is None) == (outs[1] is None) == (case == "ill")
    if case == "fine":
        assert _rel(outs[1], outs[0]) <= 1e-5


def test_supervised_step_on_card_matches_cpu(cuda_device, tmp_path):
    """One supervised per-step fit with a NaN block, a flaky read and a
    kill on the card: the same ledger as on the CPU, the card's Gram kernel
    launched, and sigma_tilde within 1e-4 / bases within 0.05 degrees."""
    from distributed_eigenspaces_tpu_torch.data.stream import block_stream
    from distributed_eigenspaces_tpu_torch.runtime.supervisor import (
        Supervisor,
        supervised_fit,
    )
    from distributed_eigenspaces_tpu_torch.utils import faults

    m, n, d, k, T = 4, 128, 256, 4, 6
    cfg = dett.PCAConfig(dim=d, k=k, num_workers=m, rows_per_worker=n, num_steps=T,
                         solver="subspace", subspace_iters=8, backend="local")
    data = _x((T * m * n, d), seed=9).numpy() * np.linspace(3, 0.2, d, dtype=np.float32)
    v0 = _x((d, k), seed=10)
    runs = {}
    for dev in ("cpu", "cuda"):
        fired = [False]

        def factory(start, dev=dev, fired=fired):
            plan = faults.ChaosPlan(nan_blocks={2: [1]}, raise_at={3: "flaky"},
                                    kill_at=None if fired[0] else 4)
            return faults.ChaosStream(
                block_stream(data, num_workers=m, rows_per_worker=n, start_row=start,
                             device=dev), plan, first_step=start // (m * n) + 1)

        sup = Supervisor(cfg, sleep=lambda s: None)
        tgram.launches = 0
        while True:
            try:
                w, st, _ = supervised_fit(factory, cfg, checkpoint_dir=str(tmp_path / dev),
                                          supervisor=sup, device=dev, v0=v0)
                break
            except faults.KillSwitch:
                fired[0] = True
        runs[dev] = (w.cpu(), st.sigma_tilde.cpu(), sup.ledger.by_kind, tgram.launches)
    assert runs["cuda"][2] == runs["cpu"][2] == {
        "quarantine_nonfinite": 1, "stream_retry": 1, "resume": 1}
    assert runs["cuda"][3] >= 2  # a cold round in each of the two processes
    assert float((runs["cuda"][1] - runs["cpu"][1]).abs().max()) <= 1e-4
    assert float(principal_angles_degrees(runs["cuda"][0], runs["cpu"][0]).max()) <= 0.05
