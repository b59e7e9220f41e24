"""The multi-host data plane (``parallel/multihost.py`` and
``bin_block_stream(worker_range=)``) against the reference's.

``host_worker_range`` and its refusal of a ragged split, ``initialize`` as
a no-op in one process without the environment, ``HostRect.block_slice``;
the strided read against the reference's on the same file; then on two
gloo ranks (one ``parallel.mesh.launch``, programs in
``tests/torch_tree_ranks.py``) each rank reading only its own workers from
one shared file, bit-equal to slicing a whole read, and
``make_multihost_train_step`` fed each rank's workers only against the
one-device step on the whole block.

Tolerances: ranges, shapes and reads exact; the two-rank step bit-equal
to the one-device step (each rank solves its workers as the one device
does, and the gathered stack is the same).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tree_ranks as ranks

from distributed_eigenspaces_tpu.data import bin_stream as jbs
from distributed_eigenspaces_tpu.parallel import multihost as jmh
from distributed_eigenspaces_tpu_torch.algo.online import OnlineState
from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data import bin_stream as tbs
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import multihost as tmh

TIMEOUT = 180.0
D, M, N, T = 16, 4, 8, 3
STEP = dict(dim=D, k=2, num_workers=M, rows_per_worker=N, num_steps=T,
            solver="subspace", subspace_iters=8, backend="shard_map")


def _file(tmp_path, rows, name="rows.bin"):
    path = str(tmp_path / name)
    rows.astype(np.float32).tofile(path)
    return path


def _rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


@pytest.mark.parametrize("m,pc", [(8, 1), (8, 2), (8, 4), (6, 3), (4, 4)])
def test_host_worker_range_matches_the_reference(m, pc):
    for pi in range(pc):
        got = tmh.host_worker_range(m, process_index=pi, process_count=pc)
        want = jmh.host_worker_range(m, process_index=pi, process_count=pc)
        assert (got.lo, got.hi, got.num_workers, got.count) == (
            want.lo, want.hi, want.num_workers, want.count)
        assert got.row_range(N) == want.row_range(N)
    # in one process with no group: this process owns every worker
    assert tmh.host_worker_range(m) == tmh.HostShard(0, m, m)


def test_ragged_split_is_refused_like_the_reference():
    for mod in (tmh, jmh):
        with pytest.raises(ValueError, match="not divisible"):
            mod.host_worker_range(6, process_index=0, process_count=4)


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    tmh.initialize()
    assert not torch.distributed.is_initialized()
    assert pmesh.world_size() == 1


def test_host_rect_block_slice_matches_the_reference():
    for args in ((0, 1, 1, 2, 2, 2), (1, 2, 0, 1, 2, 1)):
        got = tmh.HostRect(*args).block_slice(8, 32)
        assert got == jmh.HostRect(*args).block_slice(8, 32)
    with pytest.raises(ValueError, match="not divisible"):
        tmh.HostRect(0, 1, 0, 1, 3, 1).block_slice(8, 32)


@pytest.mark.parametrize("lo,hi,start_steps", [(0, 2, 0), (2, 4, 0), (1, 3, 1), (3, 4, 2)])
def test_strided_read_matches_the_reference(tmp_path, lo, hi, start_steps):
    # 3 whole steps and a ragged tail: every range stops after the same steps
    path = _file(tmp_path, _rows(T * M * N + 5))
    kw = dict(dim=D, num_workers=M, rows_per_worker=N, worker_range=(lo, hi),
              start_row=start_steps * M * N)
    got = [b.numpy() for b in tbs.bin_block_stream(path, **kw)]
    want = [np.asarray(b) for b in jbs.bin_block_stream(path, out_dtype=jnp.float32, **kw)]
    assert len(got) == len(want) == T - start_steps
    for g, w in zip(got, want):
        assert g.shape == (hi - lo, N, D)
        np.testing.assert_array_equal(g, w)
    whole = [b.numpy() for b in tbs.bin_block_stream(
        path, dim=D, num_workers=M, rows_per_worker=N, start_row=start_steps * M * N)]
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w[lo:hi])


def test_two_ranks_read_their_own_rows_and_step_like_one_device(tmp_path):
    rows = _rows(T * M * N + 3, seed=1)
    path = _file(tmp_path, rows)
    read_kw = dict(dim=D, num_workers=M, rows_per_worker=N)
    xs = rows[: T * M * N].reshape(T, M, N, D)
    v0 = np.linalg.qr(np.random.default_rng(2).standard_normal((D, 2)))[0].astype(np.float32)
    out = pmesh.launch(ranks.multihost, 2, path, read_kw, STEP, xs, v0,
                       workdir=str(tmp_path), timeout=TIMEOUT)
    whole = [b.numpy() for b in tbs.bin_block_stream(path, **read_kw)]
    assert len(whole) == T
    for r, got in enumerate(out):
        lo, hi = got["shard"]
        assert (lo, hi) == (2 * r, 2 * r + 2)
        assert len(got["blocks"]) == T
        for b, w in zip(got["blocks"], whole):
            np.testing.assert_array_equal(b, w[lo:hi])
        assert (got["rect"].w_lo, got["rect"].w_hi, got["rect"].mesh_workers) == (r, r + 1, 2)
    step = make_train_step(PCAConfig(**dict(STEP, backend="local")), device="cpu",
                           v0=torch.from_numpy(v0))
    st, vp = OnlineState.initial(D, device="cpu"), None
    for x in xs:
        st, vp = step(st, torch.from_numpy(x), vp)
    for got in out:
        np.testing.assert_array_equal(got["sigma"], st.sigma_tilde.numpy())
        np.testing.assert_array_equal(got["v"], vp.numpy())


@pytest.mark.parametrize("trainer", ["scan", "sketch"])
def test_multihost_feature_fit_is_the_feature_sharded_fit_on_one_process(trainer):
    """One process is the ``(1, 1)`` layout: this rank's rectangle is the
    whole stack, and the multi-host drive is the feature-sharded trainer
    bit for bit, windowed entry included; a block of another shape is
    refused."""
    from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as tfs

    cfg = PCAConfig(**dict(STEP, backend="feature_sharded"))
    xs = torch.from_numpy(_rows(T * M * N, seed=3).reshape(T, M, N, D))
    mesh = pmesh.local_mesh("cpu")
    fit = tmh.make_multihost_feature_fit(cfg, mesh, trainer=trainer, device="cpu")
    make = (tfs.make_feature_sharded_sketch_fit if trainer == "sketch"
            else tfs.make_feature_sharded_scan_fit)
    ref = make(cfg, device="cpu")
    want = ref.extract(ref(ref.init_state(), xs))
    assert torch.equal(fit.extract(fit(fit.init_state(), xs)), want)
    windowed = fit.fit_windows(fit.init_state(), (xs[t:t + 2] for t in range(0, T, 2)))
    assert torch.equal(fit.extract(windowed), want)
    with pytest.raises(ValueError, match="share"):
        fit(fit.init_state(), xs[:, :, :, : D // 2])
    assert tmh.host_block_rect(mesh) == tmh.HostRect(0, 1, 0, 1, 1, 1)
