"""The port's checkpoints against the reference's, on the same format.

A checkpoint written by either package restores in the other (``state.npz``
with an int32 ``step``, ``meta.json`` with the payload's sha256); a
segmented fit resumed from a reference checkpoint in the port matches the
reference's own resumed fit (``sigma_tilde`` within 1e-4, ``v_prev`` within
0.05 degrees); a torn or bad-checksum payload is quarantined and the resume
ladder steps back; rotation keeps the newest two; the reference's
feature-sharded kinds (``lowrank``, ``sketch``) cross both ways bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.algo import online as jon
from distributed_eigenspaces_tpu.algo import scan as jscan
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel.feature_sharded import LowRankState, SketchState
from distributed_eigenspaces_tpu.utils import checkpoint as jckpt
from distributed_eigenspaces_tpu_torch.algo import online as ton
from distributed_eigenspaces_tpu_torch.algo import scan as tscan
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.utils import checkpoint as tckpt

SIGMA_ATOL = 1e-4
ANGLE_DEG = 0.05
D, K, M, N, T = 32, 3, 4, 64, 6
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
            solver="subspace", subspace_iters=12, warm_start_iters=2)


def _v0():
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (D, K), jnp.float32))


def _data(seed=0):
    spec = jsyn.planted_spectrum(D, k_planted=K, seed=seed)
    z = np.random.default_rng(seed + 1).standard_normal((T, M, N, D)).astype(np.float32)
    x = (z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
    return x.astype(np.float32)


def _angle(a, b):
    return float(principal_angles_degrees(torch.as_tensor(np.array(a, np.float32)),
                                          torch.as_tensor(np.array(b, np.float32))).max())


def _segment_state(seed=3):
    rng = np.random.default_rng(seed)
    return tscan.SegmentState(
        sigma_tilde=torch.from_numpy(rng.standard_normal((D, D)).astype(np.float32)),
        step=4, v_prev=torch.from_numpy(rng.standard_normal((D, K)).astype(np.float32)))


@pytest.mark.parametrize("kind", ["online", "scan_segment"])
def test_port_checkpoint_restores_in_the_reference(kind, tmp_path):
    st = _segment_state()
    if kind == "online":
        st = ton.OnlineState(st.sigma_tilde, st.step)
    tckpt.save_checkpoint(str(tmp_path), st, cursor=1024, extra={"run": "a"})
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["state_type"] == kind and meta["step"] == 4 and meta["extra"] == {"run": "a"}
    jst, cursor = jckpt.restore_checkpoint(str(tmp_path))
    assert cursor == 1024 and type(jst).__name__ == type(st).__name__
    assert np.asarray(jst.step).dtype == np.int32 and int(jst.step) == 4
    for name in st._fields:
        if name != "step":
            np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                          getattr(st, name).numpy())


@pytest.mark.parametrize("kind", ["online", "scan_segment"])
def test_reference_checkpoint_restores_in_the_port(kind, tmp_path):
    st = _segment_state(5)
    jst = jscan.SegmentState(jnp.asarray(st.sigma_tilde.numpy()), jnp.int32(4),
                             jnp.asarray(st.v_prev.numpy()))
    if kind == "online":
        jst = jon.OnlineState(jst.sigma_tilde, jst.step)
    jckpt.save_checkpoint(str(tmp_path), jst, cursor=77)
    got, cursor = tckpt.restore_checkpoint(str(tmp_path), device="cpu")
    assert cursor == 77 and got.step == 4 and isinstance(got.step, int)
    assert type(got) is (ton.OnlineState if kind == "online" else tscan.SegmentState)
    assert torch.equal(got.sigma_tilde, st.sigma_tilde)
    if kind == "scan_segment":
        assert torch.equal(got.v_prev, st.v_prev)


def test_resume_from_a_reference_checkpoint_matches_the_reference_resume(tmp_path):
    """The reference runs 2 steps and checkpoints through its Checkpointer;
    both packages resume from that directory and run the other 4 steps."""
    x = _data()
    kw = {**BASE}
    jcfg = JaxConfig(**kw, backend="local")
    jfit = jscan.make_segmented_fit(jcfg, segment=2)
    jc = jckpt.Checkpointer(str(tmp_path), rows_per_step=M * N)
    jfit(jscan.SegmentState.initial(D, K), jnp.asarray(x[:2]), on_segment=jc.on_step)
    jstate, jcursor = jc.latest()
    jfinal = jfit(jstate, jnp.asarray(x[2:]))
    state, cursor = tckpt.Checkpointer(str(tmp_path), device="cpu").latest()
    assert cursor == jcursor == 2 * M * N and state.step == 2
    fit = tscan.make_segmented_fit(PCAConfig(**kw), segment=2, device="cpu", v0=_v0())
    final = fit(state, torch.from_numpy(x[cursor // (M * N):]))
    assert final.step == int(jfinal.step) == T
    np.testing.assert_allclose(final.sigma_tilde.numpy(), np.asarray(jfinal.sigma_tilde),
                               atol=SIGMA_ATOL, rtol=0)
    assert _angle(final.v_prev, jfinal.v_prev) <= ANGLE_DEG


def _commit(directory, steps, device="cpu", keep=2):
    ck = tckpt.Checkpointer(str(directory), keep=keep, rows_per_step=10, device=device)
    base = _segment_state()
    for t in steps:
        ck.on_step(t, base._replace(step=t))
    return ck


@pytest.mark.parametrize("damage", ["truncate", "flip_byte", "missing_payload"])
def test_damaged_payload_is_quarantined_and_the_ladder_steps_back(damage, tmp_path):
    ck = _commit(tmp_path, [1, 2])
    newest = tmp_path / "step_00000002" / "state.npz"
    raw = newest.read_bytes()
    if damage == "truncate":
        newest.write_bytes(raw[: len(raw) // 2])
    elif damage == "flip_byte":
        newest.write_bytes(raw[:-9] + bytes([raw[-9] ^ 0xFF]) + raw[-8:])
    else:
        newest.unlink()
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.restore_checkpoint(str(tmp_path / "step_00000002"), device="cpu")
    state, cursor = ck.latest()
    assert state.step == 1 and cursor == 10
    assert (tmp_path / "step_00000002.quarantined").is_dir()
    assert ck._steps() == [1]


def test_an_unverified_marker_restores_and_all_bad_gives_none(tmp_path):
    ck = _commit(tmp_path, [3])
    meta_path = tmp_path / "step_00000003" / "meta.json"
    meta = json.loads(meta_path.read_text())
    del meta["checksum"]
    meta_path.write_text(json.dumps(meta))
    assert ck.latest()[0].step == 3
    (tmp_path / "step_00000003" / "state.npz").write_bytes(b"not a zip")
    assert ck.latest() is None
    assert tckpt.Checkpointer(str(tmp_path / "absent"), device="cpu").latest() is None


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_rotation_keeps_the_newest(keep, tmp_path):
    ck = _commit(tmp_path, [1, 2, 3, 4, 5], keep=keep)
    assert ck._steps() == [1, 2, 3, 4, 5][-keep:]
    assert ck.latest()[0].step == 5


def test_every_and_uncommitted_steps(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path), every=2, keep=5, device="cpu")
    for t in range(1, 6):
        ck.on_step(t, _segment_state()._replace(step=t))
    assert ck._steps() == [2, 4]
    (tmp_path / "step_00000004" / "meta.json").unlink()  # a crash before the commit
    assert ck._steps() == [2] and ck.latest()[0].step == 2
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "step_00000004"), device="cpu")


@pytest.mark.parametrize("kind", ["lowrank", "sketch"])
def test_feature_sharded_kinds_are_refused_by_name(kind, tmp_path):
    """Once refused by name, the reference's feature-sharded kinds now
    restore in the port, and the port's in the reference, bit for bit
    (more cases: tests/test_torch_sketch.py)."""
    from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as tfs

    rng = np.random.default_rng(7)
    a = rng.standard_normal((D, 5)).astype(np.float32)
    b = rng.standard_normal((D, K) if kind == "sketch" else (5,)).astype(np.float32)
    if kind == "lowrank":
        jst = LowRankState(jnp.asarray(a), jnp.asarray(b), jnp.int32(3))
    else:
        jst = SketchState(jnp.asarray(a), jnp.asarray(b), jnp.int32(3))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jst, cursor=12)
    got, cursor = tckpt.restore_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert type(got) is (tfs.LowRankState if kind == "lowrank" else tfs.SketchState)
    assert got.step == 3 and cursor == 12
    np.testing.assert_array_equal(got[0].numpy(), a)
    np.testing.assert_array_equal(got[1].numpy(), b)
    tckpt.save_checkpoint(str(tmp_path / "port"), got, cursor=12)
    back, jcursor = jckpt.restore_checkpoint(str(tmp_path / "port"))
    assert type(back) is type(jst) and int(back.step) == 3 and jcursor == 12
    np.testing.assert_array_equal(np.asarray(back[0]), a)
    np.testing.assert_array_equal(np.asarray(back[1]), b)


def test_save_refuses_other_states(tmp_path):
    with pytest.raises(ValueError, match="unsupported checkpoint state"):
        tckpt.save_checkpoint(str(tmp_path), (torch.zeros(2), 1))
    bf16 = ton.OnlineState(torch.zeros((D, D), dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="float32"):
        tckpt.save_checkpoint(str(tmp_path), bf16)
    assert not os.path.exists(tmp_path / "meta.json")
