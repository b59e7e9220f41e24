"""The train step, the whole-fit trainers and the estimator on a workers
mesh, against the reference's on a JAX mesh of the same shape.

Gloo groups of 1, 2 and 4 ranks (``parallel.mesh.launch``, programs in
``tests/torch_mesh_ranks.py``) run the cold and warm train step, the scan
(given whole blocks and given each rank's workers), the gather scan, the
masked scan and the merge-interval and pipelined fits; the JAX package
runs each on ``make_mesh(num_workers=world)`` of its virtual CPU devices,
from the same cold start (the reference's ``jax.random.normal(PRNGKey(0),
(d, k))`` handed to the port as ``v0``). Then the estimator under
``backend="shard_map"`` at the mnist784 eval's settings, cut to a small
depth (``tests/test_evals.py:57``). Tolerances: steps and shapes exact;
every rank's state bit-equal to rank 0's; a one-rank mesh bit-equal to the
local trainer; ``sigma_tilde`` within 1e-4 absolute and every ``v_bar``
within 0.05 degrees of the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from distributed_eigenspaces_tpu.algo import online as jon
from distributed_eigenspaces_tpu.algo import scan as jscan
from distributed_eigenspaces_tpu.algo.step import make_train_step as jax_train_step
from distributed_eigenspaces_tpu.api.estimator import OnlineDistributedPCA as JaxPCA
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_eigenspaces_tpu_torch.api import estimator as port_est
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

SIGMA_ATOL = 1e-4
ANGLE_DEG = 0.05
TRUTH_DEG = 1.0
TIMEOUT = 180.0
D, K, M, N, T = 32, 3, 4, 64, 6
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
            solver="subspace", subspace_iters=12, warm_start_iters=2)
MASKS = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 0, 0],
                  [0, 0, 0, 0], [1, 1, 1, 0]], np.float32)


def _v0(d=D, k=K):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))


def _data(steps=T, seed=0):
    spec = jsyn.planted_spectrum(D, k_planted=K, seed=seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((steps, M, N, D)).astype(np.float32)
    return ((z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
            ).astype(np.float32)


def _angle(a, b):
    a = torch.as_tensor(np.array(a, dtype=np.float32))
    b = torch.as_tensor(np.array(b, dtype=np.float32))
    return float(principal_angles_degrees(a, b).max())


def _jax_run(kw, kind, xs, masks, world):
    """The reference's trainer of ``kind`` on a mesh of ``world`` devices."""
    jcfg = JaxConfig(**kw, backend="local")
    mesh = jax_make_mesh(num_workers=world, devices=jax.devices()[:world])
    st0 = jon.OnlineState.initial(D)
    if kind.startswith("step"):
        step = jax_train_step(jcfg, mesh=mesh, donate=False)
        st, vp, vbs = st0, None, []
        for x in xs:
            st, v = step(st, jnp.asarray(x)) if vp is None else step(st, jnp.asarray(x), vp)
            if kind == "step_warm":
                vp = v
            vbs.append(np.asarray(v))
        return np.asarray(st.sigma_tilde), int(st.step), np.stack(vbs)
    if kind == "masked":
        st, vbs = jscan.make_scan_fit(jcfg, mesh, masked=True)(
            st0, jnp.asarray(xs), jnp.asarray(masks))
    elif kind == "gather":
        blocks, idx = xs
        st, vbs = jscan.make_scan_fit(jcfg, mesh, gather=True)(
            st0, jnp.asarray(blocks), jnp.asarray(idx))
    else:
        st, vbs = jscan.make_scan_fit(jcfg, mesh)(st0, jnp.asarray(xs))
    return np.asarray(st.sigma_tilde), int(st.step), np.asarray(vbs)


def _assert_run(got, want):
    sigma, step, vbs = got
    jsigma, jstep, jvbs = want
    assert step == jstep and vbs.shape == jvbs.shape
    np.testing.assert_allclose(sigma, jsigma, atol=SIGMA_ATOL, rtol=0)
    for t in range(jvbs.shape[0]):
        if not np.any(jvbs[t]):  # an all-masked round merges to zeros
            assert not np.any(vbs[t])
        else:
            assert _angle(vbs[t], jvbs[t]) <= ANGLE_DEG, t


@pytest.mark.parametrize("world", [1, 2, 4])
def test_train_step_and_whole_fits_on_a_mesh(world, tmp_path):
    """The reference's ``test_scan.py:44, 119``, ``test_online.py:61`` and
    ``test_masked_dense_whole_fit.py:159`` on a mesh: every trainer kind,
    cold and warm, against the JAX one on a mesh of the same width."""
    xs = _data()
    blocks, idx = xs[:3], np.array([0, 1, 2, 1, 0, 2], np.int32)
    v0 = _v0()
    cases = [
        ("step_cold", dict(BASE, warm_start_iters=None), "step_cold", xs, None),
        ("step_warm", BASE, "step_warm", xs, None),
        ("scan", BASE, "scan", xs, None),
        ("scan_local", BASE, "scan_local", xs, None),
        ("gather", BASE, "gather", (blocks, idx), None),
        ("masked", dict(BASE, merge_interval=2), "masked", xs, MASKS),
        ("interval", dict(BASE, merge_interval=2), "scan", xs, None),
        ("pipelined", dict(BASE, pipeline_merge=True), "scan", xs, None),
    ]
    out = pmesh.launch(
        ranks.trainers, world,
        [(name, kw, kind, x, v0, masks) for name, kw, kind, x, masks in cases],
        workdir=str(tmp_path), timeout=TIMEOUT)
    for name, kw, kind, x, masks in cases:
        want = _jax_run(kw, "scan" if kind == "scan_local" else kind, x, masks, world)
        for r in range(world):
            got, ref = out[r][name]
            _assert_run(got, want)
            for a, b in zip(got, out[0][name][0]):  # the same bits on every rank
                np.testing.assert_array_equal(a, b)
            if world == 1:  # a one-rank gather is a copy
                for a, b in zip(got, ref):
                    np.testing.assert_array_equal(a, b)
    # one factor gather a round (the step kinds and every scan kind), none
    # besides: cold / warm steps, the scans, gather, masked, interval (one a
    # step, merge or fold), pipelined
    assert out[0]["gathers"] == len(cases) * T


# -- the estimator at the mnist784 eval's settings ------------------------------------

MNIST_SMALL = dict(dim=96, k=4, num_workers=8, rows_per_worker=64, num_steps=4,
                   subspace_iters=12, solver="subspace", warm_start_iters=2,
                   compute_dtype="bfloat16", stage_dtype="int8", warm_orth_method="ns")


def _mnist_data():
    d, k = MNIST_SMALL["dim"], MNIST_SMALL["k"]
    gap, noise = 20.0, 0.01
    decay = max(0.8, float((100.0 * noise / gap) ** (1.0 / max(k - 1, 1))))
    spec = jsyn.planted_subspace(d, k_planted=k, gap=gap, decay=decay, noise=noise, seed=0)
    rows = MNIST_SMALL["num_workers"] * MNIST_SMALL["rows_per_worker"] * MNIST_SMALL["num_steps"]
    return spec, np.asarray(spec.sample(jax.random.PRNGKey(1), rows))


def test_estimator_shard_map_in_one_process_is_the_local_fit():
    """Without a process group the scan mesh is None (one rank, as the
    reference with one device), so ``backend="shard_map"`` fits as
    ``"local"`` does, bit for bit."""
    spec, x = _mnist_data()
    v0 = _v0(MNIST_SMALL["dim"], MNIST_SMALL["k"])
    cfg = PCAConfig(**MNIST_SMALL, backend="shard_map")
    assert port_est._scan_mesh(cfg, "cpu") is None
    got = port_est.OnlineDistributedPCA(cfg, device="cpu", v0=v0).fit(x)
    want = port_est.OnlineDistributedPCA(PCAConfig(**MNIST_SMALL, backend="local"),
                                         device="cpu", v0=v0).fit(x)
    assert got.trainer_used_ == "scan"
    assert torch.equal(got.state.sigma_tilde, want.state.sigma_tilde)
    assert torch.equal(got.components_, want.components_)


@pytest.mark.parametrize("world", [2, 4])
def test_mnist784_settings_through_the_estimator_on_a_mesh(world, tmp_path):
    """mnist784's fields (``evals.py:96-102``: bf16, int8 stage, ns warm,
    shard_map) at d=96, k=4, n=64, T=4: the scan, the checkpointed
    segmented fit and the per-step loop on ``world`` ranks, against the JAX
    estimator on its own mesh and the local fit in each rank."""
    spec, x = _mnist_data()
    d, k = MNIST_SMALL["dim"], MNIST_SMALL["k"]
    v0 = _v0(d, k)
    ckdir = tmp_path / "ckpt"
    out = pmesh.launch(ranks.estimator_fits, world, MNIST_SMALL, x, v0, str(ckdir),
                       workdir=str(tmp_path), timeout=TIMEOUT)
    jcfg = JaxConfig(**MNIST_SMALL, backend="shard_map")
    want = np.asarray(JaxPCA(jcfg).fit(x).components_)
    want_step = np.asarray(JaxPCA(jcfg, trainer="step").fit(x).components_)
    truth = np.asarray(spec.top_k(k))
    for r, o in enumerate(out):
        assert o["mesh"] == {"workers": world, "features": 1}
        for route in ("scan", "segmented"):
            used, comps, sigma = o[route]
            assert used == route
            assert _angle(comps, want) <= ANGLE_DEG
            assert _angle(comps, truth) <= TRUTH_DEG
            np.testing.assert_allclose(sigma, o["local"][1], atol=SIGMA_ATOL, rtol=0)
            np.testing.assert_array_equal(sigma, out[0][route][2])
        used, comps, sigma, steps = o["step"]
        assert used == "step"
        assert _angle(comps, want_step) <= ANGLE_DEG
        np.testing.assert_array_equal(sigma, out[0]["step"][2])
        # on_step runs on rank 0 only
        assert steps == (list(range(1, MNIST_SMALL["num_steps"] + 1)) if r == 0 else [])
        assert o["partial"][0] == MNIST_SMALL["num_steps"] + 1
        np.testing.assert_array_equal(o["partial"][1], out[0]["partial"][1])
        # one factor gather a step
        assert o["scan_gathers"] == MNIST_SMALL["num_steps"]
    # rank 0 committed every window of 2 steps, the two newest kept
    assert sorted(p.name for p in ckdir.iterdir()) == ["step_00000002", "step_00000004"]
