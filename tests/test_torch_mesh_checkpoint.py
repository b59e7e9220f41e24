"""The segmented trainer's checkpoints on a workers mesh: rank 0 writes,
every rank restores, and a killed mesh run resumes bit for bit
(the reference's ``tests/test_whole_fit_checkpoint.py:69, 104`` on the
dense trainer).

A gloo group of 2 or 4 ranks (``parallel.mesh.launch``; programs in
``tests/torch_mesh_ranks.py``) fits with a ``Checkpointer`` on
``on_segment`` and dies when rank 0 raises in its hook after step 4; a
fresh group restores the newest checkpoint on every rank and finishes.
Tolerances: the resumed state bit-equal to the unkilled run's, the
segmented fit bit-equal to the scan of the same steps (masked and not),
every rank's state bit-equal to rank 0's, and the unkilled fit within
1e-4 (``sigma_tilde``) and 0.05 degrees (``v_prev``) of the reference's
segmented fit on a JAX mesh of the same width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from distributed_eigenspaces_tpu.algo import scan as jscan
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data import synthetic as jsyn
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh

D, K, M, N, T, S = 32, 3, 4, 64, 6, 2
BASE = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
            solver="subspace", subspace_iters=12, warm_start_iters=2, merge_interval=2)
MASKS = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 0, 0],
                  [1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
TIMEOUT = 120.0


def _data():
    spec = jsyn.planted_spectrum(D, k_planted=K, seed=0)
    z = np.random.default_rng(1).standard_normal((T, M, N, D)).astype(np.float32)
    return ((z * np.sqrt(np.asarray(spec.eigenvalues))) @ np.asarray(spec.basis).T
            ).astype(np.float32)


@pytest.mark.parametrize("world", [2, 4])
def test_killed_mesh_run_resumes_bit_for_bit(world, tmp_path):
    xs = _data()
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (D, K), jnp.float32))
    ckdir = tmp_path / "ckpt"
    with pytest.raises(ranks.Killed, match="after step 4"):
        pmesh.launch(ranks.segmented_killed, world, BASE, xs, v0, S, str(ckdir), 4,
                     workdir=str(tmp_path), timeout=TIMEOUT)
    # rank 0 alone wrote, every window, the two newest kept
    assert sorted(p.name for p in ckdir.iterdir()) == ["step_00000002", "step_00000004"]
    out = pmesh.launch(ranks.segmented_resumed, world, BASE, xs, v0, S, str(ckdir),
                       MASKS, workdir=str(tmp_path), timeout=TIMEOUT)
    for r, o in enumerate(out):
        assert o["done"] == 4 and o["restored"]["step"] == 4
        # the hooks of the finishing windows ran on rank 0 only
        assert o["seen"] == ([6] if r == 0 else [])
        for f in ("sigma", "step", "v_prev"):
            np.testing.assert_array_equal(o["resumed"][f], o["unkilled"][f])
            for run in ("restored", "unkilled", "masked"):
                np.testing.assert_array_equal(o[run][f], out[0][run][f])
        np.testing.assert_array_equal(o["unkilled"]["sigma"], o["scan"])
        np.testing.assert_array_equal(o["masked"]["sigma"], o["masked_scan"])
    jmesh = jax_make_mesh(num_workers=world, devices=jax.devices()[:world])
    jfit = jscan.make_segmented_fit(JaxConfig(**BASE, backend="local"), jmesh, segment=S)
    want = jfit(jscan.SegmentState.initial(D, K), jnp.asarray(xs))
    got = out[0]["unkilled"]
    assert got["step"] == int(want.step) == T
    np.testing.assert_allclose(got["sigma"], np.asarray(want.sigma_tilde), atol=1e-4, rtol=0)
    angle = principal_angles_degrees(torch.from_numpy(got["v_prev"]),
                                     torch.from_numpy(np.array(want.v_prev)))
    assert float(angle.max()) <= 0.05
