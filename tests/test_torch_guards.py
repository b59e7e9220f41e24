"""The port's NaN guards against the reference's checkify mode.

``DET_CHECKIFY=1`` arms ``utils/guards.checked`` on every trainer the
reference arms ``checked_jit`` on: ``make_train_step``, ``make_scan_fit``
(its masked and gather entries too), ``make_segmented_fit``,
``make_tree_scan_fit``, the feature-sharded step, scan and sketch fits, and
``make_fleet_fit``. The reference's own cases (``tests/test_aux.py``'s
``TestNanGuards``, d=32, k=2, m=4, n=16, T=3, subspace at 6 iterations)
are held case by case, then a table of inputs where the reference raises
``checkify.JaxRuntimeError`` or does not, run through both packages on the
same numpy input: a NaN in a worker the mask drops, an inf in step 2 of
3, a finite overflow, a block the gather schedule never reaches, zero
blocks (the feature-sharded scan's makes a NaN inside from finite input)
and all-masked rows. Clean guarded runs equal the unguarded ones
(atol 1e-6, as the reference's test). With the guards off no check, sync
or collective runs. One gloo launch of two ranks holds the mesh trainers:
a poisoned shard on one rank raises ``CheckError`` on both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from distributed_eigenspaces_tpu.algo.online import OnlineState as JaxState
from distributed_eigenspaces_tpu.algo.scan import make_scan_fit as jax_scan_fit
from distributed_eigenspaces_tpu.algo.step import make_train_step as jax_train_step
from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.parallel import feature_sharded as jfs
from distributed_eigenspaces_tpu.parallel import fleet as jfleet
from distributed_eigenspaces_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_eigenspaces_tpu_torch.algo.online import OnlineState, online_distributed_pca
from distributed_eigenspaces_tpu_torch.algo.scan import (
    SegmentState,
    make_scan_fit,
    make_segmented_fit,
)
from distributed_eigenspaces_tpu_torch.algo.step import make_train_step
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.parallel import feature_sharded as fs
from distributed_eigenspaces_tpu_torch.parallel import fleet
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.utils import guards
from distributed_eigenspaces_tpu_torch.utils.guards import CheckError

import torch_guard_ranks as ranks

D, K, M, N, T = 32, 2, 4, 16, 3
CPU = "cpu"
KW = dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
          solver="subspace", subspace_iters=6)
ATOL = 1e-6
TIMEOUT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small CPU tensors: intra-op threads only contend with the other test
    # workers for the cores (a loaded run spent ten times its time alone)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("DET_CHECKIFY", "1")


def _xs(seed=0, t=T):
    return np.random.default_rng(seed).standard_normal((t, M, N, D)).astype(np.float32)


def _st():
    return OnlineState.initial(D, device=CPU)


def _port_raises(fn) -> bool:
    try:
        fn()
    except CheckError:
        return True
    return False


def _ref_raises(fn) -> bool:
    try:
        fn()
    except checkify.JaxRuntimeError:
        return True
    return False


# -- the reference's TestNanGuards, case by case ----------------------------------


def test_nan_block_raises_in_the_train_step(armed):
    """The reference's block of ones with one NaN (its raise on a NaN block
    is held in the table below, ``step_nan``)."""
    x = np.ones((M, N, D), np.float32)
    x[0, 0, 0] = np.nan
    step = make_train_step(PCAConfig(**KW), device=CPU)
    with pytest.raises(CheckError, match="non-finite"):
        step(_st(), torch.from_numpy(x))


def test_clean_step_equals_the_unguarded_step(monkeypatch):
    x = torch.from_numpy(_xs()[0])
    monkeypatch.delenv("DET_CHECKIFY", raising=False)
    st_p, v_p = make_train_step(PCAConfig(**KW), device=CPU)(_st(), x)
    monkeypatch.setenv("DET_CHECKIFY", "1")
    st_g, v_g = make_train_step(PCAConfig(**KW), device=CPU)(_st(), x)
    np.testing.assert_allclose(st_g.sigma_tilde.numpy(), st_p.sigma_tilde.numpy(), atol=ATOL)
    np.testing.assert_allclose(v_g.numpy(), v_p.numpy(), atol=ATOL)


def test_scan_fit_runs_clean_and_raises_on_an_inf(armed):
    fit = make_scan_fit(PCAConfig(**KW), device=CPU)
    xs = _xs()
    st, v_bars = fit(_st(), torch.from_numpy(xs))
    assert int(st.step) == T and v_bars.shape == (T, D, K)
    xs[1, 2, 3, 4] = np.inf
    with pytest.raises(CheckError):
        fit(_st(), torch.from_numpy(xs))


def test_segmented_fit_is_guarded(armed):
    fit = make_segmented_fit(PCAConfig(**KW), segment=2, device=CPU)
    xs = _xs()
    assert int(fit(SegmentState.initial(D, K, device=CPU), xs).step) == T
    xs[2, 1, 0, 0] = np.nan
    with pytest.raises(CheckError):
        fit(SegmentState.initial(D, K, device=CPU), xs)


# -- the same inputs through both packages -----------------------------------------


def _mask(row=None, worker=None):
    mk = np.ones((T, M), np.float32)
    if row is not None:
        mk[row, slice(None) if worker is None else worker] = 0.0
    return mk


def _case(name):
    """``(xs, masks, kind)`` of a case: ``kind`` is the trainer."""
    xs = _xs()
    if name == "step_nan":
        xs[0, 0, 0, 0] = np.nan
        return xs, None, "step"
    if name == "scan_inf_step2":
        xs[1, 2, 3, 4] = np.inf
        return xs, None, "scan"
    if name == "scan_overflow":  # finite input, non-finite Gram
        xs[2, 1, 0, 0] = 1e30
        return xs, None, "scan"
    if name == "scan_zero_block":
        xs[1, 2] = 0.0
        return xs, None, "scan"
    if name == "masked_nan_in_dropped_worker":
        xs[1, 2, 0, 0] = np.nan
        return xs, _mask(1, 2), "masked"
    if name == "masked_zero_dropped_worker":
        xs[1, 2] = 0.0
        return xs, _mask(1, 2), "masked"
    if name == "masked_all_masked_step":
        return xs, _mask(1), "masked"
    if name == "gather_unscheduled_nan":
        xs = np.concatenate([xs, xs[:1]])
        xs[3, 0, 0, 0] = np.nan
        return xs, None, "gather"
    if name == "fleet_nan_tenant":
        xs[1, 2, 0, 0] = np.nan
        return xs, None, "fleet"
    if name == "fleet_masked_nan_in_dropped_worker":
        xs[1, 2, 0, 0] = np.nan
        return xs, _mask(1, 2), "fleet"
    if name == "fleet_masked_all_masked_first_step":
        return xs, _mask(0), "fleet"
    if name == "fs_scan_zero_block":  # finite input, a NaN made inside
        xs[1, 2] = 0.0
        return xs, None, "fs_scan"
    raise KeyError(name)


CASES = {  # does the reference raise?
    "step_nan": True,
    "scan_inf_step2": True,
    "scan_overflow": True,
    "scan_zero_block": False,
    "masked_nan_in_dropped_worker": True,
    "masked_zero_dropped_worker": False,
    "masked_all_masked_step": False,
    "gather_unscheduled_nan": False,
    "fleet_nan_tenant": True,
    "fleet_masked_nan_in_dropped_worker": True,
    "fleet_masked_all_masked_first_step": False,
    "fs_scan_zero_block": True,
}


def _run_port(xs, masks, kind):
    cfg = PCAConfig(**KW)
    x = torch.from_numpy(xs)
    if kind == "step":
        return make_train_step(cfg, device=CPU)(_st(), x[0])
    if kind == "scan":
        return make_scan_fit(cfg, device=CPU)(_st(), x)
    if kind == "masked":
        return make_scan_fit(cfg, device=CPU, masked=True)(_st(), x, masks)
    if kind == "gather":
        return make_scan_fit(cfg, device=CPU, gather=True)(_st(), x, [0, 1, 2])
    if kind == "fs_scan":
        fit = fs.make_feature_sharded_scan_fit(PCAConfig(**dict(KW, backend="feature_sharded")),
                                               device=CPU)
        return fit(fit.init_state(), x)
    clean = _xs(1)
    return fleet.fit_fleet(cfg, [clean, xs], mesh=None, device=CPU,
                           worker_masks=None if masks is None else [None, masks])


#: the reference's guarded programs, built once a module under the armed
#: fixture (a JAX program compiles on its first call; the blocks and masks
#: are its arguments, so the cases of a trainer share it)
_REF: dict = {}


def _ref_program(kind):
    if kind not in _REF:
        cfg = JaxConfig(**KW)
        _REF[kind] = {
            "step": lambda: jax_train_step(cfg, donate=False),
            "scan": lambda: jax_scan_fit(cfg),
            "masked": lambda: jax_scan_fit(cfg, masked=True),
            "gather": lambda: jax_scan_fit(cfg, gather=True),
            "fs_scan": lambda: jfs.make_feature_sharded_scan_fit(
                JaxConfig(**dict(KW, backend="feature_sharded")),
                jax_make_mesh(num_workers=1, num_feature_shards=1,
                              devices=jax.devices()[:1]), seed=0),
            "fleet": dict,  # fit_fleet's program cache
        }[kind]()
    return _REF[kind]


def _run_ref(xs, masks, kind):
    x = jnp.asarray(xs)
    run = _ref_program(kind)
    if kind == "step":
        return run(JaxState.initial(D), x[0])
    if kind == "scan":
        return run(JaxState.initial(D), x)
    if kind == "masked":
        return run(JaxState.initial(D), x, masks)
    if kind == "gather":
        return run(JaxState.initial(D), x, jnp.asarray([0, 1, 2], jnp.int32))
    if kind == "fs_scan":
        return run(run.init_state(), x, jnp.arange(T, dtype=jnp.int32)).u
    return jfleet.fit_fleet(JaxConfig(**KW), [_xs(1), xs], mesh=None, fit_cache=run,
                            worker_masks=None if masks is None else [None, masks])


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_port_raises_where_checkify_raises(name, armed):
    """Each case raises in the port iff it raises in the reference, on the
    same numpy input (the reference's float checks see every primitive; the
    port sees each trainer's inputs and outputs)."""
    xs, masks, kind = _case(name)
    assert _ref_raises(lambda: _run_ref(xs, masks, kind)) == CASES[name]
    assert _port_raises(lambda: _run_port(xs, masks, kind)) == CASES[name]


# -- the port's other guarded trainers ---------------------------------------------


def _fs_fits():
    cfg = PCAConfig(**dict(KW, backend="feature_sharded"))
    step = fs.make_feature_sharded_step(cfg, device=CPU)

    def run_step(xs):
        st = step.init_state()
        for x in xs:
            st, _ = step(st, torch.from_numpy(x))
        return st.u

    scan = fs.make_feature_sharded_scan_fit(cfg, device=CPU)
    sketch = fs.make_feature_sharded_sketch_fit(cfg, device=CPU)
    return {
        "fs_step": run_step,
        "fs_scan": lambda xs: scan(scan.init_state(), torch.from_numpy(xs)).u,
        "fs_scan_windows": lambda xs: scan.fit_windows(
            scan.init_state(), [torch.from_numpy(xs[:2]), torch.from_numpy(xs[2:])]).u,
        "fs_sketch": lambda xs: sketch(sketch.init_state(), torch.from_numpy(xs)).y,
        "fs_sketch_masked": lambda xs: sketch(sketch.init_state(), torch.from_numpy(xs),
                                              worker_masks=_mask(1, 2)).y,
        "fleet_masked": lambda xs: torch.as_tensor(fleet.fit_fleet(
            PCAConfig(**KW), [xs], mesh=None, device=CPU, worker_masks=[_mask(1, 2)])
            .components),
    }


@pytest.mark.parametrize("name", ["fs_step", "fs_scan", "fs_scan_windows", "fs_sketch",
                                  "fs_sketch_masked", "fleet_masked"])
def test_other_trainers_are_guarded_and_clean_runs_are_unchanged(name, monkeypatch):
    xs = _xs(2)
    monkeypatch.delenv("DET_CHECKIFY", raising=False)
    plain = _fs_fits()[name](xs)
    monkeypatch.setenv("DET_CHECKIFY", "1")
    fits = _fs_fits()
    np.testing.assert_allclose(fits[name](xs).numpy(), plain.numpy(), atol=ATOL)
    bad = xs.copy()
    bad[2, 3, 1, 5] = np.inf
    with pytest.raises(CheckError):
        fits[name](bad)


def test_guards_off_add_no_check(monkeypatch):
    """With the guards off ``checked`` is the identity and no trainer runs
    a check, a sync or an agreement."""
    monkeypatch.delenv("DET_CHECKIFY", raising=False)

    def fail(*a, **k):
        pytest.fail("a guard ran with the guards off")

    monkeypatch.setattr(guards, "non_finite", fail)
    monkeypatch.setattr(guards, "_any_rank", fail)
    f = lambda x: x  # noqa: E731
    assert guards.checked(f) is f
    xs = _xs()
    cfg = PCAConfig(**KW)
    make_train_step(cfg, device=CPU)(_st(), torch.from_numpy(xs[0]))
    make_scan_fit(cfg, device=CPU)(_st(), torch.from_numpy(xs))
    make_scan_fit(cfg, device=CPU, masked=True)(_st(), torch.from_numpy(xs), _mask(1, 2))
    make_segmented_fit(cfg, segment=2, device=CPU)(SegmentState.initial(D, K, device=CPU), xs)
    fleet.fit_fleet(cfg, [xs], mesh=None, device=CPU)
    for name, run in _fs_fits().items():
        run(xs)


@pytest.mark.parametrize("backend", ["local", "feature_sharded"])
def test_the_per_step_loop_checks_each_step_once(backend, armed, monkeypatch):
    """The loop's step is guarded once: one input and one output check a
    step (the feature-sharded loop's, in its builder)."""
    calls = []
    real = guards.non_finite

    def counted(tree):
        calls.append(1)
        return real(tree)

    monkeypatch.setattr(guards, "non_finite", counted)
    cfg = PCAConfig(**dict(KW, backend=backend))
    online_distributed_pca(iter(torch.from_numpy(_xs())), cfg, device=CPU)
    assert len(calls) == 2 * T


# -- two gloo ranks ---------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    block = _xs(3)[0]
    tenants = [_xs(10 + b) for b in range(4)]
    v0 = np.linalg.qr(np.random.default_rng(5).standard_normal((D, K)))[0].astype(np.float32)
    out = pmesh.launch(ranks.guard_rank, 2, KW, block, tenants, v0, backend="gloo",
                       timeout=TIMEOUT, workdir=str(tmp_path_factory.mktemp("guards")))
    return block, tenants, v0, out


@pytest.mark.parametrize("what", ["step", "fleet", "fs", "tree"])
def test_a_poisoned_shard_on_one_rank_raises_on_both(two_ranks, what):
    _, _, _, out = two_ranks
    for o in out:
        assert o[f"{what}_poisoned"]["raised"] == "CheckError"
        assert o[f"{what}_poisoned"]["s"] < TIMEOUT / 4
        assert o[f"{what}_clean"]["raised"] is None
        assert np.isfinite(o[f"{what}_clean"]["out"]).all()
        np.testing.assert_array_equal(o[f"{what}_clean"]["out"], out[0][f"{what}_clean"]["out"])


def test_the_mesh_clean_runs_equal_one_process(two_ranks, monkeypatch):
    block, tenants, v0, out = two_ranks
    monkeypatch.setenv("DET_CHECKIFY", "1")
    cfg = PCAConfig(**KW)
    st, _ = make_train_step(cfg, device=CPU, v0=torch.from_numpy(v0))(_st(), torch.from_numpy(block))
    np.testing.assert_allclose(out[0]["step_clean"]["out"], st.sigma_tilde.numpy(),
                               rtol=1e-5, atol=ATOL)
    one = fleet.fit_fleet(PCAConfig(**dict(KW, backend="local")), tenants, mesh=None,
                          device=CPU, v0=v0)
    np.testing.assert_allclose(out[0]["fleet_clean"]["out"], one.components, rtol=1e-5,
                               atol=1e-5)


def test_a_step_that_raises_on_one_rank_fails_both_and_the_group_goes_on(two_ranks):
    _, _, _, out = two_ranks
    assert out[1]["raises_on_one"]["raised"] == "ValueError"
    assert out[0]["raises_on_one"]["raised"] == "CheckError"
    for o in out:
        assert o["after"]["raised"] is None
        np.testing.assert_array_equal(o["after"]["out"], o["step_clean"]["out"])
