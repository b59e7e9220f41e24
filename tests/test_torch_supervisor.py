"""Parity of the supervised fit (``runtime/supervisor.py``) with the JAX
package's, and its contracts within the port: kill and resume bit for bit,
a quarantined block equal to an explicit worker drop, the fault budget,
capped backoff, prefetch, the guards, elastic quorum loss, the dynamic
round, and the fleet's and the drift monitor's supervised paths.

The reference's cold start ``jax.random.normal(PRNGKey(0), (d, k))`` goes to
the port as ``v0``; every wait runs on an injected clock or sleep."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.data.stream import block_stream as jblock_stream
from distributed_eigenspaces_tpu.runtime import scheduler as jsched
from distributed_eigenspaces_tpu.runtime.supervisor import supervised_fit as jsupervised_fit
from distributed_eigenspaces_tpu.utils import faults as jf
from distributed_eigenspaces_tpu_torch.algo.online import online_distributed_pca
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.data.stream import block_stream
from distributed_eigenspaces_tpu_torch.ops.linalg import principal_angles_degrees
from distributed_eigenspaces_tpu_torch.runtime import scheduler as tsched
from distributed_eigenspaces_tpu_torch.runtime import supervisor as tsup
from distributed_eigenspaces_tpu_torch.runtime.membership import ElasticStream, MembershipTable
from distributed_eigenspaces_tpu_torch.runtime.prefetch import PrefetchStats
from distributed_eigenspaces_tpu_torch.utils import faults as tf
from distributed_eigenspaces_tpu_torch.utils import guards
from distributed_eigenspaces_tpu_torch.utils.metrics import MetricsLogger

D, K, M, N, T = 32, 3, 4, 16, 6
CPU = "cpu"
CHAOS = dict(nan_blocks={3: [2]}, zero_blocks={5: [1]}, raise_at={4: "chaos: flaky read"},
             kill_at=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the fits here are tiny: intra-op threads only contend with the other
    # test workers for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _v0():
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (D, K), jnp.float32))


def _data(seed=0, steps=T):
    rng = np.random.default_rng(seed)
    scale = np.concatenate([[6.0, 4.5, 3.0], np.full(D - 3, 0.3)]).astype(np.float32)
    basis = np.linalg.qr(rng.standard_normal((D, D)))[0].astype(np.float32)
    return (rng.standard_normal((steps * M * N, D)).astype(np.float32) * scale) @ basis.T


def _kw(**kw):
    # no prefetch thread unless a test asks for one: its hand-offs cost most
    # of a tiny fit's time on a loaded machine
    return {**dict(dim=D, k=K, num_workers=M, rows_per_worker=N, num_steps=T,
                   backend="local", prefetch_depth=0), **kw}


def _angle(a, b):
    return float(principal_angles_degrees(torch.as_tensor(np.asarray(a)),
                                          torch.as_tensor(np.asarray(b))).max())


def _chaos_run(fit, chaos_mod, stream_fn, cfg, plan_kw, tmp, **kw):
    """The restart loop of the reference's chaos harness: a KillSwitch is
    the process dying; the next call resumes from the checkpoint, with the
    kill fired once."""
    fired = [False]

    def factory(start_row):
        plan = dict(plan_kw)
        if fired[0]:
            plan["kill_at"] = None
        return chaos_mod.ChaosStream(stream_fn(start_row), chaos_mod.ChaosPlan(**plan),
                                     first_step=start_row // (M * N) + 1)

    restarts = 0
    while True:
        try:
            return fit(factory, cfg, checkpoint_dir=str(tmp), **kw), restarts
        except chaos_mod.KillSwitch:
            restarts += 1
            fired[0] = True


def _port_stream(data):
    return lambda start: block_stream(data, num_workers=M, rows_per_worker=N,
                                      start_row=start, device=CPU)


def _jax_stream(data):
    return lambda start: jblock_stream(data, num_workers=M, rows_per_worker=N,
                                       start_row=start, device=False)


def _sleepless(**kw):
    return dict(sleep=lambda s: None, **kw)


@pytest.mark.parametrize("solver,deg", [("eigh", 0.01), ("subspace", 0.05)])
@pytest.mark.parametrize("trainer", ["step", "segmented"])
def test_chaotic_supervised_fit_matches_the_reference(trainer, solver, deg, tmp_path):
    data = _data()
    # the per-step trainer with the prefetch producer, as a supervised run's default
    kw = _kw(solver=solver, subspace_iters=8, prefetch_depth=2 if trainer == "step" else 0)
    every = 2 if trainer == "segmented" else 1
    from distributed_eigenspaces_tpu.runtime.supervisor import Supervisor as JaxSupervisor

    # one supervisor across the restart loop: its ledger holds both runs
    cfg, jcfg = PCAConfig(**kw), JaxConfig(**kw)
    (w, st, sup), restarts = _chaos_run(
        tsup.supervised_fit, tf, _port_stream(data), cfg, CHAOS,
        tmp_path / "port", trainer=trainer, checkpoint_every=every, device=CPU, v0=_v0(),
        supervisor=tsup.Supervisor(cfg, sleep=lambda s: None))
    (jw, jst, jsup), jrestarts = _chaos_run(
        jsupervised_fit, jf, _jax_stream(data), jcfg, CHAOS, tmp_path / "ref",
        trainer=trainer, checkpoint_every=every,
        supervisor=JaxSupervisor(jcfg, sleep=lambda s: None))
    assert restarts == jrestarts == 1
    assert sup.ledger.by_kind == jsup.ledger.by_kind
    assert set(sup.ledger.by_kind) == {"quarantine_nonfinite", "stream_retry", "resume"}
    assert st.step == int(jst.step) == T
    assert bool(torch.isfinite(st.sigma_tilde).all())
    assert _angle(w, jw) <= deg


def _clean_run(trainer, data, tmp, cfg, plan=None):
    plan = plan or {}
    (w, st, _), restarts = _chaos_run(
        tsup.supervised_fit, tf, _port_stream(data), cfg, plan, tmp,
        trainer=trainer, checkpoint_every=2 if trainer == "segmented" else 1,
        device=CPU, v0=_v0(), **_sleepless())
    return w, st, restarts


@pytest.mark.parametrize("trainer,solver", [("segmented", "subspace"), ("step", "eigh")])
def test_kill_and_resume_is_bit_equal(trainer, solver, tmp_path):
    data = _data(1)
    cfg = PCAConfig(**_kw(solver=solver, subspace_iters=8))
    w, st, restarts = _clean_run(trainer, data, tmp_path / "killed", cfg, {"kill_at": 5})
    w0, st0, r0 = _clean_run(trainer, data, tmp_path / "clean", cfg)
    assert (restarts, r0) == (1, 0)
    assert torch.equal(st.sigma_tilde, st0.sigma_tilde) and torch.equal(w, w0)


def test_quarantined_block_equals_an_explicit_worker_drop():
    data = _data(2)
    cfg = PCAConfig(**_kw(solver="subspace", subspace_iters=8))
    plan = tf.ChaosPlan(nan_blocks={3: [1]})
    w, st, sup = tsup.supervised_fit(
        lambda s: tf.ChaosStream(_port_stream(data)(s), plan), cfg, device=CPU, v0=_v0())
    blocks = np.array(data).reshape(T, M, N, D)
    blocks[2, 1] = tsup.Supervisor._placeholder(N, D, np.float32)
    masks = np.ones((T, M), np.float32)
    masks[2] = tf.kill_workers(M, [1])
    w2, st2 = online_distributed_pca(iter(torch.from_numpy(blocks)), cfg, device=CPU,
                                     worker_masks=iter(masks), v0=_v0())
    assert sup.ledger.by_kind == {"quarantine_nonfinite": 1}
    assert torch.equal(st.sigma_tilde, st2.sigma_tilde) and torch.equal(w, w2)


def test_tensor_and_array_blocks_screen_alike():
    sup = tsup.Supervisor(PCAConfig(**_kw()))
    x = np.random.default_rng(3).standard_normal((M, N, D)).astype(np.float32)
    x[2, 4, 5] = np.inf
    a, ma = sup.screen_block(x, 1)
    b, mb = sup.screen_block(torch.from_numpy(x.copy()), 1)
    np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(ma, mb)
    short_a, msa = sup.screen_block(x[:3], 2)
    short_b, msb = sup.screen_block(torch.from_numpy(x[:3].copy()), 2)
    np.testing.assert_array_equal(short_a, short_b.numpy())
    np.testing.assert_array_equal(msa, msb)
    assert sup.screen_block(x[:, :3], 3) is None
    assert sup.ledger.by_kind == {"quarantine_nonfinite": 4, "quarantine_short": 2,
                                  "dropped_round": 1}


def test_fault_budget_exhaustion_is_loud():
    data = _data(4)
    plan = tf.ChaosPlan(nan_blocks={2: [0], 3: [1, 2]})
    with pytest.raises(tsup.SupervisorError, match="fault budget exhausted") as err:
        tsup.supervised_fit(lambda s: tf.ChaosStream(_port_stream(data)(s), plan),
                            PCAConfig(**_kw()), fault_budget=2, device=CPU)
    assert err.value.ledger.budget_spent == 3


class _Flaky:
    """A stream whose every pull fails."""

    def __iter__(self):
        return self

    def __next__(self):
        raise OSError("disk gone")


def test_backoff_is_capped_and_escalates():
    naps = []
    with pytest.raises(tsup.SupervisorError, match="no checkpoint_dir") as err:
        tsup.supervised_fit(lambda s: _Flaky(), PCAConfig(**_kw()), max_retries=4,
                            backoff_base=0.1, backoff_max=0.25, sleep=naps.append,
                            device=CPU)
    assert naps == [0.1, 0.2, 0.25, 0.25]
    assert err.value.ledger.by_kind == {"stream_retry": 5}


def test_step_retry_replays_its_mask(monkeypatch):
    data = _data(5)
    cfg = PCAConfig(**_kw(prefetch_depth=0))
    plan = tf.ChaosPlan(nan_blocks={2: [3]})
    base = tsup.supervised_fit(lambda s: tf.ChaosStream(_port_stream(data)(s), plan), cfg,
                               device=CPU)
    from distributed_eigenspaces_tpu_torch.parallel import worker_pool

    real, calls = worker_pool.WorkerPool.round, [0]

    def flaky_round(self, *a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise OSError("device hiccup")
        return real(self, *a, **kw)

    monkeypatch.setattr(worker_pool.WorkerPool, "round", flaky_round)
    got = tsup.supervised_fit(lambda s: tf.ChaosStream(_port_stream(data)(s), plan), cfg,
                              device=CPU, **_sleepless())
    assert got[2].ledger.by_kind == {"quarantine_nonfinite": 1, "step_retry": 1}
    assert torch.equal(got[1].sigma_tilde, base[1].sigma_tilde)


def test_prefetch_feeds_the_same_blocks():
    data = _data(6)
    runs = []
    for depth in (0, 2):
        cfg = PCAConfig(**_kw(prefetch_depth=depth))
        stats = PrefetchStats()
        w, st = online_distributed_pca(_port_stream(data)(0), cfg, device=CPU, v0=_v0(),
                                       ingest_stats=stats)
        runs.append((w, st, stats.yields))
    assert torch.equal(runs[0][1].sigma_tilde, runs[1][1].sigma_tilde)
    assert (runs[0][2], runs[1][2]) == (0, T)
    m = MetricsLogger()
    tsup.supervised_fit(_port_stream(data), PCAConfig(**_kw(prefetch_depth=2)), metrics=m,
                        device=CPU)
    assert m.summary()["ingest"]["yields"] == T


@pytest.mark.parametrize("depth", [0, 2])
def test_a_shared_stream_loses_the_blocks_read_past_the_cap(depth):
    """A capped loop takes one block past its cap before it stops (as the
    reference's loop does), and the prefetch producer may take up to
    ``depth + 1`` more: those blocks are dropped, so an iterator shared
    across capped calls does not resume where the fit stopped. The fit
    itself folds the first ``cap`` blocks only."""
    blocks = list(_port_stream(_data(7))(0))
    pulled = [0]

    def counted():
        for b in blocks:
            pulled[0] += 1
            yield b

    cap = 2
    cfg = PCAConfig(**_kw(prefetch_depth=depth))
    _, st = online_distributed_pca(counted(), cfg, device=CPU, v0=_v0(), max_steps=cap)
    _, want = online_distributed_pca(iter(blocks[:cap]), cfg, device=CPU, v0=_v0(),
                                     max_steps=cap)
    assert int(st.step) == cap and torch.equal(st.sigma_tilde, want.sigma_tilde)
    lost = pulled[0] - cap
    if depth == 0:
        assert lost == 1
    else:
        assert 1 <= lost <= depth + 2


def _ill_conditioned():
    v = np.random.default_rng(7).standard_normal((D, K)).astype(np.float32)
    v[:, 1] = v[:, 0] * 1.0001
    return v


@pytest.mark.parametrize("case", ["ill", "fine"])
def test_ns_orth_guard_fires_where_the_reference_does(case, monkeypatch):
    from jax.experimental import checkify

    from distributed_eigenspaces_tpu.ops.linalg import ns_orth as jns_orth
    from distributed_eigenspaces_tpu.utils.guards import checked_jit
    from distributed_eigenspaces_tpu_torch.ops.linalg import ns_orth

    v = _ill_conditioned() if case == "ill" else np.linalg.qr(
        np.random.default_rng(8).standard_normal((D, K)))[0].astype(np.float32) * 1.3
    monkeypatch.setenv("DET_CHECKIFY", "1")
    try:
        checked_jit(jns_orth)(jnp.asarray(v))
        ref_raised = False
    except checkify.JaxRuntimeError:
        ref_raised = True
    try:
        guards.checked(ns_orth)(torch.from_numpy(v))
        raised = False
    except guards.CheckError:
        raised = True
    assert raised == ref_raised == (case == "ill")
    # off: no check runs, and the result is the same
    monkeypatch.setenv("DET_CHECKIFY", "0")
    monkeypatch.setattr("distributed_eigenspaces_tpu_torch.ops.linalg.check",
                        lambda *a: pytest.fail("a check ran with the guards off"))
    assert guards.checked(ns_orth) is ns_orth
    ns_orth(torch.from_numpy(v))


def test_checked_step_refuses_a_non_finite_result(monkeypatch):
    monkeypatch.setenv("DET_CHECKIFY", "1")
    x = np.ones((1, M, N, D), np.float32)
    x[0, 0, 0, 0] = np.nan
    with pytest.raises(guards.CheckError, match="non-finite"):
        online_distributed_pca(iter(torch.from_numpy(x)), PCAConfig(**_kw(num_steps=1)),
                               device=CPU)


def test_elastic_quorum_loss_resumes_from_the_checkpoint(tmp_path):
    cfg = PCAConfig(**_kw(num_workers=10, num_steps=8, heartbeat_timeout_ms=100.0,
                          round_deadline_ms=40.0, min_quorum_frac=0.5))
    m = 10
    data = np.random.default_rng(9).standard_normal((10 * m * N, D)).astype(np.float32)
    now = [0.0]
    killed = [0, 1, 2, 3, 4, 5]

    def sleep(s):
        now[0] += s
        # the operator brings capacity back once quorum is lost, while the
        # surviving workers go on heartbeating
        if not table.quorum_ok():
            for slot in range(len(killed), m):
                table.heartbeat(slot)
            table.sweep()
            for slot in killed[:4]:
                if table.state(slot) == "dead":
                    table.join(slot)

    logger = MetricsLogger()
    table = MembershipTable(m, heartbeat_timeout_ms=100.0, min_quorum_frac=0.5,
                            clock=lambda: now[0], sleep=sleep, metrics=logger)
    churn = tf.ChurnPlan(kill_at={4: killed})

    def factory(start_row):
        raw = block_stream(data, num_workers=m, rows_per_worker=N, start_row=start_row,
                           device=CPU)
        return ElasticStream(raw, table, cfg, churn=churn,
                             first_step=start_row // (m * N) + 1, metrics=logger,
                             clock=lambda: now[0], sleep=sleep, device=CPU)

    w, st, sup = tsup.supervised_fit(factory, cfg, metrics=logger, membership=table,
                                     checkpoint_dir=str(tmp_path), quorum_wait_s=1.0,
                                     device=CPU)
    kinds = sup.ledger.by_kind
    assert kinds["quorum_lost"] == 1 and kinds["quorum_restored"] == 1
    assert st.step == 8 and bool(torch.isfinite(w).all())
    ms = logger.summary()["membership"]
    assert ms["by_kind"]["dead"] >= 6 and ms["by_kind"]["admit"] >= 4
    # with no checkpoint the same loss is terminal and loud
    with pytest.raises(tsup.SupervisorError, match="no checkpoint_dir"):
        table2 = MembershipTable(m, min_quorum_frac=0.9, clock=lambda: 5.0)
        table2._state[:3] = ["dead"] * 3
        tsup.supervised_fit(lambda s: ElasticStream(
            block_stream(data, num_workers=m, rows_per_worker=N, device=CPU), table2, cfg,
            device=CPU, sleep=lambda s: None), cfg, device=CPU)


def test_supervised_fit_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="'step' or 'segmented'"):
        tsup.supervised_fit(lambda s: iter(()), PCAConfig(**_kw()), trainer="scan")
    with pytest.raises(ValueError, match="pipeline_merge"):
        tsup.supervised_fit(lambda s: iter(()), PCAConfig(**_kw(
            solver="subspace", pipeline_merge=True)))


def _faulty_tasks():
    fired = set()

    def hook(task):
        if task in (3, 11) and task not in fired:
            fired.add(task)
            raise OSError(f"chaos: lane crash at task {task}")

    return hook, fired


@pytest.mark.parametrize("remainder", ["drop", "pad"])
def test_dynamic_round_matches_the_reference(remainder):
    x = _data(10, steps=32)[:2000 + (7 if remainder == "pad" else 5)]
    hook, fired = _faulty_tasks()
    s, v = tsched.run_dynamic_round(x, num_batches=16, k=K, remainder=remainder,
                                    fault_hook=hook, device=CPU)
    jhook, jfired = _faulty_tasks()
    js, jv = jsched.run_dynamic_round(x, num_batches=16, k=K, remainder=remainder,
                                      fault_hook=jhook)
    assert fired == jfired == {3, 11}
    js = np.asarray(js)
    rel = np.linalg.norm(s.numpy() - js) / np.linalg.norm(js)
    assert rel <= 1e-5
    assert _angle(v, jv) <= 0.01
    with pytest.raises(ValueError, match="remainder"):
        tsched.run_dynamic_round(x[:2001], num_batches=16, k=K, remainder="error", device=CPU)


def test_fleet_screen_quarantines_one_tenant_alone():
    from distributed_eigenspaces_tpu_torch.parallel import fleet

    cfg = PCAConfig(**_kw(num_steps=3))
    problems = [_data(20 + b, steps=3) for b in range(3)]
    chaotic = [p.reshape(3, M, N, D) for p in problems]
    plan = tf.ChaosPlan(nan_blocks={2: [0]})
    sup = tsup.Supervisor(cfg)
    got = fleet.fit_fleet(cfg, [chaotic[0], tf.ChaosStream(iter(chaotic[1]), plan),
                                chaotic[2]], mesh=None, supervisor=sup, device=CPU)
    ones = [np.ones((3, M), np.float32)] * 3
    clean = fleet.fit_fleet(cfg, chaotic, mesh=None, worker_masks=ones, device=CPU)
    assert [e["tenant"] for e in sup.ledger.events] == [1]
    assert sup.ledger.events[0]["workers"] == [0]
    for b in (0, 2):
        assert np.array_equal(got.components[b], clean.components[b])
    assert np.isfinite(got.components[1]).all()
    # a tenant whose stream dies is quarantined whole, the fleet goes on
    dead = tf.ChaosStream(iter(chaotic[1]), tf.ChaosPlan(kill_at=3))
    sup2 = tsup.Supervisor(cfg)
    batch = fleet.stage_fleet(cfg, [chaotic[0], dead], supervisor=sup2)
    assert batch.actives[1].tolist() == [1.0, 1.0, 0.0]
    assert sup2.ledger.by_kind == {"tenant_killed": 1}


def test_drift_refit_runs_supervised():
    from distributed_eigenspaces_tpu_torch.serving import DriftMonitor, EigenbasisRegistry

    cfg = PCAConfig(**_kw(num_steps=2))
    reg = EigenbasisRegistry()
    reg.publish(np.linalg.qr(np.random.default_rng(11).standard_normal((D, K)))[0]
                .astype(np.float32))
    logger = MetricsLogger()
    mon = DriftMonitor(reg, cfg, auto=False, metrics=logger, device=CPU)
    rows = _data(12, steps=2)
    rows[5, 3] = np.nan  # a corrupt served row: quarantined, not fatal
    mon.observe(50.0, 100.0, rows=rows)
    published = mon.refresh_now()
    assert published is not None and published.lineage["supervised"] is True
    s = logger.summary()
    assert s["faults"]["by_kind"] == {"quarantine_nonfinite": 1}
    assert s["serving"]["drift_published"] == [published.version]
