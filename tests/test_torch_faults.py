"""Parity of ``utils/faults.py`` with the JAX package's: the same plans give
the same blocks, masks, delays and errors, and a tensor stream is corrupted
where an array stream is."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.utils import faults as jf
from distributed_eigenspaces_tpu_torch.utils import faults as tf

M, N, D, T = 6, 16, 48, 8

PLANS = {
    "nan_zero": dict(nan_blocks={2: [1], 5: [0, 3]}, zero_blocks={4: [2]}),
    "raise_then_deliver": dict(raise_at={3: "chaos: flaky read"}, nan_blocks={3: [5]}),
    "kill": dict(kill_at=6, zero_blocks={1: [0]}),
    "resumed": dict(nan_blocks={7: [4]}, raise_at={6: "x"}),
}


def _blocks(seed=0):
    return np.random.default_rng(seed).standard_normal((T, M, N, D)).astype(np.float32)


def _drain(stream):
    """Every block and every raised fault of a chaos stream, in order (a
    transient error is retried once, as the supervisor would)."""
    out = []
    while True:
        try:
            out.append(("block", np.asarray(next(stream))))
        except StopIteration:
            return out
        except OSError as e:
            out.append(("oserror", str(e)))
        except (jf.KillSwitch, tf.KillSwitch) as e:
            out.append(("kill", str(e)))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_chaos_stream_yields_what_the_reference_yields(name):
    x = _blocks()
    first = 3 if name == "resumed" else 1
    got = _drain(tf.ChaosStream(iter(x[first - 1:]), tf.ChaosPlan(**PLANS[name]),
                                first_step=first))
    want = _drain(jf.ChaosStream(iter(x[first - 1:]), jf.ChaosPlan(**PLANS[name]),
                                 first_step=first))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (kind, a), (_, b) in zip(got, want):
        if kind == "block":
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("name", sorted(PLANS))
def test_chaos_stream_corrupts_tensors_in_place_of_arrays(name):
    x = _blocks(1)
    plan = tf.ChaosPlan(**PLANS[name])
    arrays = _drain(tf.ChaosStream(iter(x), plan))
    tensors = tf.ChaosStream(iter(torch.from_numpy(x.copy())), tf.ChaosPlan(**PLANS[name]))
    for kind, want in arrays:
        if kind != "block":
            with pytest.raises((OSError, tf.KillSwitch)):
                next(tensors)
            continue
        got = next(tensors)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # the source blocks are never written
    np.testing.assert_array_equal(x, _blocks(1))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_injector_masks_match(seed):
    a = tf.FaultInjector(num_workers=M, drop_prob=0.4, seed=seed)
    b = jf.FaultInjector(num_workers=M, drop_prob=0.4, seed=seed)
    for _ in range(20):
        np.testing.assert_array_equal(a.next_mask(), b.next_mask())
    with pytest.raises(ValueError, match="drop_prob"):
        tf.FaultInjector(num_workers=M, drop_prob=1.0)


def test_kill_workers_matches():
    np.testing.assert_array_equal(tf.kill_workers(M, [1, 4]), jf.kill_workers(M, [1, 4]))
    with pytest.raises(ValueError, match="every worker"):
        tf.kill_workers(2, [0, 1])


def test_churn_plan_delays_match():
    kw = dict(kill_at={3: [0, 1]}, rejoin_at={9: [0]}, straggle={4: {2: 0.5}},
              slow={5: 0.08, 2: 0.01})
    a, b = tf.ChurnPlan(**kw), jf.ChurnPlan(**kw)
    for step in range(1, 12):
        for slot in range(M):
            assert a.delay(step, slot) == b.delay(step, slot)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("kw", [
    dict(dropout_frac=0.2, dropout_waves={3: 0.9}, straggler_frac=0.1,
         nan_frac=0.05, poison_frac=0.05, poison_scale=4.0),
    dict(dropout_frac=0.0, dropout_waves={1: 1.0}),
])
def test_client_chaos_plan_matches(kw):
    a, b = tf.ClientChaosPlan(**kw), jf.ClientChaosPlan(**kw)
    assert [a.dropout_at(r) for r in range(1, 6)] == [b.dropout_at(r) for r in range(1, 6)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("bad", [dict(nan_frac=1.5), dict(dropout_waves={2: -0.1})])
def test_client_chaos_plan_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as err:
        tf.ClientChaosPlan(**bad)
    with pytest.raises(ValueError) as jerr:
        jf.ClientChaosPlan(**bad)
    assert str(err.value) == str(jerr.value)


class _Bucket:
    def __init__(self, signature):
        self.signature = signature


def test_serve_chaos_hook_kills_once_and_poisons_its_signature():
    plan = tf.ServeChaosPlan(kill_lane_at_batch=2, fail_signatures=((8, 2),))
    hook = tf.ServeChaosHook(plan)
    hook(_Bucket((4, 2)))
    with pytest.raises(tf.KillSwitch, match="batch 2"):
        hook(_Bucket((4, 2)))
    hook(_Bucket((4, 2)))  # fired once: the restarted lane sails past
    with pytest.raises(OSError, match="poisoned"):
        hook(_Bucket((8, 2)))
    assert hook.batches == 4 and hook.killed


def test_corrupt_version_file_flips_what_the_reference_flips(tmp_path):
    payload = bytes(range(64))
    for i, mod in enumerate((tf, jf)):
        d = tmp_path / f"v{i}"
        d.mkdir()
        (d / "basis.npz").write_bytes(payload)
        path = mod.corrupt_version_file(str(d))
        assert os.path.basename(path) == "basis.npz"
    assert (tmp_path / "v0" / "basis.npz").read_bytes() == \
        (tmp_path / "v1" / "basis.npz").read_bytes() != payload


def test_kill_switch_is_one_class_for_the_scheduler():
    from distributed_eigenspaces_tpu_torch.runtime import scheduler

    assert scheduler.KillSwitch is tf.KillSwitch
