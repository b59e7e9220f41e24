"""Shared cases of the eval-harness parity tests (``tests/test_torch_evals.py``,
``tests/test_torch_evals_sharded.py``): the reference test's shrunk sizes,
the reference's own draws, and the report comparison. Not a test file
itself (pytest collects ``test_*.py``).

Each spec runs through both packages' ``run_eval`` on the same blocks and
cold start: the reference draws its ``min(steps, 4)`` blocks from
``PRNGKey(seed + 1)`` as its ``run_eval`` does, and the port takes them as
``blocks=``, with ``jax.random.normal(PRNGKey(0), (d, k))`` as ``v0``.

- The port's report has the reference's keys plus ``device``; the static
  fields (dims, steps, ``timed_steps``, the trainer, ``bytes_per_step``,
  every roofline model integer) are equal.
- The only difference allowed: the reference's tests run on 8 CPU devices
  (the conftest), the port in one process. So ``mnist784`` is ``shard_map``
  there and ``local`` here, and the three mesh configs (``mnist784``,
  ``imagenet12288``, ``clip768_chip``) carry an ``ici_model`` block there
  and none here (:data:`ONE_PROCESS`).
- The port's max principal angle is within 0.2 degrees of the reference's,
  and both are within 1 degree of the planted top-k.

The reference's reports are made with its two anchor measurements replaced
by constants: their timings are not compared, and measuring them compiles a
dozen programs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_eigenspaces_tpu import evals as jevals
from distributed_eigenspaces_tpu.data.synthetic import planted_subspace as jplanted_subspace
from distributed_eigenspaces_tpu_torch import evals

CPU = "cpu"
DEG_REF = 0.2
DEG_TRUTH = 1.0
#: the reference test's shrunk sizes (tests/test_evals.py)
CASES = {
    "synthetic1024": dict(dim=128, rows_per_worker=64, steps=4),
    "cifar10": dict(dim=96, k=4, rows_per_worker=64, steps=4),
    "mnist784": dict(dim=96, k=4, subspace_iters=12, rows_per_worker=64, steps=4),
    "imagenet12288": dict(dim=256, k=8, num_workers=4, rows_per_worker=64, steps=4),
    "clip768": dict(dim=128, k=16, subspace_iters=16, rows_per_worker=256, steps=4),
    "clip768_chip": dict(dim=64, k=8, subspace_iters=16, rows_per_worker=128, steps=4),
}
#: what differs because the reference runs on 8 devices and the port on one
#: process: the backend the mesh gives, and the collective model of a mesh
ONE_PROCESS = {
    "mnist784": {"backend": ("shard_map", "local"), "ici_model": True},
    "imagenet12288": {"ici_model": True},
    "clip768_chip": {"ici_model": True},
}
STATIC = ("config", "description", "dim", "k", "num_workers", "rows_per_worker", "steps",
          "timed_steps", "backend", "trainer", "solver", "data", "streaming", "bin_dtype",
          "bytes_per_step")
MODEL_INTS = ("cold_flops_per_step", "warm_flops_per_step", "model_flops_total",
              "model_bytes_total")
REF_ANCHOR_TFLOPS = 1.0
REF_HBM_GBPS = 100.0


def ref_inputs(name, seed=0, **over):
    """The reference ``run_eval``'s own draws: its blocks from
    ``PRNGKey(seed + 1)`` (``evals.py:319-419``) and the cold start of its
    worker solves (``PRNGKey(0)``)."""
    spec = jevals.EVAL_SPECS[name].replace(**over)
    m, n, d, k = spec.num_workers, spec.rows_per_worker, spec.dim, spec.k
    spectrum = jplanted_subspace(d, **evals.synthetic_model(
        evals.EVAL_SPECS[name].replace(**over), seed))
    key = jax.random.PRNGKey(seed + 1)
    blocks = []
    for _ in range(min(spec.steps, 4)):
        key, sub = jax.random.split(key)
        blocks.append(np.array(spectrum.sample(sub, m * n)).reshape(m, n, d))
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (d, k), jnp.float32))
    return blocks, v0


def ref_reports(names):
    """The reference's reports of ``names``, its anchors constants."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jevals, "_matmul_anchor", lambda small: REF_ANCHOR_TFLOPS)
    mp.setattr(jevals, "_hbm_anchor",
               lambda small: (REF_HBM_GBPS, {"gb_per_sec": REF_HBM_GBPS}))
    try:
        return {name: jevals.run_eval(name, **CASES[name]) for name in names}
    finally:
        mp.undo()


def port_reports(names):
    """The port's reports of ``names`` on the reference's draws."""
    out = {}
    for name in names:
        blocks, v0 = ref_inputs(name, **CASES[name])
        out[name] = evals.run_eval(name, device=CPU, blocks=blocks, v0=v0, **CASES[name])
    return out


def assert_report_matches(name, ref, got):
    diff = ONE_PROCESS.get(name, {})
    want_keys = set(ref) | {"device"}
    if diff.get("ici_model"):
        want_keys.discard("ici_model")
    assert set(got) == want_keys
    assert got["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    for key in STATIC:
        if key not in ref:
            continue
        if key in diff:
            assert (ref[key], got[key]) == diff[key], key
        else:
            assert got[key] == ref[key], key
    for key in MODEL_INTS:
        assert got["roofline"][key] == ref["roofline"][key], key
    assert got["principal_angle_deg"] <= DEG_TRUTH and ref["principal_angle_deg"] <= DEG_TRUTH
    assert abs(got["principal_angle_deg"] - ref["principal_angle_deg"]) <= DEG_REF
    assert got["accuracy_ok"] and got["samples_per_sec"] > 0
    t = got["timing"]
    assert t["n_repeats"] == 1
    assert t["seconds_iqr"][0] <= t["seconds_median"] <= t["seconds_iqr"][1]


def streams(d, k, iters):
    """The route ``step_flop_model`` assumes a solve takes (the streaming
    matvec, else the Gram)."""
    return d >= 4096 or (2 * k * iters < d and iters <= 6)


def gram_calls_per_fit(spec):
    """Gram calls of one fit of ``spec`` on the model's routes."""
    return (0 if streams(spec.dim, spec.k, spec.subspace_iters) else 1) + (
        spec.steps - 1) * (0 if streams(spec.dim, spec.k, spec.warm_start_iters) else 1)
