"""The wire codecs (``parallel/wire.py``) against the reference's.

The codecs on the same numpy inputs (``wire_roundtrip``, ``error_feedback``,
``procrustes_rotation``), the policy (``normalize_wire_policy``,
``resolve_wire_policy``, ``root_wire_dtype``) and the config's refusals and
normal form, ``tier_wire_records`` dict for dict; then the wire
collectives on four gloo ranks (one ``parallel.mesh.launch``, programs in
``tests/torch_tree_ranks.py``) against the same gathers and exchanges in
fp32, with the recorder's dtypes.

Tolerances: the round trips and ``error_feedback`` bit-equal (bf16 is one
cast; the int8 quantizer is the read path's, bit-equal to the reference's);
``procrustes_rotation`` within 1e-5 (another SVD); the records equal; a
compressed collective within ``2e-2 * max|x|`` of fp32 (the reference's
bound, ``tests/test_wire.py``), fp32 bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tree_ranks as ranks

from distributed_eigenspaces_tpu.config import PCAConfig as JaxConfig
from distributed_eigenspaces_tpu.parallel import topology as jtp
from distributed_eigenspaces_tpu.parallel import wire as jwire
from distributed_eigenspaces_tpu_torch.config import PCAConfig
from distributed_eigenspaces_tpu_torch.parallel import mesh as pmesh
from distributed_eigenspaces_tpu_torch.parallel import topology as tp
from distributed_eigenspaces_tpu_torch.parallel import wire as twire

PROCRUSTES_ATOL = 1e-5
WIRE_REL = 2e-2
TIMEOUT = 180.0
TIERS = (("chip", 2), ("host", 2))


def _x(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., 1] = 0.0  # an all-zero column quantizes exactly
    return x


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shape", [(48, 4), (3, 16, 4)])
def test_roundtrip_and_error_feedback_are_the_references_bit_for_bit(dtype, shape):
    x, r = _x(shape), 0.01 * _x(shape, seed=1)
    got = twire.wire_roundtrip(torch.from_numpy(x), dtype).numpy()
    np.testing.assert_array_equal(got, np.asarray(jwire.wire_roundtrip(jnp.asarray(x), dtype)))
    ta, tr = twire.error_feedback(torch.from_numpy(x), torch.from_numpy(r), dtype)
    ja, jr = jwire.error_feedback(jnp.asarray(x), jnp.asarray(r), dtype)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    if dtype == "fp32":  # exact: the payload and the residual as they came
        assert torch.equal(ta, torch.from_numpy(x)) and torch.equal(tr, torch.from_numpy(r))


def test_unknown_codecs_are_refused():
    x = torch.zeros((4, 2))
    for fn in (lambda: twire.wire_roundtrip(x, "fp64"),
               lambda: twire.error_feedback(x, x, "fp16")):
        with pytest.raises(ValueError, match="unknown wire dtype"):
            fn()
    with pmesh.mesh_scope(pmesh.local_mesh("cpu")):
        with pytest.raises(ValueError, match="unknown wire dtype"):
            twire.wire_all_gather(x, "workers", "fp64")
        with pytest.raises(ValueError, match="unknown wire dtype"):
            twire.wire_all_to_all(x[None], "workers", "fp64")


def test_procrustes_rotation_matches_the_reference():
    rng = np.random.default_rng(2)
    ref = np.linalg.qr(rng.standard_normal((40, 5)))[0]
    rot = np.linalg.qr(rng.standard_normal((5, 5)))[0]
    x = (ref @ rot.T + 1e-3 * rng.standard_normal((40, 5))).astype(np.float32)
    m = (x.T @ ref).astype(np.float32)
    got = twire.procrustes_rotation(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jwire.procrustes_rotation(jnp.asarray(m))),
                               atol=PROCRUSTES_ATOL, rtol=0)
    np.testing.assert_allclose(got.T @ got, np.eye(5), atol=PROCRUSTES_ATOL)
    np.testing.assert_allclose(x @ got, ref, atol=1e-2)
    # a zero reference pins the identity
    np.testing.assert_allclose(twire.procrustes_rotation(torch.zeros((3, 3))).numpy(),
                               np.eye(3), atol=PROCRUSTES_ATOL)


@pytest.mark.parametrize("policy", [
    None, {"host": "int8"}, {"chip": "bf16", "host": "bf16"}, (("chip", "int8"),),
    {"chip": "fp32", "host": "fp32"},
])
def test_policy_resolution_matches_the_reference(policy):
    kw = dict(dim=16, k=2, num_workers=4, merge_topology=TIERS, merge_wire_dtype=policy)
    jcfg, tcfg = JaxConfig(**kw), PCAConfig(**kw)
    assert tcfg.merge_wire_dtype == jcfg.merge_wire_dtype
    jt, tt = jtp.resolve_topology(jcfg), tp.resolve_topology(tcfg)
    assert twire.resolve_wire_policy(tcfg, tt) == jwire.resolve_wire_policy(jcfg, jt)
    assert twire.root_wire_dtype(tcfg, tt) == jwire.root_wire_dtype(jcfg, jt)
    if policy is not None:
        assert twire.normalize_wire_policy(policy) == jwire.normalize_wire_policy(policy)
    assert twire.resolve_wire_policy(tcfg, None) is None


def test_policy_resolution_refuses_like_the_reference():
    class Raw:  # a config that skipped PCAConfig's own checks
        merge_wire_dtype = {"pod": "int8"}

    class Bad:
        merge_wire_dtype = {"host": "fp8"}

    topo = tp.MergeTopology(TIERS)
    for mod, t in ((twire, topo), (jwire, jtp.MergeTopology(TIERS))):
        with pytest.raises(ValueError, match="name no resolved"):
            mod.resolve_wire_policy(Raw(), t)
        with pytest.raises(ValueError, match="not in"):
            mod.resolve_wire_policy(Bad(), t)


@pytest.mark.parametrize("kw,match", [
    (dict(merge_wire_dtype="int8"), "must be a mapping"),
    (dict(merge_wire_dtype={"host": "int8"}), "requires merge_topology"),
    (dict(merge_wire_dtype={"host": "int8"}, merge_topology=TIERS, pipeline_merge=True,
          solver="subspace"), "pipeline_merge"),
    (dict(merge_wire_dtype={"pod": "int8"}, merge_topology=TIERS), "names no"),
    (dict(merge_wire_dtype={"host": "fp16"}, merge_topology=TIERS), "unknown.*wire dtype"),
    (dict(merge_wire_dtype=(("host", "int8"), ("host", "bf16")), merge_topology=TIERS),
     "unique"),
])
def test_config_refuses_bad_policies_like_the_reference(kw, match):
    for cfg_cls in (JaxConfig, PCAConfig):
        with pytest.raises(ValueError, match=match):
            cfg_cls(dim=16, k=2, num_workers=4, **kw)


@pytest.mark.parametrize("tiers,policy,d,kf", [
    (TIERS, ("bf16", "int8"), 64, 4),
    ((("chip", 4), ("host", 2)), ("fp32", "int8"), 3072, 10),
    ((("a", 2), ("b", 3), ("c", 1)), ("int8", "bf16", "int8"), 96, 8),
])
def test_tier_wire_records_are_the_references(tiers, policy, d, kf):
    norms = {tiers[-1][0]: 0.125}
    got = twire.tier_wire_records(tp.MergeTopology(tiers), policy, d, kf,
                                  residual_norms=norms)
    want = jwire.tier_wire_records(jtp.MergeTopology(tiers), policy, d, kf,
                                   residual_norms=norms)
    assert got == want
    assert twire.WIRE_ITEMSIZE == jwire.WIRE_ITEMSIZE
    assert twire.WIRE_DTYPES == jwire.WIRE_DTYPES


# -- the wire collectives on four ranks ----------------------------------------------


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    world, rows, k = 4, 8, 3
    panels = _x((world, rows, k), seed=3)
    stacks = _x((world, 2, rows, k), seed=4)
    slots = _x((world, world, rows, k), seed=5)
    out = pmesh.launch(ranks.wire_collectives, world, panels, stacks, slots,
                       workdir=str(tmp_path_factory.mktemp("wire")), timeout=TIMEOUT)
    return panels, stacks, slots, out


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_wire_collectives_on_four_ranks_track_fp32(four_ranks, dtype):
    panels, stacks, slots, out = four_ranks
    want = {"gather": panels.reshape(-1, panels.shape[-1]), "gather_stacked": panels,
            "gather_stack": stacks.reshape((-1,) + stacks.shape[2:])}
    for r in range(4):
        got = out[r][dtype]
        want["all_to_all"] = slots[:, r]  # slot j: what rank j sent rank r
        for what, ref in want.items():
            assert got[what].dtype == np.float32 and got[what].shape == ref.shape
            if dtype == "fp32":
                np.testing.assert_array_equal(got[what], ref)
            else:
                tol = WIRE_REL * float(np.abs(ref).max())
                np.testing.assert_allclose(got[what], ref, atol=tol, rtol=0)
        # the payloads rode the wire in the codec's dtype; int8 with its
        # fp32 scale sidecars beside them
        dt = {"fp32": "float32", "bf16": "bfloat16", "int8": "int8"}[dtype]
        movers = [rec for rec in got["log"] if rec[5] is None]
        assert [rec[0] for rec in movers] == ["all_gather"] * 3 + ["all_to_all"]
        assert {rec[2] for rec in movers} == {dt}
        sidecars = [rec for rec in got["log"] if rec[5] == twire.SCALE_TAG]
        assert len(sidecars) == (4 if dtype == "int8" else 0)
        assert {rec[2] for rec in sidecars} <= {"float32"}
