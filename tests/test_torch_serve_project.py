"""The port's serve projections (ops/serve_project.py) against the
reference's: ``quantize_basis_i8``, the XLA twins of
``TransformEngine.project_quant`` and the Pallas kernels
``serve_project_pallas`` / ``serve_project_i8_pallas`` in interpret mode.

Inputs are made with numpy from a seed and fed to both sides.
Tolerances:
- the codec is bit-equal (both round half to even);
- plain version vs XLA twin and vs interpret-mode Pallas: relative
  Frobenius error <= 1e-5. Both sides multiply the same bf16-rounded
  operands exactly and sum in fp32 in another order; the measured gaps
  against a float64 oracle of the rounded operands are printed by
  ``test_gap_to_float64_oracle`` and sit near 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.ops.pallas_gram import (
    quantize_basis_i8 as jax_quantize,
    serve_project_i8_pallas,
    serve_project_pallas,
)
from distributed_eigenspaces_tpu_torch.ops import serve_project as tsp

TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _operands(rng, rows, d, k):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((d, k)))[0].astype(np.float32)
    return x, v


def _xla_bf16(x, v):
    return np.asarray(jnp.matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ))


def _xla_i8(x, q, s):
    z = jnp.matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return np.asarray(z * jnp.asarray(s))


@pytest.mark.parametrize("d,k", [(64, 3), (256, 10), (129, 17)])
def test_quantize_basis_i8_bit_equal_to_reference(rng, d, k):
    v = rng.standard_normal((d, k)).astype(np.float32)
    v[:, 0] = 0.0  # an all-zero column: zeros with zero scale
    jq, js = jax_quantize(jnp.asarray(v))
    tq, ts = tsp.quantize_basis_i8(torch.from_numpy(v))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (1, k)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq[:, 0].any() and float(ts[0, 0]) == 0.0


@pytest.mark.parametrize("rows,d,k", [(64, 256, 8), (100, 300, 10), (7, 129, 3)])
def test_serve_project_plain_matches_xla_twin(rng, rows, d, k):
    x, v = _operands(rng, rows, d, k)
    got = tsp.serve_project_plain(torch.from_numpy(x), torch.from_numpy(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, k)
    assert _rel(got.numpy(), _xla_bf16(x, v)) <= TOL


@pytest.mark.parametrize("rows,d,k", [(64, 256, 8), (100, 300, 10), (7, 129, 3)])
def test_serve_project_i8_plain_matches_xla_twin(rng, rows, d, k):
    x, v = _operands(rng, rows, d, k)
    jq, js = jax_quantize(jnp.asarray(v))
    tq, ts = tsp.quantize_basis_i8(torch.from_numpy(v))
    got = tsp.serve_project_i8_plain(torch.from_numpy(x), tq, ts)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, k)
    assert _rel(got.numpy(), _xla_i8(x, jq, js)) <= TOL


@pytest.mark.parametrize("rows,d,k,br,bd", [(128, 256, 8, 64, 128), (64, 384, 10, 64, 128)])
def test_serve_project_plain_matches_pallas_interpret(rng, rows, d, k, br, bd):
    x, v = _operands(rng, rows, d, k)
    want = np.asarray(serve_project_pallas(
        jnp.asarray(x), jnp.asarray(v), block_rows=br, block_d=bd, interpret=True,
    ))
    got = tsp.serve_project_plain(torch.from_numpy(x), torch.from_numpy(v))
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("rows,d,k,br,bd", [(128, 256, 8, 64, 128), (64, 384, 10, 64, 128)])
def test_serve_project_i8_plain_matches_pallas_interpret(rng, rows, d, k, br, bd):
    x, v = _operands(rng, rows, d, k)
    jq, js = jax_quantize(jnp.asarray(v))
    want = np.asarray(serve_project_i8_pallas(
        jnp.asarray(x), jq, js, block_rows=br, block_d=bd, interpret=True,
    ))
    tq, ts = tsp.quantize_basis_i8(torch.from_numpy(v))
    got = tsp.serve_project_i8_plain(torch.from_numpy(x), tq, ts)
    assert _rel(got.numpy(), want) <= TOL


def test_gap_to_float64_oracle(rng):
    """The measured gaps behind TOL: every version against the float64
    product of the same bf16-rounded operands."""
    x, v = _operands(rng, 128, 384, 10)
    oracle = _bf16(x).astype(np.float64) @ _bf16(v).astype(np.float64)
    gaps = {
        "plain": _rel(tsp.serve_project_plain(torch.from_numpy(x), torch.from_numpy(v)), oracle),
        "xla": _rel(_xla_bf16(x, v), oracle),
        "pallas": _rel(serve_project_pallas(
            jnp.asarray(x), jnp.asarray(v), block_rows=64, block_d=128, interpret=True,
        ), oracle),
    }
    print("relative gap to the float64 oracle:", gaps)
    assert max(gaps.values()) <= TOL / 10


def test_bf16_input_is_taken_as_is(rng):
    x, v = _operands(rng, 32, 128, 4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tsp.serve_project_plain(xb, torch.from_numpy(v)).numpy(),
        tsp.serve_project_plain(torch.from_numpy(x), torch.from_numpy(v)).numpy(),
    )


def test_auto_takes_plain_on_cpu_and_cuda_wrappers_refuse_cpu(rng):
    x, v = _operands(rng, 16, 64, 3)
    tx, tv = torch.from_numpy(x), torch.from_numpy(v)
    tq, ts = tsp.quantize_basis_i8(tv)
    before = (tsp.launches, tsp.launches_i8)
    np.testing.assert_array_equal(
        tsp.serve_project_auto(tx, tv).numpy(), tsp.serve_project_plain(tx, tv).numpy()
    )
    np.testing.assert_array_equal(
        tsp.serve_project_i8_auto(tx, tq, ts).numpy(),
        tsp.serve_project_i8_plain(tx, tq, ts).numpy(),
    )
    assert (tsp.launches, tsp.launches_i8) == before
    with pytest.raises(ValueError, match="CUDA"):
        tsp.serve_project_cuda(tx, tv)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.serve_project_i8_cuda(tx, tq, ts)
    assert (tsp.launches, tsp.launches_i8) == before
