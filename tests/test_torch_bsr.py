"""``BsrOperator`` and ``device_sparse_operator``'s ``prefer`` against
``trips_tpu`` on the CPU.

- ``BsrOperator.from_scipy`` with float64 and float32 values and
  ``block_dtype`` None, bfloat16 and int8, in JAX's default ``(16, 128)``
  blocks and in ``bs = 32``: ``matvec``, ``rmatvec``, ``matmat`` and
  ``rmatmat`` within 1e-12 of JAX's in float64 and 1e-6 where the port
  computes in float32 (float32 values, bfloat16 and int8 blocks);
  ``stored_bytes``, ``stored_density`` and the computation dtype equal
  JAX's. JAX's int8 apply rounds its input to bfloat16, the port's does
  not, so the inputs are bfloat16 values (the rounding is then exact).
- ``device_sparse_operator`` with each ``prefer`` and with the legacy
  ``prefer_bsr``: the class taken, and its applies against the host
  matrix and JAX's operator of the same choice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.problems as jp
from trips_tpu.sparse import BsrOperator as JaxBsr
from trips_tpu_torch.problems import device_sparse_operator
from trips_tpu_torch.sparse import (BsrOperator, BucketedBandedProjector,
                                    CsrOperator, EllOperator)

from torch_threads import one_torch_thread  # noqa: F401

JAX_BLOCK = {None: None, "bfloat16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(scope="module")
def problem():
    """The NumPy builder's fan matrix at 32x12 (float64) and bfloat16-
    valued inputs (vectors and 3-column blocks) from a seed."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TRIPS_TPU_NO_NATIVE", "1")
    A = jp.fan_beam_matrix(32, views=12)
    mp.undo()
    rng = np.random.default_rng(0)

    def bf16(*shape):
        v = jnp.asarray(rng.standard_normal(shape)).astype(jnp.bfloat16)
        return np.asarray(v.astype(jnp.float64))

    return A, {"matvec": bf16(A.shape[1]), "rmatvec": bf16(A.shape[0]),
               "matmat": bf16(A.shape[1], 3), "rmatmat": bf16(A.shape[0], 3)}


@pytest.mark.parametrize("bs", [None, 32])
@pytest.mark.parametrize("dtype", [None, np.float32])
@pytest.mark.parametrize("block", [None, "bfloat16", "int8"])
def test_bsr_matches_jax(problem, block, dtype, bs):
    A, inputs = problem
    j = JaxBsr.from_scipy(A, bs=bs, dtype=dtype, block_dtype=JAX_BLOCK[block])
    t = BsrOperator.from_scipy(A, bs=bs, dtype=dtype, block_dtype=block,
                               device="cpu")
    assert t.block_shape == j.block_shape and t.nnz == j.nnz
    assert t.stored_bytes == j.stored_bytes
    assert t.stored_density == j.stored_density
    exact = block is None and dtype is None
    assert t.dtype == (torch.float64 if exact else torch.float32)
    assert str(t.dtype).removeprefix("torch.") == j.dtype.name
    tol = 1e-12 if exact else 1e-6
    for fn, v in inputs.items():
        got = getattr(t, fn)(torch.from_numpy(v)).numpy()
        ref = np.asarray(getattr(j, fn)(jnp.asarray(v)), np.float64)
        assert got.shape == ref.shape and got.dtype == np.float64
        assert np.linalg.norm(got - ref) <= tol * np.linalg.norm(ref), fn


def test_bsr_todense_matches_jax(problem):
    A, _ = problem
    j = JaxBsr.from_scipy(A[:40, :300], bs=16, block_dtype=jnp.int8)
    t = BsrOperator.from_scipy(A[:40, :300], bs=16, block_dtype="int8",
                               device="cpu")
    np.testing.assert_allclose(t.to_scipy(), j.to_scipy(), rtol=1e-6,
                               atol=1e-7)


CHOICES = [  # (kwargs, the port's class, JAX's prefer for the same map)
    ({}, BucketedBandedProjector, "banded"),
    ({"prefer": "banded"}, BucketedBandedProjector, "banded"),
    ({"prefer": "bsr"}, BsrOperator, "bsr"),
    ({"prefer": "ell"}, EllOperator, "ell"),
    ({"prefer_bsr": True}, BsrOperator, "bsr"),
    ({"prefer_bsr": False}, EllOperator, "ell"),
    ({"prefer": "bsr", "dtype": "int8"}, BsrOperator, None),
    ({"prefer": "ell", "dtype": torch.bfloat16}, EllOperator, None),
    ({"nx": None}, CsrOperator, "ell"),
]


@pytest.mark.parametrize("kw,cls,jax_prefer", CHOICES)
def test_device_sparse_operator_prefer(problem, kw, cls, jax_prefer):
    A, inputs = problem
    theta = np.linspace(0, np.pi, 12, endpoint=False)
    geo = {"nx": 32, "angles": theta}
    geo.update({k: v for k, v in kw.items() if k == "nx"})
    rest = {k: v for k, v in kw.items() if k != "nx"}
    op = device_sparse_operator(A, **geo, **rest, device="cpu")
    assert type(op) is cls and op.dtype == torch.float32
    x = torch.from_numpy(inputs["matvec"]).float()
    y = torch.from_numpy(inputs["rmatvec"]).float()
    quantized = rest.get("dtype") is not None
    tol = 1e-2 if quantized else 1e-6
    for got, ref in ((op.matvec(x), A @ inputs["matvec"]),
                     (op.rmatvec(y), A.T @ inputs["rmatvec"])):
        got = got.double().numpy()
        assert np.linalg.norm(got - ref) <= tol * np.linalg.norm(ref)
    if jax_prefer is not None and jax_prefer != "banded":
        j = jp.device_sparse_operator(A, nx=32, angles=theta,
                                      prefer=jax_prefer)
        ref = np.asarray(j.matvec(jnp.asarray(inputs["matvec"],
                                              jnp.float32)), np.float64)
        got = op.matvec(x).double().numpy()
        assert np.linalg.norm(got - ref) <= 1e-6 * np.linalg.norm(ref)


def test_device_sparse_operator_refusals(problem):
    A, _ = problem
    with pytest.raises(ValueError, match="prefer"):
        device_sparse_operator(A, prefer="dense", device="cpu")
    with pytest.raises(ValueError, match="ELL"):
        device_sparse_operator(A, prefer="ell", dtype="int8", device="cpu")
