"""The streamed out-of-core dynamic operator: trips_tpu_torch against
trips_tpu on the CPU.

At JAX's own test shape (``tests/test_parallel.py``'s
``test_streamed_dynamic_matches_resident``: 16x16, 3 frames, 8 views,
noise-free data, 8 line groups), each frame a flat ``BandedProjector`` of
JAX's bytes carried across with ``from_numpy_stacks``:

- ``matvec``/``rmatvec`` against JAX's ``StreamedDynamicBandedOperator``
  to rtol 2e-5 and ``normal_matvec`` to 2e-4, JAX's own test's limits
  (float32 sums in another order); against the port's resident
  ``DynamicBandedOperator`` on the same frames to 1e-6 of the norm (the
  same plain applies, the stacks padded to common widths);
- ``shape``, ``nnz`` and ``stored_bytes`` equal to JAX's;
- ``cgls_normal_streamed`` against JAX's to 1e-4 at 8 iterations and 5e-3
  at 15, the limits JAX's test states (at the convergence floor of this
  noise-free system float32 drift grows).

The matrices come from the NumPy builder (``TRIPS_TPU_NO_NATIVE=1``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sp

import trips_tpu.parallel as jpar
import trips_tpu.problems as jp
from trips_tpu.sparse import BandedProjector as JaxFlat
from trips_tpu_torch.parallel import (StreamedDynamicBandedOperator,
                                      cgls_normal_streamed)
from trips_tpu_torch.sparse import BandedProjector, DynamicBandedOperator

from torch_threads import one_torch_thread  # noqa: F401

FIELDS = ["W_rows", "shift_rows", "P_rows", "W_cols", "shift_cols",
          "P_cols"]


@pytest.fixture(scope="module")
def streamed():
    """(the problem, JAX's streamed operator, the port's on JAX's bytes)."""
    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        prob = jp.generate_synthetic_dynamic(nx=16, nt=3, views=8,
                                             noise_level=0.0,
                                             return_angles=True)
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_NO_NATIVE")
        else:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old
    A, b, AA, B, nx, ny, nt, delta, x_true, angles = prob
    jops = [JaxFlat.from_scipy_fan(AA[t], nx, len(angles[t]),
                                   angles=angles[t], n_groups=8)
            for t in range(nt)]
    tops = [BandedProjector.from_numpy_stacks(
        *(np.asarray(getattr(j, f)) for f in FIELDS[:3]), j._angles_rows,
        *(np.asarray(getattr(j, f)) for f in FIELDS[3:]), j._angles_cols,
        j.shape, j.nx, j.det_count, j.n_groups, j.nnz, n_pad=j.n_pad,
        device="cpu") for j in jops]
    return (prob, jpar.StreamedDynamicBandedOperator(jops),
            StreamedDynamicBandedOperator(tops, device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64).reshape(-1), np.asarray(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_streamed_attributes_match_jax(streamed):
    prob, jop, top = streamed
    assert top.shape == jop.shape == sp.block_diag(prob[2]).shape
    assert top.nt == jop.nt == 3
    assert top.nnz == jop.nnz
    assert top.stored_bytes == jop.stored_bytes
    assert top.device == torch.device("cpu")


@pytest.mark.parametrize("fn,rtol", [("matvec", 2e-5), ("rmatvec", 2e-5),
                                     ("normal_matvec", 2e-4)])
def test_streamed_applies_match_jax(streamed, fn, rtol, rng):
    prob, jop, top = streamed
    n_in = top.shape[0] if fn == "rmatvec" else top.shape[1]
    v = rng.standard_normal(n_in).astype(np.float32)
    got = getattr(top, fn)(torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == (
        top.shape[1] if fn != "matvec" else top.shape[0],)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(getattr(jop, fn)(jnp.asarray(v))),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("fn", ["matvec", "rmatvec", "normal_matvec"])
def test_streamed_matches_resident(streamed, fn, rng):
    (A, b, AA, B, nx, ny, nt, delta, x_true, angles), _, top = streamed
    res = DynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8,
                                            device="cpu")
    n_in = top.shape[0] if fn == "rmatvec" else top.shape[1]
    v = torch.from_numpy(rng.standard_normal(n_in).astype(np.float32))
    assert _rel(getattr(top, fn)(v), getattr(res, fn)(v)) <= 1e-6


def test_streamed_needs_frames():
    with pytest.raises(ValueError, match="at least one frame"):
        StreamedDynamicBandedOperator([], device="cpu")


@pytest.mark.parametrize("iters,tol", [(8, 1e-4), (15, 5e-3)])
def test_cgls_normal_streamed_matches_jax(streamed, iters, tol):
    prob, jop, top = streamed
    b = prob[1].astype(np.float32)
    xj, kj = jpar.cgls_normal_streamed(
        jop, jnp.asarray(b), jnp.zeros(jop.shape[1], jnp.float32), iters)
    xt, kt = cgls_normal_streamed(top, torch.from_numpy(b),
                                  torch.zeros(top.shape[1]), iters)
    assert kt == kj == iters
    assert xt.dtype == torch.float32
    assert _rel(xt, np.asarray(xj)) <= tol
