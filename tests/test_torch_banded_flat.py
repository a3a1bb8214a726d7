"""The flat banded projector, and the shared-geometry block diagonal over
it, against trips_tpu on the CPU.

``BandedProjector`` packs one stack per drive orientation at the group's
widest tap count; the port's ``from_scipy_fan`` must give the JAX
package's arrays (raw shears and predictors, angle ids) byte for byte, its
``to_scipy`` the packed matrix exactly, and its applies (the plain K2, K3
and K1 over both stacks in one call) JAX's ``matvec_xla`` and
``rmatvec_xla`` to 2e-5 and the normal apply to 2e-4 of the norm (float32
sums in another order; ``tests/test_banded.py``'s tolerances).
``BatchedBlockDiagOperator`` over it is ``tests/test_banded.py::
test_banded_dynamic_block_diag``'s setup (32x32, 12 views, 8 line groups,
3 frames): every apply is one wrapper call over all frames on the one
pack. The matrices come from the NumPy builder (``TRIPS_TPU_NO_NATIVE=1``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse as sp

import trips_tpu.problems as jp
from trips_tpu.core.linop import BatchedBlockDiagOperator as JaxBlockDiag
from trips_tpu.sparse.banded import BandedProjector as JaxFlat
from trips_tpu_torch.core import BatchedBlockDiagOperator
from trips_tpu_torch.krylov import cgls, cgls_normal
from trips_tpu_torch.sparse import BandedProjector
from trips_tpu_torch.sparse import banded_kernels as bk

from torch_threads import one_torch_thread  # noqa: F401

FIELDS = ["W_rows", "shift_rows", "P_rows", "W_cols", "shift_cols",
          "P_cols"]


@pytest.fixture(autouse=True)
def _numpy_builder(monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")


def _matrix(nx, views):
    return jp.fan_beam_matrix(nx, views=views).astype(np.float32)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a, b = a.reshape(-1).astype(np.float64), np.asarray(b).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("nx,views", [(32, 12), (40, 10)])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_pack_matches_jax(nx, views, dtype):
    A = _matrix(nx, views)
    j = JaxFlat.from_scipy_fan(A, nx, views, n_groups=8,
                               dtype=None if dtype is None else jnp.bfloat16)
    t = BandedProjector.from_scipy_fan(A, nx, views, n_groups=8,
                                       dtype=dtype, device="cpu")
    for name in FIELDS:
        assert np.array_equal(_bits(getattr(j, name)),
                              _bits(getattr(t, name))), name
    assert (t._angles_rows, t._angles_cols) == (j._angles_rows,
                                                j._angles_cols)
    assert (t.T_rows, t.T_cols, t.n_pad, t.stored_bytes) == (
        j.T_rows, j.T_cols, j.n_pad, j.stored_bytes)
    assert (t.to_scipy() != j.to_scipy()).nnz == 0
    if dtype is None:
        assert (t.to_scipy() != A.astype(np.float64)).nnz == 0


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_applies_match_jax_on_its_bytes(dtype, rng):
    nx, views = 40, 10
    A = _matrix(nx, views)
    j = JaxFlat.from_scipy_fan(A, nx, views, n_groups=8,
                               dtype=None if dtype is None else jnp.bfloat16)
    t = BandedProjector.from_numpy_stacks(
        *(np.asarray(getattr(j, f)) for f in FIELDS[:3]), j._angles_rows,
        *(np.asarray(getattr(j, f)) for f in FIELDS[3:]), j._angles_cols,
        j.shape, j.nx, j.det_count, j.n_groups, j.nnz, n_pad=j.n_pad,
        device="cpu")
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    Ax = np.asarray(j.matvec_xla(jnp.asarray(x)))
    assert _rel(t.matvec(torch.from_numpy(x)), Ax) <= 2e-5
    assert _rel(t.rmatvec(torch.from_numpy(y)),
                np.asarray(j.rmatvec_xla(jnp.asarray(y)))) <= 2e-5
    assert _rel(t.normal_matvec(torch.from_numpy(x)),
                np.asarray(j.rmatvec_xla(jnp.asarray(Ax)))) <= 2e-4


def test_flat_refuses_int8():
    A = _matrix(32, 12)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        BandedProjector.from_scipy_fan(A, 32, 12, n_groups=8, dtype="int8",
                                       device="cpu")


def test_one_drive_orientation_only(rng):
    """Views all driven along rows: the column stack is empty, (0, 1, n,
    p_pad) as in the JAX package, and the launch takes only the other."""
    nx, angles = 32, np.array([0.0, 0.1, -0.2, 0.3])
    A = jp.fan_beam_matrix(nx, angles=angles).astype(np.float32)
    t = BandedProjector.from_scipy_fan(A, nx, None, angles=angles,
                                       n_groups=8, device="cpu")
    j = JaxFlat.from_scipy_fan(A, nx, None, angles=angles, n_groups=8)
    assert t.W_cols.shape == j.W_cols.shape and t.W_cols.shape[0] == 0
    assert (t.T_cols, len(t._bks)) == (0, 1)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    assert _rel(t.matvec(torch.from_numpy(x)), A @ x) <= 2e-5


@pytest.fixture(scope="module")
def block_diag():
    """test_banded_dynamic_block_diag's setup on both packages."""
    import os

    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    try:
        A = _matrix(32, 12)
    finally:
        if old is None:
            os.environ.pop("TRIPS_TPU_NO_NATIVE")
        else:
            os.environ["TRIPS_TPU_NO_NATIVE"] = old
    j = JaxFlat.from_scipy_fan(A, 32, 12, n_groups=8)
    t = BandedProjector.from_scipy_fan(A, 32, 12, n_groups=8, device="cpu")
    return A, JaxBlockDiag(j, 3), BatchedBlockDiagOperator(t, 3)


def test_block_diag_matches_jax_in_one_call_per_apply(block_diag, rng):
    A, jb, tb = block_diag
    Afull = sp.block_diag([A] * 3, format="csr")
    calls = {"fwd": 0, "adj": 0, "ata": 0}
    op = tb.op

    def count(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in calls:
        setattr(op, "_" + name, count(name, getattr(op, "_" + name)))
    x = rng.standard_normal(tb.shape[1]).astype(np.float32)
    y = rng.standard_normal(tb.shape[0]).astype(np.float32)
    for fn, v, tol in (("matvec", x, 2e-5), ("rmatvec", y, 2e-5),
                       ("normal_matvec", x, 2e-4)):
        got = getattr(tb, fn)(torch.from_numpy(v))
        ref = np.asarray(getattr(jb, fn)(jnp.asarray(v)))
        assert got.shape == ref.shape and _rel(got, ref) <= tol, fn
    assert _rel(tb.matvec(torch.from_numpy(x)), Afull @ x) <= 2e-5
    assert calls == {"fwd": 2, "adj": 1, "ata": 1}
    # each frame of the launch is the operator's own apply
    X = torch.from_numpy(x).reshape(3, -1)
    for f in range(3):
        assert torch.equal(tb.matvec(torch.from_numpy(x)).reshape(3, -1)[f],
                           op.matvec(X[f]))


def test_block_diag_solves(block_diag, rng):
    """cgls and cgls_normal on the block diagonal agree (JAX's test:
    within 2e-2 after 15 iterations)."""
    A, _, tb = block_diag
    Afull = sp.block_diag([A] * 3, format="csr")
    x = np.abs(rng.standard_normal(tb.shape[1]))
    b = torch.from_numpy((Afull @ x).astype(np.float32))
    x0 = torch.zeros(tb.shape[1])
    xs, _ = cgls(tb, b, x0, 15, 0.0)
    xn, _ = cgls_normal(tb, b, x0, 15, 0.0)
    assert float((xn - xs).norm() / xs.norm()) < 2e-2


def test_matmat_columns_as_frames(rng):
    """matmat, rmatmat and normal_matmat: one call over the k columns, the
    same as k applies."""
    A = _matrix(32, 12)
    t = BandedProjector.from_scipy_fan(A, 32, 12, n_groups=8, device="cpu")
    X = torch.from_numpy(rng.standard_normal((A.shape[1], 3))
                         .astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal((A.shape[0], 3))
                         .astype(np.float32))
    for fn, M in (("matmat", X), ("rmatmat", Y), ("normal_matmat", X)):
        got = getattr(t, fn)(M)
        one = fn.replace("matmat", "matvec")
        ref = torch.stack([getattr(t, one)(c) for c in M.T], dim=1)
        assert got.shape == ref.shape and torch.equal(got, ref), fn


def test_stack_per_frame_equals_shared_stack():
    """A bucket holding one stack per frame (the dynamic layout) applies
    frame f's stack to frame f: with every frame's stack the same, the
    shared stack's apply."""
    A = _matrix(32, 12)
    t = BandedProjector.from_scipy_fan(A, 32, 12, n_groups=8, device="cpu")
    W, S, P, sc, c = t._bks[0]
    frames = [(W[None].expand(2, *W.shape).contiguous(), S[None].repeat(
        2, 1, 1), P[None].repeat(2, 1, 1, 1), None, c)]
    ids = [t._aidx[0][None].repeat(2, 1)]
    X = torch.zeros((2, t.n_pad, t.n_pad))
    Y = bk.banded_fwd_buckets(X, None, frames, ids, t.det_count, 8,
                              len(t._aidx[0]) + len(t._aidx[1]))
    assert Y.shape == (2, 12, t.det_count)
    shared = bk.banded_fwd_buckets(X, None, t._bks[:1], t._aidx[:1],
                                   t.det_count, 8, 12)
    assert torch.equal(Y, shared)
