"""trips_tpu_torch banded pack and plain applies against trips_tpu.

Both packages pack the same CSR matrix (nx = 32 and the non-aligned nx = 40,
12 views, 8 line groups, 2 buckets per drive orientation) and the same
NumPy-seeded vectors go through both. On the CPU the port's applies run the
kernels' plain versions; the JAX operator runs its XLA oracle
(``apply_group_xla(..., wrap=True)``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu_torch.problems.projector import fan_beam_matrix
from trips_tpu_torch.sparse import BucketedBandedProjector
from trips_tpu_torch.sparse import banded_kernels as bk

from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": ("int8", "int8")}
# f32 sums in another order than the oracle's: a few ulps of the norm
RTOL = 1e-5


def _matrix(nx):
    return fan_beam_matrix(nx, views=12).astype(np.float32)


def _pair(nx, kind):
    A = _matrix(nx)
    jdt, tdt = DTYPES[kind]
    jop = JaxBucketed.from_scipy_fan(A, nx, 12, n_groups=8, n_buckets=2,
                                     dtype=jdt)
    top = BucketedBandedProjector.from_scipy_fan(A, nx, 12, n_groups=8,
                                                 n_buckets=2, dtype=tdt,
                                                 device="cpu")
    return A, jop, top


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _jax_bytes(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _from_jax(jop):
    return BucketedBandedProjector.from_numpy_stacks(
        [[np.asarray(a) for a in st] for st in jop.stacks], jop.aidxs,
        jop.is_cols, jop.shape, jop.nx, jop.det_count, jop.n_groups,
        jop.nnz, jop.n_pad, device="cpu")


@pytest.mark.parametrize("nx", [32, 40])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_pack_bytes_identical(nx, kind):
    _, jop, top = _pair(nx, kind)
    assert top.aidxs == jop.aidxs and top.is_cols == jop.is_cols
    assert top.n_pad == jop.n_pad == 128 and top.nnz == jop.nnz
    assert len(top.stacks) == len(jop.stacks) == 4
    for jst, tst in zip(jop.stacks, top.stacks):
        assert len(jst) == len(tst) == (4 if kind == "int8" else 3)
        for ja, ta in zip(jst, tst):
            ja = _jax_bytes(ja)
            tn = _numpy(ta)
            assert ja.dtype == tn.dtype and ja.shape == tn.shape
            assert np.array_equal(ja, tn)
    assert top.stored_bytes == jop.stored_bytes


@pytest.mark.parametrize("kind", list(DTYPES))
def test_from_numpy_stacks_round_trip(kind):
    _, jop, top = _pair(32, kind)
    rt = _from_jax(jop)
    assert rt.aidxs == top.aidxs and rt.is_cols == top.is_cols
    for rst, tst in zip(rt.stacks, top.stacks):
        for ra, ta in zip(rst, tst):
            assert ra.dtype == ta.dtype and torch.equal(ra, ta)


@pytest.mark.parametrize("nx", [32, 40])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_plain_applies_match_xla_oracle(nx, kind, rng):
    _, jop, top = _pair(nx, kind)
    x = rng.standard_normal(top.shape[1]).astype(np.float32)
    y = rng.standard_normal(top.shape[0]).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for got, ref in ((top.matvec(xt), jop.matvec(jnp.asarray(x))),
                     (top.rmatvec(yt), jop.rmatvec(jnp.asarray(y))),
                     (top.normal_matvec(xt),
                      jop.normal_matvec(jnp.asarray(x)))):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), ref) <= RTOL


@pytest.mark.parametrize("kind", list(DTYPES))
def test_adjointness(kind, rng):
    _, _, top = _pair(40, kind)
    x = torch.from_numpy(rng.standard_normal(top.shape[1]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(top.shape[0]).astype(np.float32))
    Ax, Aty = top.matvec(x), top.rmatvec(y)
    lhs = float(Ax.double() @ y.double())
    rhs = float(x.double() @ Aty.double())
    assert abs(lhs - rhs) <= 1e-5 * float(Ax.norm() * y.norm())


@pytest.mark.parametrize("kind", list(DTYPES))
def test_to_scipy_matches_jax(kind):
    A, jop, top = _pair(32, kind)
    M = top.to_scipy()
    assert (M != jop.to_scipy()).nnz == 0
    if kind == "float32":
        assert (M != A.astype(np.float64)).nnz == 0


def test_float64_input_keeps_dtype(rng):
    """The operator computes in float32 and casts back (as the JAX one)."""
    _, jop, top = _pair(32, "float32")
    x = rng.standard_normal(top.shape[1])
    got = top.matvec(torch.from_numpy(x))
    assert got.dtype == torch.float64
    ref = np.asarray(jop.matvec(jnp.asarray(x)))
    assert ref.dtype == np.float64 and _rel(got.numpy(), ref) <= RTOL


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never sent to the plain version."""
    _, _, top = _pair(32, "float32")
    W, S, P = top.stacks[0]
    X = torch.zeros((top.n_pad, top.n_pad), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bk.banded_fwd(X, W, S, P, top.n_groups)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bk.banded_ata(X, W, S, P, top.n_groups)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bk.banded_adj(torch.zeros((W.shape[0], W.shape[3]), device="meta"),
                      W, S, P, top.n_groups)
    assert all(v == 0 for v in bk.launch_counts.values())


def test_storage_dtype_refused():
    with pytest.raises(ValueError, match="storage dtype"):
        BucketedBandedProjector.from_scipy_fan(_matrix(32), 32, 12,
                                               n_groups=8, dtype=np.float64,
                                               device="cpu")
