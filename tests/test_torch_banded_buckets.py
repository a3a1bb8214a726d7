"""K2 and K3 over all buckets of a pack (the operator's one-launch path) on
the CPU: their plain versions against trips_tpu's bucketed operator.

``banded_fwd_buckets_ref`` and ``banded_adj_buckets_ref`` take every bucket
of the pack at once, with its angle ids and its drive flag (the ``cols``
buckets run on the transposed image), as ``banded_fwd_buckets`` and
``banded_adj_buckets`` do on the card. They are held against
``trips_tpu``'s ``BucketedBandedProjector.matvec`` and ``rmatvec`` (its XLA
oracle on the CPU) on the same packed bytes: nx = 32 and 40, 12 views, 8
line groups, 2 buckets per drive orientation, the matrix from the JAX
package's NumPy builder (``TRIPS_TPU_NO_NATIVE=1``).

Tolerance: 1e-6 of the norm in every storage class. Both packages
dequantize the same stored bfloat16 or int8 bytes to the same float32
weights (``dequant_slab``) and apply them in float32, so only the order of
the float32 sums differs, in all three classes alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trips_tpu.problems as jp
from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu_torch.sparse import BucketedBandedProjector
from trips_tpu_torch.sparse import banded_kernels as bk

from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": None, "bfloat16": jnp.bfloat16, "int8": "int8"}
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _numpy_builder(monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")


def _pair(nx, kind):
    A = jp.fan_beam_matrix(nx, views=12).astype(np.float32)
    jop = JaxBucketed.from_scipy_fan(A, nx, 12, n_groups=8, n_buckets=2,
                                     dtype=DTYPES[kind])
    top = BucketedBandedProjector.from_numpy_stacks(
        [[np.asarray(a) for a in st] for st in jop.stacks], jop.aidxs,
        jop.is_cols, jop.shape, jop.nx, jop.det_count, jop.n_groups,
        jop.nnz, jop.n_pad, device="cpu")
    return jop, top


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _buckets(top):
    """The wrappers' arguments for every bucket of ``top``'s pack."""
    bks = [(*top._parts(st), isc) for st, isc in zip(top.stacks,
                                                     top.is_cols)]
    ids = [torch.tensor(ai, dtype=torch.int32) for ai in top.aidxs]
    return bks, ids


@pytest.mark.parametrize("nx", [32, 40])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_buckets_ref_match_jax_operator(nx, kind, rng):
    jop, top = _pair(nx, kind)
    bks, ids = _buckets(top)
    # the pack has both drive orientations and interleaved angle ids
    assert any(b[4] for b in bks) and not all(b[4] for b in bks)
    assert any(list(ai) != sorted(ai) or ai[0] != 0 for ai in top.aidxs)
    n, npd, p = top.nx, top.n_pad, top.det_count
    x = rng.standard_normal(n * n).astype(np.float32)
    y = rng.standard_normal(top.shape[0]).astype(np.float32)
    X = torch.zeros((npd, npd))
    X[:n, :n] = torch.from_numpy(x).reshape(n, n)
    got = bk.banded_fwd_buckets_ref(X, X.T.contiguous(), bks, ids, p,
                                    top.n_groups)
    assert got.shape == (top.shape[0] // p, p) and got.dtype == torch.float32
    ref = np.asarray(jop.matvec(jnp.asarray(x)))
    assert _rel(got.reshape(-1).numpy(), ref) <= RTOL
    img = bk.banded_adj_buckets_ref(torch.from_numpy(y).reshape(-1, p), bks,
                                    ids, top.n_groups)
    assert img.shape == (npd, npd) and img.dtype == torch.float32
    ref = np.asarray(jop.rmatvec(jnp.asarray(y)))
    assert _rel(img[:n, :n].reshape(-1).numpy(), ref) <= RTOL


@pytest.mark.parametrize("kind", list(DTYPES))
def test_operator_calls_each_wrapper_once_per_apply(kind, rng):
    """matvec and rmatvec hand every bucket to one wrapper call (one
    launch on the card); no per-bucket scatter, gather, pad or transposed
    add is left around them."""
    _, top = _pair(40, kind)
    calls = {"fwd": 0, "adj": 0}

    def count(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    top._fwd = count("fwd", bk.banded_fwd_buckets)
    top._adj = count("adj", bk.banded_adj_buckets)
    x = torch.from_numpy(rng.standard_normal(top.shape[1]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(top.shape[0]).astype(np.float32))
    Ax, Aty = top.matvec(x), top.rmatvec(y)
    assert calls == {"fwd": 1, "adj": 1}
    assert Ax.shape == (top.shape[0],) and Aty.shape == (top.shape[1],)
    # the one call sees every bucket
    assert len(top._bks) == len(top.stacks) == 4


def test_operator_refuses_angle_ids_that_miss_a_row():
    _, top = _pair(32, "float32")
    aidxs = [list(ai) for ai in top.aidxs]
    aidxs[0][0] = aidxs[1][0]  # one angle twice, another never
    with pytest.raises(ValueError, match="angle ids"):
        BucketedBandedProjector(top.stacks, aidxs, top.is_cols, top.shape,
                                top.nx, top.det_count, top.n_groups,
                                top.nnz, top.n_pad, device="cpu")
