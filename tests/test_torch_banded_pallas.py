"""trips_tpu_torch K1-K3 (plain versions on the CPU) against the Pallas
kernels of trips_tpu run in interpret mode, one bucket per kernel and
storage class, on the same packed bytes (nx = 32, 12 views, 8 line groups).

Tolerances: float32 1e-5 (the TPU kernel's bf16x3 selection is exact, so
only the order of the sums differs). bfloat16 and int8 5e-3: the TPU kernel
rounds the sheared image to bf16 before its selection matmul
(``pallas_banded_kernel.py:242-250``) while the port follows the float32
oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trips_tpu.sparse.banded_buckets import \
    BucketedBandedProjector as JaxBucketed
from trips_tpu.sparse.pallas_banded_kernel import (_adj_call, _ata_call,
                                                   _fwd_call)
from trips_tpu_torch.problems.projector import fan_beam_matrix
from trips_tpu_torch.sparse import BucketedBandedProjector
from trips_tpu_torch.sparse import banded_kernels as bk

DTYPES = {"float32": None, "bfloat16": jnp.bfloat16, "int8": "int8"}
TOL = {"float32": 1e-5, "bfloat16": 5e-3, "int8": 5e-3}


@pytest.fixture(scope="module")
def packs():
    A = fan_beam_matrix(32, views=12).astype(np.float32)
    out = {}
    for kind, dt in DTYPES.items():
        jop = JaxBucketed.from_scipy_fan(A, 32, 12, n_groups=8, n_buckets=2,
                                         dtype=dt)
        top = BucketedBandedProjector.from_numpy_stacks(
            [[np.asarray(a) for a in st] for st in jop.stacks], jop.aidxs,
            jop.is_cols, jop.shape, jop.nx, jop.det_count, jop.n_groups,
            jop.nnz, jop.n_pad, device="cpu")
        out[kind] = (jop, top)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# K2 on a row-driven bucket, K3 and K1 on column-driven (transposed) ones
@pytest.mark.parametrize("kernel,bucket", [("fwd", 0), ("adj", 3),
                                           ("ata", 2)])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_kernel_matches_pallas_interpret(packs, kind, kernel, bucket, rng):
    jop, top = packs[kind]
    assert top.is_cols[bucket] == (bucket >= 2)
    jW, jS, jP, jsc = jop._parts(jop.stacks[bucket])
    W, S, P, sc = top._parts(top.stacks[bucket])
    npd, G = top.n_pad, top.n_groups
    na, p_pad = W.shape[0], W.shape[3]
    if kernel == "adj":
        Y = rng.standard_normal((na, p_pad)).astype(np.float32)
        ref = _adj_call(jnp.asarray(Y), jW, jS, jP, G, scales=jsc,
                        interpret=True)
        got = bk.banded_adj(torch.from_numpy(Y), W, S, P, G, sc)
    else:
        X = rng.standard_normal((npd, npd)).astype(np.float32)
        call = _fwd_call if kernel == "fwd" else _ata_call
        ref = call(jnp.asarray(X), jW, jS, jP, G, scales=jsc, interpret=True)
        fn = bk.banded_fwd if kernel == "fwd" else bk.banded_ata
        got = fn(torch.from_numpy(X), W, S, P, G, sc)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL[kind]
