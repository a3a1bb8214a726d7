"""``sparse.tall_qr``: the plain R-only tall-skinny QR (the CUDA kernel's
arithmetic and order on the CPU) in float64 against LAPACK's QR
(``torch.linalg.qr``): R^T R to 1e-12 of the Gram matrix, R itself up to
the sign of each row where the panel has full column rank (1e-12: both
are Householder QRs, backward stable). MMGKS's read-out of R of the
augmented panel ``[X | c1 | c2]`` against the formulas with Q. Panels
wider than the kernel takes go to LAPACK on the CPU as on the card. The
kernel's own tests are in ``tests/test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest
import torch

from trips_tpu_torch.sparse import tall_qr
from trips_tpu_torch.sparse.tall_qr import plan, tall_r, tall_r_ref

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-12


def _panel(m, k, seed, weighted):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g, dtype=torch.float64)
    w = (torch.rand(m, generator=g, dtype=torch.float64) + 0.25
         if weighted else None)
    return x, w


def _gram_gap(R, X):
    G = X.T @ X
    return float((R.T @ R - G).norm() / max(float(G.norm()), 1e-300))


def _signed_gap(R, Rl):
    """||D R - Rl|| / ||Rl|| with D the signs that match the diagonals."""
    d = torch.sign(torch.diagonal(R) * torch.diagonal(Rl))
    return float((d[:, None] * R - Rl).norm() / Rl.norm())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m,k", [(100, 1), (3000, 1), (100, 4), (2500, 4),
                                 (3000, 23), (9000, 25), (300, 64),
                                 (300, 130)])
def test_matches_lapack(m, k, weighted):
    x, w = _panel(m, k, m + k, weighted)
    X = x if w is None else x * w[:, None]
    R = tall_r(x, w)
    assert R.shape == (k, k) and R.dtype == torch.float64
    assert torch.equal(R, R.triu())
    assert _gram_gap(R, X) <= TOL
    assert _signed_gap(R, torch.linalg.qr(X, mode="r")[1]) <= TOL


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m,k", [(1, 1), (1, 5), (7, 3), (20, 23), (127, 4),
                                 (129, 4)])
def test_short_panels(m, k, weighted):
    """Fewer rows than a tile, and fewer than columns: R is (k, k), its
    rows past m zero to rounding (the panel's rank is m), its first
    min(m, k) rows LAPACK's up to signs."""
    x, w = _panel(m, k, 7 * m + k, weighted)
    X = x if w is None else x * w[:, None]
    R = tall_r(x, w)
    assert R.shape == (k, k) and torch.equal(R, R.triu())
    assert _gram_gap(R, X) <= TOL
    r = min(m, k)
    assert float(R[r:].norm()) <= TOL * float(R.norm())
    Rl = torch.linalg.qr(X, mode="r")[1]
    if m >= k:
        assert _signed_gap(R, Rl) <= TOL
    else:  # a wide block: the rows agree where the leading block is square
        assert _signed_gap(R[:r, :r], Rl[:, :r]) <= TOL


@pytest.mark.parametrize("col", [0, 5, 11])
def test_zero_column(col):
    """A zero column gives tau = 0 (LAPACK larfg): R's column is zero on
    and above the diagonal, and R^T R is still the Gram matrix."""
    x, w = _panel(4000, 12, col, True)
    x[:, col] = 0
    R = tall_r(x, w)
    assert torch.all(R[:, col] == 0)
    assert _gram_gap(R, x * w[:, None]) <= TOL


@pytest.mark.parametrize("rank", [1, 3, 9])
def test_rank_deficient(rank):
    g = torch.Generator().manual_seed(rank)
    B = torch.randn(5000, rank, generator=g, dtype=torch.float64)
    x = B @ torch.randn(rank, 10, generator=g, dtype=torch.float64)
    R = tall_r(x)
    assert _gram_gap(R, x) <= TOL
    s = torch.linalg.svdvals(R)
    assert float(s[rank:].max()) <= 1e-12 * float(s[0])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m,k", [(129, 170), (400, 129), (2000, 170)])
def test_wide_panels_take_the_library(m, k, weighted):
    """Wider than MAX_K on the CPU as on the card: LAPACK's R (rows past m
    zero), counted as ``qr_library``; the kernel's plan refuses the width."""
    x, w = _panel(m, k, m + k, weighted)
    X = x if w is None else x * w[:, None]
    before = dict(tall_qr.launch_counts)
    R = tall_r(x, w)
    assert tall_qr.launch_counts == dict(
        before, qr_library=before["qr_library"] + 1)
    assert R.shape == (k, k) and torch.equal(R, R.triu())
    assert _gram_gap(R, X) <= TOL
    r = min(m, k)
    assert torch.equal(R[:r], torch.linalg.qr(X, mode="r")[1])
    assert torch.all(R[r:] == 0)
    with pytest.raises(ValueError):
        plan(m, k, 8)


def test_mmgks_past_the_kernels_width():
    """Host MMGKS in float64 with panels wider than MAX_K (projection_dim
    166: the data panel has 168 to 170 columns, the regularizer's 166 to
    168) runs on the CPU, each panel by the library route."""
    import trips_tpu_torch.operators as to
    import trips_tpu_torch.solvers as ts
    from trips_tpu_torch.core import DenseOperator

    n, m = 200, 320
    g = torch.Generator().manual_seed(7)
    U = torch.linalg.qr(torch.randn(m, n, generator=g,
                                    dtype=torch.float64))[0]
    V = torch.linalg.qr(torch.randn(n, n, generator=g,
                                    dtype=torch.float64))[0]
    A = U @ torch.diag(torch.logspace(0, -3, n, dtype=torch.float64)) @ V.T
    b = A @ torch.sin(torch.linspace(0, 3, n, dtype=torch.float64))
    e = torch.randn(m, generator=g, dtype=torch.float64)
    e *= 0.01 * b.norm() / e.norm()
    tall_qr.reset_launch_counts()
    x, info = ts.MMGKS(DenseOperator(A), b + e,
                       to.FirstDerivative1D(n, device="cpu"), pnorm=2,
                       qnorm=1, projection_dim=166, n_iter=3, regparam="dp",
                       delta=float(e.norm()))
    assert tall_qr.launch_counts == {"tsqr_geqrf": 0, "qr_library": 6}
    assert len(info["xHistory"]) == 3 and bool(torch.isfinite(x).all())
    assert all(lam > 0 for lam in info["regParam_history"])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m,k", [(500, 4), (4000, 23), (2000, 168)])
def test_augmented_readout(m, k, weighted):
    """R of [wf X | wf b | b] against Q-based values (Q from LAPACK's QR of
    wf X, R_A = Q^T wf X): R_A, Q^T (wf b), ||wf b - Q Q^T wf b||^2 and
    Q^T b, the rows of the first, second and fourth up to one shared
    sign each."""
    x, wf = _panel(m, k, 3 * m + k, weighted)
    g = torch.Generator().manual_seed(m)
    b = torch.randn(m, generator=g, dtype=torch.float64)
    wf = torch.ones(m, dtype=torch.float64) if wf is None else wf
    R = tall_r(torch.cat([x * wf[:, None], (wf * b)[:, None], b[:, None]],
                         dim=1))
    Q, RA = torch.linalg.qr(x * wf[:, None])
    wb = wf * b
    bproj = Q.T @ wb
    out_norm2 = float((wb - Q @ bproj).norm() ** 2)
    d = torch.sign(torch.diagonal(R)[:k] * torch.diagonal(RA))
    assert float((d[:, None] * R[:k, :k] - RA).norm() / RA.norm()) <= TOL
    assert float((d * R[:k, k] - bproj).norm() / bproj.norm()) <= TOL
    assert abs(float(R[k, k]) ** 2 - out_norm2) <= TOL * out_norm2
    bsolve = Q.T @ b
    assert float((d * R[:k, k + 1] - bsolve).norm() / bsolve.norm()) <= TOL


@pytest.mark.parametrize("m,k,itemsize", [
    (1, 1, 4), (100, 4, 4), (71610, 25, 4), (1622016, 23, 4),
    (1622016, 23, 8), (5000, 64, 8), (10 ** 6, 128, 8), (10, 128, 4),
    (10 ** 6, 1, 8)])
def test_plan(m, k, itemsize):
    """Every row in exactly one block, whole tiles, shared memory within a
    block's, one block per SM at most."""
    p = plan(m, k, itemsize)
    assert 1 <= p.tile_rows <= tall_qr.FOLD_ROWS
    assert 1 <= p.warps <= tall_qr.MAX_WARPS
    assert p.rows_per_block % p.tile_rows == 0
    assert p.blocks * p.rows_per_block >= m > (p.blocks - 1) * p.rows_per_block
    assert 1 <= p.blocks <= tall_qr.N_SM
    assert (p.warps * (k + p.tile_rows) * (k | 1) * itemsize
            <= tall_qr.SMEM_BYTES)


@pytest.mark.parametrize("n_sm", [1, 7, 132])
def test_plans_agree(n_sm):
    """The leaves and tree differ with the SM count; R does not, beyond
    rounding."""
    x, w = _panel(5000, 17, n_sm, True)
    R = tall_r_ref(x, w, n_sm=n_sm)
    Rl = torch.linalg.qr(x * w[:, None], mode="r")[1]
    assert _signed_gap(R, Rl) <= TOL


def test_float32():
    """Float32 on the same arithmetic: within float32 rounding of the
    float64 R (the panel is well conditioned) up to row signs, which
    follow the plan, and the plan follows the element size."""
    x, w = _panel(6000, 23, 5, True)
    R32 = tall_r(x.float(), w.float())
    R64 = tall_r(x, w)
    assert R32.dtype == torch.float32
    assert _signed_gap(R32.double(), R64) <= 1e-5


def test_out_and_checks():
    x, w = _panel(600, 6, 1, True)
    out = torch.empty(6, 6, dtype=torch.float64)
    assert tall_r(x, w, out=out) is out
    assert torch.equal(out, tall_r(x, w))
    assert torch.equal(tall_r(x.new_empty(0, 6)), torch.zeros(6, 6,
                                                            dtype=x.dtype))
    with pytest.raises(ValueError):
        tall_r(x[:, 0])
    with pytest.raises(ValueError):
        tall_r(x, w[:-1])
    with pytest.raises(ValueError):
        tall_r(x, w.float())
    with pytest.raises(ValueError):
        tall_r(x, out=torch.empty(6, 5, dtype=torch.float64))
    before = dict(tall_qr.launch_counts)
    tall_r(x)
    assert tall_qr.launch_counts == before  # the CPU launches nothing


def test_weights_as_rows():
    """Weights act as a row scaling: diag(w) x through w, or scaled first,
    give the same R to rounding; a weight of zero drops its row."""
    x, w = _panel(3000, 9, 2, True)
    w[::3] = 0
    R = tall_r(x, w)
    keep = w != 0
    Rk = tall_r(x[keep] * w[keep, None])
    assert _signed_gap(R, Rk) <= TOL
    assert math.isclose(float(torch.linalg.det(R).abs()),
                        float(torch.linalg.det(Rk).abs()), rel_tol=1e-10)
    assert np.isfinite(R.numpy()).all()
