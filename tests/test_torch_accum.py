"""K1's and K3's fixed-point back-projection (``csrc/banded.cu``), on the
CPU: the scale (``fixed_exponent``), the packs' bounds (``abs_sums``,
``pack_bounds``) and the PyTorch emulation of the kernels' sum
(``tests/torch_fixed_point.py``: ``banded_adj_buckets_fixed``,
``banded_ata_buckets_fixed``).

- ``fixed_exponent`` on zero, huge, tiny, subnormal and non-finite inputs.
- Every pack's bounds against the true column and row abs-sums of its
  matrix (``to_scipy()``, float64), float32, bfloat16 and int8, for the
  flat, bucketed and dynamic packs and the one pack a shared-geometry
  block diagonal (the gel path) gives every frame, at nx <= 32: never
  below, and above by at most one 2^-BOUND_BITS step of the largest
  weight per term (a relative 1e-5 here).
- The fixed-point sum of float64 terms (int64 ``index_add_``) within 1e-6
  of the float64 sum and identical under a permuted term order; the
  emulations within 1e-6 of the plain versions (the gates of
  ``tests/test_torch_banded_buckets.py``); a zero input gives zeros and a
  non-finite one NaN, as does a finite X whose K1 stage-1 ``y`` overflows
  float32; a frame's K3 the same bits from the dynamic pack and from that
  frame's own pack (equal bounds whatever the packing); K1's and K3's
  bounds of one pack from one ``abs_sums`` pass, kept with the pack.
"""
import os

import numpy as np
import pytest
import torch

from trips_tpu_torch.core import BatchedBlockDiagOperator
from trips_tpu_torch.problems import (fan_beam_matrix,
                                      generate_synthetic_dynamic)
from trips_tpu_torch.sparse import (BandedProjector, BucketedBandedProjector,
                                    BucketedDynamicBandedOperator,
                                    DynamicBandedOperator)
from trips_tpu_torch.sparse import banded_kernels as bk

import torch_fixed_point as fx
from torch_threads import one_torch_thread  # noqa: F401

KINDS = {"float32": None, "bfloat16": torch.bfloat16, "int8": "int8"}
RTOL = 1e-6
NX, VIEWS = 24, 12


@pytest.fixture(scope="module", autouse=True)
def _numpy_builder():
    old = os.environ.get("TRIPS_TPU_NO_NATIVE")
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    yield
    if old is None:
        os.environ.pop("TRIPS_TPU_NO_NATIVE")
    else:
        os.environ["TRIPS_TPU_NO_NATIVE"] = old


@pytest.fixture(scope="module")
def matrix():
    return fan_beam_matrix(NX, views=VIEWS).astype(np.float32)


@pytest.fixture(scope="module")
def dynamic():
    np.random.seed(0)
    (_, _, AA, _, nx, _, nt, _, _,
     angles) = generate_synthetic_dynamic(nx=16, nt=3, views=9,
                                          return_angles=True)
    return AA, nx, nt, angles


def _pack(kind, form, matrix):
    if form == "flat":
        return BandedProjector.from_scipy_fan(matrix, NX, VIEWS, n_groups=8,
                                              dtype=KINDS[kind], device="cpu")
    return BucketedBandedProjector.from_scipy_fan(
        matrix, NX, VIEWS, n_groups=8, n_buckets=2, dtype=KINDS[kind],
        device="cpu")


def _true_sums(M):
    M = abs(M)
    return float(M.sum(axis=0).max()), float(M.sum(axis=1).max())


def _close_above(got, true):
    """The bound: never below the true sum, above it by at most 1e-5."""
    return true <= got <= true * (1 + 1e-5)


def test_fixed_exponent_edges():
    # m = bound * max|input|: the smallest a float32 pack and input give
    # is a subnormal weight times a subnormal input, 2^-298
    sub = float(np.float32(1.4e-45))
    m = torch.tensor([0.0, 1.0, 3.0, 3.4e38 * 1e4, 1e-30, sub,
                      sub * sub, float("inf"),
                      -float("inf"), float("nan")], dtype=torch.float64)
    e, state = fx.fixed_exponent(m)
    assert state.tolist() == [0] + [1] * 6 + [-1] * 3
    assert e[0] == 0 and (e[7:] == 0).all()
    live = m[1:7] * torch.pow(2.0, e[1:7].double())
    # every partial sum below 2^62: m 2^e in [2^60, 2^61)
    assert ((live >= 2.0 ** 60) & (live < 2.0 ** 61)).all()
    assert e[1] == 60 and e[2] == 59
    # tiny and subnormal m take large scales, huge m negative ones; the
    # largest, 2^359, is a double
    assert e[3] < 0 < e[4] < e[5] < e[6] <= 360


# the flat pack stores float32 or bfloat16
@pytest.mark.parametrize("form,kind", [("flat", "float32"),
                                       ("flat", "bfloat16")]
                         + [("bucketed", k) for k in KINDS])
def test_pack_bounds_static(form, kind, matrix):
    op = _pack(kind, form, matrix)
    col, row = bk.abs_sums(op._bks, op.n_groups)
    assert col.shape == row.shape == (1,) and col.dtype == torch.float64
    tc, tr = _true_sums(op.to_scipy())
    assert _close_above(float(col), tc) and _close_above(float(row), tr)
    bounds = bk.pack_bounds(op._bks, op.n_groups)
    assert torch.equal(bounds["banded_adj"], col)
    assert torch.equal(bounds["banded_ata"], col * row)


# the flat dynamic pack stores float32 or bfloat16
@pytest.mark.parametrize("form,kind", [("flat", "float32"),
                                       ("flat", "bfloat16")]
                         + [("bucketed", k) for k in KINDS])
def test_pack_bounds_dynamic(form, kind, dynamic):
    """Per frame, against the abs-sums of that frame's matrix as its own
    bucketed pack of the same storage stores it (``to_scipy()``)."""
    AA, nx, nt, angles = dynamic
    cls = (DynamicBandedOperator if form == "flat"
           else BucketedDynamicBandedOperator)
    extra = {} if form == "flat" else {"n_buckets": 2}
    op = cls.from_frames(AA, nx, angles, n_groups=8, dtype=KINDS[kind],
                         device="cpu", **extra)
    col, row = bk.abs_sums(op._bks, op.n_groups)
    assert col.shape == row.shape == (nt,)
    for f in range(nt):
        M = BucketedBandedProjector.from_scipy_fan(
            AA[f], nx, None, angles=angles[f], n_groups=8,
            dtype=KINDS[kind], device="cpu").to_scipy()
        tc, tr = _true_sums(M)
        assert _close_above(float(col[f]), tc), f
        assert _close_above(float(row[f]), tr), f


def test_pack_bounds_shared(matrix):
    """A block diagonal's one pack serves every frame: one bound (the
    kernels' frame stride 0), that pack's."""
    op = _pack("float32", "bucketed", matrix)
    blk = BatchedBlockDiagOperator(op, 3)
    col, row = bk.abs_sums(blk.op._bks, op.n_groups)
    tc, tr = _true_sums(op.to_scipy())
    assert col.shape == (1,) and _close_above(float(col), tc)
    rng = np.random.default_rng(3)
    rows = op.shape[0] // op.det_count
    Y = torch.tensor(rng.standard_normal((3, rows, op.det_count)),
                     dtype=torch.float32)
    got = fx.banded_adj_buckets_fixed(Y, op._bks, op._aidx, op.n_groups)
    for f in range(3):
        assert torch.equal(got[f], fx.banded_adj_buckets_fixed(
            Y[f], op._bks, op._aidx, op.n_groups))


def test_fixed_sum_exact_and_order_free():
    rng = np.random.default_rng(4)
    terms = torch.tensor(rng.standard_normal(20000)
                         * 10.0 ** rng.uniform(-6, 2, 20000))
    index = torch.tensor(rng.integers(0, 64, 20000))
    want = torch.zeros(64, dtype=torch.float64).index_add_(0, index, terms)
    m = torch.zeros(64, dtype=torch.float64).index_add_(
        0, index, terms.abs()).max()
    e, state = fx.fixed_exponent(m)
    got = fx.fixed_sum(terms, index, 64, e, state)
    assert float((got.double() - want).norm() / want.norm()) <= RTOL
    perm = torch.from_numpy(rng.permutation(20000))
    assert torch.equal(got, fx.fixed_sum(terms[perm], index[perm], 64, e,
                                          state))
    # one term at a time in reverse: the same bits
    acc = torch.zeros(64, dtype=torch.int64)
    q = torch.round(terms * 2.0 ** int(e)).long()
    for k in range(19999, -1, -1000):
        sl = slice(max(0, k - 999), k + 1)
        acc.index_add_(0, index[sl], q[sl])
    assert torch.equal(got, (acc.double() * 2.0 ** -int(e)).float())


@pytest.mark.parametrize("kind", list(KINDS))
def test_emulation_matches_plain(kind, matrix):
    op = _pack(kind, "bucketed", matrix)
    rng = np.random.default_rng(5)
    rows, p = op.shape[0] // op.det_count, op.det_count
    Y = torch.tensor(rng.standard_normal((rows, p)), dtype=torch.float32)
    X = torch.tensor(rng.standard_normal((op.n_pad, op.n_pad)),
                     dtype=torch.float32)
    XT = X.T.contiguous()
    for got, ref in (
            (fx.banded_adj_buckets_fixed(Y, op._bks, op._aidx, op.n_groups),
             bk.banded_adj_buckets_ref(Y, op._bks, op._aidx, op.n_groups)),
            (fx.banded_ata_buckets_fixed(X, XT, op._bks, op.n_groups),
             bk.banded_ata_buckets_ref(X, XT, op._bks, op.n_groups))):
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert float((got - ref).norm() / ref.norm()) <= RTOL
    # zero in, zeros out; a NaN or an inf in, NaN out (never zeros)
    z = fx.banded_adj_buckets_fixed(torch.zeros_like(Y), op._bks, op._aidx,
                                    op.n_groups)
    assert torch.equal(z, torch.zeros_like(z))
    for bad in (float("nan"), float("inf")):
        Yb = Y.clone()
        Yb[0, 0] = bad
        assert torch.isnan(fx.banded_adj_buckets_fixed(
            Yb, op._bks, op._aidx, op.n_groups)).all()
        Xb = X.clone()
        Xb[1, 2] = bad
        assert torch.isnan(fx.banded_ata_buckets_fixed(
            Xb, Xb.T.contiguous(), op._bks, op.n_groups)).all()


def test_emulation_frames_and_packings(dynamic):
    """Over frames of the dynamic pack within 1e-6 of the plain version,
    and frame t's image the same bits as from frame t's own bucketed pack:
    the same terms at the same scale, whatever the packing."""
    AA, nx, nt, angles = dynamic
    op = DynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8,
                                           device="cpu")
    rng = np.random.default_rng(6)
    Y = torch.tensor(rng.standard_normal((nt, op.views, op.det_count)),
                     dtype=torch.float32)
    got = fx.banded_adj_buckets_fixed(Y, op._bks, op._aidx, op.n_groups)
    ref = bk.banded_adj_buckets_ref(Y, op._bks, op._aidx, op.n_groups)
    assert float((got - ref).norm() / ref.norm()) <= RTOL
    X = torch.tensor(rng.standard_normal((nt, op.n_pad, op.n_pad)),
                     dtype=torch.float32)
    XT = X.transpose(1, 2).contiguous()
    a = fx.banded_ata_buckets_fixed(X, XT, op._bks, op.n_groups)
    r = bk.banded_ata_buckets_ref(X, XT, op._bks, op.n_groups)
    assert float((a - r).norm() / r.norm()) <= RTOL
    for t in range(nt):
        fop = BucketedBandedProjector.from_scipy_fan(
            AA[t], nx, None, angles=angles[t], n_groups=8, device="cpu")
        assert fop.n_pad == op.n_pad
        Yt = torch.zeros((fop.shape[0] // fop.det_count, fop.det_count))
        Yt[:, :op.det_count] = Y[t, :Yt.shape[0], :fop.det_count]
        assert fop.det_count == op.det_count
        one = fx.banded_adj_buckets_fixed(Yt, fop._bks, fop._aidx,
                                          fop.n_groups)
        assert torch.equal(bk.pack_bounds(fop._bks, 8)["banded_adj"],
                           bk.pack_bounds(op._bks, 8)["banded_adj"][t:t + 1])
        assert torch.equal(one, got[t]), t


def test_stage1_overflow_gives_nan(matrix):
    """A finite X whose stage-1 ``y`` overflows float32 (its entries near
    FLT_MAX; the bound times max|X| stays finite in float64): K1's image is
    NaN, as the plain version's is not finite, never a wrapped integer
    sum."""
    op = _pack("float32", "bucketed", matrix)
    X = torch.full((op.n_pad, op.n_pad), 3e38)
    XT = X.T.contiguous()
    bound = bk.pack_bounds(op._bks, op.n_groups)["banded_ata"]
    assert torch.isfinite(bound * 3e38).all()
    ref = bk.banded_ata_buckets_ref(X, XT, op._bks, op.n_groups)
    assert not torch.isfinite(ref).all()
    assert torch.isnan(fx.banded_ata_buckets_fixed(
        X, XT, op._bks, op.n_groups)).all()


def test_bounds_one_pass_per_pack(matrix, monkeypatch):
    """``_prepare`` makes K1's and K3's bounds of one pack from a single
    ``abs_sums`` pass and keeps them while the pack's tensors live; K1's
    tap spans likewise from one ``pack_spans`` pass."""
    op = _pack("float32", "bucketed", matrix)
    calls, span_calls = [], []
    true_sums, true_spans = bk.abs_sums, bk.pack_spans
    monkeypatch.setattr(bk, "abs_sums",
                        lambda *a: calls.append(1) or true_sums(*a))
    monkeypatch.setattr(bk, "pack_spans",
                        lambda *a: span_calls.append(1) or true_spans(*a))
    monkeypatch.setattr(bk, "prepare",
                        lambda name, inp, b, ids, g, bound, spans=None:
                        (name, bound, spans))
    bk.clear_plans()
    X = torch.zeros((op.n_pad, op.n_pad))
    got = {name: bk._prepare(name, X, op._bks, ids, op.n_groups)
           for name, ids in (("banded_adj", op._aidx), ("banded_ata", None),
                             ("banded_fwd", op._aidx))}
    assert len(calls) == 1 and got["banded_fwd"][1] is None
    want = true_sums(op._bks, op.n_groups)
    assert torch.equal(got["banded_adj"][1], want[0])
    assert torch.equal(got["banded_ata"][1], want[0] * want[1])
    assert len(span_calls) == 1
    assert got["banded_adj"][2] is None and got["banded_fwd"][2] is None
    assert all(torch.equal(a, b) for a, b in zip(
        got["banded_ata"][2], true_spans(op._bks)))
    bk._prepare("banded_adj", X, op._bks, op._aidx, op.n_groups)
    bk._prepare("banded_ata", X, op._bks, None, op.n_groups)
    assert len(calls) == 1 and len(span_calls) == 1
    bk.clear_plans()
