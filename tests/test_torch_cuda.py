"""K1-K6 and the operators on a CUDA card against their plain versions
and the CPU (marked ``cuda``).

Without a card every test here skips. On a card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Float32 sums run in another order, so the kernels agree with the plain
versions to 1e-5 of the norm; K2, K4 and K5 sum in a fixed order and K1
and K3 back-project in fixed point (integer atomics), so all five give
the same bits from run to run, K1 and K3 those of their PyTorch
emulation (``tests/torch_fixed_point.py``). A
bfloat16 output (K4's canvases, K6's U before its second product) may
round an entry one bf16 step the other way: 1e-3 there. K6's float32 path
sums 3xTF32 products (each within 2^-22 of the float32 product), also held
to 1e-5. The loops (CGLS, LSQR, the fused solvers' searches) replayed as
CUDA graphs give the eager loops' x, k and lambdas to the bit, with the
same launch counts; a capture that fails raises; the graph pool does not
grow; the profiler records a replay's kernels.
"""
import numpy as np
import pytest
import torch

from trips_tpu_torch.operators import (OnTheFlyFanProjector,
                                       OnTheFlyParallelProjector,
                                       ShearFanProjector,
                                       ShearStackParallelProjector)
from trips_tpu_torch.operators import shear_kernels as sk
from trips_tpu_torch.problems.projector import fan_beam_matrix
from trips_tpu_torch.sparse import BucketedBandedProjector
from trips_tpu_torch.sparse import banded_kernels as bk

import torch_fixed_point as fx

pytestmark = pytest.mark.cuda
KINDS = [None, torch.bfloat16, "int8"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _op(device, dtype, nx=40):
    A = fan_beam_matrix(nx, views=12).astype(np.float32)
    return BucketedBandedProjector.from_scipy_fan(
        A, nx, 12, n_groups=8, n_buckets=2, dtype=dtype, device=device)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("dtype", KINDS)
def test_kernels_match_plain(cuda, dtype):
    op = _op(cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    for stack in op.stacks:
        W, S, P, sc = op._parts(stack)
        X = torch.randn(op.n_pad, op.n_pad, device=cuda, generator=g)
        Y = torch.randn(W.shape[0], W.shape[3], device=cuda, generator=g)
        before = dict(bk.launch_counts)
        for name, inp in (("banded_fwd", X), ("banded_adj", Y),
                          ("banded_ata", X)):
            got = getattr(bk, name)(inp, W, S, P, op.n_groups, sc)
            ref = getattr(bk, name + "_ref")(inp, W, S, P, op.n_groups, sc)
            assert got.device.type == "cuda"
            assert _rel(got, ref) <= 1e-5, name
        assert all(bk.launch_counts[k] == before[k] + 1 for k in before)


@pytest.mark.parametrize("dtype", KINDS)
def test_operator_matches_cpu(cuda, dtype):
    gpu, cpu = _op(cuda, dtype), _op("cpu", dtype)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(cpu.shape[1]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(cpu.shape[0]).astype(np.float32))
    for fn, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        got = getattr(gpu, fn)(v.to(cuda)).cpu()
        assert _rel(got, getattr(cpu, fn)(v)) <= 1e-5, fn


def test_wrapper_checks_inputs(cuda):
    op = _op(cuda, None)
    W, S, P = op.stacks[0]
    X = torch.zeros(op.n_pad, op.n_pad, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bk.banded_fwd(X.T, W, S, P, op.n_groups)
    with pytest.raises(TypeError, match="float32"):
        bk.banded_fwd(X.double(), W, S, P, op.n_groups)
    with pytest.raises(ValueError, match="scales"):
        bk.banded_ata(X, W, S, P, op.n_groups,
                      torch.ones(W.shape[0], device=cuda))


G_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("g_dtype", G_DTYPES)
@pytest.mark.parametrize("nx", [32, 64])
def test_shear_kernels_match_plain(cuda, nx, g_dtype):
    op = ShearFanProjector(nx, views=12, g_dtype=g_dtype, device=cuda)
    C, na, sh = op._C, op.n_angles, op._shifts()
    g = torch.Generator(device=cuda).manual_seed(0)
    Q = torch.randn(3, C, C, device=cuda, generator=g)
    Gc = torch.randn(na, C, C, device=cuda, generator=g).to(g_dtype)
    R = torch.randn(na, C, C, device=cuda, generator=g).to(g_dtype)
    before = dict(sk.launch_counts)
    tol = 1e-5 if g_dtype == torch.float32 else 1e-3
    for name, args, kw, gate in (
            ("shear_rotate", (Q, *sh), {"out_dtype": g_dtype}, tol),
            ("shear_rotate_adjoint", (Gc, *sh), {}, 1e-5),
            ("gcontract_ata", (R, op.G), {}, tol)):
        got = getattr(sk, name)(*args, **kw)
        ref = getattr(sk, name + "_ref")(*args, **kw)
        assert got.device.type == "cuda" and got.dtype == ref.dtype
        assert _rel(got.float(), ref.float()) <= gate, name
    assert all(sk.launch_counts[k] == before[k] + 1 for k in before)


@pytest.fixture
def fresh_plans():
    """K4/K5 plans made anew in the test and forgotten after it."""
    sk.clear_plans()
    yield
    sk.clear_plans()


def _rotate_inputs(cuda, nx, views, seed):
    """K4/K5 inputs at the projector's shapes: its shifts, each k moved by a
    random multiple of C (beyond +-C; the same shear mod C), views shuffled
    so that ``kq`` is not grouped by quarter; random quarters and
    cotangents."""
    op = ShearFanProjector(nx, views=views, device=cuda)
    C, na = op._C, op.n_angles
    rng = np.random.default_rng(seed)
    perm = torch.from_numpy(rng.permutation(na)).to(cuda)
    kx, fx, ky, fy, kq = (t[perm].contiguous() for t in op._shifts())
    kx = kx + C * torch.from_numpy(rng.integers(-3, 4, (na, C))).to(cuda,
                                                                  torch.int32)
    ky = ky - C * torch.from_numpy(rng.integers(-3, 4, (na, C))).to(cuda,
                                                                  torch.int32)
    g = torch.Generator(device=cuda).manual_seed(seed)
    Q = torch.randn(3, C, C, device=cuda, generator=g)
    Gc = torch.randn(na, C, C, device=cuda, generator=g)
    return Q, Gc, (kx, fx, ky, fy, kq)


@pytest.mark.parametrize("dtype", G_DTYPES)
@pytest.mark.parametrize("nx,views", [(32, 12), (64, 12), (256, 60)])
def test_shear_rotate_staged_tile(cuda, fresh_plans, nx, views, dtype):
    """K4 and K5 against their plain versions (C = 64, 96 and 400, none a
    multiple of every tile), bitwise the same from run to run, one launch
    each; K4's output and K5's input in ``dtype``."""
    Q, Gc, sh = _rotate_inputs(cuda, nx, views, nx)
    Gc = Gc.to(dtype)
    before = dict(sk.launch_counts)
    r = sk.shear_rotate(Q, *sh, out_dtype=dtype)
    q = sk.shear_rotate_adjoint(Gc, *sh)
    assert sk.launch_counts["shear_rotate"] == before["shear_rotate"] + 1
    assert (sk.launch_counts["shear_rotate_adjoint"]
            == before["shear_rotate_adjoint"] + 1)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    ref = sk.shear_rotate_ref(Q, *sh, out_dtype=dtype)
    assert r.dtype == dtype and _rel(r.float(), ref.float()) <= tol
    assert _rel(q, sk.shear_rotate_adjoint_ref(Gc, *sh)) <= 1e-5
    assert torch.equal(r, sk.shear_rotate(Q, *sh, out_dtype=dtype))
    assert torch.equal(q, sk.shear_rotate_adjoint(Gc, *sh))


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("tile", sk.TILES)
def test_shear_rotate_every_tile(cuda, fresh_plans, monkeypatch, tile, chunk):
    """Each tile shape of the sweep, and K5 in whole quarters and in chunks
    of 8 views (partials summed by the second pass), at C = 96, 30 views,
    one quarter holding no view."""
    plans = {k: {b: {"tile": tile, "chunk": chunk} for b in (4, 2)}
             for k in sk.PLANS}
    monkeypatch.setattr(sk, "PLANS", plans)
    Q, Gc, (kx, fx, ky, fy, kq) = _rotate_inputs(cuda, 64, 30, 7)
    kq = torch.where(kq == 2, torch.ones_like(kq), kq)
    sh = (kx, fx, ky, fy, kq)
    for dtype in G_DTYPES:
        r = sk.shear_rotate(Q, *sh, out_dtype=dtype)
        ref = sk.shear_rotate_ref(Q, *sh, out_dtype=dtype)
        assert _rel(r.float(), ref.float()) <= (
            1e-5 if dtype == torch.float32 else 1e-3), dtype
        q = sk.shear_rotate_adjoint(Gc.to(dtype), *sh)
        assert _rel(q, sk.shear_rotate_adjoint_ref(Gc.to(dtype), *sh)) <= 1e-5
        assert not q[2].any()


def test_shear_rotate_adjointness(cuda, fresh_plans):
    """<K4 q, g> = <q, K5 g> in float32 at C = 400, 60 views."""
    Q, Gc, sh = _rotate_inputs(cuda, 256, 60, 3)
    lhs = float((sk.shear_rotate(Q, *sh).double() * Gc.double()).sum())
    rhs = float((Q.double() * sk.shear_rotate_adjoint(Gc, *sh).double())
                .sum())
    scale = float(sk.shear_rotate(Q, *sh).double().norm() * Gc.double().norm())
    assert abs(lhs - rhs) <= 1e-5 * scale


@pytest.mark.parametrize("name", ["shear_rotate", "shear_rotate_adjoint"])
def test_shear_rotate_refused_plan_raises(cuda, fresh_plans, monkeypatch,
                                          name):
    """A plan whose window is narrower than a tile is refused by the kernel;
    nothing falls back to the plain version."""
    true_plan = sk.rotate_plan

    def bad_plan(*args, **kw):
        pl = true_plan(*args, **kw)
        return {**pl, "w2": pl["tile"][1]}

    monkeypatch.setattr(sk, "rotate_plan", bad_plan)
    Q, Gc, sh = _rotate_inputs(cuda, 32, 8, 0)
    before = dict(sk.launch_counts)
    with pytest.raises(RuntimeError, match=f"{name} launch failed"):
        if name == "shear_rotate":
            sk.shear_rotate(Q, *sh)
        else:
            sk.shear_rotate_adjoint(Gc, *sh)
    assert sk.launch_counts == before


@pytest.mark.parametrize("ata", ["0", "1"])
@pytest.mark.parametrize("g_dtype", G_DTYPES)
def test_shear_operator_matches_cpu(cuda, g_dtype, ata, monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_SHEAR_ATA", ata)
    gpu = ShearFanProjector(48, views=10, g_dtype=g_dtype, device=cuda)
    cpu = gpu.to("cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(cpu.shape[1]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(cpu.shape[0]).astype(np.float32))
    tol = 1e-5 if g_dtype == torch.float32 else 1e-3
    for fn, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        got = getattr(gpu, fn)(v.to(cuda)).cpu()
        assert _rel(got, getattr(cpu, fn)(v)) <= tol, fn


@pytest.mark.parametrize("name", ["OnTheFlyParallelProjector",
                                  "OnTheFlyFanProjector",
                                  "ShearStackParallelProjector"])
def test_plain_projectors_match_cpu(cuda, name):
    cls = {"OnTheFlyParallelProjector": OnTheFlyParallelProjector,
           "OnTheFlyFanProjector": OnTheFlyFanProjector,
           "ShearStackParallelProjector": ShearStackParallelProjector}[name]
    angles = np.linspace(0, np.pi, 10, endpoint=False) + 0.0123
    gpu, cpu = cls(40, angles, device=cuda), cls(40, angles, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(cpu.shape[1]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(cpu.shape[0]).astype(np.float32))
    for fn, v in (("matvec", x), ("rmatvec", y)):
        got = getattr(gpu, fn)(v.to(cuda))
        assert got.device.type == "cuda"
        assert _rel(got.cpu(), getattr(cpu, fn)(v)) <= 1e-5, fn


def test_shear_wrappers_check_inputs(cuda):
    op = ShearFanProjector(32, views=8, device=cuda)
    C, na = op._C, op.n_angles
    kx, fx, ky, fy, kq = op._shifts()
    Q = torch.zeros(3, C, C, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sk.shear_rotate(Q.transpose(1, 2), kx, fx, ky, fy, kq)
    with pytest.raises(TypeError, match="float32"):
        sk.shear_rotate(Q.double(), kx, fx, ky, fy, kq)
    with pytest.raises(TypeError, match="out_dtype"):
        sk.shear_rotate(Q, kx, fx, ky, fy, kq, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="on cpu"):
        sk.shear_rotate(Q, kx.cpu(), fx, ky, fy, kq)
    with pytest.raises(ValueError, match="shape"):
        sk.shear_rotate_adjoint(torch.zeros(na + 1, C, C, device=cuda), kx,
                                fx, ky, fy, kq)
    with pytest.raises(TypeError, match="G must be"):
        sk.gcontract_ata(torch.zeros(na, C, C, device=cuda,
                                     dtype=torch.bfloat16), op.G)


@pytest.mark.parametrize("g_dtype", G_DTYPES)
@pytest.mark.parametrize("p_pad", [128, 384])
@pytest.mark.parametrize("na", [12, 60])
def test_gcontract_ata_shapes(cuda, na, p_pad, g_dtype):
    """K6 on random R and G at C = 100: C*C = 10,000 is a whole number
    neither of 64-row tiles nor of the split's chunks."""
    C = 100
    g = torch.Generator(device=cuda).manual_seed(na + p_pad)
    R = torch.randn(na, C, C, device=cuda, generator=g).to(g_dtype)
    G = torch.randn(C, C, p_pad, device=cuda, generator=g).to(g_dtype)
    before = sk.launch_counts["gcontract_ata"]
    got = sk.gcontract_ata(R, G)
    assert sk.launch_counts["gcontract_ata"] == before + 1
    ref = sk.gcontract_ata_ref(R, G)
    assert got.shape == (na, C, C) and got.dtype == torch.float32
    assert _rel(got, ref) <= (1e-5 if g_dtype == torch.float32 else 1e-3)


@pytest.fixture(scope="module")
def geometries():
    """(A, nx, angles) of tomo256x60 and of nx = 300 (n = 384), 20 views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for name, nx, views in (("tomo256x60", 256, 60), ("nx300", 300, 20)):
        theta = np.linspace(0, np.pi, views, endpoint=False)
        so, od = 3 * nx, nx
        A = fan_beam_matrix(nx, nx, angles=theta,
                            det_count=int(np.sqrt(2) * nx),
                            det_width=(so + od) / so, source_origin=so,
                            origin_det=od)
        out[name] = (A, nx, theta)
    return out


@pytest.mark.parametrize("dtype", KINDS)
@pytest.mark.parametrize("geometry", ["tomo256x60", "nx300"])
def test_banded_ata_every_bucket(cuda, geometries, geometry, dtype):
    """K1 on each bucket of the pack alone, and over all buckets in one
    launch (the operator's call), against the plain versions."""
    A, nx, theta = geometries[geometry]
    op = BucketedBandedProjector.from_scipy_fan(
        A, nx, None, angles=theta, n_groups=32, dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    X = torch.randn(op.n_pad, op.n_pad, device=cuda, generator=g)
    XT = X.T.contiguous()
    buckets = [(*op._parts(st), isc) for st, isc in zip(op.stacks,
                                                        op.is_cols)]
    for W, S, P, sc, isc in buckets:
        inp = XT if isc else X
        got = bk.banded_ata(inp, W, S, P, op.n_groups, sc)
        ref = bk.banded_ata_ref(inp, W, S, P, op.n_groups, sc)
        assert _rel(got, ref) <= 1e-5, tuple(W.shape)
    before = bk.launch_counts["banded_ata"]
    got = bk.banded_ata_buckets(X, XT, buckets, op.n_groups)
    assert bk.launch_counts["banded_ata"] == before + 1
    ref = bk.banded_ata_buckets_ref(X, XT, buckets, op.n_groups)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("dtype", KINDS)
@pytest.mark.parametrize("geometry", ["tomo256x60", "nx300"])
def test_banded_fwd_adj_buckets(cuda, geometries, geometry, dtype):
    """K2 and K3 over every bucket of the pack in one launch each (the
    operator's calls, with the angle ids and the ``cols`` buckets), and on
    each bucket alone (nb = 1), against their plain versions; K2 is the
    same to the bit from run to run (its sums run in a fixed order)."""
    A, nx, theta = geometries[geometry]
    op = BucketedBandedProjector.from_scipy_fan(
        A, nx, None, angles=theta, n_groups=32, dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    X = torch.randn(op.n_pad, op.n_pad, device=cuda, generator=g)
    XT = X.T.contiguous()
    p = op.det_count
    Y = torch.randn(op.shape[0] // p, p, device=cuda, generator=g)
    bks, ids = op._bks, op._aidx
    assert any(b[4] for b in bks) and not all(b[4] for b in bks)
    before = dict(bk.launch_counts)
    y = bk.banded_fwd_buckets(X, XT, bks, ids, p, op.n_groups)
    img = bk.banded_adj_buckets(Y, bks, ids, op.n_groups)
    assert bk.launch_counts["banded_fwd"] == before["banded_fwd"] + 1
    assert bk.launch_counts["banded_adj"] == before["banded_adj"] + 1
    assert _rel(y, bk.banded_fwd_buckets_ref(X, XT, bks, ids, p,
                                             op.n_groups)) <= 1e-5
    assert _rel(img, bk.banded_adj_buckets_ref(Y, bks, ids,
                                               op.n_groups)) <= 1e-5
    assert torch.equal(y, bk.banded_fwd_buckets(X, XT, bks, ids, p,
                                                op.n_groups))
    for W, S, P, sc, isc in bks:
        inp = XT if isc else X
        Yb = torch.randn(W.shape[0], W.shape[3], device=cuda, generator=g)
        for name, v in (("banded_fwd", inp), ("banded_adj", Yb)):
            got = getattr(bk, name)(v, W, S, P, op.n_groups, sc)
            ref = getattr(bk, name + "_ref")(v, W, S, P, op.n_groups, sc)
            assert _rel(got, ref) <= 1e-5, (name, tuple(W.shape))


@pytest.mark.parametrize("dtype", KINDS)
def test_banded_adjointness(cuda, geometries, dtype):
    """<Ax, y> = <x, A'y> through one K2 and one K3 launch, tomo256x60."""
    A, nx, theta = geometries["tomo256x60"]
    op = BucketedBandedProjector.from_scipy_fan(
        A, nx, None, angles=theta, n_groups=32, dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(op.shape[1], device=cuda, generator=g)
    y = torch.randn(op.shape[0], device=cuda, generator=g)
    Ax, Aty = op.matvec(x), op.rmatvec(y)
    gap = abs(float(Ax.double() @ y.double())
              - float(x.double() @ Aty.double()))
    assert gap <= 1e-5 * float(Ax.double().norm() * y.double().norm())


def _dyadic(op):
    """``op``'s buckets with every stored weight rounded to a multiple of
    1/16 (int8: scales 1/16), so that with small integer images every
    float32 sum of K1's stage 1 is exact in any order."""
    out = []
    for W, S, P, sc, isc in op._bks:
        if sc is None:
            W = (torch.round(W.float() * 16) / 16).to(W.dtype)
        else:
            sc = torch.full_like(sc, 1 / 16)
        out.append((W.contiguous(), S, P, sc, isc))
    return tuple(out)


def _to_cpu(buckets):
    return [tuple(t.cpu() if torch.is_tensor(t) else t for t in b)
            for b in buckets]


@pytest.mark.parametrize("dtype", KINDS)
def test_fixed_point_repeats_and_emulation(cuda, geometries, dtype):
    """K1 and K3 over all buckets of tomo256x60's pack: the same bits in 5
    calls; K3 those of its emulation on random input, K1 those of its
    emulation where stage 1 is exact (dyadic weights, integer images);
    zeros in, zeros out; a NaN or an inf in, NaN out."""
    A, nx, theta = geometries["tomo256x60"]
    op = BucketedBandedProjector.from_scipy_fan(
        A, nx, None, angles=theta, n_groups=32, dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    X = torch.randn(op.n_pad, op.n_pad, device=cuda, generator=g)
    XT = X.T.contiguous()
    p = op.det_count
    Y = torch.randn(op.shape[0] // p, p, device=cuda, generator=g)
    for fn, args in ((bk.banded_adj_buckets, (Y, op._bks, op._aidx,
                                              op.n_groups)),
                     (bk.banded_ata_buckets, (X, XT, op._bks, op.n_groups))):
        first = fn(*args)
        assert all(torch.equal(first, fn(*args)) for _ in range(4))
    cpu = _to_cpu(op._bks)
    ids = [a.cpu() for a in op._aidx]
    got = bk.banded_adj_buckets(Y, op._bks, op._aidx, op.n_groups).cpu()
    assert torch.equal(got, fx.banded_adj_buckets_fixed(Y.cpu(), cpu, ids,
                                                        op.n_groups))
    dy = _dyadic(op)
    Xi = torch.randint(-4, 5, (op.n_pad, op.n_pad), device=cuda,
                       generator=g).float()
    got = bk.banded_ata_buckets(Xi, Xi.T.contiguous(), dy, op.n_groups)
    want = fx.banded_ata_buckets_fixed(Xi.cpu(), Xi.T.contiguous().cpu(),
                                       _to_cpu(dy), op.n_groups)
    assert torch.equal(got.cpu(), want)
    zero = bk.banded_adj_buckets(torch.zeros_like(Y), op._bks, op._aidx,
                                 op.n_groups)
    assert torch.equal(zero, torch.zeros_like(zero))
    for bad in (float("nan"), float("inf")):
        Yb, Xb = Y.clone(), X.clone()
        Yb[3, 5], Xb[7, 9] = bad, bad
        assert torch.isnan(bk.banded_adj_buckets(
            Yb, op._bks, op._aidx, op.n_groups)).all()
        assert torch.isnan(bk.banded_ata_buckets(
            Xb, Xb.T.contiguous(), op._bks, op.n_groups)).all()
    # a finite X whose stage-1 y overflows float32: NaN (the frame's flag),
    # never a wrapped integer sum
    Xo = torch.full_like(X, 3e38)
    assert not torch.isfinite(bk.banded_ata_buckets_ref(
        Xo.cpu(), Xo.T.contiguous().cpu(), cpu, op.n_groups)).all()
    assert torch.isnan(bk.banded_ata_buckets(
        Xo, Xo.T.contiguous(), op._bks, op.n_groups)).all()


@pytest.mark.parametrize("name", ["banded_fwd", "banded_adj"])
def test_refused_plan_raises(cuda, name, monkeypatch):
    """A plan the kernel cannot run (parts beyond a 16-block cluster for
    K2; a chunk past a TMA box's 256 lines for K3) raises; nothing falls
    back to the plain version."""
    op = _op(cuda, None)
    true_plan = bk.launch_plan

    def bad_plan(kernel, taps, n, itemsize):
        pl = true_plan(kernel, taps, n, itemsize)
        if kernel == "banded_fwd":
            return {**pl, "parts": 32, "lines": -(-n // 32)}
        return {**pl, "buckets": [{**b, "chunk_lines": 300}
                                  for b in pl["buckets"]]}

    monkeypatch.setattr(bk, "launch_plan", bad_plan)
    X = torch.zeros(op.n_pad, op.n_pad, device=cuda)
    Y = torch.zeros(op.shape[0] // op.det_count, op.det_count, device=cuda)
    before = dict(bk.launch_counts)
    with pytest.raises(RuntimeError, match=f"{name} launch failed"):
        if name == "banded_fwd":
            bk.banded_fwd_buckets(X, X.T.contiguous(), op._bks, op._aidx,
                                  op.det_count, op.n_groups)
        else:
            bk.banded_adj_buckets(Y, op._bks, op._aidx, op.n_groups)
    assert bk.launch_counts == before


def test_checked_buckets_are_kept_weakly(cuda):
    """The operator's buckets are checked once and their launch arguments
    kept; a sequence holding another tensor is checked again, and nothing
    kept holds a pack alive."""
    import gc
    import weakref

    op = _op(cuda, None)
    p = op.det_count
    X = torch.zeros(op.n_pad, op.n_pad, device=cuda)
    args = (X, X.T.contiguous(), op._bks, op._aidx, p, op.n_groups)
    bk.banded_fwd_buckets(*args)
    kept = len(bk._PREPARED)
    bk.banded_fwd_buckets(*args)
    assert len(bk._PREPARED) == kept
    W, S, P, sc, isc = op._bks[0]
    bad = ((W, S.long(), P, sc, isc),) + op._bks[1:]
    with pytest.raises(TypeError, match="S must be"):
        bk.banded_fwd_buckets(X, args[1], bad, op._aidx, p, op.n_groups)
    gone = weakref.ref(W)
    del W, S, P, sc, bad, args, op
    gc.collect()
    assert gone() is None


# ---- the tomography demo's regularized solvers ------------------------------
@pytest.mark.parametrize("name,args", [
    ("FirstDerivative1D", (50,)), ("FirstDerivative2D", (64, 48)),
    ("SpaceTimeDerivative", (12, 10, 3)),
    ("CenteredSpaceTimeDerivative", (12, 10, 3)),
    ("CenteredDerivative2D", (64, 48))])
def test_derivatives_match_cpu(cuda, name, args):
    """Shifts, differences and ordered slice adds: the card's applies equal
    the CPU's (held to 1e-6 of the norm)."""
    from trips_tpu_torch import operators as to

    gpu, cpu = (getattr(to, name)(*args, device=d) for d in (cuda, "cpu"))
    assert gpu.device.type == "cuda"
    g = torch.Generator().manual_seed(0)
    x = torch.randn(cpu.shape[1], 3, generator=g)
    y = torch.randn(cpu.shape[0], 3, generator=g)
    for fn, v in (("matvec", x[:, 0]), ("rmatvec", y[:, 0]), ("matmat", x),
                  ("rmatmat", y)):
        got = getattr(gpu, fn)(v.to(cuda))
        assert got.device.type == "cuda"
        assert _rel(got.cpu(), getattr(cpu, fn)(v)) <= 1e-6, fn


@pytest.fixture(scope="module")
def demo64():
    """The tomography demo's problem at nx = 64, 20 views (grains, 0.1%
    noise after np.random.seed(0)) with the float32 banded operator on the
    card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from trips_tpu_torch.problems import Tomography, device_sparse_operator

    np.random.seed(0)
    tomo = Tomography(CommitCrime=False, device="cpu")
    x_true, nx, ny = tomo.gen_true("grains", nx=64, ny=64, phantom_seed=0)
    OP, b, _, _, A = tomo.gen_data(x_true, nx, ny, 20)
    bn, delta = tomo.add_noise(b, "Gaussian", 0.001)
    gpu = device_sparse_operator(A, nx=nx, angles=tomo.theta, device="cuda")
    return dict(ops={"cuda": gpu, "cpu": OP}, x_true=x_true, nx=nx,
                b=torch.tensor(bn.reshape(-1), dtype=torch.float32),
                delta=float(delta))


# name: (solve(op, b, L, delta), (K2, K3) launches from info, 10 iterations,
# projection_dim 3: see chip_smoke.demo_solves; A.matmat(V) is one K2)
DEMO = {
    "GKS": (lambda op, b, L, delta: _solvers().GKS(
        op, b, L, projection_dim=3, n_iter=10, regparam="dp", delta=delta),
        lambda info: (14, 13)),
    "Hybrid_LSQR": (lambda op, b, L, delta: _solvers().Hybrid_LSQR(
        op, b, n_iter=10, regparam="dp", delta=delta, reorth=True),
        lambda info: (info["matvec_count"] // 2,) * 2),
    "MMGKS": (lambda op, b, L, delta: _solvers().MMGKS(
        op, b, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=10,
        regparam="dp", delta=delta), lambda info: (24, 14)),
}


def _solvers():
    from trips_tpu_torch import solvers

    return solvers


@pytest.mark.parametrize("name", list(DEMO))
def test_demo_solvers_match_cpu(cuda, demo64, name):
    """demos/demo_tomography.py:50-61 at nx = 64 on the card (K2 and K3
    behind every apply, launched as often as the loop implies, no K1)
    against the same solve on the CPU (their plain versions): float32 sums
    in another order, so the final relError within 1e-3."""
    from trips_tpu_torch.operators import FirstDerivative2D

    d = demo64
    solve, expect = DEMO[name]
    err = {}
    for dev in ("cuda", "cpu"):
        L = FirstDerivative2D(d["nx"], d["nx"], device=dev)
        bk.reset_launch_counts()
        x, info = solve(d["ops"][dev], d["b"].to(dev), L, d["delta"])
        assert x.device.type == dev and x.dtype == torch.float32
        if dev == "cuda":
            launches = dict(bk.launch_counts)
            assert (launches["banded_fwd"], launches["banded_adj"]) == \
                expect(info) and launches["banded_ata"] == 0, launches
        err[dev] = _rel(x.cpu().reshape(-1),
                        torch.from_numpy(d["x_true"].reshape(-1)))
    assert abs(err["cuda"] - err["cpu"]) <= 1e-3, err


# ---- K1-K3 over frames (dynamic CT) ----------------------------------------
DYN_CLASSES = [("flat", None), ("flat", "bfloat16"), ("bucketed", None),
               ("bucketed", "bfloat16"), ("bucketed", "int8")]


@pytest.fixture(scope="module")
def dynamic32():
    """The synthetic dynamic problem at 32x32, 4 frames, 9 views: the row-
    and column-driven angle counts change from frame to frame, so the
    stacks hold padded angles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from trips_tpu_torch.problems import generate_synthetic_dynamic

    return generate_synthetic_dynamic(nx=32, nt=4, views=9, noise_level=0.01,
                                      return_angles=True)


def _dyn(problem, kind, dtype, device):
    from trips_tpu_torch.sparse import (BucketedDynamicBandedOperator,
                                        DynamicBandedOperator)

    A, b, AA, B, nx, ny, nt, delta, x, al = problem
    cls = (DynamicBandedOperator if kind == "flat"
           else BucketedDynamicBandedOperator)
    return cls.from_frames(AA, nx, al, n_groups=8, dtype=dtype,
                           device=device)


@pytest.mark.parametrize("kind,dtype", DYN_CLASSES)
def test_frame_launches_match_plain(cuda, dynamic32, kind, dtype):
    """K1, K2 and K3 over all frames and stacks of a frame-varying pack in
    one launch each, against their plain versions; the operator against
    the same operator on the CPU."""
    op = _dyn(dynamic32, kind, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    X = torch.randn(op.nt, op.n_pad, op.n_pad, device=cuda, generator=g)
    XT = X.transpose(1, 2).contiguous()
    Y = torch.randn(op.nt, op.views, op.det_count, device=cuda, generator=g)
    args = {"banded_fwd": (X, XT, op._bks, op._aidx, op.det_count,
                           op.n_groups, op.views),
            "banded_adj": (Y, op._bks, op._aidx, op.n_groups),
            "banded_ata": (X, XT, op._bks, op.n_groups)}
    for name, a in args.items():
        before = bk.launch_counts[name]
        got = getattr(bk, name + "_buckets")(*a)
        assert bk.launch_counts[name] == before + 1
        ref = getattr(bk, name + "_buckets_ref")(*a)
        assert got.shape == ref.shape and _rel(got, ref) <= 1e-5, name
    cpu = _dyn(dynamic32, kind, dtype, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(cpu.shape[1]).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(cpu.shape[0]).astype(np.float32))
    bk.reset_launch_counts()
    for fn, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        got = getattr(op, fn)(v.to(cuda)).cpu()
        assert _rel(got, getattr(cpu, fn)(v)) <= 1e-5, fn
    assert bk.launch_counts == {"banded_fwd": 1, "banded_adj": 1,
                                "banded_ata": 1}


def test_padded_angles_write_no_row_on_card(cuda, dynamic32):
    """Weights put into the padded angles' slots (id ``views``: past the
    frame's sinogram, where frame f + 1's row 0 lies in memory) change
    neither K2's sinogram nor K3's image."""
    op = _dyn(dynamic32, "bucketed", None, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(op.shape[1], device=cuda, generator=g)
    y = torch.randn(op.shape[0], device=cuda, generator=g)
    clean = op.matvec(x), op.rmatvec(y)
    pads = 0
    for W, _, _, ids in op.stacks:
        pad = ids == op.views
        pads += int(pad.sum())
        W[pad] = 1.0
    assert pads
    assert torch.equal(op.matvec(x), clean[0])
    assert torch.equal(op.rmatvec(y), clean[1])


@pytest.mark.parametrize("kind,dtype", DYN_CLASSES)
def test_fixed_point_frames(cuda, dynamic32, kind, dtype):
    """Over the frames of the dynamic packs, and with a pack split over two
    launches (``kMaxBuckets`` lowered to 1 through the wrapper's
    ``prepare``): K1 and K3 the same bits in 5 calls, K3 those of its
    emulation, over one launch or one per bucket alike."""
    op = _dyn(dynamic32, kind, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    X = torch.randn(op.nt, op.n_pad, op.n_pad, device=cuda, generator=g)
    XT = X.transpose(1, 2).contiguous()
    Y = torch.randn(op.nt, op.views, op.det_count, device=cuda, generator=g)
    for fn, args in ((bk.banded_adj_buckets, (Y, op._bks, op._aidx,
                                              op.n_groups)),
                     (bk.banded_ata_buckets, (X, XT, op._bks, op.n_groups))):
        first = fn(*args)
        assert all(torch.equal(first, fn(*args)) for _ in range(4))
    img = bk.banded_adj_buckets(Y, op._bks, op._aidx, op.n_groups)
    assert torch.equal(img.cpu(), fx.banded_adj_buckets_fixed(
        Y.cpu(), _to_cpu(op._bks), [a.cpu() for a in op._aidx],
        op.n_groups))
    # one launch per bucket: the int64 image carries over between them
    name = "banded_adj"
    n, p_pad, nf, launches, bound = bk.prepare(name, Y, op._bks, op._aidx,
                                               op.n_groups)
    assert len(launches) == 1 and launches[0][0] >= 2
    split = [bk.prepare(name, Y, op._bks[k:k + 1], op._aidx[k:k + 1],
                        op.n_groups, bound)[3][0]
             for k in range(len(op._bks))]
    before = bk.launch_counts[name]
    two = bk.banded_adj_buckets(Y, op._bks, op._aidx, op.n_groups,
                                prepared=(n, p_pad, nf, split, bound))
    assert bk.launch_counts[name] == before + len(split)
    assert torch.equal(two, img)


@pytest.mark.parametrize("dtype", KINDS)
def test_shared_stack_frames(cuda, dtype):
    """Weight frame stride 0: a pack without a frame axis applied to 5
    frames in one launch (the block diagonal over one operator, a matmat's
    columns) equals 5 single applies, K2 to the bit."""
    from trips_tpu_torch.core import BatchedBlockDiagOperator

    op = _op(cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    X = torch.randn(5, op.shape[1], device=cuda, generator=g)
    Y = torch.randn(5, op.shape[0], device=cuda, generator=g)
    bk.reset_launch_counts()
    fw, ad, at = op.matmat(X.T), op.rmatmat(Y.T), op.normal_matmat(X.T)
    assert bk.launch_counts == {"banded_fwd": 1, "banded_adj": 1,
                                "banded_ata": 1}
    for f in range(5):  # the frame's own scale: the same bits alone
        assert torch.equal(fw[:, f], op.matvec(X[f]))
        assert torch.equal(ad[:, f], op.rmatvec(Y[f]))
        assert torch.equal(at[:, f], op.normal_matvec(X[f]))
    blk = BatchedBlockDiagOperator(op, 5)
    bk.reset_launch_counts()
    for fn, v in (("matvec", X), ("rmatvec", Y), ("normal_matvec", X)):
        got = getattr(blk, fn)(v.reshape(-1))
        ref = torch.cat([getattr(op, fn)(r) for r in v])
        assert torch.equal(got, ref), fn
    assert bk.launch_counts == {"banded_fwd": 6, "banded_adj": 6,
                                "banded_ata": 6}


def test_frame_wrappers_check_frames(cuda, dynamic32):
    """Images must carry as many frames as a per-frame pack holds."""
    op = _dyn(dynamic32, "flat", None, cuda)
    X = torch.zeros(op.nt - 1, op.n_pad, op.n_pad, device=cuda)
    with pytest.raises(ValueError, match="frames"):
        bk.banded_ata_buckets(X, X, op._bks, op.n_groups)
    with pytest.raises(ValueError, match="frames"):
        bk.banded_ata_buckets(X[0], X[0], op._bks, op.n_groups)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_flat_projector_matches_cpu(cuda, dtype):
    """The flat BandedProjector (raw, unreduced shears and predictors; both
    stacks in one launch) on the card against the CPU, alone and under
    the block diagonal over 3 frames."""
    from trips_tpu_torch.core import BatchedBlockDiagOperator
    from trips_tpu_torch.sparse import BandedProjector

    A = fan_beam_matrix(40, views=12).astype(np.float32)
    gpu, cpu = (BandedProjector.from_scipy_fan(A, 40, 12, n_groups=8,
                                               dtype=dtype, device=d)
                for d in (cuda, "cpu"))
    rng = np.random.default_rng(1)
    for op_g, op_c in ((gpu, cpu), (BatchedBlockDiagOperator(gpu, 3),
                                    BatchedBlockDiagOperator(cpu, 3))):
        x = torch.from_numpy(rng.standard_normal(op_c.shape[1])
                             .astype(np.float32))
        y = torch.from_numpy(rng.standard_normal(op_c.shape[0])
                             .astype(np.float32))
        bk.reset_launch_counts()
        for fn, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
            got = getattr(op_g, fn)(v.to(cuda)).cpu()
            assert _rel(got, getattr(op_c, fn)(v)) <= 1e-5, fn
        assert bk.launch_counts == {"banded_fwd": 1, "banded_adj": 1,
                                    "banded_ata": 1}


def test_csr_operator_matches_cpu(cuda):
    """CsrOperator (cuSPARSE, the transpose stored) on the card."""
    from trips_tpu_torch.sparse import CsrOperator

    A = fan_beam_matrix(40, views=12)
    gpu, cpu = (CsrOperator.from_scipy(A, dtype=torch.float32, device=d)
                for d in (cuda, "cpu"))
    g = torch.Generator().manual_seed(2)
    X = torch.randn(A.shape[1], 3, generator=g)
    Y = torch.randn(A.shape[0], 3, generator=g)
    for fn, v in (("matvec", X[:, 0]), ("rmatvec", Y[:, 0]), ("matmat", X),
                  ("rmatmat", Y)):
        got = getattr(gpu, fn)(v.to(cuda))
        assert got.device.type == "cuda"
        assert _rel(got.cpu(), getattr(cpu, fn)(v)) <= 1e-6, fn


# ---- the all-on-device solvers ----------------------------------------------
FUSED = {
    "fused_gks dp": (lambda F, op, b, L, delta, dev: F.fused_gks(
        op, b, L, projection_dim=3, n_iter=10, regparam_mode="dp",
        delta=delta, device=dev), (14, 13)),
    "fused_gks gcv": (lambda F, op, b, L, delta, dev: F.fused_gks(
        op, b, L, projection_dim=3, n_iter=10, regparam_mode="gcv",
        device=dev), (14, 13)),
    "fused_gks l_curve": (lambda F, op, b, L, delta, dev: F.fused_gks(
        op, b, L, projection_dim=3, n_iter=10, regparam_mode="l_curve",
        device=dev), (14, 13)),
    "fused_mmgks dp": (lambda F, op, b, L, delta, dev: F.fused_mmgks(
        op, b, L, pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=10,
        regparam_mode="dp", delta=delta, device=dev), (24, 14)),
    "fused_hybrid_lsqr gcv": (lambda F, op, b, L, delta, dev:
                              F.fused_hybrid_lsqr(op, b, n_iter=10,
                                                  device=dev), (10, 10)),
    "fused_hybrid_lsqr dp reorth": (
        lambda F, op, b, L, delta, dev: F.fused_hybrid_lsqr(
            op, b, n_iter=10, regparam_mode="dp", delta=delta, reorth=True,
            device=dev), (10, 10)),
}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_solvers_match_cpu(cuda, demo64, name):
    """The all-on-device solvers at nx = 64 on the card (K2 and K3 as often
    as the loop implies, lam chosen on the card) against the same solve on
    the CPU: float32 sums in another order, so the final relError within
    1e-3; lam and x finite, the lam history on the card."""
    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.solvers import fused as F

    d = demo64
    solve, expect = FUSED[name]
    err = {}
    for dev in ("cuda", "cpu"):
        L = FirstDerivative2D(d["nx"], d["nx"], device=dev)
        bk.reset_launch_counts()
        x, lams = solve(F, d["ops"][dev], d["b"].to(dev), L, d["delta"],
                        dev)[:2]
        assert x.device.type == lams.device.type == dev
        assert torch.isfinite(x).all() and torch.isfinite(lams).all()
        if dev == "cuda":
            launches = dict(bk.launch_counts)
            assert (launches["banded_fwd"], launches["banded_adj"]) == \
                expect and launches["banded_ata"] == 0, launches
        err[dev] = _rel(x.cpu(), torch.from_numpy(d["x_true"].reshape(-1)))
    assert abs(err["cuda"] - err["cpu"]) <= 1e-3, err


def test_device_searches_match_cpu(cuda):
    """Brent (GCV, L-curve) and the DP Newton on the card in float64 give
    the CPU's lam (the same steps; the K x K factorizations in another
    order: 1e-6)."""
    from trips_tpu_torch.regparam import device as td

    rng = np.random.default_rng(0)
    k = 10
    R_A = np.triu(rng.standard_normal((k, k))) + np.diag(np.logspace(0, -4,
                                                                     k))
    R_L, bp = np.eye(k), rng.standard_normal(k)
    B = np.eye(k + 1)[:, :k] * 0.5 + np.eye(k + 1, k, -1) * 0.3
    bb = rng.standard_normal(k + 1)
    for fn, args in ((td.gcv_lambda, (R_A, R_L, bp)),
                     (td.lcurve_lambda, (R_A, R_L, bp)),
                     (td.dp_lambda, (B, bb, 0.2 * np.linalg.norm(bb)))):
        got = fn(*args, device=cuda)
        assert got.device.type == "cuda"
        ref = fn(*args, device="cpu")
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref)), fn


def test_lsqr_matches_cpu(cuda, demo64):
    """Damped LSQR on the card (one K2 and one K3 per enqueued step, one K3
    at set-up) against the CPU: float32, so the final relError within
    1e-3; 30 steps, the stopping test never fires."""
    from trips_tpu_torch.krylov import lsqr

    d = demo64
    err = {}
    for dev in ("cuda", "cpu"):
        bk.reset_launch_counts()
        x, k = lsqr(d["ops"][dev], d["b"].to(dev), 30, damp=0.05,
                    device=dev)
        assert k == 30 and x.device.type == dev
        if dev == "cuda":
            launches = dict(bk.launch_counts)
            assert launches == {"banded_fwd": 32, "banded_adj": 33,
                                "banded_ata": 0}, launches
        err[dev] = _rel(x.cpu(), torch.from_numpy(d["x_true"].reshape(-1)))
    assert abs(err["cuda"] - err["cpu"]) <= 1e-3, err


def test_fused_dynamic_checkpoint_on_card(cuda, dynamic32, tmp_path):
    """The dynamic isoTV MMGKS (GCV on float64 data, where its search is
    stable) in chunks on the card, killed after the first chunk and
    resumed from its file: bitwise the uninterrupted iterate and lambda
    history on the card and on the CPU, and within 1e-3 of the CPU's
    relError."""
    from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
    from trips_tpu_torch.solvers.checkpointed import fused_mmgks_checkpointed
    from trips_tpu_torch.utils import save_state

    A, b, AA, B, nx, ny, nt, delta, x_true, al = dynamic32

    class Killed(Exception):
        pass

    def kill(it, **state):
        save_state(str(tmp_path / "s.npz"), state)
        raise Killed

    xs = {}
    for dev in ("cuda", "cpu"):
        op = _dyn(dynamic32, "flat", None, dev)
        kw = dict(pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=6,
                  regparam_mode="gcv", weight_mode="isoTV",
                  prob_dims=(nx, ny, nt), chunk=3, device=dev)
        L = CenteredSpaceTimeDerivative(nx, ny, nt, device=dev)
        bt = torch.tensor(b, dtype=torch.float64, device=dev)
        xs[dev] = [fused_mmgks_checkpointed(op, bt, L, **kw)[:2]]
        with pytest.raises(Killed):
            fused_mmgks_checkpointed(op, bt, L, callback=kill, **kw)
        xs[dev].append(fused_mmgks_checkpointed(
            op, bt, L, resume_state=str(tmp_path / "s.npz"), **kw)[:2])
    for dev in ("cuda", "cpu"):
        (x, lams), (xr, lamsr) = xs[dev]
        assert torch.equal(xr, x) and torch.equal(lamsr, lams), dev
    xt = torch.from_numpy(x_true.reshape(-1))
    errs = [_rel(x[0][0].cpu(), xt) for x in xs.values()]
    assert abs(errs[0] - errs[1]) <= 1e-3, errs


@pytest.mark.parametrize("dim,spread,nx,ny", [((9, 9), (3, 3), 128, 128),
                                              ((4, 6), (1.0, 2.0), 60, 44)])
def test_blur2d_float32_matches_float64(cuda, dim, spread, nx, ny):
    """cuDNN's float32 conv2d with TF32 off (``import trips_tpu_torch``
    turns it off): within 1e-6 of the float64 apply on the card, and the
    float64 apply within 1e-12 of the CPU's."""
    from trips_tpu_torch.operators import Blur2D

    ops = {dt: Blur2D(dim, spread, nx, ny, dtype=dt, device=cuda)
           for dt in (torch.float32, torch.float64)}
    cpu = Blur2D(dim, spread, nx, ny, dtype=torch.float64, device="cpu")
    g = torch.Generator(device=cuda).manual_seed(0)
    X = torch.rand(nx * ny, 4, device=cuda, generator=g, dtype=torch.float64)
    for name in ("matvec", "rmatvec", "matmat", "rmatmat"):
        arg = X[:, 0] if name.endswith("vec") else X
        ref = getattr(ops[torch.float64], name)(arg)
        assert _rel(getattr(ops[torch.float32], name)(arg.float()), ref) <= 1e-6
        assert _rel(ref.cpu(), getattr(cpu, name)(arg.cpu())) <= 1e-12


def test_blur2d_matmat_is_one_conv2d(cuda):
    """A column apply is one conv2d over all columns (the JAX package's
    vmap), not one per column."""
    from trips_tpu_torch.operators import Blur2D

    op = Blur2D((9, 9), (3, 3), 128, 128, device=cuda)
    X = torch.rand(128 * 128, 8, device=cuda)
    op.matmat(X)
    act = [torch.profiler.ProfilerActivity.CPU]
    for fn in (op.matmat, op.rmatmat):
        with torch.profiler.profile(activities=act) as prof:
            fn(X)
        counts = {e.key: e.count for e in prof.key_averages()}
        assert counts.get("aten::conv2d") == 1, counts


@pytest.mark.parametrize("solver", ["fused_gks", "fused_mmgks"])
def test_fused_gcv_deblur1d_matches_cpu(cuda, solver):
    """The 1D deblurring demo's float32 fused GCV solves (n = 200, 15
    iterations) end within 1e-3 of the same solve on the CPU. With
    PyTorch's default card SVD (Jacobi) fused GKS ended at relError 0.060
    against 0.024 on the CPU; ``core.device.svd`` picks ``gesvd``."""
    from trips_tpu_torch.operators import FirstDerivative1D
    from trips_tpu_torch.problems import Deblurring1D
    from trips_tpu_torch.solvers import fused as F

    errs = []
    for dev in (cuda, "cpu"):
        np.random.seed(0)
        prob = Deblurring1D(device=dev)
        A = prob.forward_Op_1D(parameter=10.0, nx=200)
        x_true = prob.gen_xtrue(200, "curve0")
        b, _ = prob.add_noise(prob.gen_data(x_true, parameter=10.0),
                              "Gaussian", 0.02)
        kw = dict(pnorm=2.0, qnorm=1.0) if solver == "fused_mmgks" else {}
        x = getattr(F, solver)(
            A, torch.tensor(b.reshape(-1), dtype=torch.float32, device=dev),
            FirstDerivative1D(200, device=dev), projection_dim=3, n_iter=15,
            regparam_mode="gcv", device=dev, **kw)[0]
        x_true = x_true.reshape(-1)
        errs.append(float(np.linalg.norm(x.double().cpu().numpy() - x_true)
                          / np.linalg.norm(x_true)))
    assert abs(errs[0] - errs[1]) <= 1e-3, errs


# ---- the streamed operator, the batched solve ----------------------------
def _requested(dev, which):
    return torch.cuda.memory_stats(dev)[f"requested_bytes.all.{which}"]


def _frames(problem, dtype):
    """The frames' host packs (8 line groups, 3 buckets)."""
    from trips_tpu_torch.sparse import BucketedBandedProjector

    A, b, AA, B, nx, ny, nt, delta, x, al = problem
    return [BucketedBandedProjector.from_scipy_fan(
        AA[t], nx, None, angles=al[t], n_groups=8, n_buckets=3, dtype=dtype,
        device="cpu") for t in range(nt)]


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_streamed_matches_resident_on_card(cuda, dynamic32, dtype):
    """The streamed applies launch K2, K3 and K1 once per frame, the
    ``matvec`` bitwise equal to the frames' resident ``matvec``s (K2 is
    bitwise repeatable), with and without the compute stream slowed
    before each frame (the side stream must wait for a slot's frame before
    overwriting it); ``rmatvec`` bitwise the resident bucketed dynamic
    operator's (K3 adds the same terms at the same scale: a frame's bound
    is its matrix's, whatever the packing) and ``normal_matvec`` within
    1e-6 (K1's stage 1 sums each row in its packing's order); the
    memory an apply holds at most the two slots, the output and a
    slack."""
    from trips_tpu_torch.parallel import StreamedDynamicBandedOperator
    from trips_tpu_torch.sparse import BucketedBandedProjector

    nt = dynamic32[6]
    frames = _frames(dynamic32, dtype)
    res = _dyn(dynamic32, "bucketed", dtype, cuda)
    twins = [BucketedBandedProjector(
        op.stacks, op.aidxs, op.is_cols, op.shape, op.nx, op.det_count,
        op.n_groups, op.nnz, op.n_pad, device=cuda) for op in frames]
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(res.shape[1], device=cuda, generator=g)
    y = torch.randn(res.shape[0], device=cuda, generator=g)
    cols = np.cumsum([0] + [op.shape[1] for op in frames])
    Ax_frames = torch.cat([tw.matvec(x[cols[t]:cols[t + 1]])
                           for t, tw in enumerate(twins)])
    torch.cuda.synchronize()
    before = _requested(cuda, "current")
    sop = StreamedDynamicBandedOperator(frames, device=cuda)
    for fn, v, want in (("matvec", x, "banded_fwd"),
                        ("rmatvec", y, "banded_adj"),
                        ("normal_matvec", x, "banded_ata")):
        bk.reset_launch_counts()
        got = getattr(sop, fn)(v)
        torch.cuda.synchronize()
        assert bk.launch_counts == {k: nt if k == want else 0
                                    for k in bk.launch_counts}, fn
        if fn == "matvec":
            assert torch.equal(got, Ax_frames)
        elif fn == "rmatvec":
            assert torch.equal(got, res.rmatvec(v))
        else:
            assert _rel(got, getattr(res, fn)(v)) <= 1e-6, fn
    # the two-slot bound, in bytes requested (the allocator's rounding up
    # to a cached block depends on what its cache held): the slots
    # (allocated at construction, the angle ids resident beside them: a
    # few hundred bytes), the output, and a slack of 16 float32 images for
    # a frame's images and sinograms
    del got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    sop.normal_matvec(x)
    torch.cuda.synchronize()
    peak = _requested(cuda, "peak") - before
    slots = 2 * max(sop.slab_bytes)
    bound = slots + 4 * x.numel() + 16 * 4 * frames[0].n_pad ** 2
    assert slots <= peak <= bound < sum(sop.slab_bytes)
    # backpressure: the compute stream slowed before each frame
    orig = sop._apply_frame

    def slowed(fn, s, t, v):
        torch.cuda._sleep(2_000_000)
        return orig(fn, s, t, v)

    sop._apply_frame = slowed
    assert torch.equal(sop.matvec(x), Ax_frames)


def test_streamed_refuses_card_frames(cuda, dynamic32):
    from trips_tpu_torch.parallel import StreamedDynamicBandedOperator
    from trips_tpu_torch.sparse import BucketedBandedProjector

    A, b, AA, B, nx, ny, nt, delta, x, al = dynamic32
    op = BucketedBandedProjector.from_scipy_fan(AA[0], nx, None,
                                                angles=al[0], n_groups=8,
                                                device=cuda)
    with pytest.raises(ValueError, match="on the host"):
        StreamedDynamicBandedOperator([op], device=cuda)


@pytest.mark.parametrize("solver", ["mmgks", "gks"])
def test_batched_frame_solve_matches_cpu(cuda, solver):
    """``batched_frame_solve`` in float64 on the card (ELL gathers, the
    fused solvers) against the CPU, frame by frame, to 1e-6."""
    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.parallel import batched_frame_solve
    from trips_tpu_torch.problems import generate_synthetic_dynamic

    A, b, AA, B, nx, ny, nt, delta, x_true = generate_synthetic_dynamic(
        nx=16, nt=4, views=10, noise_level=0.01)
    kw = {} if solver == "mmgks" else dict(regparam_mode="dp",
                                           delta=delta / nt)
    X = {dev: batched_frame_solve(AA, B, FirstDerivative2D(nx, ny,
                                                           device=dev),
                                  solver=solver, device=dev, **kw)
         for dev in (cuda, "cpu")}
    assert X[cuda].device.type == "cuda" and X[cuda].dtype == torch.float64
    for f in range(nt):
        assert _rel(X[cuda][f].cpu(), X["cpu"][f]) <= 1e-6, f


def _sharded_gates(sop, op, x, y):
    """Each apply of the sharded ``sop`` against the unsharded ``op``:
    ``matvec`` bitwise, the others within 1e-5, one launch of its kernel
    and one all_reduce each."""
    from trips_tpu_torch.parallel import collective_counts

    for name, v, kernel in (("matvec", x, "banded_fwd"),
                            ("rmatvec", y, "banded_adj"),
                            ("normal_matvec", x, "banded_ata")):
        before = (dict(bk.launch_counts), collective_counts["all_reduce"])
        got = getattr(sop, name)(v)
        torch.cuda.synchronize()
        launched = {k: bk.launch_counts[k] - before[0][k]
                    for k in bk.launch_counts}
        assert launched == {k: int(k == kernel) for k in launched}, name
        assert collective_counts["all_reduce"] - before[1] == 1, name
        ref = getattr(op, name)(v)
        if name == "matvec":
            assert torch.equal(got, ref)
        assert _rel(got, ref) <= 1e-5, name


@pytest.mark.parametrize("kind", ["flat", None, "int8"])
def test_sharded_banded_on_card(cuda, kind):
    """A one-rank mesh without a process group (the all_reduce is the
    identity): the sharded static packs, sharded from a host pack, against
    the unsharded pack on the card."""
    from trips_tpu_torch.parallel import (ShardedBandedProjector,
                                          ShardedBucketedBandedProjector,
                                          make_mesh)
    from trips_tpu_torch.sparse import BandedProjector

    nx = 40
    A = fan_beam_matrix(nx, views=12).astype(np.float32)
    mesh = make_mesh({"angles": 1})
    if kind == "flat":
        ops = [BandedProjector.from_scipy_fan(A, nx, 12, n_groups=8,
                                              device=d) for d in ("cpu", cuda)]
        sop = ShardedBandedProjector.from_banded(ops[0], mesh, axis="angles",
                                                 device=cuda)
    else:
        ops = [_op(d, kind, nx) for d in ("cpu", cuda)]
        sop = ShardedBucketedBandedProjector.from_bucketed(ops[0], mesh,
                                                           device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(A.shape[1], device=cuda, generator=g)
    y = torch.randn(A.shape[0], device=cuda, generator=g)
    _sharded_gates(sop, ops[1], x, y)


@pytest.mark.parametrize("kind", ["flat", "bucketed"])
def test_sharded_dynamic_on_card(cuda, dynamic32, kind):
    """The (time x angles)-sharded dynamic packs (padded angles in some
    frames) on a one-rank mesh, against the unsharded dynamic pack."""
    from trips_tpu_torch.parallel import (
        ShardedBucketedDynamicBandedOperator, ShardedDynamicBandedOperator,
        make_mesh)

    op = _dyn(dynamic32, kind, None, cuda)
    cls = (ShardedDynamicBandedOperator if kind == "flat"
           else ShardedBucketedDynamicBandedOperator)
    sop = cls.from_dynamic(op, make_mesh({"time": 1, "angles": 1}),
                           device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(op.shape[1], device=cuda, generator=g)
    y = torch.randn(op.shape[0], device=cuda, generator=g)
    _sharded_gates(sop, op, x, y)


# ---- the loops as replayed CUDA graphs ---------------------------------------
def _graph_and_eager(fn):
    """fn() with its loops replayed as CUDA graphs, then with them stepped
    eagerly (``core.loop.eager``): [(output, K1-K3 launches, K4-K6
    launches)] for each."""
    import contextlib

    from trips_tpu_torch.core import loop

    out = []
    for ctx in (contextlib.nullcontext, loop.eager):
        bk.reset_launch_counts()
        sk.reset_launch_counts()
        with ctx():
            res = fn()
        torch.cuda.synchronize()
        out.append((res, dict(bk.launch_counts), dict(sk.launch_counts)))
    return out


def _same_bits(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    return a == b


def _loop_case(name, cuda, dynamic32):
    """(operator, b) of a loop case on the card."""
    from trips_tpu_torch.core import BatchedBlockDiagOperator
    from trips_tpu_torch.operators import Blur2D
    from trips_tpu_torch.sparse import CsrOperator, EllOperator

    kind = name.split()[0]
    if kind == "banded":
        dtype = {"f32": None, "bf16": torch.bfloat16, "int8": "int8"}[
            name.split()[1]]
        op = _op(cuda, dtype)
    elif kind == "shear":
        op = ShearFanProjector(48, views=10, g_dtype=torch.bfloat16,
                               device=cuda)
    elif kind == "dynamic":
        op = _dyn(dynamic32, "bucketed", None, cuda)
    elif kind == "frames":
        op = BatchedBlockDiagOperator(_op(cuda, None), 3)
    elif kind in ("csr", "ell"):
        A = fan_beam_matrix(40, views=12).astype(np.float32)
        op = (CsrOperator if kind == "csr" else EllOperator).from_scipy(
            A, device=cuda)
    else:
        op = Blur2D((9, 9), (3, 3), 48, 48, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(op.shape[1], device=cuda, generator=g)
    b = op.matvec(x) + 0.01 * torch.randn(op.shape[0], device=cuda,
                                          generator=g)
    return op, b


LOOP_CASES = ["banded f32 cgls", "banded bf16 cgls", "banded int8 cgls",
              "banded f32 cgls_normal", "banded bf16 cgls_normal",
              "banded int8 cgls_normal", "banded f32 lsqr",
              "banded f32 cgls stops", "shear cgls", "shear cgls_normal K6",
              "dynamic cgls_normal", "frames cgls_normal", "csr cgls",
              "ell cgls", "blur cgls"]


@pytest.mark.parametrize("name", LOOP_CASES)
def test_loop_graph_bitwise_eager(cuda, dynamic32, name, monkeypatch):
    """Each loop on the card as replays of one captured step: x and k the
    eager loop's to the bit, and each kernel launched as often (a replay
    counts its step's launches)."""
    from trips_tpu_torch.krylov import cgls, cgls_normal, lsqr

    monkeypatch.setenv("TRIPS_TPU_SHEAR_ATA", "1" if "K6" in name else "0")
    op, b = _loop_case(name, cuda, dynamic32)
    assert op.capturable
    x0 = torch.zeros(op.shape[1], device=cuda)
    if "lsqr" in name:
        def fn():
            return lsqr(op, b, 25, damp=0.05, atol=1e-4, btol=1e-4,
                        device=cuda)
    else:
        solver = cgls_normal if "cgls_normal" in name else cgls
        iters, tol = 19, 0.0
        if "stops" in name:
            # the rule fires at step 11, mid-chunk: the replays after it
            # leave the state frozen
            from trips_tpu_torch.krylov.cgls import _init, _step

            s, r = _init(op, b, x0), []
            for _ in range(11):
                s = _step(op, 0.0, s)
                r.append(float(torch.sqrt(s.gamma) / s.norms_t0))
            iters, tol = 40, r[-1] * (1 + 1e-6)
            assert min(r[:-1]) > tol

        def fn():
            return solver(op, b, x0, iters, tol)
    (xg, bg, sg), (xe, be, se) = _graph_and_eager(fn)
    assert _same_bits(xg, xe), (xg[1], xe[1])
    assert bg == be and sg == se
    assert sum(bg.values()) + sum(sg.values()) > 0 or name.split()[0] in (
        "csr", "ell", "blur")
    if "stops" in name:
        assert xg[1] == 11


def test_shear_fused_ata_replayed_step(cuda, monkeypatch):
    """``cgls_normal`` on ``ShearFanProjector(fused_ata=True)``, as the
    benchmark's shear cell runs it, with ``TRIPS_TPU_SHEAR_ATA=0``: replayed,
    x is the eager loop's to the bit; each step launches K4, K6 and K5 once
    and no stage-B product (the one ``_mm`` of a solve is its initial
    A^T b); the K4 and K5 plans (``shear.plan``) are made once per
    operator, not per solve."""
    from trips_tpu_torch.krylov import cgls_normal
    from trips_tpu_torch.operators import fan_shear
    from trips_tpu_torch.utils import telemetry

    monkeypatch.setenv("TRIPS_TPU_SHEAR_ATA", "0")
    op = ShearFanProjector(48, views=10, fused_ata=True, device=cuda)
    assert op.capturable
    g = torch.Generator(device=cuda).manual_seed(5)
    b = torch.randn(op.shape[0], device=cuda, generator=g)
    x0 = torch.zeros(op.shape[1], device=cuda)
    products, mm = [], fan_shear._mm

    def counted_mm(*a):
        products.append(1)
        return mm(*a)

    monkeypatch.setattr(fan_shear, "_mm", counted_mm)
    iters, plans = 19, []
    for _ in range(2):
        products.clear()
        with telemetry.tracing() as tr:
            (xg, _, sg), (xe, _, se) = _graph_and_eager(
                lambda: cgls_normal(op, b, x0, iters))
        plans.append(sum(s.name == "shear.plan" for s in tr.spans))
        assert _same_bits(xg, xe) and xg[1] == iters
        assert sg == se == {"shear_rotate": iters + 1,
                            "gcontract_ata": iters + 1,
                            "shear_rotate_adjoint": iters + 2}
        assert len(products) == 2  # graph run and eager run
    assert plans == [2, 0]


def test_checkpointed_resume_graph_bitwise_eager(cuda):
    """``cgls_normal_checkpointed`` on the card, killed after its first
    chunk and resumed from the state it saved: the uninterrupted run's
    iterate and k, and both the eager run's, to the bit."""
    from trips_tpu_torch.core import loop
    from trips_tpu_torch.solvers.checkpointed import \
        cgls_normal_checkpointed

    op = _op(cuda, None)
    b = op.matvec(torch.rand(op.shape[1], device=cuda))
    x0 = torch.zeros(op.shape[1], device=cuda)
    saved = {}

    def keep(it, **state):
        saved.setdefault("s", state)

    full = cgls_normal_checkpointed(op, b, x0, 20, chunk=6, callback=keep,
                                    device=cuda)
    res = cgls_normal_checkpointed(op, b, x0, 20, chunk=6,
                                   resume_state=saved["s"], device=cuda)
    with loop.eager():
        eager = cgls_normal_checkpointed(op, b, x0, 20, chunk=6, device=cuda)
    assert int(saved["s"]["k"]) == 6
    assert _same_bits(res, full) and _same_bits(full, eager)


SEARCH_CASES = ["fused_gks gcv", "fused_gks l_curve", "fused_gks dp",
                "fused_mmgks dp", "fused_hybrid_lsqr gcv"]


@pytest.mark.parametrize("name", SEARCH_CASES)
def test_fused_search_graph_bitwise_eager(cuda, demo64, name):
    """The fused solvers' Brent and Newton searches replayed on the card:
    x and the lambda sequence the eager searches' to the bit, K2/K3
    launched as often."""
    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.solvers import fused as F

    d = demo64
    op, b = d["ops"]["cuda"], d["b"].to(cuda)
    L = FirstDerivative2D(d["nx"], d["nx"], device=cuda)
    solver, mode = name.split()
    kw = dict(n_iter=6, regparam_mode=mode, delta=d["delta"], device=cuda)
    if solver != "fused_hybrid_lsqr":
        kw.update(projection_dim=3)
    args = (op, b) if solver == "fused_hybrid_lsqr" else (op, b, L)
    (rg, bg, _), (re, be, _) = _graph_and_eager(
        lambda: getattr(F, solver)(*args, **kw))
    assert _same_bits(rg[:2], re[:2]) and bg == be
    assert torch.isfinite(rg[1]).all()


def test_device_searches_graph_bitwise_eager(cuda):
    """``gcv_lambda`` and ``lcurve_lambda`` (Brent over k x k solves,
    ``torch.linalg.solve_ex`` captured) and ``dp_lambda`` (Newton), in
    float32 and float64, replayed: the eager lam to the bit."""
    from trips_tpu_torch.regparam import device as td

    rng = np.random.default_rng(0)
    k = 10
    R_A = np.triu(rng.standard_normal((k, k))) + np.diag(np.logspace(0, -4,
                                                                     k))
    R_L, bp = np.eye(k), rng.standard_normal(k)
    B = np.eye(k + 1)[:, :k] * 0.5 + np.eye(k + 1, k, -1) * 0.3
    bb = rng.standard_normal(k + 1)
    for dt in (np.float32, np.float64):
        for fn, args in ((td.gcv_lambda, (R_A, R_L, bp)),
                         (td.lcurve_lambda, (R_A, R_L, bp)),
                         (td.dp_lambda, (B, bb, 0.2 * np.linalg.norm(bb)))):
            args = [a.astype(dt) if isinstance(a, np.ndarray) else a
                    for a in args]
            (g, _, _), (e, _, _) = _graph_and_eager(
                lambda: fn(*args, device=cuda))
            assert _same_bits(g, e), (fn, dt, float(g), float(e))


def test_failed_capture_raises(cuda):
    """A step that reads the host cannot be captured: the loop raises (it
    never falls back to stepping eagerly), leaves the launch counts as
    they were and the card usable."""
    from trips_tpu_torch.krylov import cgls

    class HostRead(BucketedBandedProjector):
        def matvec(self, x):
            float(x.sum())  # a sync: refused while capturing
            return super().matvec(x)

    op = _op(cuda, None)
    bad = HostRead.__new__(HostRead)
    bad.__dict__.update(op.__dict__)
    b = op.matvec(torch.rand(op.shape[1], device=cuda))
    x0 = torch.zeros(op.shape[1], device=cuda)
    bk.reset_launch_counts()
    with pytest.raises(RuntimeError):
        cgls(bad, b, x0, 10, 0.0)
    torch.cuda.synchronize()
    # the eager first step's launches, no capture's
    assert bk.launch_counts == {"banded_fwd": 2, "banded_adj": 2,
                                "banded_ata": 0}
    x, k = cgls(op, b, x0, 10, 0.0)
    assert k == 10 and torch.isfinite(x).all()


def test_graph_memory_does_not_grow(cuda, demo64):
    """One Brent graph a fused iteration, freed when its search returns;
    the pool they share is reused: a second solve reserves no more device
    memory than the first left reserved."""
    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.solvers import fused as F

    d = demo64
    op, b = d["ops"]["cuda"], d["b"].to(cuda)
    L = FirstDerivative2D(d["nx"], d["nx"], device=cuda)

    def solve():
        return F.fused_gks(op, b, L, projection_dim=3, n_iter=10,
                           regparam_mode="gcv", device=cuda)

    solve()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    solve()
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() <= reserved


def test_device_busy_ms_reads_graph_replays(cuda):
    """``telemetry.device_busy_ms`` on a profile of replayed graphs: the
    profiler records each replayed kernel, so the busy time of a replayed
    ``cgls_normal`` is the eager solve's within the profiler's spread; a
    card profile with no device kernel still raises."""
    import contextlib

    from trips_tpu_torch.core import loop
    from trips_tpu_torch.krylov import cgls_normal
    from trips_tpu_torch.utils.telemetry import device_busy_ms

    op = _op(cuda, None)
    b = op.matvec(torch.rand(op.shape[1], device=cuda))
    x0 = torch.zeros(op.shape[1], device=cuda)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    busy = {}
    for label, ctx in (("graph", contextlib.nullcontext),
                       ("eager", loop.eager)):
        with ctx():
            cgls_normal(op, b, x0, 24)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=act) as prof:
                cgls_normal(op, b, x0, 24)
                torch.cuda.synchronize()
        busy[label] = device_busy_ms(prof)
        names = {e.key for e in prof.key_averages()}
        assert any("ata_kernel" in n for n in names), label
    assert 0.5 * busy["eager"] <= busy["graph"] <= 1.5 * busy["eager"], busy
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        device_busy_ms(prof)


def test_trace_spans_of_replayed_loops(cuda, demo64, tmp_path):
    """The span recorder on the card: one ``loop.capture`` inside the
    ``loop.cgls_normal`` span of a replayed solve and inside each
    ``loop.brent`` search of ``fused_gks``, as many as the loops' own
    ``captures``; ``core.loop.TRACE`` reads the same with the recorder on
    as off; under a CUDA profiler session every span is a
    ``user_annotation`` of the exported trace, and the busy time counts no
    annotation."""
    import json

    from trips_tpu_torch.core import loop
    from trips_tpu_torch.krylov import cgls_normal
    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.solvers import fused as F
    from trips_tpu_torch.utils import telemetry

    d = demo64
    op, b = d["ops"]["cuda"], d["b"].to(cuda)
    L = FirstDerivative2D(d["nx"], d["nx"], device=cuda)
    x0 = torch.zeros(op.shape[1], device=cuda)

    def solves():
        loop.TRACE = []
        try:
            cgls_normal(op, b, x0, 24)
            F.fused_gks(op, b, L, projection_dim=3, n_iter=4,
                        regparam_mode="gcv", device=cuda)
            torch.cuda.synchronize()
            return [(n, r, None if s is None else int(s))
                    for n, r, s in loop.TRACE]
        finally:
            loop.TRACE = None

    off = solves()
    with telemetry.tracing() as t:
        on = solves()
    assert on == off
    loops = [s for s in t.spans if s.name in ("loop.cgls_normal",
                                              "loop.brent")]
    assert [s.name for s in loops] == ["loop.cgls_normal"] + ["loop.brent"] * 4
    captures = [s for s in t.spans if s.name == "loop.capture"]
    for s in loops:
        assert s.attrs["captures"] == 1
        assert sum(c.parent is s for c in captures) == 1
    assert len(captures) == len(loops)
    assert [(s.name[5:], s.attrs["reads"]) for s in loops] == \
        [(n, r) for n, r, _ in off if n in ("cgls_normal", "brent")]

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        with telemetry.tracing() as t:
            solves()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = sorted((e["ts"], e["name"]) for e in events
                 if e.get("cat") == "user_annotation")
    assert [n for _, n in ann] == [s.name for s in t.spans]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    window = max(b for _, b in kernels) - min(a for a, _ in kernels)
    assert 0 < telemetry.device_busy_ms(prof) * 1e3 <= window


# ---- the tall-skinny QR of MMGKS's panels (csrc/tsqr.cu) -------------------
TSQR_M = [1, 100, 71610, 1622016]
TSQR_K = [1, 4, 23, 25, 64, 128]
# float32: the kernel and cuSOLVER's float32 QR both within 1e-6 or so of
# the float64 R on these well-conditioned Gaussian panels; 2e-5 leaves
# room for 1.6M-row sums. float64: backward stable Householder, 1e-12.
TSQR_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _tsqr_gaps(R, X):
    """(Gram gap, signed gap or None) of R against the float64 panel X:
    ||R^T R - X^T X|| / ||X^T X||, and, where the panel has at least 4k
    rows (so that R's rows are well determined), ||D R - R_l|| / ||R_l||
    for LAPACK's R_l (float64) with D the signs matching the diagonals."""
    R, (m, k) = R.double(), X.shape
    G = X.T @ X
    gram = float((R.T @ R - G).norm() / G.norm())
    if m < 4 * k:
        return gram, None
    Rl = torch.linalg.qr(X, mode="r")[1]
    d = torch.sign(torch.diagonal(R) * torch.diagonal(Rl))
    return gram, float((d[:, None] * R - Rl).norm() / Rl.norm())


@pytest.mark.parametrize("k", TSQR_K)
@pytest.mark.parametrize("m", TSQR_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tall_r_kernel(cuda, dtype, m, k):
    """``tsqr_geqrf`` weighted and unweighted against LAPACK's float64 QR
    (R^T R, and R up to row signs), weighted against the plain version on
    the card (the same plan; skipped where the plain version's k steps a
    tile would take seconds: 1.6M rows at k >= 64); one launch a call,
    bitwise repeatable; zeros below the diagonal."""
    from trips_tpu_torch.sparse import tall_qr

    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    w = torch.rand(m, generator=g, device=cuda, dtype=dtype) + 0.25
    tol = TSQR_TOL[dtype]
    before = dict(tall_qr.launch_counts)
    R = tall_qr.tall_r(x, w)
    assert tall_qr.launch_counts["tsqr_geqrf"] == before["tsqr_geqrf"] + 1
    assert tall_qr.launch_counts["qr_library"] == before["qr_library"]
    assert R.shape == (k, k) and R.dtype == dtype and R.device.type == "cuda"
    assert torch.equal(R, R.triu())
    assert torch.equal(R, tall_qr.tall_r(x, w))
    for Rk, X in ((R, x.double() * w.double()[:, None]),
                  (tall_qr.tall_r(x), x.double())):
        gram, signed = _tsqr_gaps(Rk, X)
        assert gram <= tol and (signed is None or signed <= tol), \
            (gram, signed)
    if m < 10 ** 6 or k <= 25:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        Rp = tall_qr.tall_r_ref(x, w, n_sm=sms)
        gram = float((R.double().T @ R.double() - Rp.double().T
                      @ Rp.double()).norm() / (Rp.double().T
                                               @ Rp.double()).norm())
        assert gram <= tol
        if m >= 4 * k:
            assert _rel(R, Rp) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("col", [0, 3, 24])
def test_tall_r_zero_column(cuda, dtype, col):
    """A zero column: tau 0 (LAPACK larfg), R's column exactly zero."""
    from trips_tpu_torch.sparse.tall_qr import tall_r

    g = torch.Generator(device=cuda).manual_seed(col)
    x = torch.randn(71610, 25, generator=g, device=cuda, dtype=dtype)
    x[:, col] = 0
    w = torch.rand(71610, generator=g, device=cuda, dtype=dtype) + 0.25
    R = tall_r(x, w)
    assert torch.all(R[:, col] == 0)
    gram, signed = _tsqr_gaps(R, x.double() * w.double()[:, None])
    assert gram <= TSQR_TOL[dtype]


def test_tall_r_wide_panel_takes_the_library(cuda):
    """Wider than 128 columns: torch.linalg.qr, counted as such."""
    from trips_tpu_torch.sparse import tall_qr

    x = torch.randn(3000, 130, device=cuda, dtype=torch.float64)
    before = dict(tall_qr.launch_counts)
    R = tall_qr.tall_r(x)
    assert tall_qr.launch_counts["qr_library"] == before["qr_library"] + 1
    assert tall_qr.launch_counts["tsqr_geqrf"] == before["tsqr_geqrf"]
    gram, signed = _tsqr_gaps(R, x)
    assert gram <= 1e-12 and signed <= 1e-12


def _mmgks_dyn(problem, dev, n_iter, dtype, regparam):
    from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
    from trips_tpu_torch.solvers import MMGKS
    from trips_tpu_torch.sparse import CsrOperator

    A, b, AA, B, nx, ny, nt, delta, x, al = problem
    op = (CsrOperator.from_scipy(A, dtype=np.float64, device=dev)
          if dtype == torch.float64 else _dyn(problem, "flat", None, dev))
    L = CenteredSpaceTimeDerivative(nx, ny, nt, device=dev)
    bt = torch.as_tensor(np.asarray(b).reshape(-1), dtype=dtype, device=dev)
    return MMGKS(op, bt, L, pnorm=2, qnorm=1, projection_dim=4,
                 n_iter=n_iter, regparam=regparam, delta=float(delta),
                 isoTV="isoTV", prob_dims=(nx, ny, nt))


def test_mmgks_iteration_launches_tsqr(cuda, dynamic32):
    """Each host MMGKS iteration: two ``tsqr_geqrf`` launches (the data
    panel with its two data columns, the weighted regularizer panel), no
    library QR."""
    from trips_tpu_torch.sparse import tall_qr

    for n_iter in (1, 3):
        tall_qr.reset_launch_counts()
        _mmgks_dyn(dynamic32, cuda, n_iter, torch.float32, "gcv")
        assert tall_qr.launch_counts == {"tsqr_geqrf": 2 * n_iter,
                                         "qr_library": 0}


def test_mmgks_float64_matches_cpu(cuda, dynamic32):
    """Host MMGKS (isotropic TV, the discrepancy principle) in float64 over
    the CSR operator on the card (``tsqr_geqrf``) and on the CPU (the
    plain version): every iterate and every lambda within 1e-8. DP's root
    is well conditioned (two CPU runs in another rounding order: 2e-15);
    GCV's case is the next test."""
    out = {dev: _mmgks_dyn(dynamic32, dev, 8, torch.float64, "dp")
           for dev in (cuda, "cpu")}
    (xc, ic), (xh, ih) = out[cuda], out["cpu"]
    assert _rel(xc.cpu(), xh) <= 1e-8
    assert len(ic["xHistory"]) == len(ih["xHistory"]) == 8
    for a, b in zip(ic["xHistory"], ih["xHistory"]):
        assert _rel(a.cpu(), b) <= 1e-8
    lc, lh = (np.asarray(i["regParam_history"]) for i in (ic, ih))
    assert lh[-1] > 0
    np.testing.assert_allclose(lc, lh, rtol=1e-8, atol=0)


# GCV on dynamic32 in float64 (8 iterations): lambda settles in GCV's flat
# bottom (1e-7..1e-6 after the first iterations), where two CPU runs of the
# same arithmetic in another rounding order (b scaled by 1 +- 1e-15..5e-14,
# or the leaves of a plan for 1 or 2 SMs) choose lambdas up to 3.4x apart,
# their iterates part by up to 1.1e-8, and each run's lambda scores within
# 2.0e-7 of the other's minimum on the other's projected problem. The card
# is held to ten times those readings.
GCV_X_RTOL, GCV_SCORE_RTOL = 1e-7, 2e-6


def test_mmgks_float64_gcv_matches_cpu(cuda, dynamic32, monkeypatch):
    """Host MMGKS with GCV in float64 on the card and on the CPU: every
    iterate within GCV_X_RTOL; at each iteration the card's lambda scores,
    on the CPU run's projected problem, within GCV_SCORE_RTOL of the
    CPU's lambda (the GCV function is flat there, so lambda itself is not
    held)."""
    import trips_tpu_torch.solvers.mmgks as mm
    from trips_tpu_torch.regparam.gcv import _gcv_terms

    select, seen = mm._select_lambda, []

    def recorded(regparam, R_A, R_L, bproj, *rest):
        seen.append((R_A.copy(), R_L.copy(), np.asarray(bproj).copy()))
        return select(regparam, R_A, R_L, bproj, *rest)

    monkeypatch.setattr(mm, "_select_lambda", recorded)
    out = {}
    for dev in (cuda, "cpu"):
        seen.clear()
        out[dev] = _mmgks_dyn(dynamic32, dev, 8, torch.float64, "gcv")
    (xc, ic), (xh, ih) = out[cuda], out["cpu"]
    assert len(ic["xHistory"]) == len(ih["xHistory"]) == len(seen) == 8
    assert _rel(xc.cpu(), xh) <= GCV_X_RTOL
    for a, b in zip(ic["xHistory"], ih["xHistory"]):
        assert _rel(a.cpu(), b) <= GCV_X_RTOL

    def score(lam, R_A, R_L, bproj):
        num, trace = _gcv_terms(lam, R_A, R_L, bproj.reshape(-1, 1))
        return num / (R_A.shape[0] - trace) ** 2

    for lc, lh, problem in zip(ic["regParam_history"],
                               ih["regParam_history"], seen):
        assert lc > 0 and lh > 0
        assert abs(score(lc, *problem) / score(lh, *problem) - 1) \
            <= GCV_SCORE_RTOL, (lc, lh)
