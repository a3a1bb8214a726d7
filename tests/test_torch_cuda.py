"""K1-K6 and the operators on a CUDA card against their plain versions
and the CPU (marked ``cuda``).

Without a card every test here skips. On a card (no JAX needed):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Float32 sums run in another order (and the banded adjoints with atomics),
so the kernels agree with the plain versions to 1e-5 of the norm. A
bfloat16 output (K4's canvases, K6's U before its second product) may
round an entry one bf16 step the other way: 1e-3 there. K6's float32 path
sums 3xTF32 products (each within 2^-22 of the float32 product), also held
to 1e-5.
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
