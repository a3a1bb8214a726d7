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
