"""The shear-rotate fan projector: trips_tpu_torch against trips_tpu.

Kernels K4-K6 (their plain versions, on the CPU) against the Pallas
kernels in interpret mode, and the port's ``ShearFanProjector`` against the
JAX operator's XLA path, on the same arrays carried across with
``ShearFanProjector.from_numpy`` (nx = 32, 8 views: C = 64, quarter groups
3/3/2). Tolerances:

- K4, K5 float32: 1e-6 relative (the same float32 arithmetic, another
  order of operations).
- K6: rtol 2e-5, atol 2e-4, the JAX package's own test tolerance.
- The operator: float64 1e-12, float32 1e-5 relative. With a bfloat16
  ``G`` the port follows the JAX package's kernel path, which rounds the
  sinogram to bfloat16 before the transposed product
  (``fan_shear.py:276-279``); the JAX XLA path on the CPU transposes the
  forward and does not. Measured here: ``matvec`` 5.7e-8, ``rmatvec``
  2.5e-3, ``normal_matvec`` 1.6e-3; gates 1e-6 and 1e-2.
- CGLS in float64: 8 views of a 32x32 image leave the system far
  underdetermined, and CG amplifies the roundoff of two correct float64
  runs about fivefold per iteration from the first one on (measured
  iterate gaps: 2e-16 at iteration 1, 7e-12 at 8, 5e-10 at 10, 9e-3 at
  30; relError gaps 3e-3 at most). The first 8 iterates are held to 1e-9
  relative and the relError histories of all 30 to 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trips_tpu.krylov import cgls_history as jax_cgls_history
from trips_tpu.operators.fan_shear import ShearFanProjector as JaxShearFan
from trips_tpu.operators.pallas_shear import (gcontract_ata_pallas,
                                              rotate_all_adjoint_pallas,
                                              rotate_all_pallas)
from trips_tpu_torch.core import DenseOperator
from trips_tpu_torch.krylov import cgls_history
from trips_tpu_torch.operators import ShearFanProjector
from trips_tpu_torch.operators import shear_kernels as sk
from trips_tpu_torch.problems import fan_beam_matrix
from trips_tpu_torch.problems.phantoms import grains

from torch_threads import one_torch_thread  # noqa: F401

NX, VIEWS = 32, 8
KINDS = {"float64": (jnp.float64, jnp.float64, torch.float64, torch.float64),
         "float32": (jnp.float32, jnp.float32, torch.float32, torch.float32),
         "bfloat16": (jnp.float32, jnp.bfloat16, torch.float32,
                      torch.bfloat16)}
# relative gates (matvec, rmatvec, normal_matvec) per kind, see above
OP_TOL = {"float64": (1e-12,) * 3, "float32": (1e-5,) * 3,
          "bfloat16": (1e-6, 1e-2, 1e-2)}
NONDEFAULT = dict(det_count=40, det_width=1.1, source_origin=2.5 * 24,
                  origin_det=1.5 * 24)

_mv = jax.jit(lambda op, x: op.matvec(x))
_rmv = jax.jit(lambda op, y: op.rmatvec(y))


def _port(jop, dtype, g_dtype):
    """The port's operator on the JAX operator's bytes."""
    return ShearFanProjector.from_numpy(
        np.asarray(jop.G.astype(jnp.float64)), np.asarray(jop._kx),
        np.asarray(jop._fx), np.asarray(jop._ky), np.asarray(jop._fy),
        jop._kq, jop._C, jop.nx, jop.det_count, jop._so, jop._od, jop._dw,
        dtype=dtype, g_dtype=g_dtype, device="cpu")


@pytest.fixture(scope="module")
def ops():
    """kind -> (JAX operator, port operator) at nx = 32, 8 views."""
    out = {}
    for kind, (jdt, jg, tdt, tg) in KINDS.items():
        jop = JaxShearFan(NX, views=VIEWS, dtype=jdt, g_dtype=jg)
        out[kind] = (jop, _port(jop, tdt, tg))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _shifts(jop):
    return [_t(a) for a in (jop._kx, jop._fx, jop._ky, jop._fy)] + [
        torch.tensor(jop._kq, dtype=torch.int32)]


@pytest.mark.parametrize("geometry", ["default", "nondefault"])
def test_host_setup_matches_jax(ops, geometry):
    """The port's own constructor gives the JAX operator's arrays: the
    shifts exactly, ``G`` to 1e-14 (XLA may contract the float64 hat
    arithmetic differently; measured: 1 ulp in 144 entries of the
    non-default geometry, none in the default one)."""
    if geometry == "default":
        jop, kw, nx, views = ops["float64"][0], {}, NX, VIEWS
    else:
        kw, nx, views = NONDEFAULT, 24, 6
        jop = JaxShearFan(nx, views=views, dtype=jnp.float64, **kw)
    top = ShearFanProjector(nx, views=views, dtype=torch.float64,
                            device="cpu", **kw)
    assert (top._C, top._kq, top.shape) == (jop._C, jop._kq, jop.shape)
    for name in ("_kx", "_fx", "_ky", "_fy"):
        assert np.array_equal(getattr(top, name).numpy(),
                              np.asarray(getattr(jop, name))), name
    np.testing.assert_allclose(top.G.numpy(), np.asarray(jop.G), rtol=1e-14,
                               atol=0)
    if geometry == "default":
        jb, tb = ops["bfloat16"][0], ShearFanProjector(
            nx, views=views, g_dtype=torch.bfloat16, device="cpu")
        assert np.array_equal(tb.G.float().numpy(),
                              np.asarray(jb.G.astype(jnp.float32)))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_rotate_matches_pallas_interpret(ops, out, rng):
    """K4: gate 1e-6 for float32 output; a bfloat16 output may differ by
    one rounding step where the float32 value lies near a bf16 midpoint
    (gate 1e-3, measured 0)."""
    jop = ops["float32"][0]
    X = jnp.asarray(rng.standard_normal((NX, NX)).astype(np.float32))
    Q = jop._quarters(X).astype(jnp.float32)
    jdt, tdt = (jnp.float32, torch.float32) if out == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    ref = rotate_all_pallas(Q, jop._kx, jop._fx, jop._ky, jop._fy, jop._kq,
                            out_dtype=jdt, interpret=True)
    got = sk.shear_rotate(_t(Q), *_shifts(jop), out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    err = _rel(got.float(), ref.astype(jnp.float32))
    assert err <= (1e-6 if out == "float32" else 1e-3), err


@pytest.mark.parametrize("inp", ["float32", "bfloat16"])
def test_rotate_adjoint_matches_pallas_interpret(ops, inp, rng):
    """K5 on the same float32 or bfloat16 cotangents: 1e-6 relative."""
    jop = ops["float32"][0]
    C = jop._C
    g = jnp.asarray(rng.standard_normal((VIEWS, C, C)).astype(np.float32))
    if inp == "bfloat16":
        g = g.astype(jnp.bfloat16)
    ref = rotate_all_adjoint_pallas(g, jop._kx, jop._fx, jop._ky, jop._fy,
                                    jop._kq, out_dtype=jnp.float32,
                                    interpret=True)
    got = sk.shear_rotate_adjoint(_t(g.astype(jnp.float32)).to(
        torch.bfloat16 if inp == "bfloat16" else torch.float32),
        *_shifts(jop))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, C, C)
    assert _rel(got, ref) <= 1e-6


def test_rotate_adjoint_identity(ops, rng):
    """<rot(X), g> == <X, rot_T(g)> through the quarter turns and the crop
    (float64)."""
    top = ops["float64"][1]
    X = torch.from_numpy(rng.standard_normal((NX, NX)))
    g = torch.from_numpy(rng.standard_normal((VIEWS, top._C, top._C)))
    lhs = float((top._rotate(X) * g).sum())
    rhs = float((X * top._rotate_adjoint(g)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_gcontract_matches_pallas_interpret(ops, kind, rng):
    """K6 against the fused Pallas contraction, tile by tile in interpret
    mode, in its float32 accumulator: rtol 2e-5, atol 2e-4."""
    jop, top = ops[kind]
    C = jop._C
    R = jnp.asarray(rng.standard_normal((VIEWS, C, C)).astype(np.float32))
    R = R.astype(jop.G.dtype)
    ref = gcontract_ata_pallas(R, jop.G, acc_dtype=jnp.float32,
                               interpret=True)
    got = sk.gcontract_ata(_t(R.astype(jnp.float32)).to(top.g_dtype), top.G)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-4)


@pytest.mark.parametrize("kind", list(KINDS))
def test_operator_matches_jax(ops, kind, rng, monkeypatch):
    jop, top = ops[kind]
    dt = np.dtype(KINDS[kind][0])
    x = rng.standard_normal(jop.shape[1]).astype(dt)
    y = rng.standard_normal(jop.shape[0]).astype(dt)
    jAx = _mv(jop, jnp.asarray(x))
    ref = {"matvec": jAx, "rmatvec": _rmv(jop, jnp.asarray(y)),
           "normal_matvec": _rmv(jop, jAx)}
    tol = dict(zip(ref, OP_TOL[kind]))
    for name, v in (("matvec", x), ("rmatvec", y), ("normal_matvec", x)):
        got = getattr(top, name)(torch.from_numpy(v))
        assert got.dtype == torch.from_numpy(v).dtype
        err = _rel(got, ref[name])
        assert err <= tol[name], (name, err)
    monkeypatch.setenv("TRIPS_TPU_SHEAR_ATA", "1")
    err = _rel(top.normal_matvec(torch.from_numpy(x)), ref["normal_matvec"])
    assert err <= tol["normal_matvec"], ("normal_matvec, K6 path", err)


@pytest.mark.parametrize("nx,views,kw", [
    (32, 8, {}), (16, 5, {"det_count": 31}), (24, 6, NONDEFAULT)])
def test_adjoint_exact(nx, views, kw, rng, monkeypatch):
    op = ShearFanProjector(nx, views=views, dtype=torch.float64,
                           device="cpu", **kw)
    x = torch.from_numpy(rng.standard_normal(op.shape[1]))
    y = torch.from_numpy(rng.standard_normal(op.shape[0]))
    np.testing.assert_allclose(float(op.matvec(x) @ y),
                               float(x @ op.rmatvec(y)), rtol=1e-12)
    ref = op.rmatvec(op.matvec(x))
    monkeypatch.setenv("TRIPS_TPU_SHEAR_ATA", "1")
    assert _rel(op.normal_matvec(x), ref) <= 1e-12


def test_nondefault_geometry_close_to_siddon():
    """Custom distances and detector grid: the sinogram of a smooth image
    tracks the matching Siddon matrix (the models differ only by their
    pixel-scale footprints), as the JAX package's test holds it."""
    nx, views = 24, 6
    A = fan_beam_matrix(nx, views=views, **NONDEFAULT)
    op = ShearFanProjector(nx, views=views, dtype=torch.float64,
                           device="cpu", **NONDEFAULT)
    yy, xx = np.mgrid[0:nx, 0:nx]
    sm = np.exp(-(((xx - 14.0) ** 2 + (yy - 8.0) ** 2) / 12.0)).reshape(-1)
    assert _rel(op.matvec(torch.from_numpy(sm)), A @ sm) < 0.08


def test_matmat_consistent(ops, rng):
    top = ops["float64"][1]
    X = torch.from_numpy(rng.standard_normal((top.shape[1], 3)))
    Y = torch.from_numpy(rng.standard_normal((top.shape[0], 2)))
    AX, AtY = top.matmat(X), top.rmatmat(Y)
    assert tuple(AX.shape) == (top.shape[0], 3)
    assert tuple(AtY.shape) == (top.shape[1], 2)
    for k in range(3):
        np.testing.assert_allclose(AX[:, k], top.matvec(X[:, k]), atol=1e-12)
    for k in range(2):
        np.testing.assert_allclose(AtY[:, k], top.rmatvec(Y[:, k]),
                                   atol=1e-12)
    np.testing.assert_allclose((top @ X).numpy(), AX.numpy(), atol=1e-12)


def test_cgls_history_matches_jax(ops, rng):
    """30 float64 CGLS iterates on noisy Siddon data (1%), the port's plain
    path against the JAX XLA path (gates in the module docstring)."""
    jop, top = ops["float64"]
    xt = grains(NX, seed=0).reshape(-1)
    b = fan_beam_matrix(NX, views=VIEWS) @ xt
    e = rng.standard_normal(len(b))
    b = b + 0.01 * np.linalg.norm(b) / np.linalg.norm(e) * e
    _, jk, jxs, _ = jax_cgls_history(jop, jnp.asarray(b),
                                     jnp.zeros(NX * NX), 30, 0.0)
    _, tk, txs, _ = cgls_history(top, torch.from_numpy(b),
                                 torch.zeros(NX * NX, dtype=torch.float64),
                                 30, 0.0)
    assert tk == int(jk) == 30
    jxs, txs = np.asarray(jxs), txs.numpy()
    gap = np.linalg.norm(txs - jxs, axis=1) / np.linalg.norm(jxs, axis=1)
    assert gap[:8].max() <= 1e-9, gap

    def rel_err(xs):
        return np.linalg.norm(xs - xt, axis=1) / np.linalg.norm(xt)

    np.testing.assert_allclose(rel_err(txs), rel_err(jxs), rtol=0,
                               atol=1e-2)


def test_cgls_reconstruction_parity(rng):
    """Semiconvergence minima match the exact-matrix reconstruction at 2%
    noise (data from the Siddon matrix), as the JAX package's test holds
    its operator (nx = 64, 20 views, float64, port only)."""
    nx, views, noise = 64, 20, 0.02
    A = fan_beam_matrix(nx, views=views)
    op = ShearFanProjector(nx, views=views, dtype=torch.float64,
                           device="cpu")
    xt = grains(nx, seed=0).reshape(-1)
    b_true = A @ xt
    e = rng.standard_normal(len(b_true))
    e *= noise * np.linalg.norm(b_true) / np.linalg.norm(e)
    b = torch.from_numpy(b_true + e)
    x0 = torch.zeros(nx * nx, dtype=torch.float64)
    _, _, xs_ref, _ = cgls_history(DenseOperator(A.toarray()), b, x0, 40,
                                   0.0)
    _, _, xs_sh, _ = cgls_history(op, b, x0, 40, 0.0)

    def errs(xs):
        return np.linalg.norm(xs.numpy() - xt, axis=1) / np.linalg.norm(xt)

    e_ref, e_sh = errs(xs_ref), errs(xs_sh)
    assert e_sh.min() < 1.2 * e_ref.min()
    assert abs(int(np.argmin(e_sh)) - int(np.argmin(e_ref))) <= 3


def test_wrappers_refuse_other_devices(ops):
    top = ops["float32"][1]
    C, na = top._C, top.n_angles
    meta = torch.device("meta")
    kx, fx, ky, fy, kq = (t.to(meta) for t in top._shifts())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sk.shear_rotate(torch.empty(3, C, C, device=meta), kx, fx, ky, fy, kq)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sk.shear_rotate_adjoint(torch.empty(na, C, C, device=meta), kx, fx,
                                ky, fy, kq)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sk.gcontract_ata(torch.empty(na, C, C, device=meta),
                         top.G.to(meta))


@pytest.mark.parametrize("env", ["0", "1"])
@pytest.mark.parametrize("fused", [True, False, None])
def test_fused_ata_switch(fused, env, rng, monkeypatch):
    """``fused_ata`` True runs K6 and False the product pair whatever
    ``TRIPS_TPU_SHEAR_ATA`` says; None follows the variable. Both paths
    agree in float64; ``from_numpy`` and ``to`` keep the switch."""
    monkeypatch.setenv("TRIPS_TPU_SHEAR_ATA", env)
    op = ShearFanProjector(16, views=5, dtype=torch.float64, device="cpu",
                           fused_ata=fused)
    calls = []

    def ata(R, G):  # the K6 wrapper, counted (over the class's)
        calls.append(1)
        return sk.gcontract_ata(R, G)

    op._ata = ata
    x = torch.from_numpy(rng.standard_normal(op.shape[1]))
    got = op.normal_matvec(x)
    assert len(calls) == (env == "1" if fused is None else fused)
    assert _rel(got, op.rmatvec(op.matvec(x))) <= 1e-12
    assert op.to("cpu").fused_ata is fused
    again = ShearFanProjector.from_numpy(
        op.G.numpy(), op._kx.numpy(), op._fx.numpy(), op._ky.numpy(),
        op._fy.numpy(), op._kq, op._C, op.nx, op.det_count, op._so, op._od,
        op._dw, dtype=torch.float64, device="cpu", fused_ata=fused)
    assert again.fused_ata is fused
    assert torch.equal(again.normal_matvec(x), got)


def test_fused_ata_refuses_other_values():
    with pytest.raises(ValueError, match="fused_ata"):
        ShearFanProjector(16, views=5, device="cpu", fused_ata="1")


def test_shear_g_span():
    """Building G is the span ``shear.g`` under ``tracing()``; the CPU
    wrappers make no K4/K5 plan, so no ``shear.plan``."""
    from trips_tpu_torch.utils import telemetry

    with telemetry.tracing() as tr:
        op = ShearFanProjector(16, views=5, device="cpu", fused_ata=True)
        op.normal_matvec(torch.zeros(op.shape[1]))
    names = [s.name for s in tr.spans]
    assert names.count("shear.g") == 1 and "shear.plan" not in names
    g = tr.spans[names.index("shear.g")]
    assert g.end_ns > g.start_ns
