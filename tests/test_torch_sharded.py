"""The sharded operators over several ranks: real process groups on the CPU.

A module fixture writes the inputs once (scipy matrices from the JAX
package's generators, vectors from a seed) and starts
``tests/torch_dist_worker.py``'s ``main`` in ``world`` processes with
``torch.multiprocessing`` (spawn), once at world 2 (the static classes on
{'rows': 2} and {'angles': 2}) and once at world 4 (the dynamic ones on
(time 2, rows 2) from ``pod_mesh(time_shards=2)`` and on (time 2, angles
2)), over gloo on 127.0.0.1. Every wait is bounded: 60 s inside the group,
120 s for the parent's join of both worlds (run at once), after which the
workers are killed. Each
rank saves its outputs; each leg below is one test case holding rank 0's
against the JAX package's result on ``trips_tpu.parallel.make_mesh`` of the
same shape (its applies and solvers under ``jax.jit``), with the tolerance
JAX's own test states for it (``tests/test_parallel.py``,
``tests/multihost_worker.py``: 1e-12/1e-10 float64 ELL, 1e-6 and 1e-4 the
CGLS solutions, 1e-6 GKS, 1e-5/1e-4 BSR, 2e-2 bfloat16 blocks, 2e-5 and
2e-4 float32 banded, 2e-4 and 5e-4 int8 and dynamic, 1e-3 the banded
solvers); ``test_ranks_agree`` holds every rank's outputs to rank 0's bit
for bit (whole vectors, every element reduced once and copied).
"""
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as tmp
from scipy import sparse as sp

import torch_dist_worker as worker
import trips_tpu.parallel as jpar
from torch_threads import one_torch_thread  # noqa: F401
from trips_tpu.krylov import cgls, cgls_normal
from trips_tpu.operators import FirstDerivative1D, SpaceTimeDerivative
from trips_tpu.problems import generate_synthetic_dynamic
from trips_tpu.problems.phantoms import shepp_logan
from trips_tpu.problems.projector import fan_beam_matrix
from trips_tpu.solvers import GKS
from trips_tpu.sparse import BandedProjector, EllOperator
from trips_tpu.sparse.banded_buckets import BucketedBandedProjector
from trips_tpu.sparse.dynamic_banded import (BucketedDynamicBandedOperator,
                                             DynamicBandedOperator)

JOIN_S = 120


def _inputs():
    rng = np.random.default_rng(0)
    d = {"ell_A": sp.random(96, 120, density=0.1, format="csr",
                            random_state=np.random.RandomState(5)),
         "ell_x": rng.standard_normal(120), "ell_y": rng.standard_normal(96)}
    cg = (sp.random(96, 96, density=0.2, format="csr",
                    random_state=np.random.RandomState(6))
          + sp.identity(96)).tocsr()
    d.update(cg_A=cg, cg_xt=rng.standard_normal(96))
    d["cg_b"] = cg @ d["cg_xt"]
    rs = np.random.RandomState(3)
    q1, _ = np.linalg.qr(rs.randn(96, 96))
    q2, _ = np.linalg.qr(rs.randn(96, 96))
    gks_A = q1 @ np.diag(np.logspace(0, -3, 96)) @ q2.T
    d.update(gks_A=gks_A, gks_b=gks_A @ np.sin(np.linspace(0, 3, 96))
             + 0.01 * rs.randn(96))
    d["bsr_A"] = sp.random(96, 250, density=0.1, format="csr",
                           random_state=np.random.RandomState(5)
                           ).astype(np.float32)
    d["bsr_x"] = rng.standard_normal(250).astype(np.float32)
    d["bsr_y"] = rng.standard_normal(96).astype(np.float32)
    d["bf16_A"] = sp.random(96, 128, density=0.15, format="csr",
                            random_state=np.random.RandomState(9)
                            ).astype(np.float32)
    d["bf16_x"] = rng.standard_normal(128).astype(np.float32)
    nx, views = 32, 12
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    xt = shepp_logan(nx).reshape(-1).astype(np.float32)
    d.update(fan_A=A, fan_nx=nx, fan_views=views, fan_b=A @ xt, fan_xt=xt,
             fan_x=rng.standard_normal(nx * nx).astype(np.float32),
             fan_y=rng.standard_normal(A.shape[0]).astype(np.float32))
    _, b, AA, _, nx, _, nt, _, x_true, al = generate_synthetic_dynamic(
        nx=16, nt=4, views=9, noise_level=0.01, return_angles=True)
    n, m = nt * nx * nx, sum(a.shape[0] for a in AA)
    d.update(dyn_AA=list(AA), dyn_nx=nx, dyn_nt=nt, dyn_b=b,
             dyn_xt=x_true, dyn_angles=np.array(al),
             dyn_x=rng.standard_normal(n), dyn_y=rng.standard_normal(m))
    return d


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, inputs, out_dir):
    """Start ``world`` ranks of the worker; -> their processes."""
    out_dir.mkdir()
    ctx = tmp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.main,
                         args=(r, world, port, str(inputs), str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, out_dir, deadline):
    """Wait for the ranks until ``deadline`` (``time.monotonic``), kill
    them past it; -> each rank's outputs."""
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0))
        alive = [p for p in procs if p.is_alive()]
        assert not alive, f"{len(alive)} ranks alive past {JOIN_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * len(procs), f"exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(out_dir / f"out{r}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """world -> each rank's outputs. Both worlds start at once; a world's
    ranks are joined when a test first asks for them."""
    root = tmp_path_factory.mktemp("sharded")
    path = root / "inputs.npz"
    worker.save_inputs(path, **inputs)
    started = {w: (_start(w, path, root / f"world{w}"), root / f"world{w}")
               for w in sorted(LEGS)}
    deadline = time.monotonic() + JOIN_S
    done = {}

    def get(world):
        if world not in done:
            done[world] = _join(*started[world], deadline)
        return done[world]

    yield get
    for w in started:  # a world no test asked for
        if w not in done:
            _join(*started[w], deadline)


def _japply(op, name, v):
    return np.asarray(jax.jit(lambda o, u: getattr(o, name)(u))(
        op, jnp.asarray(v)))


def _pad(v, n):
    return np.pad(v, (0, n - len(v)))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(b))


def _applies(out, name, op, x, y, tol):
    """matvec, rmatvec, normal_matvec of ``out``'s leg ``name`` on ``x``,
    ``y`` against JAX's sharded ``op``; ``tol``: (rtol, atol) of the
    forward/adjoint and of the normal apply; one all_reduce each."""
    (r1, a1), (r2, a2) = tol
    np.testing.assert_allclose(out[name + "_mv"], _japply(op, "matvec", x),
                               rtol=r1, atol=a1)
    np.testing.assert_allclose(out[name + "_rmv"], _japply(op, "rmatvec", y),
                               rtol=r1, atol=a1)
    np.testing.assert_allclose(out[name + "_nmv"],
                               _japply(op, "normal_matvec", x), rtol=r2,
                               atol=a2)
    np.testing.assert_array_equal(out[name + "_counts"], [1, 1, 1])


def _fan(d, kind, mesh, axis):
    A, nx, views = d["fan_A"], int(d["fan_nx"]), int(d["fan_views"])
    if kind == "banded":
        return jpar.ShardedBandedProjector.from_banded(
            BandedProjector.from_scipy_fan(A, nx, views, n_groups=8), mesh,
            axis=axis)
    return jpar.ShardedBucketedBandedProjector.from_bucketed(
        BucketedBandedProjector.from_scipy_fan(
            A, nx, views, n_groups=8, n_buckets=3 if kind == "bucketed"
            else 2, dtype="int8" if kind == "int8" else None), mesh,
        axis=axis)


def _dyn(d, kind):
    AA, nx, al = d["dyn_AA"], int(d["dyn_nx"]), list(d["dyn_angles"])
    mesh = jpar.make_mesh({"time": 2, "angles": 2})
    if kind == "dyn_banded":
        return jpar.ShardedDynamicBandedOperator.from_dynamic(
            DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8), mesh)
    return jpar.ShardedBucketedDynamicBandedOperator.from_dynamic(
        BucketedDynamicBandedOperator.from_frames(
            AA, nx, al, n_groups=8, n_buckets=2,
            dtype="int8" if kind == "dyn_int8" else None), mesh)


def _tv_steps(op, b, L, lam=0.01, steps=3):
    """``tests/test_parallel.py:62``'s regularized step, jitted, 3 times."""
    @jax.jit
    def step(op, bv, x):
        r = op.matvec(x) - bv
        g = op.rmatvec(r) + lam * L.rmatvec(L.matvec(x))
        return x - 0.01 * g, jnp.linalg.norm(g)

    x = jnp.zeros(op.shape[1], b.dtype)
    for _ in range(steps):
        x, gn = step(op, b, x)
    return np.asarray(x), float(gn)


def leg_ell(out, d):
    op = jpar.ShardedEllOperator.from_ell(EllOperator.from_scipy(d["ell_A"]),
                                          jpar.make_mesh({"rows": 2}))
    m, n = op.shape
    x, y = _pad(d["ell_x"], n), _pad(d["ell_y"], m)
    for got, name, v, ref in (
            (out["ell_mv"], "matvec", x, d["ell_A"] @ d["ell_x"]),
            (out["ell_rmv"], "rmatvec", y, d["ell_A"].T @ d["ell_y"])):
        np.testing.assert_allclose(got, _japply(op, name, v), atol=1e-12)
        np.testing.assert_allclose(got[:len(ref)], ref, atol=1e-12)


def leg_ell_cgls(out, d):
    op = jpar.ShardedEllOperator.from_ell(EllOperator.from_scipy(d["cg_A"]),
                                          jpar.make_mesh({"rows": 2}))
    xj, _ = cgls(op, jnp.asarray(d["cg_b"]), jnp.zeros(96), 300, 1e-12)
    assert _rel(out["ell_cgls"], d["cg_xt"]) < 1e-6
    assert _rel(out["ell_cgls"], np.asarray(xj)) < 1e-6


def leg_gks(out, d):
    op = jpar.ShardedEllOperator.from_ell(EllOperator.from_dense(d["gks_A"]),
                                          jpar.make_mesh({"rows": 2}))
    xj, _ = GKS(op, jnp.asarray(d["gks_b"]), FirstDerivative1D(96),
                projection_dim=3, n_iter=5, regparam="gcv")
    np.testing.assert_allclose(out["gks"], np.asarray(xj).reshape(-1),
                               atol=1e-6)


def leg_bsr(out, d):
    op = jpar.ShardedBsrOperator.from_scipy(
        d["bsr_A"], jpar.make_mesh({"rows": 2}), block_shape=(8, 16))
    m, n = op.shape
    x, y = _pad(d["bsr_x"], n), _pad(d["bsr_y"], m)
    for got, name, v, k in ((out["bsr_mv"], "matvec", x, 96),
                            (out["bsr_rmv"], "rmatvec", y, 250)):
        np.testing.assert_allclose(got, _japply(op, name, v), atol=1e-5)
        assert not got[k:].any()


def leg_bsr_cgls(out, d):
    op = jpar.ShardedBsrOperator.from_scipy(
        d["cg_A"], jpar.make_mesh({"rows": 2}), block_shape=(8, 16))
    b = _pad(d["cg_b"].astype(np.float32), op.shape[0])
    xj, _ = cgls(op, jnp.asarray(b), jnp.zeros(op.shape[1], jnp.float32),
                 300, 1e-12)
    assert _rel(out["bsr_cgls"][:96], d["cg_xt"]) < 1e-4
    assert _rel(out["bsr_cgls"], np.asarray(xj)) < 1e-4


def leg_bsr_bf16(out, d):
    op = jpar.ShardedBsrOperator.from_scipy(
        d["bf16_A"], jpar.make_mesh({"rows": 2}), block_shape=(8, 16),
        block_dtype=jnp.bfloat16)
    ref = d["bf16_A"] @ d["bf16_x"]
    xj = _japply(op, "matvec", _pad(d["bf16_x"], op.shape[1]))
    assert _rel(out["bf16_mv"][:96], ref) < 2e-2
    assert _rel(out["bf16_mv"], xj) < 2e-2


def leg_banded(out, d):
    _applies(out, "banded", _fan(d, "banded", jpar.make_mesh({"rows": 2}),
                                 "rows"),
             d["fan_x"], d["fan_y"], ((0, 2e-5), (2e-4, 2e-4)))


def leg_bucketed(out, d):
    _applies(out, "bucketed", _fan(d, "bucketed",
                                   jpar.make_mesh({"angles": 2}), "angles"),
             d["fan_x"], d["fan_y"], ((0, 2e-5), (2e-4, 2e-4)))


def leg_int8(out, d):
    _applies(out, "int8", _fan(d, "int8", jpar.make_mesh({"angles": 2}),
                               "angles"),
             d["fan_x"], d["fan_y"], ((2e-4, 2e-4), (5e-4, 5e-4)))


def leg_banded_solvers(out, d):
    """``tests/multihost_worker.py``'s legs 2 and 3 (5 iterations of
    ``cgls`` on the flat pack, of ``cgls_normal`` on int8) and
    ``test_parallel.py:329``'s 20 of ``cgls_normal``, within 1e-3."""
    b = jnp.asarray(d["fan_b"])
    x0 = jnp.zeros(int(d["fan_nx"]) ** 2, jnp.float32)
    flat = _fan(d, "banded", jpar.make_mesh({"rows": 2}), "rows")
    for key, solver, op, its in (
            ("banded_cgls", cgls, flat, 5),
            ("banded_cgn", cgls_normal, flat, 20),
            ("int8_cgn", cgls_normal, _fan(d, "int8", jpar.make_mesh(
                {"angles": 2}), "angles"), 5)):
        xj, _ = solver(op, b, x0, its, 0.0)
        assert _rel(out[key], np.asarray(xj)) < 1e-3, key


def leg_int8_4(out, d):
    """The int8 pack (buckets of 3 angles) on {'angles': 4}: rank 3 holds
    no angle and still takes part in every all_reduce."""
    _applies(out, "int8_4", _fan(d, "int8", jpar.make_mesh({"angles": 4}),
                                 "angles"),
             d["fan_x"], d["fan_y"], ((2e-4, 2e-4), (5e-4, 5e-4)))


def leg_pod_mesh(out, d):
    np.testing.assert_array_equal(out["pod_shape"], [2, 2])
    assert bool(out["no_jax"])


def leg_dyn_ell(out, d):
    op = jpar.ShardedDynamicOperator.from_blocks(
        d["dyn_AA"], jpar.make_mesh({"time": 2, "rows": 2}))
    for got, name, v in ((out["dyn_ell_mv"], "matvec", d["dyn_x"]),
                         (out["dyn_ell_rmv"], "rmatvec", d["dyn_y"])):
        np.testing.assert_allclose(got, _japply(op, name, v), atol=1e-10)
    nx, nt = int(d["dyn_nx"]), int(d["dyn_nt"])
    x, gn = _tv_steps(op, jnp.asarray(d["dyn_b"]),
                      SpaceTimeDerivative(nx, nx, nt))
    np.testing.assert_allclose(out["dyn_ell_tv"], x, atol=1e-10)
    np.testing.assert_allclose(out["dyn_ell_tv_gn"], gn, rtol=1e-10)


def leg_dyn_bsr(out, d):
    op = jpar.ShardedDynamicBsrOperator.from_blocks(
        d["dyn_AA"], jpar.make_mesh({"time": 2, "rows": 2}),
        block_shape=(8, 32))
    for got, name, v in ((out["dyn_bsr_mv"], "matvec", d["dyn_x"]),
                         (out["dyn_bsr_rmv"], "rmatvec", d["dyn_y"])):
        np.testing.assert_allclose(got, _japply(op, name,
                                                v.astype(np.float32)),
                                   atol=1e-4)
    nx, nt = int(d["dyn_nx"]), int(d["dyn_nt"])
    x, gn = _tv_steps(op, jnp.asarray(d["dyn_b"], jnp.float32),
                      SpaceTimeDerivative(nx, nx, nt))
    np.testing.assert_allclose(out["dyn_bsr_tv"], x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["dyn_bsr_tv_gn"], gn, rtol=1e-4)


def _leg_dyn_banded(kind):
    def leg(out, d):
        op = _dyn(d, kind)
        nmv = (5e-4, 5e-4) if kind == "dyn_int8" else (2e-4, 5e-4)
        _applies(out, kind, op, d["dyn_x"].astype(np.float32),
                 d["dyn_y"].astype(np.float32), ((2e-4, 2e-4), nmv))
        b = jnp.asarray(d["dyn_b"], jnp.float32)
        xj, _ = cgls_normal(op, b, jnp.zeros(op.shape[1], jnp.float32), 20,
                            0.0)
        assert _rel(out[kind + "_cgn"], np.asarray(xj)) < 1e-3
        assert _rel(out[kind + "_cgn"], d["dyn_xt"]) < 0.6
    return leg


LEGS = {2: {"ell": leg_ell, "ell_cgls": leg_ell_cgls, "gks": leg_gks,
            "bsr": leg_bsr, "bsr_cgls": leg_bsr_cgls,
            "bsr_bf16": leg_bsr_bf16, "banded": leg_banded,
            "bucketed": leg_bucketed, "int8": leg_int8,
            "banded_solvers": leg_banded_solvers},
        4: {"pod_mesh": leg_pod_mesh, "int8_4": leg_int8_4,
            "dyn_ell": leg_dyn_ell,
            "dyn_bsr": leg_dyn_bsr,
            **{k: _leg_dyn_banded(k)
               for k in ("dyn_banded", "dyn_bucketed", "dyn_int8")}}}


@pytest.mark.parametrize("world,leg", [(w, k) for w in LEGS for k in LEGS[w]])
def test_leg(runs, inputs, world, leg):
    LEGS[world][leg](runs(world)[0], inputs)


@pytest.mark.parametrize("world", sorted(LEGS))
def test_ranks_agree(runs, world):
    outs = runs(world)
    assert outs[0], "rank 0 saved nothing"
    for r, o in enumerate(outs[1:], 1):
        assert o.keys() == outs[0].keys()
        for k, v in o.items():
            assert np.array_equal(v, outs[0][k]), (r, k)

