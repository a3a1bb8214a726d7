#!/usr/bin/env python3
"""Reference relErrors of the demos' regularized solvers on the CPU, for
the gates of ``chip_smoke.py`` [6]-[12].

    python3 demo_reference.py jax      # trips_tpu, through the demo's own code
    python3 demo_reference.py torch    # trips_tpu_torch, float32, plain K2/K3
    python3 demo_reference.py dynamic  # trips_tpu, the dynamic demo at
                                       # Emoji's block structure
    python3 demo_reference.py fused    # trips_tpu, the all-on-device
                                       # solvers on both problems
    python3 demo_reference.py fused64  # the same solves in float64
    python3 demo_reference.py fused_torch  # trips_tpu_torch on the CPU,
                                           # the dynamic float32 solves
    python3 demo_reference.py deblur   # trips_tpu, the deblurring demos'
                                       # solvers, x64 off
    python3 demo_reference.py deblur64 # the same solves in float64
    python3 demo_reference.py deblur_probe  # trips_tpu_torch on the card:
                                            # where its float32 solves part
    python3 demo_reference.py streamed # trips_tpu, the streamed dynamic
                                       # operator's CGLS, x64 off
    python3 demo_reference.py batched  # trips_tpu, batched_frame_solve
                                       # in float64
    python3 demo_reference.py gel      # trips_tpu, gelPhantom's solvers
                                       # on chip_smoke.py's bundle, x64 off
    python3 demo_reference.py l_curve  # trips_tpu, the L-curve and
                                       # small-scale CGLS demos, x64 off
    python3 demo_reference.py l_curve64  # the same in float64

Both run ``demos/demo_tomography.py --large`` (grains phantom, 256x256, 60
views, Gaussian noise 0.001 after ``np.random.seed(0)``) with 30
iterations: GKS with ``FirstDerivative2D`` and Hybrid LSQR with
reorthogonalization and MMGKS p=2 q=1, each with the discrepancy principle,
then Hybrid LSQR with GCV on the same inputs. The ``jax`` mode imports only
``trips_tpu`` (x64 off, the NumPy matrix builder), the ``torch`` mode only
``trips_tpu_torch`` on the CPU. Each takes 2-3 minutes and a few GB.

The ``dynamic`` mode runs ``demos/demo_dynamic_ct.py``'s sequence
(:75-116) through ``trips_tpu`` (x64 off, the NumPy matrix builder) on
``generate_synthetic_dynamic(nx=128, nt=33, views=10, noise_level=0.01)``,
Emoji's block structure (33 frames of 128x128, 10 angles per frame): static
per-frame MMGKS over each frame's ``EllOperator`` (5 iterations,
``projection_dim=3``, ``FirstDerivative2D``), then over the demo's
``DynamicBandedOperator`` (8 line groups) MMGKS with anisotropic
space-time TV, isotropic TV and group sparsity (20 iterations,
``projection_dim=4``) and Hybrid LSQR, all with GCV; it prints each final
relError.

The ``fused`` mode runs ``trips_tpu``'s all-on-device solvers (x64 off, the
NumPy matrix builder) on both problems, as ``chip_smoke.py`` [8] runs the
port's: on the tomography demo's inputs and ``FirstDerivative2D``,
``fused_gks`` (``projection_dim=3``, 30 iterations) with DP, GCV and the
L-curve, ``fused_mmgks`` p=2 q=1 with DP, ``fused_hybrid_lsqr`` (30) with
GCV and with DP and reorthogonalization, and ``lsqr`` (50 steps) damped by
the square root of the GCV lambda; on the dynamic inputs over the
``DynamicBandedOperator``, ``fused_mmgks`` with isotropic TV and with group
sparsity (GCV, ``projection_dim=3``, 20 iterations, as
``demos/demo_fused_dynamic.py``), then both again with lambda fixed
(``regparam_mode="scalar"``) at ``FUSED_LAM_PIN``. It prints each final
relError and last lambda, and the length of every Brent search of the
static solves (JAX's ``fminbound`` evaluations, counted with
``jax.debug.callback``). About 10 minutes and a few GB. ``fused64`` runs
the same solves with x64 on, in float64 (about 10 minutes).

The ``fused_torch`` mode runs the dynamic float32 solves of ``fused``
through ``trips_tpu_torch`` on the CPU (the kernels' plain versions, no
atomics: the same bytes every run), GCV twice each and the fixed-lambda
pair once, printing each final relError and the last lambdas.

The ``deblur`` mode runs, through ``trips_tpu`` with x64 off (float32, as
the demos run on a TPU), the solvers of ``chip_smoke.py`` [9]: the 1D
demo (``demos/demo_1d_deblurring.py``: n = 200, parameter 10, ``curve0``,
2% noise after ``np.random.seed(0)``, 30 iterations: TSVD, TGSVD and
Tikhonov with DP, Hybrid GMRES and Hybrid LSQR with DP on the total
discrepancy and ``reorth``, GKS with DP and ``FirstDerivative1D``); the 2D
demo with ``--large`` (``demos/demo_2d_deblurring.py``: 128x128 ``h_im``,
9x9 PSF of spread (3, 3), 1% noise, 30 iterations: Arnoldi-Tikhonov DP
(8), Hybrid GMRES and Hybrid LSQR with GCV, GKS with GCV and
``FirstDerivative2D``, MMGKS p=2 q=1 with ``FirstDerivative2D`` and with
``FrameletOperator(128, 128, 2)`` (15)); ``demos/demo_fused_tpu.py
--config deblur1d`` (the 1D inputs: ``fused_gks`` with GCV, DP and the
L-curve and ``fused_mmgks`` with GCV, 15 iterations, ``fused_hybrid_lsqr``
with GCV, 20); and ``fused_hybrid_gmres`` with GCV and with DP on the 2D
inputs (30), DP also with ``reorth``. It prints each final relError with
its lambda (or k), and the same solve's final relError on ``b`` perturbed
by one unit of the working precision (``b * (1 + eps * N(0, 1))``,
``default_rng(1)``): the spread two correct runs can show. About 10
minutes on the CPU. ``deblur64`` runs the same solves with x64 on, in
float64 (about 10 minutes).

The ``deblur_probe`` mode runs ``trips_tpu_torch`` alone, on the card when
there is one and on its host: the float32 fused GCV solves of ``deblur``
with the projected problems' ``svd``, ``qr`` and ``solve_ex`` routed one
at a time elsewhere, on ``b`` perturbed by one float32 unit, and the GCV
curve of the last iteration; fused Hybrid GMRES with DP with and without
reorthogonalization (``run_deblur_probe``).

The ``streamed`` and ``batched`` modes run ``trips_tpu``'s ``parallel``
package on the CPU on the inputs of ``chip_smoke.py`` [10], the dynamic
problem of ``dynamic`` (the NumPy matrix builder). ``streamed``: x64 off,
each frame a float32 ``BucketedBandedProjector`` (8 line groups, 3
buckets), ``cgls_normal_streamed`` over the
``StreamedDynamicBandedOperator`` from ``x0 = 0`` for 20 iterations; it
prints the final relError. ``batched``: x64 on, ``batched_frame_solve``
over the frames' float64 matrices with ``FirstDerivative2D``: fused MMGKS
with GCV (``projection_dim=3``, 10 iterations) and fused GKS with DP at
``delta / nt``; it prints each frame's final relError.

The ``gel`` mode (about 20 s) writes ``chip_smoke.py``'s synthetic
gelPhantom bundle (``gel_bundle``, through ``trips_tpu_torch``'s NumPy
builder) into a temporary directory and runs, through ``trips_tpu`` with
x64 off and the NumPy matrix builder, ``generate_gelPhantom(nx=256,
angle_step=20)`` and over ``BatchedBlockDiagOperator`` of
``device_sparse_operator``'s choice on the CPU (``EllOperator``) CGLS
(30 iterations), ``cgls_normal`` (30) and Hybrid LSQR with GCV (20); it
prints ||b|| and each final relError (``chip_smoke.py`` [12b]).

The ``l_curve`` mode (about 35 s) runs ``demos/demo_l_curve.py``'s
sequence at its defaults (64x64 tectonic, 30 views, 1% noise after
``np.random.seed(0)``, 20 iterations: GKS and MMGKS p=2 q=1 with the
L-curve and DP, Hybrid LSQR with GCV and the L-curve; ``trips_tpu``'s
default C++ matrix builder, as the demo runs), then
``demos/demo_small_scale_cgls.py``'s (50x50 ``h_im``, 50 iterations, tol
1e-3) and ``trips_tpu.bench.iters_to_tol.compare()``, all with x64 off;
``l_curve64`` (about 35 s) the same with x64 on. They print each final
relError and lambda, CGLS's ``its`` and the iteration rows
(``chip_smoke.py`` [12c], [12d], [12f]).
"""
import contextlib
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_ITER = 30


def run_jax():
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [str(ROOT / "demos"), str(ROOT)]
    import demo_tomography as demo
    import jax

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)
    rec = []
    orig = demo.relerr

    def relerr(x, xt):
        rec.append(float(orig(x, xt)))
        return rec[-1]

    demo.relerr = relerr
    sys.argv = ["demo", "--large"]
    demo.main()
    print("demo relerr [GKS dp, Hybrid LSQR dp reorth, MMGKS dp]:",
          repr(rec), flush=True)

    from trips_tpu.problems import Tomography
    from trips_tpu.solvers import Hybrid_LSQR

    np.random.seed(0)
    tomo = Tomography(CommitCrime=False)
    x_true, nx, ny = tomo.gen_true("grains", nx=256, ny=256, phantom_seed=0)
    OP, b, _, _, _ = tomo.gen_data(x_true, nx, ny, 60)
    b_noisy, delta = tomo.add_noise(b, "Gaussian", 0.001)
    print("||b_noisy||", repr(float(np.linalg.norm(b_noisy))), "delta",
          repr(float(delta)), type(OP).__name__, flush=True)
    x, info = Hybrid_LSQR(OP, b_noisy.reshape(-1), n_iter=N_ITER,
                          x_true=x_true)
    print("Hybrid LSQR gcv relerr", repr(orig(x, x_true)), "lam",
          repr(info["regParam"]), flush=True)


def run_torch():
    sys.path.insert(0, str(ROOT))
    import torch

    from trips_tpu_torch.operators import FirstDerivative2D
    from trips_tpu_torch.problems import Tomography
    from trips_tpu_torch.solvers import GKS, MMGKS, Hybrid_LSQR

    torch.set_num_threads(4)
    np.random.seed(0)
    tomo = Tomography(CommitCrime=False, device="cpu")
    x_true, nx, ny = tomo.gen_true("grains", nx=256, ny=256, phantom_seed=0)
    OP, b, _, _, _ = tomo.gen_data(x_true, nx, ny, 60)
    b_noisy, delta = tomo.add_noise(b, "Gaussian", 0.001)
    delta = float(delta)
    print("||b||", repr(float(np.linalg.norm(b_noisy))), "delta",
          repr(delta), flush=True)
    bv = torch.tensor(b_noisy.reshape(-1), dtype=torch.float32)
    L = FirstDerivative2D(nx, ny, device="cpu")
    runs = {
        "GKS dp": lambda: GKS(OP, bv, L, projection_dim=3, n_iter=N_ITER,
                              regparam="dp", delta=delta, x_true=x_true),
        "Hybrid LSQR dp": lambda: Hybrid_LSQR(
            OP, bv, n_iter=N_ITER, regparam="dp", delta=delta, reorth=True,
            x_true=x_true),
        "MMGKS dp": lambda: MMGKS(OP, bv, L, pnorm=2, qnorm=1,
                                  projection_dim=3, n_iter=N_ITER,
                                  regparam="dp", delta=delta, x_true=x_true),
        "Hybrid LSQR gcv": lambda: Hybrid_LSQR(OP, bv, n_iter=N_ITER,
                                               x_true=x_true),
    }
    for name, fn in runs.items():
        t = time.time()
        _, info = fn()
        h = info["relError"]
        print(name, "final", repr(h[-1]), "min", repr(min(h)), "lam",
              repr(info["regParam"]), "its", info["its"],
              f"{time.time() - t:.1f} s", flush=True)


DYN = dict(nx=128, nt=33, views=10, noise_level=0.01)
DYN_ITERS = 20
# The fixed lambda of the dynamic fused MMGKS runs: the last GCV lambda of
# the same solve in ``fused`` (float32, x64 off). At float64's last GCV
# lambdas (3.3e-9, 2.1e-7) the regularizer does nothing: isoTV and GS
# both end at relError 0.2330788, 5e-9 apart, so their weights go unseen.
FUSED_LAM_PIN = {"isoTV": 0.003238760633394122,
                 "GS": 0.10979907959699631}


def run_dynamic():
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    from trips_tpu.operators import (CenteredSpaceTimeDerivative,
                                     FirstDerivative2D, SpaceTimeDerivative)
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.solvers import MMGKS, Hybrid_LSQR
    from trips_tpu.sparse import DynamicBandedOperator, EllOperator

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)
    np.random.seed(0)
    (A, b, AA, B, nx, ny, nt, delta, x_true,
     angles) = generate_synthetic_dynamic(**DYN, return_angles=True)
    print("A", A.shape, "nnz", A.nnz, "||b||", repr(float(np.linalg.norm(b))),
          "delta", repr(delta), flush=True)

    def relerr(x):
        x = np.asarray(x).reshape(-1)
        return float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))

    def report(name, x, info, t):
        print(name, "final", repr(relerr(x)), "lam", repr(info["regParam"]),
              "its", info["its"], f"{time.time() - t:.1f} s", flush=True)

    t = time.time()
    L2 = FirstDerivative2D(nx, ny)
    xs = [np.asarray(MMGKS(EllOperator.from_scipy(AA[f]),
                           np.asarray(B[f]).reshape(-1), L2, pnorm=2,
                           qnorm=1, projection_dim=3, n_iter=5,
                           regparam="gcv")[0]).reshape(-1)
          for f in range(nt)]
    print("static per-frame MMGKS final", repr(relerr(np.concatenate(xs))),
          f"{time.time() - t:.1f} s", flush=True)
    op = DynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8)
    kw = dict(pnorm=2, qnorm=1, projection_dim=4, n_iter=DYN_ITERS,
              regparam="gcv")
    dims = dict(prob_dims=(nx, ny, nt))
    runs = {
        "dynamic MMGKS anisoTV": lambda: MMGKS(
            op, b, SpaceTimeDerivative(nx, ny, nt), **kw),
        "dynamic MMGKS isoTV": lambda: MMGKS(
            op, b, CenteredSpaceTimeDerivative(nx, ny, nt), isoTV="isoTV",
            **dims, **kw),
        "dynamic MMGKS GS": lambda: MMGKS(op, b, None, GS="GS", **dims,
                                          **kw),
        "Hybrid LSQR": lambda: Hybrid_LSQR(op, b, n_iter=DYN_ITERS,
                                           regparam="gcv"),
    }
    for name, fn in runs.items():
        t = time.time()
        x, info = fn()
        report(name, x, info, t)


FUSED_ITERS, FUSED_DYN_ITERS, LSQR_STEPS = 30, 20, 50


def _count_brent(fused):
    """Wrap ``fused.fminbound`` so every evaluation's lambda is recorded;
    -> the list the evaluations go to."""
    import jax

    xs = []
    inner = fused.fminbound

    def counted(func, x1, x2, **kw):
        def f(lam):
            jax.debug.callback(lambda v: xs.append(float(v)), lam)
            return func(lam)
        return inner(f, x1, x2, **kw)

    fused.fminbound = counted
    return xs


def _searches(xs):
    """Evaluations per search: each search starts at the same point (its
    first golden-section point), so split the record there."""
    if not xs:
        return []
    starts = [i for i, v in enumerate(xs) if v == xs[0]] + [len(xs)]
    return [b - a for a, b in zip(starts, starts[1:])]


def run_fused(x64=False):
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", x64)
    import jax.numpy as jnp

    from trips_tpu.krylov import lsqr
    from trips_tpu.operators import (CenteredSpaceTimeDerivative,
                                     FirstDerivative2D)
    from trips_tpu.problems import Tomography, generate_synthetic_dynamic
    from trips_tpu.solvers import fused
    from trips_tpu.sparse import DynamicBandedOperator

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)
    tomo = Tomography(CommitCrime=False)
    x_true, nx, ny = tomo.gen_true("grains", nx=256, ny=256, phantom_seed=0)
    OP, b, _, _, _ = tomo.gen_data(x_true, nx, ny, 60)
    np.random.seed(0)
    b_noisy, delta = tomo.add_noise(b, "Gaussian", 0.001)
    delta = float(delta)
    print("||b_noisy||", repr(float(np.linalg.norm(b_noisy))), "delta",
          repr(delta), type(OP).__name__, flush=True)
    xt = np.asarray(x_true).reshape(-1)
    dtype = jnp.float64 if x64 else jnp.float32
    bj = jnp.asarray(np.asarray(b_noisy).reshape(-1), dtype)
    L = FirstDerivative2D(nx, ny)

    def relerr(x):
        x = np.asarray(x).reshape(-1)
        return float(np.linalg.norm(x - xt) / np.linalg.norm(xt))

    xs = _count_brent(fused)
    n, d = FUSED_ITERS, 3
    runs = {
        "fused GKS dp": lambda: fused.fused_gks(
            OP, bj, L, projection_dim=d, n_iter=n, regparam_mode="dp",
            delta=delta),
        "fused GKS gcv": lambda: fused.fused_gks(
            OP, bj, L, projection_dim=d, n_iter=n, regparam_mode="gcv"),
        "fused GKS l_curve": lambda: fused.fused_gks(
            OP, bj, L, projection_dim=d, n_iter=n, regparam_mode="l_curve"),
        "fused MMGKS dp": lambda: fused.fused_mmgks(
            OP, bj, L, pnorm=2.0, qnorm=1.0, projection_dim=d, n_iter=n,
            regparam_mode="dp", delta=delta),
        "fused Hybrid LSQR gcv": lambda: fused.fused_hybrid_lsqr(
            OP, bj, n_iter=n, regparam_mode="gcv"),
        "fused Hybrid LSQR dp reorth": lambda: fused.fused_hybrid_lsqr(
            OP, bj, n_iter=n, regparam_mode="dp", delta=delta, reorth=True),
    }
    lam_gcv = None
    for name, fn in runs.items():
        t = time.time()
        xs.clear()
        out = fn()
        lams = np.asarray(out[1])
        if name == "fused Hybrid LSQR gcv":
            lam_gcv = float(lams[-1])
        print(name, "final", repr(relerr(out[0])), "lam", repr(float(
            lams[-1])), f"{time.time() - t:.1f} s", "brent evaluations",
            _searches(list(xs)), flush=True)
    t = time.time()
    x, k = lsqr(OP, bj, LSQR_STEPS, damp=float(np.sqrt(lam_gcv)))
    print("lsqr damped", "final", repr(relerr(x)), "k", int(k), "damp",
          repr(float(np.sqrt(lam_gcv))), f"{time.time() - t:.1f} s",
          flush=True)

    np.random.seed(0)
    (A, b, AA, B, nx, ny, nt, delta, x_true,
     angles) = generate_synthetic_dynamic(**DYN, return_angles=True)
    print("dynamic ||b||", repr(float(np.linalg.norm(b))), flush=True)
    xt = np.asarray(x_true).reshape(-1)
    op = DynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8)
    bj = jnp.asarray(b.astype(np.float64 if x64 else np.float32))
    for rule in ("gcv", "scalar"):
        for mode in ("isoTV", "GS"):
            t = time.time()
            x, lams, _ = fused.fused_mmgks(
                op, bj, CenteredSpaceTimeDerivative(nx, ny, nt)
                if mode == "isoTV" else None, pnorm=2.0, qnorm=1.0,
                projection_dim=3, n_iter=FUSED_DYN_ITERS,
                regparam=FUSED_LAM_PIN[mode], regparam_mode=rule,
                weight_mode=mode, prob_dims=(nx, ny, nt))
            print(f"fused dynamic MMGKS {mode}"
                  + (" lambda fixed" if rule == "scalar" else ""), "final",
                  repr(relerr(x)), "lam", repr(float(lams[-1])),
                  f"{time.time() - t:.1f} s", flush=True)


def run_fused_torch():
    sys.path.insert(0, str(ROOT))
    import torch

    from trips_tpu_torch.operators import CenteredSpaceTimeDerivative
    from trips_tpu_torch.problems import generate_synthetic_dynamic
    from trips_tpu_torch.solvers import fused
    from trips_tpu_torch.sparse import DynamicBandedOperator

    torch.set_num_threads(4)
    np.random.seed(0)
    (A, b, AA, B, nx, ny, nt, delta, x_true,
     angles) = generate_synthetic_dynamic(**DYN, return_angles=True)
    print("dynamic ||b||", repr(float(np.linalg.norm(b))), flush=True)
    xt = np.asarray(x_true).reshape(-1)
    op = DynamicBandedOperator.from_frames(AA, nx, angles, n_groups=8,
                                           device="cpu")
    bv = torch.tensor(np.asarray(b).reshape(-1), dtype=torch.float32)
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt, device="cpu")
    for rule, repeats in (("gcv", 2), ("scalar", 1)):
        for mode in ("isoTV", "GS"):
            for _ in range(repeats):
                t = time.time()
                x, lams, _ = fused.fused_mmgks(
                    op, bv, Ltv if mode == "isoTV" else None, pnorm=2.0,
                    qnorm=1.0, projection_dim=3, n_iter=FUSED_DYN_ITERS,
                    regparam=FUSED_LAM_PIN[mode], regparam_mode=rule,
                    weight_mode=mode, prob_dims=(nx, ny, nt), device="cpu")
                x = x.double().numpy().reshape(-1)
                print(f"fused dynamic MMGKS {mode}"
                      + (" lambda fixed" if rule == "scalar" else ""),
                      "final", repr(float(np.linalg.norm(x - xt)
                                          / np.linalg.norm(xt))),
                      "last lambdas", repr(lams[-4:].tolist()),
                      f"{time.time() - t:.1f} s", flush=True)


DEBLUR_ITERS, FRAMELET_ITERS, AT_ITERS = 30, 15, 8
FUSED1D_ITERS, FUSED1D_HYB_ITERS = 15, 20


def run_deblur(x64=False):
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", x64)
    import jax.numpy as jnp

    from trips_tpu.operators import (FirstDerivative1D, FirstDerivative2D,
                                     FrameletOperator,
                                     first_derivative_matrix)
    from trips_tpu.problems import Deblurring1D, Deblurring2D
    from trips_tpu.solvers import (GKS, MMGKS, Arnoldi_Tikhonov,
                                   Hybrid_GMRES, Hybrid_LSQR, Tikhonov,
                                   fused, tGSVD_sol, tSVD_sol)

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)
    np.random.seed(0)
    n = 200
    prob = Deblurring1D()
    A = prob.forward_Op_1D(parameter=10.0, nx=n)
    x1 = prob.gen_xtrue(n, "curve0")
    b1, delta1 = prob.add_noise(prob.gen_data(x1, parameter=10.0),
                                "Gaussian", 0.02)
    delta1 = float(delta1)
    A_dense = np.asarray(A.mat)
    delta_total = float(np.linalg.norm(
        np.asarray(b1).reshape(-1) - A_dense @ np.asarray(x1).reshape(-1)))
    L_sq = np.vstack([first_derivative_matrix(n).toarray(), np.zeros((1, n))])

    np.random.seed(0)
    prob2 = Deblurring2D()
    A2 = prob2.forward_Op([9, 9], (3, 3), 128, 128)
    x2 = prob2.gen_true("h_im", nx=128, ny=128)
    b2, delta2 = prob2.add_noise(prob2.gen_data(x2.reshape(-1, 1)),
                                 "Gaussian", 0.01)
    delta2 = float(delta2)
    print("1D ||b||", repr(float(np.linalg.norm(b1))), "delta", repr(delta1),
          "delta_total", repr(delta_total), "2D ||b||",
          repr(float(np.linalg.norm(b2))), "delta", repr(delta2), flush=True)
    dt = jnp.float64 if x64 else jnp.float32
    eps = float(jnp.finfo(dt).eps)
    its, d = DEBLUR_ITERS, 3
    L1, L2 = FirstDerivative1D(n), FirstDerivative2D(128, 128)
    W = FrameletOperator(128, 128, 2)

    def first(out):
        return out[0], out[1]

    def lams(out):
        return out[0], float(np.asarray(out[1])[-1])

    def info(out):
        return out[0], out[1]["regParam"]

    # name -> (problem, solve(b) -> (x, lambda or k))
    runs = {
        "1D TSVD dp": (1, lambda b: first(tSVD_sol(
            A_dense, b, regparam="dp", delta=delta1))),
        "1D TGSVD dp": (1, lambda b: first(tGSVD_sol(
            A_dense, L_sq, b, regparam="dp", delta=delta1))),
        "1D Tikhonov dp": (1, lambda b: first(Tikhonov(
            A_dense, b, np.eye(n), regparam="dp", delta=delta1))),
        "1D Hybrid GMRES dp": (1, lambda b: info(Hybrid_GMRES(
            A, b, n_iter=its, regparam="dp", delta=delta_total,
            reorth=True))),
        "1D Hybrid LSQR dp": (1, lambda b: info(Hybrid_LSQR(
            A, b, n_iter=its, regparam="dp", delta=delta_total,
            reorth=True))),
        "1D GKS dp": (1, lambda b: info(GKS(
            A, b.reshape(-1), L1, projection_dim=d, n_iter=its,
            regparam="dp", delta=delta1))),
        "2D Arnoldi-Tikhonov dp": (2, lambda b: first(Arnoldi_Tikhonov(
            A2, b, n_iter=AT_ITERS, regparam="dp", delta=delta2))),
        "2D Hybrid GMRES gcv": (2, lambda b: info(Hybrid_GMRES(
            A2, b, n_iter=its, regparam="gcv"))),
        "2D Hybrid LSQR gcv": (2, lambda b: info(Hybrid_LSQR(
            A2, b, n_iter=its, regparam="gcv"))),
        "2D GKS gcv": (2, lambda b: info(GKS(
            A2, b, L2, projection_dim=d, n_iter=its, regparam="gcv"))),
        "2D MMGKS derivative": (2, lambda b: info(MMGKS(
            A2, b, L2, pnorm=2, qnorm=1, projection_dim=d, n_iter=its,
            regparam="gcv"))),
        "2D MMGKS framelet": (2, lambda b: info(MMGKS(
            A2, b, W, pnorm=2, qnorm=1, projection_dim=d,
            n_iter=FRAMELET_ITERS, regparam="gcv"))),
    }
    for mode in ("gcv", "dp", "l_curve"):
        runs[f"fused GKS {mode}"] = (1, lambda b, mode=mode: lams(
            fused.fused_gks(A, jnp.asarray(b.reshape(-1), dt), L1,
                            projection_dim=d, n_iter=FUSED1D_ITERS,
                            regparam_mode=mode, delta=delta1)))
    runs["fused MMGKS gcv"] = (1, lambda b: lams(fused.fused_mmgks(
        A, jnp.asarray(b.reshape(-1), dt), L1, pnorm=2.0, qnorm=1.0,
        projection_dim=d, n_iter=FUSED1D_ITERS, regparam_mode="gcv")))
    runs["fused Hybrid LSQR gcv"] = (1, lambda b: lams(
        fused.fused_hybrid_lsqr(A, jnp.asarray(b.reshape(-1), dt),
                                n_iter=FUSED1D_HYB_ITERS,
                                regparam_mode="gcv")))
    for mode in ("gcv", "dp"):
        runs[f"fused Hybrid GMRES {mode}"] = (2, lambda b, mode=mode: lams(
            fused.fused_hybrid_gmres(A2, jnp.asarray(b, dt), n_iter=its,
                                     regparam_mode=mode, delta=delta2)))
    runs["fused Hybrid GMRES dp reorth"] = (2, lambda b: lams(
        fused.fused_hybrid_gmres(A2, jnp.asarray(b, dt), n_iter=its,
                                 regparam_mode="dp", delta=delta2,
                                 reorth=True)))

    data = {1: (np.asarray(b1), np.asarray(x1).reshape(-1)),
            2: (np.asarray(b2).reshape(-1), np.asarray(x2).reshape(-1))}
    rng = np.random.default_rng(1)
    perturbed = {k: b * (1 + eps * rng.standard_normal(b.shape))
                 for k, (b, _) in data.items()}
    for name, (which, solve) in runs.items():
        b, xt = data[which]
        t = time.time()
        x, par = solve(b)
        err = float(np.linalg.norm(np.asarray(x).reshape(-1) - xt)
                    / np.linalg.norm(xt))
        secs = time.time() - t
        xp, parp = solve(perturbed[which])
        errp = float(np.linalg.norm(np.asarray(xp).reshape(-1) - xt)
                     / np.linalg.norm(xt))
        print(name, "final", repr(err), "param", repr(float(par)),
              "perturbed final", repr(errp), "param", repr(float(parp)),
              f"{secs:.1f} s", flush=True)


@contextlib.contextmanager
def _routed(svd=None, qr=None, solve=None):
    """``torch.linalg``'s ``svd``, ``qr`` and ``solve_ex`` routed for the
    duration: "host" runs the call on the CPU in the input's dtype,
    "float64" runs it on the input's device in float64, a cuSOLVER driver
    name ("gesvd", "gesvdj") is passed to ``svd`` as ``driver``
    in place of ``core.device.svd``'s.
    The result comes back on the input's device in its dtype."""
    import torch

    la = torch.linalg
    saved = {k: getattr(la, k) for k in ("svd", "qr", "solve_ex")}

    def route(name, how):
        orig = saved[name]
        if how is None:
            return orig

        def call(A, *args, **kw):
            if how == "host":
                kw.pop("driver", None)
                out = orig(A.cpu(), *[a.cpu() for a in args], **kw)
            elif how == "float64":
                out = orig(A.double(), *[a.double() for a in args], **kw)
            else:
                out = orig(A, *args, **{**kw, "driver": how})
            return type(out)(t.to(A.device, t.dtype if t.dtype in (
                torch.int32, torch.int64) else A.dtype) for t in out)
        return call

    try:
        la.svd, la.qr, la.solve_ex = (route("svd", svd), route("qr", qr),
                                      route("solve_ex", solve))
        yield
    finally:
        for k, v in saved.items():
            setattr(la, k, v)


def run_deblur_probe():
    """Where the card's float32 fused GCV solves and fused Hybrid GMRES
    with DP leave the CPU's (``chip_smoke.py`` [9]): each solve on the card
    with the projected problems' ``svd``, ``qr`` and ``solve_ex`` routed
    one at a time (to the CPU, to float64, to another cuSOLVER SVD driver),
    on the CPU, on ``b`` perturbed by one float32 unit (eight draws), and
    the GCV curve of the last iteration; fused Hybrid GMRES DP with and
    without reorthogonalization in float32 and float64; the device time of
    one projected SVD by driver. Runs ``trips_tpu_torch`` only, on the card
    and its host (about a minute there), or on the CPU alone where no card
    is present (about 5 minutes)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import deblur_problems
    from trips_tpu_torch.operators import FirstDerivative1D
    from trips_tpu_torch.solvers import fused as F

    cuda = torch.cuda.is_available()
    devs = ["cuda", "cpu"] if cuda else ["cpu"]
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0) if cuda else "no card", flush=True)
    probs = {(dev, dt): deblur_problems(dev, dt) for dev in devs
             for dt in (torch.float32, torch.float64)}
    eps = float(np.finfo(np.float32).eps)

    def relerr(x, xt):
        return float(np.linalg.norm(x.double().cpu().numpy().reshape(-1)
                                    - xt) / np.linalg.norm(xt))

    curves = []
    brent = F.fminbound

    def recorded(func, *a, **kw):  # keep the last GCV function
        curves.append(func)
        return brent(func, *a, **kw)

    F.fminbound = recorded

    def one(name, dev, dt=torch.float32, b=None, reorth=False):
        p1, p2 = probs[dev, dt]
        if name.startswith("fused Hybrid GMRES"):
            x, lams = F.fused_hybrid_gmres(
                p2["A"], p2["bt"] if b is None else b, n_iter=DEBLUR_ITERS,
                regparam_mode="dp", delta=p2["delta"], reorth=reorth,
                device=dev)
            return relerr(x, p2["x"]), lams
        L1 = FirstDerivative1D(p1["n"], device=dev)
        kw = dict(projection_dim=3, n_iter=FUSED1D_ITERS,
                  regparam_mode="gcv", device=dev)
        b = p1["bt"] if b is None else b
        if name == "fused GKS gcv":
            x, lams, _ = F.fused_gks(p1["A"], b, L1, **kw)
        else:
            x, lams, _ = F.fused_mmgks(p1["A"], b, L1, pnorm=2.0, qnorm=1.0,
                                       **kw)
        return relerr(x, p1["x"]), lams

    def show(label, err, lams):
        print(f"{label}: relError {err!r}, lambdas "
              f"{lams.double().cpu().numpy().tolist()!r}", flush=True)

    routes = {"as shipped": {}, "svd host": dict(svd="host"),
              "svd float64": dict(svd="float64"),
              "svd gesvd": dict(svd="gesvd"),
              "svd gesvdj": dict(svd="gesvdj"),
              "qr host": dict(qr="host"), "solve_ex host": dict(solve="host"),
              "svd, qr, solve_ex host": dict(svd="host", qr="host",
                                             solve="host")}
    grid = np.logspace(-9, 2, 45)
    for name in ("fused GKS gcv", "fused MMGKS gcv"):
        for dev in devs:
            for label, how in routes.items():
                if dev == "cpu" and how and label != "svd float64":
                    continue
                with _routed(**how):
                    curves.clear()
                    err, lams = one(name, dev)
                show(f"{name} on {dev}, {label}", err, lams)
                if label in ("as shipped", "svd gesvdj"):
                    f = curves[-1]
                    vals = [float(f(torch.full((), v, dtype=torch.float32,
                                               device=dev))) for v in grid]
                    print(f"{name} on {dev}, {label}: GCV at the last "
                          f"iteration on lambda = logspace(-9, 2, 45): "
                          f"{vals!r}", flush=True)
            b = probs[dev, torch.float32][0]["bt"]
            rng = np.random.default_rng(1)
            errs = []
            for _ in range(8):
                noise = torch.from_numpy(rng.standard_normal(b.shape[0]))
                bp = (b.double() * (1 + eps * noise.to(dev))).float()
                errs.append(one(name, dev, b=bp)[0])
            print(f"{name} on {dev}, b perturbed by one float32 unit (eight "
                  f"draws, default_rng(1)): relErrors {errs!r}", flush=True)
        err, lams = one(name, devs[0], dt=torch.float64)
        show(f"{name} on {devs[0]}, float64", err, lams)
    name = "fused Hybrid GMRES dp"
    for dev in devs:
        for dt in (torch.float32, torch.float64):
            for reorth in (False, True):
                err, lams = one(name, dev, dt=dt, reorth=reorth)
                show(f"{name} on {dev}, {str(dt)[6:]}, reorth {reorth}", err,
                     lams[-3:])
    if cuda:  # the device time of one projected SVD (1D GKS: 18 x 18)
        M = torch.randn(18, 18, device="cuda")
        for driver in (None, "gesvd", "gesvdj", "gesvda"):
            kw = {} if driver is None else dict(driver=driver)
            for _ in range(3):
                torch.linalg.svd(M, **kw)
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            for _ in range(50):
                torch.linalg.svd(M, **kw)
            stop.record()
            torch.cuda.synchronize()
            print(f"svd of 18 x 18 float32, driver {driver}: "
                  f"{start.elapsed_time(stop) / 50 * 1e3!r} us per call "
                  "(CUDA events, the host's status read included)",
                  flush=True)


STREAMED_ITERS, BATCHED_ITERS = 20, 10


def run_streamed():
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp

    from trips_tpu.parallel import (StreamedDynamicBandedOperator,
                                    cgls_normal_streamed)
    from trips_tpu.problems import generate_synthetic_dynamic
    from trips_tpu.sparse import BucketedBandedProjector

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)
    (A, b, AA, B, nx, ny, nt, delta, x_true,
     angles) = generate_synthetic_dynamic(**DYN, return_angles=True)
    print("||b||", repr(float(np.linalg.norm(b))), flush=True)
    t = time.time()
    ops = [BucketedBandedProjector.from_scipy_fan(
        AA[f], nx, None, angles=angles[f], n_groups=8, n_buckets=3)
        for f in range(nt)]
    sop = StreamedDynamicBandedOperator(ops)
    print(f"packs {time.time() - t:.1f} s", flush=True)
    t = time.time()
    x, k = cgls_normal_streamed(sop, jnp.asarray(b, jnp.float32),
                                jnp.zeros(sop.shape[1], jnp.float32),
                                STREAMED_ITERS)
    x = np.asarray(x, np.float64)
    print("cgls_normal_streamed float32 k", k, "final relError",
          repr(float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))),
          f"{time.time() - t:.1f} s", flush=True)


def run_batched():
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", True)
    from trips_tpu.operators import FirstDerivative2D
    from trips_tpu.parallel import batched_frame_solve
    from trips_tpu.problems import generate_synthetic_dynamic

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)
    (A, b, AA, B, nx, ny, nt, delta, x_true,
     angles) = generate_synthetic_dynamic(**DYN, return_angles=True)
    xt = x_true.reshape(nt, -1)
    L = FirstDerivative2D(nx, ny)
    for name, kw in (("mmgks gcv", dict(solver="mmgks")),
                     ("gks dp", dict(solver="gks", regparam_mode="dp",
                                     delta=delta / nt))):
        t = time.time()
        X = np.asarray(batched_frame_solve(AA, B, L, n_iter=BATCHED_ITERS,
                                           **kw))
        errs = [float(np.linalg.norm(X[f] - xt[f]) / np.linalg.norm(xt[f]))
                for f in range(nt)]
        print(f"batched {name} per-frame final relError", repr(errs),
              f"{time.time() - t:.1f} s", flush=True)


GEL_ITERS = {"CGLS": 30, "cgls_normal": 30, "Hybrid LSQR gcv": 20}


def run_gel():
    os.environ["TRIPS_TPU_NO_NATIVE"] = "1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import tempfile

    import jax
    import jax.numpy as jnp

    from chip_smoke import GEL, gel_bundle
    from trips_tpu.core.linop import BatchedBlockDiagOperator
    from trips_tpu.krylov import cgls_normal
    from trips_tpu.problems import device_sparse_operator, generate_gelPhantom
    from trips_tpu.problems.gelphantom import read_frames
    from trips_tpu.solvers import CGLS, Hybrid_LSQR

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        X = gel_bundle(f"{tmp}/GelPhantomData_b4.mat")
        A, b, AA, B, nx, ny, nt = generate_gelPhantom(
            nx=GEL["nx"], angle_step=GEL["step"], data_dir=tmp)
        angles = read_frames(f"{tmp}/GelPhantomData_b4.mat")["angles"]
    keep = np.arange(0, GEL["n_angles"], GEL["step"])
    x_true = X.reshape(-1)
    op = BatchedBlockDiagOperator(device_sparse_operator(
        AA[0], nx=nx, angles=angles[keep]), nt)
    print("||b||", repr(float(np.linalg.norm(b))), "nnz of a frame",
          AA[0].nnz, type(op.op).__name__, flush=True)

    def relerr(x):
        x = np.asarray(x, np.float64).reshape(-1)
        return float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))

    bj = jnp.asarray(b, jnp.float32)
    x0 = jnp.zeros(op.shape[1], jnp.float32)
    runs = {
        "CGLS": lambda: CGLS(op, bj, x0, GEL_ITERS["CGLS"], 1e-6,
                             x_true=x_true)[0],
        "cgls_normal": lambda: cgls_normal(op, bj, x0,
                                           GEL_ITERS["cgls_normal"])[0],
        "Hybrid LSQR gcv": lambda: Hybrid_LSQR(
            op, bj, n_iter=GEL_ITERS["Hybrid LSQR gcv"], regparam="gcv",
            x_true=x_true)[0],
    }
    for name, fn in runs.items():
        t = time.time()
        print(name, "final relError", repr(relerr(fn())),
              f"{time.time() - t:.1f} s", flush=True)


def run_l_curve(x64=False):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("TRIPS_TPU_NO_NATIVE", None)
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", x64)
    from trips_tpu.core.linop import ScaledOperator, VStackOperator
    from trips_tpu.operators import FirstDerivative2D
    from trips_tpu.problems import Deblurring2D, Tomography
    from trips_tpu.solvers import CGLS, GKS, MMGKS, Hybrid_LSQR
    from trips_tpu.solvers._common import as_op

    print("x64", jax.config.jax_enable_x64, jax.__version__, flush=True)

    def relerr(x, xt):
        x, xt = np.asarray(x).reshape(-1), np.asarray(xt).reshape(-1)
        return float(np.linalg.norm(x - xt) / np.linalg.norm(xt))

    # demos/demo_l_curve.py at its defaults (64x64, 30 views, 20 iterations)
    np.random.seed(0)
    tomo = Tomography(CommitCrime=False)
    x_true, nx, ny = tomo.gen_true("tectonic", nx=64, ny=64)
    OP, b, p, q, A = tomo.gen_data(x_true, nx, ny, 30)
    b_noisy, delta = tomo.add_noise(b, "Gaussian", 0.01)
    delta = float(delta)
    bv = b_noisy.reshape(-1)
    L = FirstDerivative2D(nx, ny)
    print("||b||", repr(float(np.linalg.norm(bv))), "delta", repr(delta),
          type(OP).__name__, flush=True)
    runs = {}
    for rp in ["l_curve", "dp"]:
        runs[f"GKS ({rp})"] = lambda rp=rp: GKS(
            OP, bv, L, projection_dim=3, n_iter=20, regparam=rp, delta=delta)
        runs[f"MMGKS ({rp})"] = lambda rp=rp: MMGKS(
            OP, bv, L, pnorm=2, qnorm=1, projection_dim=3, n_iter=20,
            regparam=rp, delta=delta)
    for rp in ["gcv", "l_curve"]:
        runs[f"Hybrid LSQR ({rp})"] = lambda rp=rp: Hybrid_LSQR(
            OP, bv, n_iter=20, regparam=rp, delta=delta)
    for name, fn in runs.items():
        t = time.time()
        x, info = fn()
        print(name, "final relError", repr(relerr(x, x_true)), "lam",
              repr(float(info["regParam"])), f"{time.time() - t:.1f} s",
              flush=True)

    # demos/demo_small_scale_cgls.py at its defaults (50x50, 50 iterations)
    np.random.seed(0)
    prob = Deblurring2D()
    Ab = prob.forward_Op([3, 3], (1, 1), 50, 50)
    x_true = prob.gen_true("h_im", nx=50, ny=50)
    b_true = prob.gen_data(np.asarray(x_true).reshape(-1, 1))
    b, _ = prob.add_noise(b_true, "Gaussian", 0.01)
    bv = np.asarray(b).reshape(-1)
    L = FirstDerivative2D(50, 50)
    Ahat = VStackOperator([as_op(Ab), ScaledOperator(np.sqrt(0.01),
                                                     as_op(L))])
    bhat = np.concatenate([bv, np.zeros(L.shape[0])])
    x0 = np.asarray(as_op(Ab).rmatvec(bv))
    x, info = CGLS(Ahat, bhat, x0, max_iter=50, tol=1e-3,
                   x_true=np.asarray(x_true).reshape(-1))
    print("small-scale CGLS its", info["its"], "final relError",
          repr(float(info["relError"][-1])), flush=True)

    from trips_tpu.bench.iters_to_tol import compare

    print("iters_to_tol rows (name, reference, trips_tpu)", compare(),
          flush=True)


if __name__ == "__main__":
    modes = {"jax": run_jax, "torch": run_torch, "dynamic": run_dynamic,
             "fused": run_fused, "fused64": lambda: run_fused(x64=True),
             "fused_torch": run_fused_torch, "deblur": run_deblur,
             "deblur64": lambda: run_deblur(x64=True),
             "deblur_probe": run_deblur_probe, "streamed": run_streamed,
             "batched": run_batched, "gel": run_gel,
             "l_curve": run_l_curve,
             "l_curve64": lambda: run_l_curve(x64=True)}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} "
                 "jax|torch|dynamic|fused|fused64|fused_torch|deblur|"
                 "deblur64|deblur_probe|streamed|batched|gel|l_curve|"
                 "l_curve64")
    modes[sys.argv[1]]()
