#!/usr/bin/env python3
"""Reference relErrors of the demos' regularized solvers on the CPU, for
the gates of ``chip_smoke.py`` [6] and [7].

    python3 demo_reference.py jax      # trips_tpu, through the demo's own code
    python3 demo_reference.py torch    # trips_tpu_torch, float32, plain K2/K3
    python3 demo_reference.py dynamic  # trips_tpu, the dynamic demo at
                                       # Emoji's block structure
    python3 demo_reference.py fused    # trips_tpu, the all-on-device
                                       # solvers on both problems
    python3 demo_reference.py fused64  # the same solves in float64
    python3 demo_reference.py fused_torch  # trips_tpu_torch on the CPU,
                                           # the dynamic float32 solves

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
"""
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


if __name__ == "__main__":
    modes = {"jax": run_jax, "torch": run_torch, "dynamic": run_dynamic,
             "fused": run_fused, "fused64": lambda: run_fused(x64=True),
             "fused_torch": run_fused_torch}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} "
                 "jax|torch|dynamic|fused|fused64|fused_torch")
    modes[sys.argv[1]]()
