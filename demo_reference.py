#!/usr/bin/env python3
"""Reference relErrors of the demos' regularized solvers on the CPU, for
the gates of ``chip_smoke.py`` [6] and [7].

    python3 demo_reference.py jax      # trips_tpu, through the demo's own code
    python3 demo_reference.py torch    # trips_tpu_torch, float32, plain K2/K3
    python3 demo_reference.py dynamic  # trips_tpu, the dynamic demo at
                                       # Emoji's block structure

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


if __name__ == "__main__":
    modes = {"jax": run_jax, "torch": run_torch, "dynamic": run_dynamic}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} jax|torch|dynamic")
    modes[sys.argv[1]]()
