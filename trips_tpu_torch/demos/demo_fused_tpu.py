"""The all-on-device solvers, the twin of ``demos/demo_fused_tpu.py``
(whose name is kept so that a reader finds the counterpart; there the
whole solve is one jitted TPU program). On the card this is the path
with no host work in an iteration's arithmetic: the Krylov recurrences,
the choice of the regularization parameter (GCV, DP, L-curve), the
projected solves and the basis growth all run on the device, each search
a captured CUDA graph replayed a chunk of steps between host reads
(``core.loop``).

Two configurations: ``deblur1d`` (the 1D deblurring problem, n = 200,
float32) and ``tomo`` (a tectonic phantom, the fan-beam matrix packed as
the bfloat16 ``BucketedBandedProjector`` with 3 buckets and 32 line
groups: kernels K2 and K3, and K1 in ``cgls_normal``). Fused GKS with
GCV, DP and the L-curve, fused MMGKS and fused Hybrid LSQR with GCV, then
``cgls`` and ``cgls_normal`` (the fused A^T A kernel: the stored band
streams once per iteration instead of once per projection).

Run: python3 -m trips_tpu_torch.demos.demo_fused_tpu [--config
deblur1d|tomo] [--n 200] [--nx 64 --views 30] [--iters 15] [--device cuda]
"""
import argparse
import time

import numpy as np
import torch

from ..solvers._common import host


def relerr(x, xt):
    x = host(x).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def build_deblur1d(n, device, dtype=torch.float32):
    from ..operators import FirstDerivative1D
    from ..problems import Deblurring1D

    np.random.seed(0)
    prob = Deblurring1D(device=device, dtype=dtype)
    A = prob.forward_Op_1D(parameter=10.0, nx=n)
    x_true = prob.gen_xtrue(n, "curve0")
    b, delta = prob.add_noise(prob.gen_data(x_true), "Gaussian", 0.02)
    return (A, FirstDerivative1D(n, device=A.device), np.asarray(b).ravel(),
            x_true, float(delta))


def tomo_data(nx, views):
    """The tomo configuration's host data after ``np.random.seed(0)``:
    (A float32 CSR, b float32, x_true float32, delta)."""
    from ..problems.phantoms import tectonic
    from ..problems.projector import fan_beam_matrix

    np.random.seed(0)
    A = fan_beam_matrix(nx, views=views).astype(np.float32)
    x_true = tectonic(nx).reshape(-1).astype(np.float32)
    b_true = A @ x_true
    e = np.random.randn(b_true.size)
    sig = 0.01 * np.linalg.norm(b_true) / np.linalg.norm(e)
    b = (b_true + sig * e).astype(np.float32)
    return A, b, x_true, float(np.linalg.norm(sig * e))


def build_tomo(nx, views, device):
    from ..operators import FirstDerivative2D
    from ..sparse import BucketedBandedProjector

    A, b, x_true, delta = tomo_data(nx, views)
    # the Ta-bucketed banded pack of the exact Siddon matrix, bfloat16
    op = BucketedBandedProjector.from_scipy_fan(A, nx, views, n_groups=32,
                                                n_buckets=3,
                                                dtype=torch.bfloat16,
                                                device=device)
    return op, FirstDerivative2D(nx, nx, device=op.device), b, x_true, delta


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def solves(A, L, bj, delta, n_iter):
    """The demo's solves, in its order: {name: solve}, each solve a
    function of no arguments returning (x, lams) (``cgls``,
    ``cgls_normal``: (x, iterations)), on ``bj``'s device and dtype."""
    from ..krylov import cgls, cgls_normal
    from ..solvers.fused import fused_gks, fused_hybrid_lsqr, fused_mmgks

    dev = bj.device
    runs = {}
    for mode in ("gcv", "dp", "l_curve"):
        runs[f"fused_gks[{mode}]"] = lambda mode=mode: fused_gks(
            A, bj, L, projection_dim=3, n_iter=n_iter, regparam_mode=mode,
            delta=delta, device=dev)[:2]
    runs["fused_mmgks[gcv]"] = lambda: fused_mmgks(
        A, bj, L, pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=n_iter,
        regparam_mode="gcv", device=dev)[:2]
    # modified-GCV stabilizes the deep hybrid factorization (DP at a fixed
    # large n_iter keeps the semiconvergent last iterate, faithfully to the
    # reference; pair dp with dp_stop via solvers.Hybrid_LSQR for that use)
    runs["fused_hyb_lsqr[gcv]"] = lambda: fused_hybrid_lsqr(
        A, bj, n_iter=max(n_iter, 20), regparam_mode="gcv", device=dev)
    # CG on the normal equations with the fused A^T A kernel (K1): the
    # stored band streams from memory once per iteration instead of once
    # per projection
    x0 = torch.zeros(A.shape[1], dtype=bj.dtype, device=dev)
    for name, fn in (("cgls", cgls), ("cgls_normal", cgls_normal)):
        runs[name] = lambda fn=fn: fn(A, bj, x0, max(n_iter, 20), 0.0)
    return runs


def main(argv=None):
    """Run the demo and print its lines; returns {solver: relError}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("deblur1d", "tomo"),
                    default="deblur1d")
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.config == "deblur1d":
        A, L, b, x_true, delta = build_deblur1d(args.n, args.device)
    else:
        A, L, b, x_true, delta = build_tomo(args.nx, args.views, args.device)
    dev = A.device
    bj = torch.tensor(b, dtype=torch.float32, device=dev)
    results = {}
    for name, solve in solves(A, L, bj, delta, args.iters).items():
        kind = name.split("[")[0]
        if kind == "fused_gks" or kind.startswith("cgls"):
            # the first solve, then the same again timed (JAX: its
            # compile, then the run of the compiled program)
            t0 = time.perf_counter()
            solve()
            _sync(dev)
            t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, lams = solve()
        float(torch.linalg.norm(x))
        t_run = time.perf_counter() - t0
        results[name] = err = relerr(x, x_true)
        if kind == "fused_gks":
            print(f"fused_gks[{name[10:-1]:8s}]  rel_err={err:.4f}  "
                  f"lam={float(lams[-1]):.3e}  first={t_first:.1f}s  "
                  f"run={t_run * 1e3:.0f}ms ({args.iters} iters, on the "
                  f"device)")
        elif kind.startswith("cgls"):
            print(f"{name:19s} rel_err={err:.4f}  run={1e3 * t_run:.0f}ms")
        else:
            print(f"{name:19s} rel_err={err:.4f}  "
                  f"lam={float(lams[-1]):.3e}")
    return results


if __name__ == "__main__":
    main()
