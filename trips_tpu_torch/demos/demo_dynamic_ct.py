"""Dynamic CT demo, the twin of ``demos/demo_dynamic_ct.py`` (which mirrors
the reference's Emoji/CrossPhantom/STEMPO notebooks, paper Codes 5-7):
static per-frame MMGKS against dynamic MMGKS with anisotropic space-time
TV, isotropic TV and group sparsity, and Hybrid LSQR on the full block
system, all with GCV, in float32.

The dynamic solvers run on the frame-varying banded pack
(``DynamicBandedOperator``, 8 line groups: kernels K2 and K3 over all
frames in one launch on the card) where the frames' angle sets are known,
else on the block system's ``EllOperator``; the static solves on each
frame's ``EllOperator``. ``--dataset emoji|crossphantom|stempo`` reads
files already under ``./data`` (the loaders never download: without the
file they raise, as the JAX package's do where it cannot fetch it).

Run: python3 -m trips_tpu_torch.demos.demo_dynamic_ct [--nx 32 --nt 8]
[--dataset synthetic] [--iters 20] [--device cuda]
"""
import argparse

import numpy as np
import torch

from ..operators import (CenteredSpaceTimeDerivative, FirstDerivative2D,
                         SpaceTimeDerivative)
from ..problems import (generate_crossPhantom, generate_emoji,
                        generate_stempo, generate_synthetic_dynamic)
from ..solvers import MMGKS, Hybrid_LSQR
from ..solvers._common import host
from ..sparse import DynamicBandedOperator, EllOperator


def relerr(x, xt):
    x, xt = host(x).reshape(-1), np.asarray(xt).reshape(-1)
    return np.linalg.norm(x - xt) / np.linalg.norm(xt)


def problem(dataset, nx, nt):
    """The demo's inputs after ``np.random.seed(0)``: (A, b, AA, B, nx,
    ny, nt, x_true or None, the frames' angles or None), on the host."""
    np.random.seed(0)
    x_true = angles_list = None
    if dataset == "synthetic":
        (A, b, AA, B, nx, ny, nt, delta, x_true,
         angles_list) = generate_synthetic_dynamic(
            nx=nx, nt=nt, views=12, noise_level=0.01, return_angles=True)
    elif dataset == "emoji":
        A, b, AA, B, nx, ny, nt = generate_emoji(dataset=30)
    elif dataset == "crossphantom":
        A, b, AA, B, nx, ny, nt = generate_crossPhantom(dataset=15)
    else:
        A, b, AA, B, nx, ny, nt, delta, x_true = generate_stempo(
            data_set="simulation", new_shape=(nx, nx), nt=nt)
    return A, b, AA, B, nx, ny, nt, x_true, angles_list


def solves(op, b, AA, B, nx, ny, nt, n_iter, dtype):
    """The demo's solves, in its order: {name: solve}, each solve a
    function of no arguments returning (x, info); ``op`` is the block
    system's operator, the static solves run on each frame's
    ``EllOperator`` of ``dtype``, all on ``op``'s device."""
    dev = op.device
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    bv = torch.tensor(np.asarray(b).reshape(-1), dtype=dtype, device=dev)

    def static():
        # per-frame MMGKS (the reference loops frames serially;
        # CrossPhantom demo cell 20)
        xs = []
        L2 = FirstDerivative2D(nx, ny, device=dev)
        for t in range(nt):
            op_t = EllOperator.from_scipy(AA[t], dtype=np_dtype,
                                          device=dev)
            bt = torch.tensor(np.asarray(B[t]).reshape(-1), dtype=dtype,
                              device=dev)
            x_t, _ = MMGKS(op_t, bt, L2, pnorm=2, qnorm=1, projection_dim=3,
                           n_iter=max(4, n_iter // 4), regparam="gcv")
            xs.append(host(x_t).reshape(-1))
        return np.concatenate(xs), None

    L = SpaceTimeDerivative(nx, ny, nt, device=dev)
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt, device=dev)
    dims = (nx, ny, nt)
    return {
        "static per-frame MMGKS": static,
        # anisotropic space-time TV
        "dynamic MMGKS (anisoTV)": lambda: MMGKS(
            op, bv, L, pnorm=2, qnorm=1, projection_dim=4, n_iter=n_iter,
            regparam="gcv"),
        "dynamic MMGKS (isoTV)": lambda: MMGKS(
            op, bv, Ltv, pnorm=2, qnorm=1, projection_dim=4, n_iter=n_iter,
            regparam="gcv", isoTV="isoTV", prob_dims=dims),
        # group sparsity
        "dynamic MMGKS (GS)": lambda: MMGKS(
            op, bv, None, pnorm=2, qnorm=1, projection_dim=4, n_iter=n_iter,
            regparam="gcv", GS="GS", prob_dims=dims),
        # Hybrid LSQR on the full block system
        "Hybrid LSQR (full system)": lambda: Hybrid_LSQR(
            op, bv, n_iter=n_iter, regparam="gcv"),
    }


def main(argv=None):
    """Run the demo and print its lines; returns {name: relError} (empty
    where the data carries no ground truth)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "emoji", "crossphantom", "stempo"])
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nt", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    A, b, AA, B, nx, ny, nt, x_true, angles_list = problem(
        args.dataset, args.nx, args.nt)
    # the frame-varying banded pack where the per-frame angle sets are
    # known (the downloaded datasets' are not: their ELL matrix)
    if angles_list is not None:
        op = DynamicBandedOperator.from_frames(AA, nx, angles_list,
                                               n_groups=8, device=args.device)
    else:
        op = EllOperator.from_scipy(A, dtype=np.float32, device=args.device)
    results = {}
    for name, solve in solves(op, b, AA, B, nx, ny, nt, args.iters,
                              torch.float32).items():
        x, _ = solve()
        if x_true is not None:
            results[name] = relerr(x, x_true)

    for name, err in results.items():
        print(f"{name:30s} relative error = {err:.4f}")
    return results


if __name__ == "__main__":
    main()
