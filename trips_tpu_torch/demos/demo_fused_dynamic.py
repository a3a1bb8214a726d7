"""Fused dynamic reconstruction, the twin of ``demos/demo_fused_dynamic.py``:
the reference's flagship dynamic MMGKS (isoTV and GS weights, paper Codes
5-7) with every iteration on the device, over the frame-varying
``DynamicBandedOperator`` (kernels K2 and K3 over all frames in one launch
on the card), and the checkpointed loop killed at iteration 6, resumed from
its file, and held bit for bit to the uninterrupted run.

- ``fused_mmgks(weight_mode='isoTV'|'GS', prob_dims=...)``: the
  Krylov recurrences, the weights and GCV's lambda on the device
  (``solvers/fused.py``; host twin ``solvers/mmgks.py``);
- ``fused_mmgks_checkpointed``: the same loop in chunks of 3 with the state
  saved after each; the resumed run repeats the uninterrupted one's
  operations on the same bytes, and K1 and K3 add in fixed point (the same
  bits every run), so it ends bitwise equal on the card as on the CPU.

Run: python3 -m trips_tpu_torch.demos.demo_fused_dynamic [--nx 32 --nt 6
--views 12] [--n_iter 10] [--device cuda]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from ..operators import CenteredSpaceTimeDerivative
from ..problems import generate_synthetic_dynamic
from ..solvers._common import host
from ..solvers.checkpointed import fused_mmgks_checkpointed
from ..solvers.fused import fused_mmgks
from ..sparse import DynamicBandedOperator
from ..utils.checkpoint import save_state


def relerr(x, xt):
    x = host(x).reshape(-1)
    return float(np.linalg.norm(x - xt) / np.linalg.norm(xt))


class Killed(Exception):
    pass


def solves(op, bj, Ltv, dims, n_iter):
    """The demo's two fused solves: {name: solve}, each solve a function
    of no arguments returning (x, lams), on ``bj``'s device and dtype."""
    return {f"fused dynamic MMGKS ({mode})": lambda mode=mode: fused_mmgks(
        op, bj, Ltv if mode == "isoTV" else None, pnorm=2.0, qnorm=1.0,
        projection_dim=3, n_iter=n_iter, regparam_mode="gcv",
        weight_mode=mode, prob_dims=dims, device=bj.device)[:2]
        for mode in ("isoTV", "GS")}


def kill_and_resume(op, bj, Ltv, dims, n_iter, path):
    """The checkpointed isoTV loop in chunks of 3: a whole run, a run
    killed at iteration 6 with its state saved to ``path`` after each
    chunk, and the run resumed from ``path``: -> (the whole run's x, the
    resumed run's x)."""
    kw = dict(pnorm=2.0, qnorm=1.0, projection_dim=3, n_iter=n_iter,
              regparam_mode="gcv", weight_mode="isoTV", prob_dims=dims,
              chunk=3, device=bj.device)
    x_ref, _, _ = fused_mmgks_checkpointed(op, bj, Ltv, **kw)

    def cb(it, **state):
        save_state(path, state)
        if it >= 6:
            raise Killed

    try:
        fused_mmgks_checkpointed(op, bj, Ltv, callback=cb, **kw)
    except Killed:
        print(f"killed at iteration 6; checkpoint at {path}")
    x_res, _, _ = fused_mmgks_checkpointed(op, bj, Ltv, resume_state=path,
                                           **kw)
    return x_ref, x_res


def main(argv=None):
    """Run the demo and print its lines; returns {name: relError} and
    whether the resumed run equals the uninterrupted one (it asserts so)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nt", type=int, default=6)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--n_iter", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    A, b, AA, B, nx, ny, nt, delta, x_true, al = generate_synthetic_dynamic(
        nx=args.nx, nt=args.nt, views=args.views, noise_level=0.01,
        return_angles=True)
    op = DynamicBandedOperator.from_frames(AA, nx, al, n_groups=8,
                                           device=args.device)
    dev = op.device
    bj = torch.tensor(b.astype(np.float32), device=dev)
    Ltv = CenteredSpaceTimeDerivative(nx, ny, nt, device=dev)
    dims = (nx, ny, nt)
    results = {}
    for name, solve in solves(op, bj, Ltv, dims, args.n_iter).items():
        x, lams = solve()
        results[name] = relerr(x, x_true)
        print(f"{name}:  rel_err {relerr(x, x_true):.4f}  lam_last "
              f"{float(lams[-1]):.3e}")

    # checkpoint/resume: kill after the second chunk, resume from disk
    path = os.path.join(tempfile.mkdtemp(), "dyn_ckpt.npz")
    x_ref, x_res = kill_and_resume(op, bj, Ltv, dims, args.n_iter, path)
    same = torch.equal(x_res, x_ref)
    results["resumed"] = relerr(x_res, x_true)
    print(f"resumed run == uninterrupted run bit-for-bit: {same}  "
          f"(rel_err {relerr(x_res, x_true):.4f})")
    assert same
    return results, same


if __name__ == "__main__":
    main()
