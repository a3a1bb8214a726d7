"""Per-frame reconstruction of dynamic CT, frame by frame.

Counterpart of ``trips_tpu/parallel/batched.py``. The reference
reconstructs dynamic frames one by one in a Python loop
(2_demo_dynamic_CrossPhantom.ipynb cell 20); the JAX package stacks the
frames' padded ELL tables and ``jax.vmap``s a fused solver over them, one
device launch for all frames. Here the stacked tables are the same, and
the solve is a loop over frames, each frame's ``EllOperator`` a view of
them: ``vmap``'s meaning, each frame's ``x`` that frame's fused solve.
``torch.func.vmap`` does not apply, because the port's fused loops read
the host once per chunk of steps (``core/loop.py``). A leading frame axis
in the fused solvers' state (a masked batched Brent, a batched SVD) would
cut the host's launches by ~nt; that is a speed change, queued in
ROADMAP's ``perf_opt`` list.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..solvers.fused import fused_gks, fused_mmgks
from ..sparse.ell import EllOperator, _csr_to_ell


def stack_ell_tables(blocks, device=DEFAULT):
    """Per-frame scipy matrices -> stacked padded ELL tables (nt leading)
    on ``device``: (values, int32 columns, the transposes' values and
    columns, the frames' shape, the nnz of all frames), the tables the JAX
    package's ``stack_ell_tables`` makes."""
    from scipy import sparse as sp

    device = resolve(device)
    mats = [sp.csr_matrix(b) for b in blocks]
    shape = mats[0].shape
    for m_ in mats:
        if m_.shape != shape:
            raise ValueError("all frames must share one shape")
    fwd = [_csr_to_ell(m_) for m_ in mats]
    bwd = [_csr_to_ell(m_.T.tocsr()) for m_ in mats]
    w = max(v.shape[1] for v, _ in fwd)
    w_t = max(v.shape[1] for v, _ in bwd)

    def pad_stack(tabs, width):
        vals = np.stack([
            np.pad(v, ((0, 0), (0, width - v.shape[1]))) for v, _ in tabs
        ])
        cols = np.stack([
            np.pad(c, ((0, 0), (0, width - c.shape[1]))) for _, c in tabs
        ])
        return (torch.from_numpy(vals).to(device),
                torch.from_numpy(cols.astype(np.int32)).to(device))

    vals, cols = pad_stack(fwd, w)
    vals_t, cols_t = pad_stack(bwd, w_t)
    nnz = sum(m_.nnz for m_ in mats)
    return vals, cols, vals_t, cols_t, shape, nnz


def batched_frame_solve(blocks, B, L, solver="mmgks", device=DEFAULT, **kw):
    """Reconstruct every frame with a fused solver, frame by frame.

    blocks: per-frame scipy matrices (same shape); B: per-frame data
    vectors; L: the shared regularization operator, on ``device``.
    ``solver``: "mmgks" (``fused_mmgks``) or anything else (``fused_gks``),
    with the JAX package's defaults ``projection_dim=3``, ``n_iter=10``,
    ``regparam_mode="gcv"``; the rest of ``kw`` (``delta``, ``pnorm``,
    ...) goes to the solver. Returns X (nt, n)."""
    device = resolve(device)
    vals, cols, vals_t, cols_t, shape, _ = stack_ell_tables(blocks, device)
    Bm = torch.stack([torch.as_tensor(np.asarray(bb).reshape(-1),
                                      device=device) for bb in B])
    solve = fused_mmgks if solver == "mmgks" else fused_gks
    static = dict(
        projection_dim=kw.pop("projection_dim", 3),
        n_iter=kw.pop("n_iter", 10),
        use_gcv=kw.pop("use_gcv", None),
        regparam_mode=kw.pop("regparam_mode", "gcv"),
    )
    X = []
    for t in range(len(Bm)):
        # frame t's own nnz (its stored nonzeros for a dense block), where
        # the JAX package's vmapped operator carries all frames'; the
        # solve never reads it
        op = EllOperator(vals[t], cols[t], vals_t[t], cols_t[t], shape,
                         nnz=getattr(blocks[t], "nnz", None))
        x, _, _ = solve(op, Bm[t], L, device=device, **static, **kw)
        X.append(x)
    return torch.stack(X)
