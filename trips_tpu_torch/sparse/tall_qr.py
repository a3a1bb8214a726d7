"""R-only QR of tall-skinny panels: ``tall_r``, its plain version, its plan.

``tall_r(x, w)`` returns the ``(k, k)`` upper triangle R of a Householder
QR of ``diag(w) x`` for an ``(m, k)`` panel ``x`` (zeros below the
diagonal, also where ``m < k``), so that ``R^T R = x^T diag(w)^2 x``. No Q
is formed. MMGKS needs only R: of the panel with the data columns
appended, ``[X | c]``, ``R[:k, k] = Q^T c`` and ``R[k, k]^2`` is the
energy of ``c`` outside X's range (``solvers/mmgks.py``), each up to the
sign of its row.

- A panel wider than ``MAX_K`` goes to ``torch.linalg.qr`` on every
  device (``qr_library`` counts that route). The route is a test of the
  width, made before anything runs.
- A CUDA tensor (float32 or float64) goes to the hand-written kernel
  ``tsqr_geqrf`` (``csrc/tsqr.cu``: a leaf per block of rows,
  Householder-folded warp by warp, and a tree over the leaves run by the
  block that finishes last, in one launch).
- A CPU tensor goes to ``tall_r_ref``, the plain PyTorch version: the
  kernel's structured reflections on the kernel's tiles and leaves, merged
  in the kernel's order (``plan``; off the card the plan is the H100's,
  ``N_SM``).

The kernel replaces no TPU kernel: the JAX package calls ``jnp.linalg.qr``
at this place (``trips_tpu/solvers/mmgks.py:91-92``), which cuSOLVER runs
as an unblocked ``geqr2``. ``launch_counts`` counts the kernel's launches
(``tsqr_geqrf``) and the library route's calls (``qr_library``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.loop import counted

launch_counts = counted({"tsqr_geqrf": 0, "qr_library": 0})

# The kernel's shape, fixed when it is compiled (csrc/tsqr.cu kFoldRows,
# kMaxWarps; its launch refuses a plan past them): rows one fold takes (32
# lanes x 4 rows), and warps a block.
FOLD_ROWS = 128
MAX_WARPS = 16
# The widest panel the kernel takes: a merge folds a whole k x k triangle
# as one fold's rows.
MAX_K = FOLD_ROWS
# The plan's H100 numbers: a block's shared memory (227 KB on sm_90 less
# 1 KB of static; a plan for more is refused by the device at launch) and
# the SMs of an H100 SXM, which the CPU's plan takes.
SMEM_BYTES = 226 * 1024
N_SM = 132
_KIND = {torch.float32: 0, torch.float64: 1}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


class Plan(NamedTuple):
    tile_rows: int       # rows a warp folds at a time (<= FOLD_ROWS)
    warps: int           # warps a block
    blocks: int          # blocks, one leaf each
    rows_per_block: int  # a multiple of tile_rows; blocks x it >= m


def plan(m, k, itemsize, n_sm=N_SM):
    """The kernel's launch plan for an ``(m, k)`` panel of ``itemsize``-byte
    values: a warp's triangle and tile (rows at the odd stride ``k | 1``)
    as many times as shared memory holds, up to ``MAX_WARPS`` (tiles of
    fewer rows where one triangle leaves no room for ``FOLD_ROWS``), and
    one block per SM at most, each with a whole number of tiles. At
    ``k <= MAX_K`` one triangle leaves room for 96 rows of float64."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the kernel takes 1 to {MAX_K} columns, not {k}")
    row = (k | 1) * itemsize
    tile_rows = min(FOLD_ROWS, (SMEM_BYTES - k * row) // row)
    warps = min(MAX_WARPS, SMEM_BYTES // ((k + tile_rows) * row))
    blocks = max(1, min(n_sm, math.ceil(m / (warps * tile_rows))))
    rows_per_block = math.ceil(math.ceil(m / blocks) / tile_rows) * tile_rows
    blocks = max(1, math.ceil(m / rows_per_block))
    return Plan(tile_rows, warps, blocks, rows_per_block)


# ---- plain version ------------------------------------------------------
def _fold(R, X):
    """R <- the R factor of [R; X], batched: R (B, k, k) upper triangular,
    updated in place; X (B, n, k), overwritten. The kernel's structured
    reflections: reflection j touches R's row j and X's column j only
    (LAPACK larfg: a zero column below R gives tau = 0). R's diagonal is
    +0 or a reflection's beta, never -0, so beta = -copysign(nrm, alpha)."""
    k = R.shape[-1]
    for j in range(k):
        x = X[:, :, j]
        sigma = torch.linalg.vecdot(x, x)
        alpha = R[:, j, j]
        beta = -torch.copysign(torch.addcmul(sigma, alpha, alpha).sqrt_(),
                               alpha)
        on = sigma != 0
        u = x * torch.where(on, 1 / (alpha - beta), 0.0)[:, None]
        if j + 1 < k:
            tw = (torch.where(on, (beta - alpha) / beta, 0.0)[:, None]
                  * torch.baddbmm(R[:, j, None, j + 1:], u[:, None, :],
                                  X[:, :, j + 1:])[:, 0])
            R[:, j, j + 1:] -= tw
            X[:, :, j + 1:] -= u[:, :, None] * tw[:, None, :]
        R[:, j, j] = torch.where(on, beta, alpha)


def _merge(R):
    """Fold each block's warp triangles R (P, live, k, k) into warp 0's, as
    ``merge_warps`` does: at each level the triangles left (s apart) go in
    groups of g + 1, the first folding the next g stacked as rows. The
    kernel's warps past ``live`` hold zeros (no tile), which change
    nothing, so their slots are left out. Returns (P, k, k)."""
    P, live, k, _ = R.shape
    g = max(1, FOLD_ROWS // k)
    s = 1
    while s < live:
        span = s * (g + 1)
        for lead in range(0, live, span):
            n = min(g, (live - 1 - lead) // s)
            if n > 0:
                src = R[:, lead + s:lead + s * n + 1:s].reshape(P, n * k, k)
                _fold(R[:, lead], src.clone())
        s = span
    return R[:, 0]


def _blocks_r(X, p):
    """Each block's triangle (P, k, k) of the rows it owns in plan p, its
    warps folding their tiles (tile t of warp w: the block's tile t nw + w)
    and then merging."""
    m, k = X.shape
    P, nw, T, rpb = p.blocks, p.warps, p.tile_rows, p.rows_per_block
    live = min(nw, rpb // T)  # warps with a tile
    tpw = math.ceil(rpb // T / nw)  # tiles of the busiest warp
    tiles = X.new_zeros(P, tpw * nw * T, k)
    tiles[:, :rpb] = torch.nn.functional.pad(
        X, (0, 0, 0, P * rpb - m)).view(P, rpb, k)
    tiles = tiles.view(P, tpw, nw, T, k)[:, :, :live]
    R = X.new_zeros(P, live, k, k)
    for t in range(tpw):
        _fold(R.view(P * live, k, k), tiles[:, t].reshape(P * live, T, k))
    return _merge(R)


def tall_r_ref(x, w=None, n_sm=N_SM):
    """``tall_r`` in plain PyTorch on the kernel's plan for ``n_sm`` SMs:
    the blocks' leaves, then one block over the leaves stacked as rows.
    ``k <= MAX_K``.

    On the CPU, host MMGKS takes this with the H100's plan on purpose: its
    R then rounds as the card's does, and the float64 lambdas stay at the
    JAX package's to the rounding noise floor that
    ``tests/test_torch_solvers.py`` holds them to (a LAPACK QR of each
    fold's rows rounds otherwise, and fails there)."""
    m, k = x.shape
    X = x if w is None else x * w[:, None]
    if m == 0 or k == 0:
        return x.new_zeros(k, k)
    p = plan(m, k, x.element_size(), n_sm)
    R = _blocks_r(X, p)
    if p.blocks > 1:
        rows = math.ceil(p.blocks * k / p.tile_rows) * p.tile_rows
        R = _blocks_r(R.reshape(p.blocks * k, k),
                      p._replace(blocks=1, rows_per_block=rows))
    return R[0]


# ---- the route ------------------------------------------------------------
def _launch(x, w, out):
    from .. import _build

    m, k = x.shape
    p = plan(m, k, x.element_size(),
             torch.cuda.get_device_properties(x.device).multi_processor_count)
    # the leaves, then the ticket the blocks take (csrc/tsqr.cu)
    work = x.new_empty(p.blocks * k * k + 1) if p.blocks > 1 else None
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.trips_tsqr(
            _KIND[x.dtype], x.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), m, k, p.tile_rows,
            p.warps, p.blocks, p.rows_per_block,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"tsqr_geqrf launch failed: CUDA error {err}")
    launch_counts["tsqr_geqrf"] += 1
    return out


def tall_r(x, w=None, out=None):
    """The ``(k, k)`` R factor of ``diag(w) x`` for an ``(m, k)`` panel
    ``x`` (``w``: ``(m,)`` row weights of x's dtype and device, or None),
    written into ``out`` if given (a contiguous ``(k, k)`` tensor of x's
    dtype and device). Rows of R may differ in sign from LAPACK's."""
    if x.dim() != 2:
        raise ValueError(f"tall_r takes an (m, k) panel, got {tuple(x.shape)}")
    m, k = x.shape
    if w is not None and (w.shape != (m,) or w.dtype != x.dtype
                          or w.device != x.device):
        raise ValueError("w must be (m,) of the panel's dtype and device")
    if out is not None and (out.shape != (k, k) or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (k, k) tensor of the "
                         "panel's dtype and device")
    if k > MAX_K:
        launch_counts["qr_library"] += 1
        X = x if w is None else x * w[:, None]
        R = x.new_zeros(k, k)
        R[:min(m, k)] = torch.linalg.qr(X, mode="r")[1]
    elif x.device.type == "cpu":
        R = tall_r_ref(x, w)
    elif x.device.type != "cuda":
        raise ValueError(f"tall_r: no route for a {x.device.type} tensor")
    elif x.dtype not in _KIND:
        raise TypeError(f"tall_r takes float32 or float64, got {x.dtype}")
    elif m == 0 or k == 0:
        R = x.new_zeros(k, k)
    else:
        R = out if out is not None else x.new_empty(k, k)
        return _launch(x.contiguous(),
                       None if w is None else w.contiguous(), R)
    if out is None:
        return R
    return out.copy_(R)
