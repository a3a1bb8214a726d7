"""Shear-packed band format: host pack and dequantization.

Packing (host NumPy, exact: every nnz keeps its float32 value and
position) stores, per angle, a weight slab ``W (T, n_pad, p_pad)`` with

    column(a, i, d, t) = shift[a, i] + P[a, g(i), d] + t,   0 <= t < T

where ``shift`` is a per-(angle, line) integer shear, ``P`` a per-group
integer predictor (``g(i)`` groups ``n_pad / G`` consecutive lines) and the
tap axis ``T`` absorbs the per-line residual. The drive axis per angle
follows Joseph's rule (rows when |cos th| >= |sin th|, else columns, on the
transposed image). Padded lines (``i >= nx``) and padded lanes
(``d >= p``) carry zero weight, so an apply may wrap columns mod ``n_pad``
without masks.

The pack functions are copies of ``trips_tpu/sparse/banded.py`` and give
byte-identical stacks from the same CSR matrix. As there, each angle's
shear, predictor and taps, and the fill of its weights, run in the C++
library (``trips_tpu_torch.native``, bit for bit the NumPy code beside it)
unless ``TRIPS_TPU_NO_NATIVE=1`` selects the NumPy code. The applies on a
packed group, and their plain versions
(the twin of ``trips_tpu``'s ``apply_group_xla(..., wrap=True)``), are in
``banded_kernels.py``.
"""
from __future__ import annotations

import numpy as np

from ..native import pack_angle, scatter_fill


def sp_isspmatrix_csr_like(A):
    return getattr(A, "format", None) == "csr"


def _pack_angle(coo_d, coo_i, coo_c, coo_v, n, p, n_groups, n_pad=None):
    """Pack one angle's (detector, line, column, value) triplets.

    Returns ((t, line, detector, value) scatter coordinates, T_a,
    shift (n_pad,) int32, P (n_groups, p) int32) with
    column = shift[i] + P[g(i), d] + t.
    """
    n_pad = n if n_pad is None else n_pad
    native = pack_angle(coo_d, coo_i, coo_c, n, p, n_groups, n_pad)
    if native is not None:
        t, shift, P, T_a = native
        return (t, coo_i, coo_d, coo_v), T_a, shift, P
    # minimum observed column per (line, detector): cmin[i, d]
    cmin = np.full((n, p), np.iinfo(np.int32).max, np.int64)
    np.minimum.at(cmin, (coo_i, coo_d), coo_c)
    have_id = cmin < np.iinfo(np.int32).max

    # per-line integer shear: the line's median start, int(np.median(...))
    # semantics (floor of the two middle elements' average)
    shift = np.zeros(n_pad, np.int64)
    have_i = have_id.any(axis=1)
    cnt = have_id.sum(axis=1)
    vals = np.where(have_id, cmin, np.iinfo(np.int64).max)
    vals.sort(axis=1)
    rows = np.arange(n)
    safe = np.maximum(cnt, 1)
    lo = vals[rows, (safe - 1) // 2]
    hi = vals[rows, np.minimum(safe // 2, p - 1)]
    shift[:n] = np.where(have_i, (lo + hi) // 2, 0)

    # per-group predictor: P[g, d] = min over the group's lines of
    # (cmin - shift); leaves only the within-group slope to the taps
    gsize = n_pad // n_groups
    g_of = np.arange(n) // gsize
    rel = np.where(have_id, cmin - shift[:n, None],
                   np.iinfo(np.int32).max)
    P = np.full((n_groups, p), np.iinfo(np.int32).max, np.int64)
    np.minimum.at(P, (g_of[:, None].repeat(p, 1), np.arange(p)[None, :]
                      .repeat(n, 0)), rel)
    # (g, d) cells with no data: nearest present detector of the group
    for g in range(n_groups):
        miss = P[g] == np.iinfo(np.int32).max
        if miss.all():
            P[g] = 0
        elif miss.any():
            ok = np.nonzero(~miss)[0]
            P[g, miss] = P[g, ok[np.argmin(
                np.abs(np.nonzero(miss)[0][:, None] - ok[None, :]), axis=1)]]

    t = coo_c - shift[coo_i] - P[g_of[coo_i], coo_d]
    if not (t >= 0).all():
        raise ValueError("pack invariant violated: negative tap offset")
    T_a = int(t.max()) + 1 if len(t) else 1
    return ((t, coo_i, coo_d, coo_v), T_a, shift.astype(np.int32),
            P.astype(np.int32))


def _pack_groups(A, nx, views, angles, n_groups):
    """Angle-major matrix -> per-angle pack results split by drive
    orientation. Returns (packs, idx, angles, p, n_pad) where packs[dr] is a
    list of ``_pack_angle`` results and idx[dr] the matching angle ids."""
    angles = (np.linspace(0, np.pi, views, endpoint=False)
              if angles is None else np.asarray(angles))
    if A.shape[0] % len(angles):
        raise ValueError(f"{A.shape[0]} rows do not split into "
                         f"{len(angles)} angles of equal detector count")
    coo = A.tocoo()
    p = A.shape[0] // len(angles)
    n = nx
    # lane-align the roll axis; padded lines are zero-weight
    n_pad = -(-n // 128) * 128
    if n_pad % n_groups:
        raise ValueError(
            f"n_groups={n_groups} must divide the padded grid "
            f"{n_pad} (nx={n} padded to the next multiple of 128); "
            f"pick n_groups from the divisors of {n_pad}.")
    drive_rows = np.abs(np.cos(angles)) >= np.abs(np.sin(angles))
    packs = {True: [], False: []}
    idx = {True: [], False: []}
    d_of = (coo.row % p).astype(np.int32, copy=False)
    i_img = (coo.col // nx).astype(np.int32, copy=False)
    j_img = (coo.col % nx).astype(np.int32, copy=False)
    vals = (coo.data if coo.data.dtype == np.float32
            else coo.data.astype(np.float32))
    # angle-major rows: each angle is one contiguous slice of the COO
    if sp_isspmatrix_csr_like(A):
        sorted_rows = True
        bounds = np.asarray(A.indptr)[np.arange(len(angles) + 1) * p]
    else:
        a_of = coo.row // p
        sorted_rows = bool(np.all(np.diff(coo.row) >= 0))
        if sorted_rows:
            bounds = np.searchsorted(a_of, np.arange(len(angles) + 1))
    for a in range(len(angles)):
        m = (slice(bounds[a], bounds[a + 1]) if sorted_rows
             else a_of == a)
        dr = bool(drive_rows[a])
        line = i_img[m] if dr else j_img[m]
        c = j_img[m] if dr else i_img[m]
        packs[dr].append(_pack_angle(d_of[m], line, c, vals[m], n, p,
                                     n_groups, n_pad=n_pad))
        idx[dr].append(a)
    return packs, idx, angles, p, n_pad


def _stack_packs(group, n_pad, p, p_pad):
    """Stack per-angle pack results into float32 (W, S, P) arrays at the
    group-wide T = max T_a."""
    T = max(T_a for _, T_a, _, _ in group)
    W = np.zeros((len(group), T, n_pad, p_pad), np.float32)
    for k, ((t, ii, dd, vv), _, _, _) in enumerate(group):
        if not scatter_fill(t, ii, dd, vv, W[k]):
            W[k, t, ii, dd] = vv
    S = np.stack([s for _, _, s, _ in group])
    P = np.stack([np.pad(pp, ((0, 0), (0, p_pad - p)), mode="edge")
                  for _, _, _, pp in group])
    return W, S, P


def dequant_slab(W, sc):
    """Stored weight stack -> float32; int8 stacks times their per-angle
    scales. ``sc`` None passes float32/bfloat16 stacks through as float32."""
    if sc is None:
        return W.float()
    return W.float() * sc[:, None, None, None]

