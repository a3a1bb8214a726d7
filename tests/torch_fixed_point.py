"""K1's and K3's fixed-point sum (``trips_tpu_torch/csrc/banded.cu``) in
PyTorch, for the tests: int64 ``index_add_`` of the rounded terms, the
kernels' output bit for bit where their terms are the same.

- ``fixed_exponent``: the scale the kernels derive from ``m = bound *
  max|input|``.
- ``banded_adj_buckets_fixed``: K3, every term ``w * y[d]`` exact in
  float64.
- ``banded_ata_buckets_fixed``: K1, stage 1's float32 ``y`` from the plain
  version (the kernel's order of sums differs, so its ``y`` may differ in
  the last bits unless those sums are exact), then K3's sum.
"""
import torch

from trips_tpu_torch.sparse import banded_kernels as bk


def fixed_exponent(m):
    """The fixed-point scale of ``m = bound * max|input|`` (float64
    tensor, one per frame), as ``csrc/banded.cu`` ``fixed_scale`` takes
    it: -> (e, state) int64 tensors, state 1 where the terms add at scale
    ``2^e`` (``e = 61 - k`` for ``m < 2^k``: every partial sum below
    2^62), 0 where ``m == 0`` (a zero image, e = 0), -1 where ``m`` is not
    finite (an image of NaN, e = 0)."""
    m = torch.as_tensor(m, dtype=torch.float64)
    finite, zero = torch.isfinite(m), m == 0
    k = torch.frexp(torch.where(finite & ~zero, m, 1.0)).exponent.long()
    state = torch.where(finite, torch.where(zero, 0, 1), -1).long()
    return torch.where(state > 0, 61 - k, 0), state


def fixed_sum(terms, index, size, e, state):
    """The kernels' fixed-point sum of float64 ``terms`` into ``size``
    entries at ``index`` for one frame: each term times ``2^e`` rounded
    to int64 (half to even, as ``__double2ll_rn``), summed in int64, then
    ``float(acc 2^-e)``; NaN where ``state < 0``."""
    acc = torch.zeros(size, dtype=torch.int64, device=terms.device)
    if state > 0:
        acc.index_add_(0, index, torch.round(terms * 2.0 ** int(e)).long())
    out = (acc.double() * 2.0 ** -int(e)).float()
    if state < 0:
        out.fill_(float("nan"))
    return out


def _fixed_frame(parts, n, n_groups, e, state):
    """One frame's back-projection into an ``(n, n)`` image in fixed point:
    ``parts`` holds ``(W, S, Pm, scales, cols, y)`` per bucket, ``y (na,
    p_pad)`` what each angle's detectors project back; every term ``w *
    y[d]`` is exact in float64 (``fixed_sum``). A ``y`` that is not finite
    (K1's stage 1 overflowing float32) makes the image NaN, as the
    kernel's per-frame flag does."""
    lines = torch.arange(n, device=parts[0][0].device)[None, None, :, None]
    terms, index = [], []
    for W, S, Pm, sc, cols, y in parts:
        if state > 0 and not torch.isfinite(y).all():
            state = -1
        c = bk._columns(S, Pm, n_groups, W.shape[1], n)
        terms.append((bk.dequant_slab(W, sc).double()
                      * y.double()[:, None, None, :]).reshape(-1))
        index.append((c * n + lines if cols else lines * n + c).reshape(-1))
    return fixed_sum(torch.cat(terms), torch.cat(index), n * n, e,
                     state).view(n, n)


def _scales(name, inp, buckets, n_groups, bound):
    """(e, state) per frame of ``inp`` (frames in front of two
    dimensions) for kernel ``name``: ``bound`` (``pack_bounds`` unless
    given) times max|inp[f]|."""
    bound = (bk.pack_bounds(buckets, n_groups)[name] if bound is None
             else bound).to(inp.device)
    return fixed_exponent(bound.expand(inp.shape[0])
                          * bk._max_abs(inp, 2).double())


def banded_adj_buckets_fixed(Y, buckets, aidx, n_groups, bound=None):
    """K3's arithmetic on the card: ``banded_adj_buckets`` with every term
    ``w * y[d]`` (exact in float64) added in fixed point at frame f's
    scale from ``bound`` (``pack_bounds(...)["banded_adj"]`` unless given)
    and max|Y[f]|. Equal to the kernel's output bit for bit."""
    n = buckets[0][0].shape[-2]
    Y, framed = bk._frames(Y, 2)
    rows, p = Y.shape[1:]
    e, state = _scales("banded_adj", Y, buckets, n_groups, bound)
    out = torch.zeros((Y.shape[0], n, n), dtype=torch.float32,
                      device=Y.device)
    for f in range(Y.shape[0]):
        parts = []
        for bucket, ids in zip(buckets, aidx):
            (W, S, Pm, sc, cols), ids = bk._in_frame(bucket, ids, f)
            keep = (ids >= 0) & (ids < rows)
            Yg = torch.zeros((W.shape[0], W.shape[3]), dtype=torch.float64,
                             device=Y.device)
            Yg[keep, :p] = Y[f].double()[ids[keep].long()]
            parts.append((W, S, Pm, sc, cols, Yg))
        out[f] = _fixed_frame(parts, n, n_groups, e[f], state[f])
    return out if framed else out[0]


def banded_ata_buckets_fixed(X, XT, buckets, n_groups, bound=None):
    """K1's stage 2 on the card: each bucket's float32 ``y =
    banded_fwd_ref``, back-projected as ``banded_adj_buckets_fixed`` does
    at frame f's scale from ``bound`` (``pack_bounds(...)["banded_ata"]``
    unless given) and max|X[f]|."""
    X, framed = bk._frames(X, 2)
    XT = None if XT is None else bk._frames(XT, 2)[0]
    e, state = _scales("banded_ata", X, buckets, n_groups, bound)
    out = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    for f in range(X.shape[0]):
        parts = []
        for bucket in buckets:
            (W, S, Pm, sc, cols), _ = bk._in_frame(bucket, None, f)
            y = bk.banded_fwd_ref(XT[f] if cols else X[f], W, S, Pm,
                                  n_groups, sc)
            parts.append((W, S, Pm, sc, cols, y))
        out[f] = _fixed_frame(parts, X.shape[-1], n_groups, e[f], state[f])
    return out if framed else out[0]
