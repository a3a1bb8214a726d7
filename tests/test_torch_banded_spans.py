"""K1's tap spans (``banded_kernels.pack_spans``) on the CPU.

K1 loads and walks, per (angle, ``det`` detectors, line) of a bucket, only
the taps from the first to the last that hold a nonzero stored weight in
any of the tile's detectors. Its output stays that of the whole pack only
if every nonzero weight lies in its tile's span. Held here, at nx = 32, for
every storage class (float32, bfloat16, int8), flat and bucketed packs,
frame-stacked (one stack per frame, the dynamic operators) and shared
(one stack every frame reads, weight stride 0), on the buckets that drive
the image and on those that drive its transpose (``cols``):

- the spans cover every nonzero stored weight;
- both ends of every span are nonzero in some detector of the tile;
- the padded angles and all-zero lines get empty spans;
- an int8 pack's spans come from its int8 bytes (rounding makes zeros
  the float32 pack does not have);
- a plain PyTorch walk over the spans alone gives ``banded_ata_buckets_ref``
  bit for bit where the float32 sums are exact (dyadic weights, integer
  images), and within 1e-5 of the norm on random images.
"""
import numpy as np
import pytest
import torch

from trips_tpu_torch.problems import generate_synthetic_dynamic
from trips_tpu_torch.problems.projector import fan_beam_matrix
from trips_tpu_torch.sparse import (BandedProjector, BucketedBandedProjector,
                                    BucketedDynamicBandedOperator,
                                    DynamicBandedOperator)
from trips_tpu_torch.sparse import banded_kernels as bk
from trips_tpu_torch.sparse.pack import dequant_slab

from torch_threads import one_torch_thread  # noqa: F401

NX, VIEWS, NT = 32, 9, 3  # 9 views: the dynamic packs pad an angle a frame
DTYPES = {"float32": None, "bfloat16": torch.bfloat16, "int8": "int8"}
_OPS = {}


def _op(layout, frames, kind, like=None):
    """The pack of (flat or bucketed, frame-stacked or shared) in one
    storage class, built once, by the class that stores ``like`` (default:
    ``kind``; the flat classes store no int8, so a flat int8 pack is a
    bucketed one with one bucket per drive)."""
    key = (layout, frames, kind, like)
    if key not in _OPS:
        dt = DTYPES[kind]
        flat = layout == "flat" and (like or kind) != "int8"
        n_buckets = 1 if layout == "flat" else 2
        if frames == "stacked":
            if "dyn" not in _OPS:
                _OPS["dyn"] = generate_synthetic_dynamic(
                    nx=NX, nt=NT, views=VIEWS, return_angles=True)
            d = _OPS["dyn"]
            AA, angles = d[2], d[9]
            if flat:
                op = DynamicBandedOperator.from_frames(
                    AA, NX, angles, n_groups=8, dtype=dt, device="cpu")
            else:
                op = BucketedDynamicBandedOperator.from_frames(
                    AA, NX, angles, n_groups=8, dtype=dt,
                    n_buckets=n_buckets, device="cpu")
        else:
            A = fan_beam_matrix(NX, views=VIEWS).astype(np.float32)
            if flat:
                op = BandedProjector.from_scipy_fan(
                    A, NX, VIEWS, n_groups=8, dtype=dt, device="cpu")
            else:
                op = BucketedBandedProjector.from_scipy_fan(
                    A, NX, VIEWS, n_groups=8, dtype=dt, n_buckets=n_buckets,
                    device="cpu")
        _OPS[key] = op
    return _OPS[key]


def _case(layout, frames, kind, cols, like=None):
    """(op, its buckets that drive the transposed image or those that do
    not, their angle ids, the spans of those buckets)."""
    op = _op(layout, frames, kind, like)
    keep = [k for k, b in enumerate(op._bks) if bool(b[4]) == cols]
    assert keep, "the pack holds no such bucket"
    bks = [op._bks[k] for k in keep]
    return op, bks, [op._aidx[k] for k in keep], bk.pack_spans(bks)


CASES = pytest.mark.parametrize("layout,frames,kind,cols", [
    (layout, frames, kind, cols)
    for layout in ("flat", "bucketed") for frames in ("stacked", "shared")
    for kind in DTYPES for cols in (False, True)])


def _tiles(W, det):
    """(angles, T, n, tiles) bool: whether a stored weight of the (angle,
    tap, line, ``det``-detector tile) is nonzero."""
    T, n, p_pad = W.shape[-3:]
    nz = (W.reshape(-1, T, n, p_pad) != 0).numpy()
    tiles = -(-p_pad // det)
    nz = np.pad(nz, ((0, 0), (0, 0), (0, 0), (0, tiles * det - p_pad)))
    return nz.reshape(nz.shape[:3] + (tiles, det)).any(-1)


def _lo_cnt(sp):
    sp = sp.numpy().astype(np.int64)
    return sp & 0xFFFF, sp >> 16  # (angles, tiles, n) each


def _det(bks):
    return bk.span_det(bks[0][0].element_size())


@CASES
def test_spans_cover_every_nonzero(layout, frames, kind, cols):
    _, bks, _, spans = _case(layout, frames, kind, cols)
    det = _det(bks)
    for (W, *_), sp in zip(bks, spans):
        nz = _tiles(W, det)                      # (a, T, n, tiles)
        lo, cnt = _lo_cnt(sp)                    # (a, tiles, n)
        t = np.arange(W.shape[-3])[None, :, None, None]
        inside = ((t >= lo.transpose(0, 2, 1)[:, None])
                  & (t < (lo + cnt).transpose(0, 2, 1)[:, None]))
        assert not (nz & ~inside).any()
        assert nz.any()


@CASES
def test_span_ends_are_nonzero(layout, frames, kind, cols):
    _, bks, _, spans = _case(layout, frames, kind, cols)
    det = _det(bks)
    for (W, *_), sp in zip(bks, spans):
        nz = _tiles(W, det)
        lo, cnt = _lo_cnt(sp)
        a, c, i = np.nonzero(cnt)
        assert len(a)
        assert nz[a, lo[a, c, i], i, c].all()
        assert nz[a, lo[a, c, i] + cnt[a, c, i] - 1, i, c].all()
        assert (lo[cnt == 0] == 0).all()


@CASES
def test_empty_lines_and_padded_angles(layout, frames, kind, cols):
    """A (angle, tile, line) with no nonzero weight gets an empty span; a
    padded angle (the dynamic packs' id ``views``) gets only empty
    spans."""
    op, bks, ids, spans = _case(layout, frames, kind, cols)
    det = _det(bks)
    padded = 0
    for (W, *_), a_ids, sp in zip(bks, ids, spans):
        nz = _tiles(W, det).any(1)               # (a, n, tiles)
        _, cnt = _lo_cnt(sp)
        assert ((cnt > 0) == nz.transpose(0, 2, 1)).all()
        assert (cnt == 0).any()
        pad = a_ids.reshape(-1).numpy() >= getattr(op, "views", 1 << 30)
        assert (cnt[pad] == 0).all()
        padded += int(pad.sum())
    if frames == "stacked":
        assert padded  # 9 views in groups of 5 and 5: one padded a frame


@pytest.mark.parametrize("layout,frames", [
    (layout, frames) for layout in ("flat", "bucketed")
    for frames in ("stacked", "shared")])
def test_int8_spans_come_from_int8_bytes(layout, frames):
    """The int8 pack's spans are those of its own bytes: inside the
    float32 pack's (the same weights, some rounded to zero), and narrower
    wherever rounding zeroed every weight of a span's end in the tile,
    which happens in each of these packs (both drives together)."""
    narrower = 0
    for cols in (False, True):
        _, b8, _, s8 = _case(layout, frames, "int8", cols)
        _, b32, _, _ = _case(layout, frames, "float32", cols, like="int8")
        det = _det(b8)
        for (W8, *_), sp8, (W32, *_) in zip(b8, s8, b32):
            assert torch.equal(sp8, bk.tap_spans(W8, det))
            lo8, c8 = _lo_cnt(sp8)
            lo32, c32 = _lo_cnt(bk.tap_spans(W32, det))
            some = c8 > 0
            assert (lo8[some] >= lo32[some]).all()
            assert ((lo8 + c8)[some] <= (lo32 + c32)[some]).all()
            narrower += int((c8 < c32).sum())
    assert narrower


def _walk_ata(X, XT, buckets, spans, n_groups, det):
    """A^T A over the spans alone: every (angle, tile, line) contributes
    the taps ``lo .. lo + cnt - 1`` of its span and nothing else, gathered
    row by row (float32, as the kernel's stage 1; the back-projection too,
    in float32)."""
    Xf, framed = (X, True) if X.dim() == 3 else (X[None], False)
    XTf = None if XT is None else (XT if XT.dim() == 3 else XT[None])
    nf = Xf.shape[0]
    out = torch.zeros(Xf.shape, dtype=torch.float32)
    for f in range(nf):
        for (W, S, Pm, sc, cols), sp in zip(buckets, spans):
            if W.dim() == 5:
                na = W.shape[1]
                W, S, Pm = W[f], S[f], Pm[f]
                sc = None if sc is None else sc[f]
                sp = sp[f * na:(f + 1) * na]
            na, T, n, p_pad = W.shape
            w = dequant_slab(W, sc)
            tiles = -(-p_pad // det)
            w = torch.nn.functional.pad(w, (0, tiles * det - p_pad))
            lo, cnt = (sp & 0xFFFF).long(), (sp >> 16).long()
            img_in = XTf[f] if cols else Xf[f]
            gsize = n // n_groups
            d = torch.arange(det)
            y = torch.zeros(na, tiles * det)
            rows = []
            for k in range(T):
                a, c, i = torch.nonzero(cnt > k, as_tuple=True)
                t = lo[a, c, i] + k
                dd = c[:, None] * det + d                     # (R, det)
                wr = w[a[:, None], t[:, None], i[:, None], dd]
                pm = Pm.long()[a[:, None], (i // gsize)[:, None],
                               dd.clamp(max=p_pad - 1)]
                col = torch.remainder(S.long()[a, i][:, None] + pm
                                      + t[:, None], n)
                y.index_put_((a[:, None].expand_as(dd), dd),
                             wr * img_in[i[:, None], col], accumulate=True)
                rows.append((a, i, dd, wr, col))
            img = torch.zeros(n * n)
            for a, i, dd, wr, col in rows:
                img.index_add_(0, (i[:, None] * n + col).reshape(-1),
                               (wr * y[a[:, None], dd]).reshape(-1))
            img = img.view(n, n)
            out[f] += img.T if cols else img
    return out if framed else out[0]


def _dyadic(buckets):
    """The buckets with every weight a multiple of 1/16 (int8: scales
    1/16), so that with small integer images every float32 sum is exact
    in any order."""
    out = []
    for W, S, Pm, sc, cols in buckets:
        if sc is None:
            W = (torch.round(W.float() * 16) / 16).to(W.dtype)
        else:
            sc = torch.full_like(sc, 1 / 16)
        out.append((W.contiguous(), S, Pm, sc, cols))
    return out


@CASES
def test_walk_over_spans_equals_plain(layout, frames, kind, cols):
    op, bks, _, _ = _case(layout, frames, kind, cols)
    n = op.n_pad
    shape = (NT, n, n) if frames == "stacked" else (2, n, n)
    g = torch.Generator().manual_seed(3)
    dy = _dyadic(bks)
    spans = bk.pack_spans(dy)
    det = _det(dy)
    Xi = torch.randint(-4, 5, shape, generator=g).float()
    XiT = Xi.transpose(-1, -2).contiguous()
    want = bk.banded_ata_buckets_ref(Xi, XiT, dy, op.n_groups)
    got = _walk_ata(Xi, XiT, dy, spans, op.n_groups, det)
    assert want.abs().max() > 0
    assert torch.equal(got, want)
    X = torch.randn(shape, generator=g)
    XT = X.transpose(-1, -2).contiguous()
    want = bk.banded_ata_buckets_ref(X, XT, bks, op.n_groups).double()
    got = _walk_ata(X, XT, bks, bk.pack_spans(bks), op.n_groups, det)
    assert float((got.double() - want).norm() / want.norm()) <= 1e-5


def test_spans_pad_a_partial_tile():
    """A tile past p_pad reads its missing detectors as zeros."""
    W = torch.zeros(1, 4, 3, 48)
    W[0, 1, 0, 40] = 1.0   # tile 0 of 32 detectors: line 0, tap 1 ...
    W[0, 3, 0, 47] = 2.0   # ... to tap 3, in the half-filled second tile
    W[0, 2, 2, 5] = 3.0
    lo, cnt = _lo_cnt(bk.tap_spans(W, 32))
    assert lo.shape == (1, 2, 3)
    assert (lo[0, 1, 0], cnt[0, 1, 0]) == (1, 3)
    assert (lo[0, 0, 2], cnt[0, 0, 2]) == (2, 1)
    assert cnt.sum() == 4
