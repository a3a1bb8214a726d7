"""Shear-rotate kernels K4-K6: wrappers, plain versions, launch counts.

``ShearFanProjector`` rotates each view's image into one canonical frame
with an exact quarter turn (one of three precomputed canvases, ``kq``) and
three shears: along rows (``kx``, ``fx`` per row), along columns (``ky``,
``fy`` per column), along rows again. One shear with shift ``(k, f)`` is

    out(c) = (1 - f) * in((c + k) mod C) + f * in((c + k + 1) mod C)

- ``shear_rotate`` (K4): quarters ``(3, C, C)`` -> ``(na, C, C)`` rotated
  canvases, rounded once to ``out_dtype``.
- ``shear_rotate_adjoint`` (K5): ``(na, C, C)`` cotangents -> ``(3, C, C)``,
  the exact transpose summed per quarter turn.
- ``gcontract_ata`` (K6): rotated canvases ``R (na, C, C)`` and the stage-B
  constant ``G (C, C, p_pad)`` -> ``U . G^T`` with ``U = R . G`` rounded to
  the G dtype: the forward and adjoint stage-B products in one call.

They replace ``rotate_all_pallas``, ``rotate_all_adjoint_pallas`` and
``gcontract_ata_pallas`` of ``trips_tpu/operators/pallas_shear.py``. Each
wrapper sends a CPU tensor to its plain PyTorch version (``*_ref``, which
also takes float64), launches the CUDA kernel (``csrc/shear.cu``) for a
CUDA tensor, and raises for anything else. ``launch_counts`` counts kernel
launches only.

K4 and K5 run one tile routine (the three shears staged through shared
memory per output tile, K5 on the transposed chain). ``rotate_plan`` sizes
its footprint in Python, once per shift set, and the wrappers keep the plan
(``PLANS`` names the tile shape per kernel and canvas type; call
``clear_plans()`` after changing it).
"""
from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from ..core.loop import counted

# a replayed CUDA graph of a loop step counts its launches per replay
# (core/loop.py)
launch_counts = counted({"shear_rotate": 0, "shear_rotate_adjoint": 0,
                         "gcontract_ata": 0})

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BF16_N = 1024  # K6 bf16 keeps U (64 x p_pad) in shared memory


# Tile shapes (rows, columns) the K4/K5 kernels take; the chip sweep times
# each. PLANS: per kernel and canvas itemsize (K4's output, K5's input),
# the tile and, for K5, the most views a block sums (None: a quarter); each
# block writes a float32 partial plane, summed in order by a second pass.
TILES = ((8, 32), (16, 32), (16, 64), (32, 64))
PLANS = {"shear_rotate": {4: {"tile": (32, 64)}, 2: {"tile": (32, 64)}},
         "shear_rotate_adjoint": {4: {"tile": (16, 64), "chunk": 4},
                                  2: {"tile": (16, 64), "chunk": 4}}}
VEC, ROWS = 4, 2    # outputs per thread: ROWS rows of VEC (vector stores)
MAX_THREADS = 512   # threads per block: TY * TX / (VEC * ROWS)
SMEM_BYTES = 231424  # a block's 227 KB on sm_90 less 1 KB of static


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---- plain versions ---------------------------------------------------------
def _acc_dtype(*ts):
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else torch.float32)


def _shift_index(k, dim, C):
    """(na, C, C) source index ``c + k`` along ``dim`` (2: per row, 1: per
    column), before the mod."""
    ar = torch.arange(C, device=k.device)
    if dim == 2:
        return ar[None, None, :] + k.long()[:, :, None]
    return ar[None, :, None] + k.long()[:, None, :]


def _blend(f, dim):
    return f[:, :, None] if dim == 2 else f[:, None, :]


def _shear(buf, k, f, dim):
    C = buf.shape[dim]
    idx = _shift_index(k, dim, C)
    f = _blend(f.to(buf.dtype), dim)
    return ((1.0 - f) * torch.gather(buf, dim, idx % C)
            + f * torch.gather(buf, dim, (idx + 1) % C))


def _shear_t(buf, k, f, dim):
    """Exact transpose of ``_shear``:
    out(c) = (1 - f) * g((c - k) mod C) + f * g((c - k - 1) mod C)."""
    C = buf.shape[dim]
    idx = _shift_index(-k.long(), dim, C)
    f = _blend(f.to(buf.dtype), dim)
    return ((1.0 - f) * torch.gather(buf, dim, idx % C)
            + f * torch.gather(buf, dim, (idx - 1) % C))


def shear_rotate_ref(quarters, kx, fx, ky, fy, kq, out_dtype=torch.float32):
    buf = quarters[kq.long()]
    buf = _shear(buf, kx, fx, 2)
    buf = _shear(buf, ky, fy, 1)
    buf = _shear(buf, kx, fx, 2)
    return buf.to(out_dtype)


def shear_rotate_adjoint_ref(g, kx, fx, ky, fy, kq):
    buf = g.to(_acc_dtype(g, fx))
    buf = _shear_t(buf, kx, fx, 2)
    buf = _shear_t(buf, ky, fy, 1)
    buf = _shear_t(buf, kx, fx, 2)
    C = g.shape[1]
    out = torch.zeros((3, C, C), dtype=buf.dtype, device=g.device)
    return out.index_add_(0, kq.long(), buf)


def gcontract_ata_ref(R, G):
    na, C = R.shape[0], R.shape[1]
    acc = _acc_dtype(R, G)
    G2 = G.reshape(C * C, G.shape[2]).to(acc)
    U = (R.reshape(na, C * C).to(acc) @ G2).to(G.dtype)
    return (U.to(acc) @ G2.T).reshape(na, C, C)


# ---- K4/K5 plans ------------------------------------------------------------
def _arc(v, C):
    """The shortest arc of the circle [0, C) holding every value of ``v``
    (along its last axis): (first value, length - 1)."""
    s = np.sort(v, axis=-1)
    gaps = np.concatenate([np.diff(s, axis=-1), s[..., :1] + C - s[..., -1:]],
                          axis=-1)
    g = gaps.argmax(axis=-1)[..., None]
    first = np.take_along_axis(s, (g + 1) % v.shape[-1], -1)[..., 0]
    return first, C - np.take_along_axis(gaps, g, -1)[..., 0]


def rotate_smem_bytes(ty, w2, r1):
    """Shared memory of one K4/K5 block, as ``csrc/shear.cu`` lays it out:
    a 16-byte record per window row and column, 8 bytes per tile row, then
    TY + 1 rows of stage-1 values, each 4 Q words (``rotate_quarter``)."""
    q = -(-w2 // 4)
    q += (8 - q % 32) % 32  # Q = 8 mod 32: no bank conflicts
    return 4 * (4 * r1 + 4 * w2 + 2 * ty + (ty + 1) * 4 * q)


def rotate_plan(kernel, kx, ky, kq, C, tile, chunk=None):
    """The footprint of ``kernel`` (``shear_rotate`` or
    ``shear_rotate_adjoint``) per ``tile`` = (TY rows, TX columns) of output,
    from the integer shifts ``kx``, ``ky`` (na, C) and quarters ``kq`` (na,)
    (NumPy). K5 runs K4's routine on the shifts ``-k - 1``.

    Output row i reads the stage-2 row at window columns ``xs + t`` (mod C),
    t < ``w2`` = TX + 1 + the longest arc of ``kx`` (mod C) over any tile's
    rows; window column c reads stage-1 rows ``ys + v``, v < ``r1`` = TY + 1
    + the longest arc of ``ky`` over any tile's window. ``starts`` (na,
    tiles, 2) int32 holds each (view, tile)'s (xs, ys), tiles row-major;
    ``kx``, ``ky`` (na, C) int32 the shifts the kernel reads, reduced mod C
    (K5's ``-k - 1``), so that it computes no ``%``.
    For K5 also ``order`` (views by quarter, stable), ``chunks`` (first,
    count, slot) over ``order``, and ``qfirst`` (4,): quarter z's chunks are
    ``qfirst[z] .. qfirst[z + 1] - 1``: at most ``chunk`` views each
    (balanced; None: one chunk per quarter), none for a quarter with no
    view; slot = chunk index, its partial plane. Raises on what the kernels
    cannot run."""
    ty, tx = tile
    if tx % VEC or ty % ROWS or not (
            32 <= ty * tx // (VEC * ROWS) <= MAX_THREADS):
        raise ValueError(f"tile {tile}: TX must be a multiple of {VEC}, TY "
                         f"of {ROWS}, and TY * TX / {VEC * ROWS} within "
                         f"32..{MAX_THREADS}")
    if C * C >= 2 ** 31:
        raise ValueError(f"C = {C}: a canvas must hold fewer than 2^31 "
                         f"elements")
    kx, ky = np.asarray(kx, np.int64), np.asarray(ky, np.int64)
    kq = np.asarray(kq, np.int64)
    na = len(kq)
    if na < 1 or kx.shape != (na, C) or ky.shape != (na, C):
        raise ValueError(f"shifts must be (na, C) = ({na}, {C}), got "
                         f"{kx.shape}, {ky.shape}")
    if kq.min() < 0 or kq.max() > 2:
        raise ValueError(f"quarter ids must be 0, 1 or 2, got {set(kq)}")
    if kernel == "shear_rotate_adjoint":
        kx, ky = -kx - 1, -ky - 1
    elif kernel != "shear_rotate":
        raise ValueError(f"no rotate plan for {kernel}")
    xr, yr = kx % C, ky % C
    nty, ntx = -(-C // ty), -(-C // tx)
    rows = np.minimum(np.arange(nty * ty), C - 1).reshape(nty, ty)
    xmin, xspan = _arc(xr[:, rows], C)                        # (na, nty)
    w2 = tx + 1 + int(xspan.max())
    xs = (np.arange(ntx) * tx + xmin[:, :, None]) % C         # (na, nty, ntx)
    cols = (xs[..., None] + np.arange(w2)) % C
    ymin, yspan = _arc(yr[np.arange(na)[:, None, None, None], cols], C)
    r1 = ty + 1 + int(yspan.max())
    ys = (np.arange(nty)[None, :, None] * ty + ymin) % C
    smem = rotate_smem_bytes(ty, w2, r1)
    if smem > SMEM_BYTES:
        raise ValueError(f"{kernel}: a {ty}x{tx} tile of these shifts needs "
                         f"{smem} bytes of shared memory, more than "
                         f"{SMEM_BYTES}")
    plan = {"tile": (ty, tx), "w2": w2, "r1": r1, "smem_bytes": smem,
            "kx": xr.astype(np.int32), "ky": yr.astype(np.int32),
            "starts": np.stack([xs, ys], -1).reshape(na, nty * ntx, 2)
            .astype(np.int32)}
    if kernel == "shear_rotate":
        return plan
    order = np.argsort(kq, kind="stable")
    counts = np.bincount(kq, minlength=3)
    chunks, qfirst, first = [], [], 0
    for z in range(3):
        n = int(counts[z])
        qfirst.append(len(chunks))
        m = -(-n // chunk) if chunk else min(n, 1)  # 0 for no view
        cuts = [first + n * c // max(m, 1) for c in range(m + 1)]
        chunks += [(b, e - b, len(chunks) + c)
                   for c, (b, e) in enumerate(zip(cuts, cuts[1:]))]
        first += n
    qfirst.append(len(chunks))
    return {**plan, "order": order.astype(np.int32),
            "chunks": np.array(chunks, np.int32).reshape(-1, 3),
            "qfirst": np.array(qfirst, np.int32)}


# ---- kernel wrappers --------------------------------------------------------
def _check(tensors, inp):
    """``tensors``: (tensor, dtype or tuple of dtypes, shape, name)."""
    if inp.device.type != "cuda":
        raise ValueError(f"shear kernels take CPU or CUDA tensors, got "
                         f"{inp.device}")
    for t, dts, shape, name in tensors:
        dts = dts if isinstance(dts, tuple) else (dts,)
        if t.device != inp.device:
            raise ValueError(f"{name} is on {t.device}, input on "
                             f"{inp.device}")
        if t.dtype not in dts:
            raise TypeError(f"{name} must be "
                            f"{' or '.join(map(str, dts))}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _shift_checks(kx, fx, ky, fy, kq, C):
    na = kx.shape[0]
    return [(kx, torch.int32, (na, C), "kx"),
            (fx, torch.float32, (na, C), "fx"),
            (ky, torch.int32, (na, C), "ky"),
            (fy, torch.float32, (na, C), "fy"),
            (kq, torch.int32, (na,), "kq")]


def _launch(name, symbol, inp, *args):
    from .. import _build

    fn = getattr(_build.load(), symbol)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


# rotate plans made, by (kernel, itemsize, ids of kx, ky, kq, C, device):
# weak references to those shift tensors and the plan with its arrays on the
# device; an entry stands only while the very same tensors come again
_MADE = {}


def clear_plans():
    """Forget the K4/K5 plans made (after ``PLANS`` changed)."""
    _MADE.clear()


def _device_plan(kernel, itemsize, kx, ky, kq, C):
    """``rotate_plan`` for these shift tensors under ``PLANS``, its arrays on
    their device; made once per shift set (one host read of the shifts)."""
    key = (kernel, itemsize, id(kx), id(ky), id(kq), C, kx.device)
    hit = _MADE.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0],
                                                        (kx, ky, kq))):
        return hit[1]
    cfg = PLANS[kernel][itemsize]
    pl = rotate_plan(kernel, kx.cpu().numpy(), ky.cpu().numpy(),
                     kq.cpu().numpy(), C, cfg["tile"], cfg.get("chunk"))
    pl = {k: torch.from_numpy(v).to(kx.device)
          if isinstance(v, np.ndarray) else v for k, v in pl.items()}
    if len(_MADE) >= 64:
        del _MADE[next(iter(_MADE))]
    _MADE[key] = ([weakref.ref(t) for t in (kx, ky, kq)], pl)
    return pl


def _sizes(pl):
    return (*pl["tile"], pl["w2"], pl["r1"])


def shear_rotate(quarters, kx, fx, ky, fy, kq, out_dtype=torch.float32):
    """K4: float32 ``quarters (3, C, C)`` -> ``(na, C, C)`` in ``out_dtype``
    (float32 or bfloat16 on the card)."""
    if quarters.device.type == "cpu":
        return shear_rotate_ref(quarters, kx, fx, ky, fy, kq, out_dtype)
    C = quarters.shape[-1]
    _check([(quarters, torch.float32, (3, C, C), "quarters")]
           + _shift_checks(kx, fx, ky, fy, kq, C), quarters)
    if out_dtype not in _KIND:
        raise TypeError(f"out_dtype {out_dtype} is not float32/bfloat16")
    na = kx.shape[0]
    out = torch.empty((na, C, C), dtype=out_dtype, device=quarters.device)
    pl = _device_plan("shear_rotate", out.element_size(), kx, ky, kq, C)
    _launch("shear_rotate", "trips_shear_rotate", quarters,
            _KIND[out_dtype], *_ptrs(quarters, pl["kx"], fx, pl["ky"], fy,
                                     kq, pl["starts"], out), na, C,
            *_sizes(pl))
    return out


def shear_rotate_adjoint(g, kx, fx, ky, fy, kq):
    """K5: ``g (na, C, C)`` (float32 or bfloat16) -> ``(3, C, C)`` float32
    (float64 on the CPU when ``g`` or ``fx`` is); a quarter with no view is
    zero."""
    if g.device.type == "cpu":
        return shear_rotate_adjoint_ref(g, kx, fx, ky, fy, kq)
    na, C = kx.shape[0], g.shape[-1]
    _check([(g, tuple(_KIND), (na, C, C), "g")]
           + _shift_checks(kx, fx, ky, fy, kq, C), g)
    pl = _device_plan("shear_rotate_adjoint", g.element_size(), kx, ky, kq,
                      C)
    out = torch.empty((3, C, C), dtype=torch.float32, device=g.device)
    nchunks = pl["chunks"].shape[0]
    partials = torch.empty((nchunks, C, C), dtype=torch.float32,
                           device=g.device)
    _launch("shear_rotate_adjoint", "trips_shear_rotate_adj", g,
            _KIND[g.dtype], *_ptrs(g, pl["kx"], fx, pl["ky"], fy,
                                   pl["order"], pl["chunks"], pl["starts"],
                                   pl["qfirst"], partials, out), C, nchunks,
            *_sizes(pl))
    return out


@functools.lru_cache(maxsize=8)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_split(K, blocks, unit):
    """K6's split of the C*C axis: ``(chunk, nsplit)``, block ``s`` taking
    rows ``[s * chunk, min(K, (s + 1) * chunk))``, ``chunk`` a multiple of
    ``unit`` (the kernel's tile, ``trips_shear_ata_k_tile``), about one
    block per SM (``blocks``). The first product's partials are summed in
    block order."""
    chunk = -(-K // blocks)
    chunk = -(-chunk // unit) * unit
    return chunk, -(-K // chunk)


def gcontract_ata(R, G):
    """K6: ``R (na, C, C)`` and ``G (C, C, p_pad)`` of one dtype ->
    ``(na, C, C)`` float32 (float64 for float64 inputs on the CPU)."""
    if R.device.type == "cpu":
        return gcontract_ata_ref(R, G)
    if G.dim() != 3:
        raise ValueError(f"G must be (C, C, p_pad), got {tuple(G.shape)}")
    na, C, N = R.shape[0], G.shape[0], G.shape[2]
    _check([(R, tuple(_KIND), (na, C, C), "R"),
            (G, R.dtype, (C, C, N), "G")], R)
    K = C * C
    # TMA rows are whole 16-byte units; wgmma and the tile loops take
    # p_pad in 64-detector boxes
    if K % 8 or N % 64 or (R.dtype == torch.bfloat16 and N > _MAX_BF16_N):
        raise ValueError(f"K6 takes C*C a multiple of 8 and p_pad a "
                         f"multiple of 64 (at most {_MAX_BF16_N} for "
                         f"bfloat16), got C={C}, p_pad={N}")
    from .. import _build

    chunk, nsplit = k_split(K, _sm_count(R.device.index or 0),
                            _build.load().trips_shear_ata_k_tile())
    P = torch.empty((nsplit, na, N), dtype=torch.float32, device=R.device)
    U = torch.empty((na, N), dtype=R.dtype, device=R.device)
    out = torch.empty((na, C, C), dtype=torch.float32, device=R.device)
    _launch("gcontract_ata", "trips_shear_ata", R, _KIND[R.dtype],
            *_ptrs(R, G, P, U, out), na, K, N, nsplit, chunk)
    return out
