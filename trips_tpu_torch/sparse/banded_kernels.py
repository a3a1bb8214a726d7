"""Banded-projector kernels K1-K3: wrappers, plain versions, launch plans,
launch counts.

One bucket of the shear-packed band format (``banded.py``) is the stack
``W (na, T, n, p_pad)`` (float32, bfloat16, or int8 with per-angle float32
``scales (na,)``), ``S (na, n)`` int32 raw shears and ``Pm (na, G, p_pad)``
int32 predictors; ``n`` is the padded roll size. Every stored weight sits at

    column(a, t, i, d) = (S[a, i] + Pm[a, i // (n // G), d] + t) mod n

of drive line ``i``. The three maps, each in float32 on the dequantized
weights:

- ``banded_fwd`` (K2): image ``X (n, n)`` -> ``(na, p_pad)``,
  ``y[a, d] = sum_{t,i} W[a,t,i,d] * X[i, column]``.
- ``banded_adj`` (K3): ``Y (na, p_pad)`` -> image ``(n, n)``, the exact
  transpose summed over angles.
- ``banded_ata`` (K1): ``X`` -> ``adj(fwd(X))`` in one pass per bucket; the
  sinogram row stays on chip.

The operator's path runs each over all buckets of a pack in one launch
(``banded_fwd_buckets``, ``banded_adj_buckets``, ``banded_ata_buckets``):
K2 writes each angle's row of the ``(n_angles, p)`` sinogram, K3 reads it
there, and the buckets with ``cols`` drive the transposed image. The
one-bucket wrappers are their ``nb = 1`` case.

Frames: the same launch takes a stack of images ``(nf, n, n)`` (the
sinograms ``(nf, rows, p)``). A bucket whose tensors carry a leading frame
axis, ``W (nf, na, T, n, p_pad)``, ``S (nf, na, n)``, ``Pm (nf, na, G,
p_pad)``, ``scales (nf, na)`` and angle ids ``(nf, na)``, applies frame
f's stack to frame f (the dynamic operators' frame-varying geometry); a
bucket without one applies its stack to every frame (a shared-geometry
block diagonal, the columns of a ``matmat``). An angle id is a row of its
frame's sinogram; one outside ``[0, rows)`` (a padded angle) writes and
reads nothing.

They replace ``_fwd_call``, ``_adj_call`` and ``_ata_call`` of
``trips_tpu/sparse/pallas_banded_kernel.py``, and their ``jax.vmap`` over
frames in ``trips_tpu/sparse/dynamic_banded.py``. Each wrapper sends a CPU
tensor to its plain PyTorch version (``*_ref``, the twin of the JAX oracle
``apply_group_xla(..., wrap=True)``), launches the CUDA kernel
(``csrc/banded.cu``) for a CUDA tensor, and raises for anything else.
``launch_counts`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from .pack import dequant_slab

launch_counts = {"banded_fwd": 0, "banded_adj": 0, "banded_ata": 0}

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OP = {"banded_fwd": 0, "banded_adj": 1, "banded_ata": 2}  # csrc/banded.cu
SMEM_BYTES = 227 * 1024  # the most dynamic shared memory a block can have
_MAX_BOX = 256           # a TMA box spans at most 256 per dimension
# How each kernel cuts a (bucket, angle, det detectors) tile (see
# tile_plan): det by weight size; the choices of parts that split the
# lines (a cluster for K1 and K2: at most 16, Hopper's non-portable size;
# independent blocks for K3); the most lines a part takes, so that every
# block has work for its line slices but not a long serial chain; and the
# most slab bytes a block loads at once, by weight size. The kernels use
# 32 registers a thread, so shared memory sets how many 256-thread blocks
# share an SM: 6 with 36 KB slabs, 8 (all the SM's threads) with 26 KB or
# less. The widths (32 or 64) and slab sizes (12, 18, 26 or 36 KB) are the
# fastest on an H100 (chip_banded_plans.py): 256-byte float32 rows;
# smaller slabs slow K1 and K2 in bfloat16, where they mean 16-block
# clusters. The kernel takes the plan as given and sizes its shared memory
# and TMA loads from it.
_TILE = {"parts": (1, 2, 4, 8, 16), "max_lines": 64}
PLANS = {
    "banded_ata": {**_TILE, "det": {4: 64, 2: 32, 1: 32},
                   "slab_bytes": {4: 26 * 1024, 2: 36 * 1024, 1: 36 * 1024}},
    "banded_fwd": {**_TILE, "det": {4: 64, 2: 32, 1: 64},
                   "slab_bytes": {4: 18 * 1024, 2: 36 * 1024, 1: 36 * 1024}},
    "banded_adj": {**_TILE, "det": {4: 64, 2: 64, 1: 64},
                   "slab_bytes": {4: 18 * 1024, 2: 18 * 1024, 1: 18 * 1024}},
}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---- plain versions ---------------------------------------------------------
def _columns(S, Pm, n_groups, T, n):
    """(na, T, n, p_pad) int64 column of every stored weight."""
    dev = S.device
    g_of = torch.arange(n, device=dev) // (n // n_groups)
    cidx = (S.long()[:, None, :, None]
            + Pm.long()[:, g_of][:, None, :, :]
            + torch.arange(T, device=dev)[None, :, None, None])
    return torch.remainder(cidx, n)


def banded_fwd_ref(X, W, S, Pm, n_groups, scales=None):
    na, T, n, p_pad = W.shape
    c = _columns(S, Pm, n_groups, T, n)
    rows = torch.arange(n, device=X.device)[None, None, :, None]
    return (dequant_slab(W, scales) * X.float()[rows, c]).sum(dim=(1, 2))


def banded_adj_ref(Y, W, S, Pm, n_groups, scales=None):
    na, T, n, p_pad = W.shape
    c = _columns(S, Pm, n_groups, T, n)
    contrib = dequant_slab(W, scales) * Y.float()[:, None, None, :]
    flat = torch.arange(n, device=Y.device)[None, None, :, None] * n + c
    img = torch.zeros(n * n, dtype=torch.float32, device=Y.device)
    return img.index_add_(0, flat.reshape(-1), contrib.reshape(-1)).view(n, n)


def banded_ata_ref(X, W, S, Pm, n_groups, scales=None):
    y = banded_fwd_ref(X, W, S, Pm, n_groups, scales)
    return banded_adj_ref(y, W, S, Pm, n_groups, scales)


def _in_frame(bucket, ids, f):
    """Frame ``f``'s ``(W, S, Pm, scales, cols)`` and angle ids: its own
    stack where the bucket holds one per frame, else the shared one."""
    W, S, Pm, sc, cols = bucket
    if W.dim() == 4:
        return bucket, ids
    return ((W[f], S[f], Pm[f], None if sc is None else sc[f], cols),
            None if ids is None else ids[f])


def _frames(t, dims):
    """(t as frames, whether it had a frame axis): an unframed tensor of
    ``dims`` dimensions is one frame."""
    return (t, True) if t.dim() == dims + 1 else (t[None], False)


def banded_fwd_buckets_ref(X, XT, buckets, aidx, p, n_groups, rows=None):
    rows = _rows(aidx) if rows is None else rows
    X, framed = _frames(X, 2)
    XT = None if XT is None else _frames(XT, 2)[0]
    y = torch.zeros((X.shape[0], rows, p), dtype=torch.float32,
                    device=X.device)
    for f in range(X.shape[0]):
        for bucket, ids in zip(buckets, aidx):
            (W, S, Pm, sc, cols), ids = _in_frame(bucket, ids, f)
            yg = banded_fwd_ref(XT[f] if cols else X[f], W, S, Pm, n_groups,
                                sc)
            keep = (ids >= 0) & (ids < rows)
            y[f].index_copy_(0, ids[keep].long(), yg[keep, :p])
    return y if framed else y[0]


def banded_adj_buckets_ref(Y, buckets, aidx, n_groups):
    n = buckets[0][0].shape[-2]
    Y, framed = _frames(Y, 2)
    rows, p = Y.shape[1:]
    out = torch.zeros((Y.shape[0], n, n), dtype=torch.float32,
                      device=Y.device)
    for f in range(Y.shape[0]):
        for bucket, ids in zip(buckets, aidx):
            (W, S, Pm, sc, cols), ids = _in_frame(bucket, ids, f)
            keep = (ids >= 0) & (ids < rows)
            Yg = torch.zeros((W.shape[0], W.shape[3]), dtype=torch.float32,
                             device=Y.device)
            Yg[keep, :p] = Y[f].float()[ids[keep].long()]
            c = banded_adj_ref(Yg, W, S, Pm, n_groups, sc)
            out[f] += c.T if cols else c
    return out if framed else out[0]


def banded_ata_buckets_ref(X, XT, buckets, n_groups):
    X, framed = _frames(X, 2)
    XT = None if XT is None else _frames(XT, 2)[0]
    out = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    for f in range(X.shape[0]):
        for bucket in buckets:
            (W, S, Pm, sc, cols), _ = _in_frame(bucket, None, f)
            c = banded_ata_ref(XT[f] if cols else X[f], W, S, Pm, n_groups,
                               sc)
            out[f] += c.T if cols else c
    return out if framed else out[0]


def _rows(aidx):
    """Sinogram rows when the buckets' angle ids of a frame are ``0 ..
    rows - 1``, each once."""
    return sum(a.shape[-1] for a in aidx)


# ---- plans ------------------------------------------------------------------
def tile_plan(kernel, T, n, itemsize, parts=None):
    """How ``kernel`` (``banded_fwd``, ``banded_adj`` or ``banded_ata``)
    cuts one (angle, ``det`` detectors) tile of a bucket with ``T`` taps
    (``PLANS``): ``parts`` blocks (the fewest of the kernel's choices with
    at most ``max_lines`` lines whose slabs fit ``slab_bytes``, unless
    given) split the ``n`` lines, ``lines`` each; a block loads
    ``chunk_lines`` lines of all taps at a time (``taps_per_box`` taps per
    TMA box, the largest divisor of T up to 256), ``smem_bytes`` of shared
    memory; ``chunks`` > 1 means the block loads its slab in turns (and
    K1 reads its weights a second time, from L2, for stage 2)."""
    cfg = PLANS[kernel]
    det, slab = cfg["det"][itemsize], cfg["slab_bytes"][itemsize]
    row = det * itemsize  # one (tap, line) row of a tile
    for c in cfg["parts"] if parts is None else (parts,):
        lines = -(-n // c)
        if lines <= cfg["max_lines"] and T * lines * row <= slab:
            break
    chunks = -(-lines // min(_MAX_BOX, max(1, slab // (T * row))))
    chunk_lines = -(-lines // chunks)  # balanced chunks
    taps_per_box = max(t for t in range(1, min(T, _MAX_BOX) + 1)
                       if T % t == 0)
    smem = T * chunk_lines * row
    if smem > SMEM_BYTES:
        raise ValueError(f"{kernel}: one line of T={T} taps needs {smem} "
                         f"bytes of shared memory, more than {SMEM_BYTES}")
    return {"det": det, "parts": c, "lines": lines,
            "chunk_lines": chunk_lines, "chunks": chunks,
            "taps_per_box": taps_per_box, "smem_bytes": smem}


@functools.lru_cache(maxsize=64)
def launch_plan(kernel, taps, n, itemsize):
    """``kernel``'s plan for one launch over buckets with ``taps`` (a tuple
    of their T), memoized (the operator asks for the same plan every
    apply): the parts and lines are shared (the most any bucket asks for),
    the chunks and boxes are each bucket's, the shared memory the
    largest."""
    parts = max(tile_plan(kernel, T, n, itemsize)["parts"] for T in taps)
    plans = [tile_plan(kernel, T, n, itemsize, parts) for T in taps]
    return {"det": plans[0]["det"], "parts": parts,
            "lines": plans[0]["lines"],
            "smem_bytes": max(p["smem_bytes"] for p in plans),
            "buckets": plans}


# ---- kernel wrappers --------------------------------------------------------
def _check_tensor(t, dev, dtype, shape, name):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, input on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_buckets(inp, buckets, aidx, n_groups):
    """Refuse what the kernels do not take: ``inp`` must lie on a CUDA
    card, the buckets are ``(W, S, Pm, scales, cols)`` of one storage kind,
    one ``n`` and one ``p_pad``, on its device, each with or without a
    leading frame axis (the same frame count for all that have one);
    ``aidx`` (None for K1) their int32 angle ids. -> (n, p_pad, the frames
    the buckets with a frame axis hold, or None)."""
    dev = inp.device
    if dev.type != "cuda":
        raise ValueError(f"banded kernels take CPU or CUDA tensors, got "
                         f"{dev}")
    if not buckets:
        raise ValueError("no buckets")
    if aidx is not None and len(aidx) != len(buckets):
        raise ValueError(f"{len(aidx)} angle id tensors for {len(buckets)} "
                         f"buckets")
    frames = set()
    for k, (W, S, Pm, scales, _) in enumerate(buckets):
        if W.dim() not in (4, 5):
            raise ValueError(f"W must be ([nf,] na, T, n, p_pad), got "
                             f"{tuple(W.shape)}")
        lead = tuple(W.shape[:-4])
        frames.update(lead)
        na, T, n, p_pad = W.shape[-4:]
        if W.dtype not in _KIND:
            raise TypeError(f"W dtype {W.dtype} is not float32/bfloat16/int8")
        if (scales is not None) != (W.dtype == torch.int8):
            raise ValueError("scales are required for int8 weights and only "
                             "for them")
        if n_groups <= 0 or n % n_groups:
            raise ValueError(f"n_groups={n_groups} must divide n={n}")
        if na < 1:
            raise ValueError("a bucket holds no angle")
        # TMA reads W in rows of p_pad: 16-byte strides and base
        if p_pad * W.element_size() % 16 or W.data_ptr() % 16:
            raise ValueError(f"W rows must be 16-byte aligned (p_pad="
                             f"{p_pad})")
        want = [(W, W.dtype, W.shape, "W"),
                (S, torch.int32, lead + (na, n), "S"),
                (Pm, torch.int32, lead + (na, n_groups, p_pad), "Pm")]
        if scales is not None:
            want.append((scales, torch.float32, lead + (na,), "scales"))
        if aidx is not None:
            want.append((aidx[k], torch.int32, lead + (na,), "angle ids"))
        for t, dt, shape, name in want:
            _check_tensor(t, dev, dt, shape, name)
    kinds = {b[0].dtype for b in buckets}
    if len(kinds) != 1:
        raise TypeError(f"one launch takes one storage kind, got {kinds}")
    shapes = {tuple(b[0].shape[-2:]) for b in buckets}
    if len(shapes) != 1:
        raise ValueError(f"buckets of one launch share n and p_pad, got "
                         f"{shapes}")
    if len(frames) > 1:
        raise ValueError(f"buckets with a frame axis must share nf, got "
                         f"{sorted(frames)}")
    return n, p_pad, frames.pop() if frames else None


# launch arguments of buckets already checked, by (kernel, id of the bucket
# and angle id sequences, their cols flags, n_groups, device): weak
# references to their tensors and the arguments; an entry stands only while
# the sequences hold the very tensors it was made for
_PREPARED = {}


def clear_plans():
    """Forget the memoized plans and launch arguments (after ``PLANS``
    changed)."""
    launch_plan.cache_clear()
    _PREPARED.clear()


def prepare(name, inp, buckets, aidx, n_groups):
    """Check the buckets (``_check_buckets``) and make their launch
    arguments for kernel ``name`` (``banded_fwd``, ``banded_adj`` or
    ``banded_ata``; ``aidx`` None for K1) on ``inp``'s device: (n, p_pad,
    the buckets' frame count or None, [(nb, ctypes arrays, plan)]), one
    entry per launch of at most the library's
    ``trips_banded_max_buckets``. The arguments hold the tensors' addresses,
    not the tensors: a caller that keeps them (the wrappers' ``prepared``)
    keeps the tensors alive and unmoved beside them."""
    from .. import _build

    n, p_pad, nf = _check_buckets(inp, buckets, aidx, n_groups)
    most = _build.load().trips_banded_max_buckets()
    launches = []
    for k in range(0, len(buckets), most):
        part = buckets[k:k + most]
        pl = launch_plan(name, tuple(b[0].shape[-3] for b in part), n,
                         part[0][0].element_size())
        cols = list(zip(*(
            (W.data_ptr(), S.data_ptr(), Pm.data_ptr(),
             sc.data_ptr() if sc is not None else None,
             aidx[k + j].data_ptr() if aidx is not None else None,
             W.shape[-4], W.shape[-3], q["chunk_lines"], q["taps_per_box"],
             int(c), W.shape[-4] if W.dim() == 5 else 0)
            for j, ((W, S, Pm, sc, c), q)
            in enumerate(zip(part, pl["buckets"])))))
        arrs = ([(ctypes.c_void_p * len(part))(*v) for v in cols[:5]]
                + [(ctypes.c_int * len(part))(*v) for v in cols[5:]])
        launches.append((len(part), arrs, pl))
    return n, p_pad, nf, launches


def _prepare(name, inp, buckets, aidx, n_groups):
    """``prepare``, kept: the operator hands over the same buckets every
    apply, so their check and arguments are kept, without keeping the
    tensors alive, and reused while the same tensors come again."""
    tensors = [t for b in buckets for t in b[:4] if t is not None]
    tensors += list(aidx) if aidx is not None else []
    key = (name, id(buckets), id(aidx), tuple(bool(b[4]) for b in buckets),
           n_groups, inp.device)
    hit = _PREPARED.get(key)
    if hit is not None and len(hit[0]) == len(tensors) and all(
            r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    out = prepare(name, inp, buckets, aidx, n_groups)
    if len(_PREPARED) >= 64:
        del _PREPARED[next(iter(_PREPARED))]
    _PREPARED[key] = ([weakref.ref(t) for t in tensors], out)
    return out


def _launch(name, inp, inp_t, out, kind, launches, p, rows, n, p_pad,
            n_groups, nf):
    """Launch kernel ``name`` over ``nf`` frames with the arguments from
    ``_prepare``; raises if a launch fails."""
    from .. import _build

    lib = _build.load()
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        for nb, arrs, pl in launches:
            err = lib.trips_banded(
                _OP[name], _KIND[kind], nb,
                *(ctypes.addressof(a) for a in arrs), inp.data_ptr(),
                inp_t.data_ptr(), out.data_ptr(), p, rows, n, p_pad,
                n_groups, pl["det"], pl["parts"], pl["lines"], nf, stream)
            if err:
                _PREPARED.clear()  # nothing kept from a refused launch
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")
            launch_counts[name] += 1
    return out


def _frame_count(t, dims, nf_pack, name):
    """Frames of ``t`` (a frame axis in front of ``dims`` dimensions, or
    none: one frame); they must match the buckets' frame axis."""
    nf = t.shape[0] if t.dim() == dims + 1 else 1
    if t.dim() not in (dims, dims + 1) or (
            nf_pack is not None and (t.dim() == dims or nf != nf_pack)):
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not match "
                         f"the buckets' {nf_pack} frames")
    return nf


def _check_images(X, XT, buckets, n, nf_pack):
    """-> (nf, the transposed images to pass: XT where a bucket drives
    them, else X)."""
    nf = _frame_count(X, 2, nf_pack, "X")
    _check_tensor(X, X.device, torch.float32, X.shape[:-2] + (n, n), "X")
    if not any(b[4] for b in buckets):
        return nf, X
    _check_tensor(XT, X.device, torch.float32, X.shape, "XT")
    return nf, XT


def banded_fwd_buckets(X, XT, buckets, aidx, p, n_groups, rows=None,
                       prepared=None):
    """K2 over the buckets of one pack in one launch: ``buckets`` holds
    ``(W, S, Pm, scales, cols)``, ``aidx`` each bucket's int32 angle ids;
    a bucket with ``cols`` drives ``XT`` (the transposed image,
    contiguous). ``X`` is one image ``(n, n)`` or frames ``(nf, n, n)``
    (see the module's note on frames). -> the ``(rows, p)`` float32
    sinogram, or ``(nf, rows, p)``: row ``aidx[k][a]`` holding detectors
    ``d < p`` of bucket k's angle a. ``rows`` defaults to the angles of a
    frame over all buckets; the ids of a frame must hold ``0 .. rows -
    1``, each once (the operators' packs have them so), or rows are left
    unwritten. ``prepared``: ``prepare("banded_fwd", ...)`` of these
    buckets, made once by a caller that keeps them (else the wrapper's
    kept arguments, ``_prepare``)."""
    if X.device.type == "cpu":
        return banded_fwd_buckets_ref(X, XT, buckets, aidx, p, n_groups,
                                      rows)
    n, p_pad, nf_pack, launches = prepared or _prepare(
        "banded_fwd", X, buckets, aidx, n_groups)
    nf, XT = _check_images(X, XT, buckets, n, nf_pack)
    if not 1 <= p <= p_pad:
        raise ValueError(f"p={p} must lie in [1, p_pad={p_pad}]")
    rows = _rows(aidx) if rows is None else rows
    Y = torch.empty(X.shape[:-2] + (rows, p), dtype=torch.float32,
                    device=X.device)
    return _launch("banded_fwd", X, XT, Y, buckets[0][0].dtype, launches, p,
                   rows, n, p_pad, n_groups, nf)


def banded_adj_buckets(Y, buckets, aidx, n_groups, prepared=None):
    """K3 over the buckets of one pack in one launch: ``Y (rows, p)``
    float32 sinogram, or frames ``(nf, rows, p)``, ``buckets`` and
    ``aidx`` as for ``banded_fwd_buckets``; bucket k's angle a reads row
    ``aidx[k][a]`` (zero beyond ``p``), a bucket with ``cols`` adds its
    image transposed. -> ``(n, n)`` float32 (``(nf, n, n)``), the sum of
    ``banded_adj`` over the buckets. ``prepared`` as for
    ``banded_fwd_buckets``."""
    if Y.device.type == "cpu":
        return banded_adj_buckets_ref(Y, buckets, aidx, n_groups)
    n, p_pad, nf_pack, launches = prepared or _prepare(
        "banded_adj", Y, buckets, aidx, n_groups)
    nf = _frame_count(Y, 2, nf_pack, "Y")
    if not 1 <= Y.shape[-1] <= p_pad:
        raise ValueError(f"Y must be ([nf,] rows, p) with p <= p_pad="
                         f"{p_pad}, got {tuple(Y.shape)}")
    _check_tensor(Y, Y.device, torch.float32, Y.shape, "Y")
    out = torch.zeros(Y.shape[:-2] + (n, n), dtype=torch.float32,
                      device=Y.device)
    return _launch("banded_adj", Y, Y, out, buckets[0][0].dtype, launches,
                   Y.shape[-1], Y.shape[-2], n, p_pad, n_groups, nf)


def banded_ata_buckets(X, XT, buckets, n_groups, prepared=None):
    """K1 over the buckets of one pack in one launch: ``buckets`` holds
    ``(W, S, Pm, scales, cols)``; a bucket with ``cols`` drives ``XT`` (the
    transposed image, contiguous) and its image is transposed before the
    sum. ``X`` is ``(n, n)`` or frames ``(nf, n, n)``. -> float32 of
    ``X``'s shape, the sum of ``banded_ata`` over the buckets.
    ``prepared`` as for ``banded_fwd_buckets``."""
    if X.device.type == "cpu":
        return banded_ata_buckets_ref(X, XT, buckets, n_groups)
    n, p_pad, nf_pack, launches = prepared or _prepare(
        "banded_ata", X, buckets, None, n_groups)
    nf, XT = _check_images(X, XT, buckets, n, nf_pack)
    out = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    return _launch("banded_ata", X, XT, out, buckets[0][0].dtype, launches,
                   0, 0, n, p_pad, n_groups, nf)


def _ids(W, dev):
    return [torch.arange(W.shape[0], dtype=torch.int32, device=dev)]


def banded_fwd(X, W, S, Pm, n_groups, scales=None):
    """K2 on one bucket: image ``X (n, n)`` -> ``(na, p_pad)`` float32."""
    return banded_fwd_buckets(X, None, [(W, S, Pm, scales, False)],
                              _ids(W, X.device), W.shape[3], n_groups)


def banded_adj(Y, W, S, Pm, n_groups, scales=None):
    """K3 on one bucket: ``Y (na, p_pad)`` -> image ``(n, n)`` float32."""
    return banded_adj_buckets(Y, [(W, S, Pm, scales, False)],
                              _ids(W, Y.device), n_groups)


def banded_ata(X, W, S, Pm, n_groups, scales=None):
    """K1 on one bucket: image ``X (n, n)`` -> ``adj(fwd(X))`` ``(n, n)``
    float32."""
    return banded_ata_buckets(X, None, [(W, S, Pm, scales, False)], n_groups)
