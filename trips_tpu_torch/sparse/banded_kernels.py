"""Banded-projector kernels K1-K3: wrappers, plain versions, launch counts.

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
  sinogram row stays on chip. ``banded_ata_buckets`` runs it over all
  buckets of a pack in one launch (the operator's path).

They replace ``_fwd_call``, ``_adj_call`` and ``_ata_call`` of
``trips_tpu/sparse/pallas_banded_kernel.py``. Each wrapper sends a CPU
tensor to its plain PyTorch version (``*_ref``, the twin of the JAX oracle
``apply_group_xla(..., wrap=True)``), launches the CUDA kernel
(``csrc/banded.cu``) for a CUDA tensor, and raises for anything else.
``launch_counts`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .banded import dequant_slab

launch_counts = {"banded_fwd": 0, "banded_adj": 0, "banded_ata": 0}

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_LANES = 32  # detectors per forward block (csrc/banded.cu kLanes)
_MAX_ADJ_N = 48 * 1024 // 4  # K3 keeps one image row in shared memory
# K1's weight slab per block: at most this many bytes, so that about six
# blocks share an SM (some load while the others compute)
ATA_SLAB_BYTES = 36 * 1024
# ... and at most this many lines per block, so that every block has work
# for its line slices but not a long serial chain (nor too few blocks)
ATA_MAX_LINES = 64
SMEM_BYTES = 227 * 1024  # the most dynamic shared memory a block can have
_MAX_BOX = 256           # a TMA box spans at most 256 per dimension
_CLUSTERS = (1, 2, 4, 8, 16)  # K1's cluster sizes (16: non-portable)
# K1: detectors per tile by weight size: 256-byte slab rows for float32
# (measured faster on an H100), 32 detectors for the narrower types. The
# kernel takes the plan as given and sizes its shared memory and TMA loads
# from it.
_ATA_DET = {4: 64, 2: 32, 1: 32}


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


# ---- K1 plan ---------------------------------------------------------------
def ata_plan(T, n, itemsize, cluster=None):
    """How K1 (``csrc/banded.cu`` ``ata_kernel``) cuts one (angle, ``det``
    detectors: 64 for float32 weights, 32 for the others) tile of a bucket
    with ``T`` taps: ``cluster`` blocks (1, 2, 4, 8 or 16: the fewest with at
    most ``ATA_MAX_LINES`` lines whose slabs fit ``ATA_SLAB_BYTES``, unless
    given) split the ``n`` lines, ``lines`` each; a block loads
    ``chunk_lines`` lines of all taps at a time
    (``taps_per_box`` taps per TMA box, the largest divisor of T up to
    256), ``smem_bytes`` of shared memory; ``chunks`` > 1 means the block
    reads its weights a second time (from L2) for stage 2."""
    det = _ATA_DET[itemsize]
    row = det * itemsize  # one (tap, line) row of a tile
    for c in _CLUSTERS if cluster is None else (cluster,):
        lines = -(-n // c)
        if lines <= ATA_MAX_LINES and T * lines * row <= ATA_SLAB_BYTES:
            break
    chunks = -(-lines // min(_MAX_BOX, max(1, ATA_SLAB_BYTES // (T * row))))
    chunk_lines = -(-lines // chunks)  # balanced chunks
    taps_per_box = max(t for t in range(1, min(T, _MAX_BOX) + 1)
                       if T % t == 0)
    smem = T * chunk_lines * row
    if smem > SMEM_BYTES:
        raise ValueError(f"K1: one line of T={T} taps needs {smem} bytes "
                         f"of shared memory, more than {SMEM_BYTES}")
    return {"det": det, "cluster": c, "lines": lines,
            "chunk_lines": chunk_lines, "chunks": chunks,
            "taps_per_box": taps_per_box, "smem_bytes": smem}


@functools.lru_cache(maxsize=64)
def ata_launch_plan(taps, n, itemsize):
    """K1's plan for one launch over buckets with ``taps`` (a tuple of their
    T), memoized (the operator asks for the same plan every apply): the
    cluster and lines are shared (the largest any bucket asks for), the
    chunks and boxes are each bucket's, the shared memory the largest."""
    cluster = max(ata_plan(T, n, itemsize)["cluster"] for T in taps)
    plans = [ata_plan(T, n, itemsize, cluster) for T in taps]
    return {"det": plans[0]["det"], "cluster": cluster,
            "lines": plans[0]["lines"],
            "smem_bytes": max(p["smem_bytes"] for p in plans),
            "buckets": plans}


# ---- kernel wrappers --------------------------------------------------------
def _check(inp, adjoint, W, S, Pm, n_groups, scales):
    """Refuse what the kernels do not take; ``inp`` is X (n, n), or Y
    (na, p_pad) for the adjoint."""
    if inp.device.type != "cuda":
        raise ValueError(f"banded kernels take CPU or CUDA tensors, got "
                         f"{inp.device}")
    if W.dim() != 4:
        raise ValueError(f"W must be (na, T, n, p_pad), got {tuple(W.shape)}")
    na, T, n, p_pad = W.shape
    if W.dtype not in _KIND:
        raise TypeError(f"W dtype {W.dtype} is not float32/bfloat16/int8")
    if (scales is not None) != (W.dtype == torch.int8):
        raise ValueError("scales are required for int8 weights and only "
                         "for them")
    if n_groups <= 0 or n % n_groups:
        raise ValueError(f"n_groups={n_groups} must divide n={n}")
    if p_pad % _LANES:
        raise ValueError(f"p_pad={p_pad} must be a multiple of {_LANES}")
    if n > _MAX_ADJ_N:
        raise ValueError(f"n={n} exceeds the kernels' {_MAX_ADJ_N}")
    want = [(inp, torch.float32, (na, p_pad) if adjoint else (n, n), "input"),
            (S, torch.int32, (na, n), "S"),
            (Pm, torch.int32, (na, n_groups, p_pad), "Pm")]
    if scales is not None:
        want.append((scales, torch.float32, (na,), "scales"))
    for t, dt, shape, name in want + [(W, W.dtype, tuple(W.shape), "W")]:
        if t.device != inp.device:
            raise ValueError(f"{name} is on {t.device}, input on "
                             f"{inp.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return na, T, n, p_pad


def _launch(name, inp, out, W, S, Pm, n_groups, scales):
    from .. import _build

    na, T, n, p_pad = W.shape
    fn = getattr(_build.load(), "trips_" + name)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = fn(_KIND[W.dtype], inp.data_ptr(), W.data_ptr(), S.data_ptr(),
                 Pm.data_ptr(),
                 scales.data_ptr() if scales is not None else None,
                 out.data_ptr(), na, T, n, p_pad, n_groups, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out


def banded_fwd(X, W, S, Pm, n_groups, scales=None):
    """K2: image ``X (n, n)`` -> ``(na, p_pad)`` float32."""
    if X.device.type == "cpu":
        return banded_fwd_ref(X, W, S, Pm, n_groups, scales)
    na, _, _, p_pad = _check(X, False, W, S, Pm, n_groups, scales)
    Y = torch.empty((na, p_pad), dtype=torch.float32, device=X.device)
    return _launch("banded_fwd", X, Y, W, S, Pm, n_groups, scales)


def banded_adj(Y, W, S, Pm, n_groups, scales=None):
    """K3: ``Y (na, p_pad)`` -> image ``(n, n)`` float32."""
    if Y.device.type == "cpu":
        return banded_adj_ref(Y, W, S, Pm, n_groups, scales)
    _, _, n, _ = _check(Y, True, W, S, Pm, n_groups, scales)
    out = torch.empty((n, n), dtype=torch.float32, device=Y.device)
    return _launch("banded_adj", Y, out, W, S, Pm, n_groups, scales)


def banded_ata(X, W, S, Pm, n_groups, scales=None):
    """K1: image ``X (n, n)`` -> ``adj(fwd(X))`` ``(n, n)`` float32."""
    return banded_ata_buckets(X, None, [(W, S, Pm, scales, False)], n_groups)


def banded_ata_buckets_ref(X, XT, buckets, n_groups):
    out = torch.zeros_like(X, dtype=torch.float32)
    for W, S, Pm, scales, cols in buckets:
        c = banded_ata_ref(XT if cols else X, W, S, Pm, n_groups, scales)
        out += c.T if cols else c
    return out


def banded_ata_buckets(X, XT, buckets, n_groups):
    """K1 over the buckets of one pack: ``buckets`` holds ``(W, S, Pm,
    scales, cols)``; a bucket with ``cols`` drives ``XT`` (the transposed
    image, contiguous) and its image is transposed before the sum. ->
    ``(n, n)`` float32, the sum of ``banded_ata`` over the buckets, in one
    launch per 16 buckets (the kernel's ``trips_banded_ata_max_buckets``)."""
    if X.device.type == "cpu":
        return banded_ata_buckets_ref(X, XT, buckets, n_groups)
    from .. import _build

    kinds = {W.dtype for W, *_ in buckets}
    if len(kinds) != 1:
        raise TypeError(f"one launch takes one storage kind, got {kinds}")
    shapes = {_check(XT if cols else X, False, W, S, Pm, n_groups,
                     scales)[2:] for W, S, Pm, scales, cols in buckets}
    if len(shapes) != 1:
        raise ValueError(f"buckets of one launch share n and p_pad, got "
                         f"{shapes}")
    (n, p_pad), = shapes
    W0 = buckets[0][0]
    out = torch.zeros((n, n), dtype=torch.float32, device=X.device)
    any_cols = any(b[4] for b in buckets)
    lib = _build.load()
    fn, most = lib.trips_banded_ata, lib.trips_banded_ata_max_buckets()
    for k in range(0, len(buckets), most):
        part = buckets[k:k + most]
        pl = ata_launch_plan(tuple(b[0].shape[1] for b in part), n,
                             W0.element_size())

        def arr(ct, vals):
            return (ct * len(part))(*vals)

        ptr = ctypes.c_void_p
        args = [arr(ptr, [t.data_ptr() for t, *_ in part]),
                arr(ptr, [b[1].data_ptr() for b in part]),
                arr(ptr, [b[2].data_ptr() for b in part]),
                arr(ptr, [b[3].data_ptr() if b[3] is not None else None
                          for b in part]),
                arr(ctypes.c_int, [b[0].shape[0] for b in part]),
                arr(ctypes.c_int, [b[0].shape[1] for b in part]),
                arr(ctypes.c_int, [q["chunk_lines"] for q in pl["buckets"]]),
                arr(ctypes.c_int, [q["taps_per_box"] for q in pl["buckets"]]),
                arr(ctypes.c_int, [int(b[4]) for b in part])]
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            err = fn(_KIND[W0.dtype], len(part),
                     *(ctypes.addressof(a) for a in args),
                     X.data_ptr(), (XT if any_cols else X).data_ptr(),
                     out.data_ptr(), n, p_pad, n_groups, pl["det"],
                     pl["cluster"], pl["lines"], stream)
        if err:
            raise RuntimeError(f"banded_ata launch failed: CUDA error {err}")
        launch_counts["banded_ata"] += 1
    return out
