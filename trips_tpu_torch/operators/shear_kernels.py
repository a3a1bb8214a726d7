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
"""
from __future__ import annotations

import functools

import torch

launch_counts = {"shear_rotate": 0, "shear_rotate_adjoint": 0,
                 "gcontract_ata": 0}

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BF16_N = 1024  # K6 bf16 keeps U (64 x p_pad) in shared memory


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
    _launch("shear_rotate", "trips_shear_rotate", quarters,
            _KIND[out_dtype], *_ptrs(quarters, kx, fx, ky, fy, kq, out), na,
            C)
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
    out = torch.empty((3, C, C), dtype=torch.float32, device=g.device)
    _launch("shear_rotate_adjoint", "trips_shear_rotate_adj", g,
            _KIND[g.dtype], *_ptrs(g, kx, fx, ky, fy, kq, out), na, C)
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
