"""Frame-varying dynamic CT on the shear-packed banded format.

Counterpart of ``trips_tpu/sparse/dynamic_banded.py``. Every frame has its
own projector (its own angle set, as STEMPO's simulation mode rotates
them); each frame's matrix is packed as the static operators pack it, and
the frames are stacked per drive group at common ``(na, T)``: ``W (nt, na,
T, n_pad, p_pad)``, ``S (nt, na, n_pad)``, ``Pm (nt, na, G, p_pad)`` (mod
``n_pad``) and angle ids ``(nt, na)``, a padded angle all-zero weights and
id ``views``. ``matvec`` (K2), ``rmatvec`` (K3) and ``normal_matvec`` (K1)
each run in one launch over all frames and stacks (``banded_kernels``):
the frame is an index of the launch grid, where the JAX package
``jax.vmap``s one kernel call per stack over the frames. An angle id is a
row of its frame's ``(views, p)`` sinogram, so a padded angle's id lies
outside it and is dropped.

The packs are made on the host (``sparse/pack.py``, the weights filled by
the C++ ``scatter_fill`` unless ``TRIPS_TPU_NO_NATIVE=1``) and hold the JAX
package's bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from ..native import scatter_fill
from .banded_buckets import _storage, _to_torch, drive_images
from .banded_kernels import (banded_adj_buckets, banded_ata_buckets,
                             banded_fwd_buckets)
from .pack import _pack_groups


def _pack_frames(AA, nx, angles_list, n_groups, lane_pad):
    """Pack every frame's matrix (``trips_tpu``'s frame checks and errors).
    -> ([(packs, idx)] per frame, views, p, p_pad, n_pad)."""
    nt = len(AA)
    if len(angles_list) != nt:
        raise ValueError(f"{len(angles_list)} angle sets for {nt} frames")
    views = len(angles_list[0])
    for t, a in enumerate(angles_list):
        if len(a) != views:
            raise ValueError(
                f"frame {t} has {len(a)} angles, expected {views}: the "
                "stacked sinogram layout (nt, views, p) requires a uniform "
                "angle count per frame")
    packed, p = [], None
    for t in range(nt):
        packs, idx, _, p_t, n_pad = _pack_groups(
            AA[t], nx, None, np.asarray(angles_list[t]), n_groups)
        if p is None:
            p = p_t
        elif p_t != p:
            raise ValueError(f"frame {t} has {p_t} detectors, expected {p}")
        packed.append((packs, idx))
    return packed, views, p, -(-p // lane_pad) * lane_pad, n_pad


def _fill(W, S, P, t, j, entry, p):
    """Frame t, stack slot j <- one angle's pack result."""
    (tt, ii, dd, vv), _, shift, Pk = entry
    if not scatter_fill(tt, ii, dd, vv, W[t, j]):
        W[t, j][tt, ii, dd] = vv
    S[t, j] = shift
    P[t, j, :, :p] = Pk
    P[t, j, :, p:] = Pk[:, -1:]  # edge pad, as the flat stack pads


def _weights(W, kind):
    """A float32 NumPy stack in its storage class: (W, scales or None),
    int8 with per-(frame, angle) absmax/127 scales."""
    if kind == "int8":
        sc = np.maximum(np.abs(W).max(axis=(2, 3, 4)), 1e-30) / 127.0
        Wq = np.rint(W / sc[:, :, None, None, None]).astype(np.int8)
        return torch.from_numpy(Wq), torch.from_numpy(sc.astype(np.float32))
    W = torch.from_numpy(W)
    return (W.to(torch.bfloat16) if kind == "bfloat16" else W), None


class DynamicBandedOperator(LinearOperator):
    """Block diagonal over time of per-frame banded projectors with
    frame-varying geometry: one stack per drive group, each applied to
    every frame in one launch with the other. Storage float32 or bfloat16.
    ``device``: the CUDA card unless "cpu" is asked for."""

    _fwd = staticmethod(banded_fwd_buckets)
    _adj = staticmethod(banded_adj_buckets)
    _ata = staticmethod(banded_ata_buckets)

    def __init__(self, groups, shape, nx, p, views, n_groups, nnz, nt,
                 n_pad=None, device=DEFAULT):
        # groups: (W, S, Pm, aidx) of the row- and the column-driven angles
        self.device = resolve(device)
        (self.W_rows, self.shift_rows, self.P_rows, self.aidx_rows), \
            (self.W_cols, self.shift_cols, self.P_cols, self.aidx_cols) = (
                tuple(torch.as_tensor(t).to(self.device) for t in g)
                for g in groups)
        if self.W_rows.dtype == torch.int8:
            raise ValueError("DynamicBandedOperator stores float32 or "
                             "bfloat16; int8 is BucketedDynamicBanded"
                             "Operator's")
        self._init(shape, nx, p, views, n_groups, nnz, nt, n_pad)

    def _init(self, shape, nx, p, views, n_groups, nnz, nt, n_pad):
        self.shape = tuple(shape)
        self.dtype = torch.float32
        self.nx = nx
        self.n_pad = nx if n_pad is None else n_pad
        self.det_count = p
        self.views = views
        self.n_groups = n_groups
        self.nnz = nnz
        self.nt = nt
        held = [g for g in self._groups() if g[0].shape[1]]
        self._bks = tuple((W, S, Pm, sc, isc)
                          for W, S, Pm, _, isc, sc in held)
        self._aidx = tuple(g[3] for g in held)
        # K2 writes each frame's sinogram into torch.empty: every frame's
        # ids must hold each row once
        ids = np.concatenate([a.cpu().numpy() for a in self._aidx], axis=1)
        for t in range(nt):
            real = np.sort(ids[t][(ids[t] >= 0) & (ids[t] < views)])
            if not np.array_equal(real, np.arange(views)):
                raise ValueError(f"frame {t}'s angle ids do not hold each "
                                 f"of [0, {views}) once")

    @classmethod
    def from_frames(cls, AA, nx, angles_list, n_groups=32, dtype=None,
                    lane_pad=128, device=DEFAULT):
        """Pack per-frame matrices ``AA[t]`` (scipy, angle-major rows)
        built at ``angles_list[t]`` into one stacked operator. ``dtype``:
        None/float32 (exact) or bfloat16."""
        device = resolve(device)  # before the host work of packing
        kind = _storage(dtype)
        if kind == "int8":
            raise ValueError("DynamicBandedOperator stores float32 or "
                             "bfloat16; use BucketedDynamicBandedOperator "
                             "for int8")
        packed, views, p, p_pad, n_pad = _pack_frames(AA, nx, angles_list,
                                                      n_groups, lane_pad)
        nt = len(AA)

        def stack_group(dr):
            na = max(len(idx[dr]) for _, idx in packed)
            T = max((T_a for packs, _ in packed
                     for _, T_a, _, _ in packs[dr]), default=1)
            W = np.zeros((nt, na, T if na else 1, n_pad, p_pad), np.float32)
            S = np.zeros((nt, na, n_pad), np.int32)
            P = np.zeros((nt, na, n_groups, p_pad), np.int32)
            Ai = np.full((nt, na), views, np.int32)
            for t, (packs, idx) in enumerate(packed):
                for k, entry in enumerate(packs[dr]):
                    _fill(W, S, P, t, k, entry, p)
                    Ai[t, k] = idx[dr][k]
            np.mod(P, n_pad, out=P)
            return (_weights(W, kind)[0], torch.from_numpy(S),
                    torch.from_numpy(P), torch.from_numpy(Ai))

        groups = (stack_group(True), stack_group(False))
        m = sum(At.shape[0] for At in AA)
        nnz = sum(At.nnz for At in AA)
        return cls(groups, (m, nt * nx * nx), nx, p, views, n_groups, nnz,
                   nt, n_pad=n_pad, device=device)

    @classmethod
    def from_numpy_stacks(cls, groups, shape, nx, p, views, n_groups, nnz,
                          nt, n_pad=None, device=DEFAULT):
        """Build from NumPy copies of another pack's ``(W, S, Pm, aidx)``
        groups (for instance ``trips_tpu``'s): the same bytes."""
        device = resolve(device)
        return cls([[_to_torch(a, device) for a in g] for g in groups],
                   shape, nx, p, views, n_groups, nnz, nt, n_pad=n_pad,
                   device=device)

    @property
    def stored_bytes(self):
        return sum(t.numel() * t.element_size()
                   for g in self._groups() for t in g[:4]
                   + ((g[5],) if g[5] is not None else ()))

    def _groups(self):
        """(W, S, Pm, aidx, is_cols, scales or None) per stack."""
        return ((self.W_rows, self.shift_rows, self.P_rows, self.aidx_rows,
                 False, None),
                (self.W_cols, self.shift_cols, self.P_cols, self.aidx_cols,
                 True, None))

    def _drive_images(self, x):
        """(nt*nx*nx,) -> the (nt, n_pad, n_pad) float32 frames and their
        contiguous transposes."""
        return drive_images(x.reshape(self.nt, -1), self.nx, self.n_pad)

    def matvec(self, x):
        """One K2 launch over all frames and stacks."""
        X, XT = self._drive_images(x)
        y = self._fwd(X, XT, self._bks, self._aidx, self.det_count,
                      self.n_groups, self.views)
        return y.reshape(-1).to(x.dtype)

    def rmatvec(self, yv):
        """One K3 launch over all frames and stacks."""
        n = self.nx
        Y = yv.reshape(self.nt, self.views, self.det_count).to(torch.float32)
        img = self._adj(Y.contiguous(), self._bks, self._aidx, self.n_groups)
        return img[:, :n, :n].reshape(-1).to(yv.dtype)

    def normal_matvec(self, x):
        """Per-frame fused A^T A: one K1 launch over all frames and
        stacks."""
        n = self.nx
        X, XT = self._drive_images(x)
        img = self._ata(X, XT, self._bks, self.n_groups)
        return img[:, :n, :n].reshape(-1).to(x.dtype)


class BucketedDynamicBandedOperator(DynamicBandedOperator):
    """Tap-width-bucketed dynamic banded operator: within each drive group
    every frame's angles are sorted by tap width (padded angles first) and
    split into ``n_buckets`` equal-count buckets, each stacked at its own
    T. ``stacks``: ``(W, S, Pm, aidx[, scales])`` per bucket, scales
    ``(nt, na)`` for int8. Storage float32, bfloat16 or int8 with
    per-(frame, angle) absmax/127 scales."""

    def __init__(self, stacks, is_cols, shape, nx, p, views, n_groups, nnz,
                 nt, n_pad, device=DEFAULT):
        self.device = resolve(device)
        self.stacks = tuple(tuple(torch.as_tensor(t).to(self.device)
                                  for t in st) for st in stacks)
        self.is_cols = tuple(bool(f) for f in is_cols)
        self._init(shape, nx, p, views, n_groups, nnz, nt, n_pad)

    def _groups(self):
        return tuple((st[0], st[1], st[2], st[3], isc,
                      st[4] if len(st) > 4 else None)
                     for st, isc in zip(self.stacks, self.is_cols))

    @classmethod
    def from_frames(cls, AA, nx, angles_list, n_groups=32, dtype=None,
                    lane_pad=128, n_buckets=3, device=DEFAULT):
        """Pack per-frame matrices into ``n_buckets`` buckets per drive
        group. ``dtype``: None/float32 (exact), bfloat16 or "int8"."""
        device = resolve(device)
        kind = _storage(dtype)
        packed, views, p, p_pad, n_pad = _pack_frames(AA, nx, angles_list,
                                                      n_groups, lane_pad)
        nt = len(AA)
        stacks, flags = [], []
        for dr in (True, False):
            na_max = max(len(idx[dr]) for _, idx in packed)
            if na_max == 0:
                continue
            # per frame: entries ordered by tap width (pads = width 0
            # first), so bucket b holds every frame's b-th width quantile
            per_frame = []
            for packs, idx in packed:
                ent = [(e[1], e, idx[dr][k]) for k, e in enumerate(packs[dr])]
                ent += [(0, None, views)] * (na_max - len(ent))
                ent.sort(key=lambda e: e[0])
                per_frame.append(ent)
            for part in np.array_split(np.arange(na_max),
                                       min(n_buckets, na_max)):
                if not len(part):
                    continue
                T = max(1, max(per_frame[t][k][0] for k in part
                               for t in range(nt)))
                W = np.zeros((nt, len(part), T, n_pad, p_pad), np.float32)
                S = np.zeros((nt, len(part), n_pad), np.int32)
                P = np.zeros((nt, len(part), n_groups, p_pad), np.int32)
                Ai = np.full((nt, len(part)), views, np.int32)
                for t in range(nt):
                    for j, k in enumerate(part):
                        _, entry, aid = per_frame[t][k]
                        if entry is not None:
                            _fill(W, S, P, t, j, entry, p)
                            Ai[t, j] = aid
                np.mod(P, n_pad, out=P)
                Wk, sc = _weights(W, kind)
                st = [Wk, torch.from_numpy(S), torch.from_numpy(P),
                      torch.from_numpy(Ai)]
                stacks.append(st + ([sc] if sc is not None else []))
                flags.append(not dr)
        m = sum(At.shape[0] for At in AA)
        nnz = sum(At.nnz for At in AA)
        return cls(stacks, flags, (m, nt * nx * nx), nx, p, views, n_groups,
                   nnz, nt, n_pad, device=device)

    @classmethod
    def from_numpy_stacks(cls, stacks, is_cols, shape, nx, p, views,
                          n_groups, nnz, nt, n_pad, device=DEFAULT):
        """Build from NumPy copies of another pack's stacks (for instance
        ``trips_tpu``'s, bfloat16 as ml_dtypes arrays): the same bytes."""
        device = resolve(device)
        return cls([[_to_torch(a, device) for a in st] for st in stacks],
                   is_cols, shape, nx, p, views, n_groups, nnz, nt, n_pad,
                   device=device)
