"""(time x angles)-sharded dynamic banded operators over K1-K3.

Counterpart of ``trips_tpu/parallel/sharded_dynamic_banded.py``. The
dynamic pack stacks per-frame banded packs as ``(nt, na, T, n_pad, p_pad)``
arrays with two independent axes: frames (nothing couples them in A) and,
within a frame, angles. On a ('time', 'angles') mesh a rank holds frames
``[t0, t1)`` of its time slice and, of every stack, its share of the
angles by the map of ``parallel/sharded_banded.py`` (no padded angle is
added; a rank whose share of a stack is empty drops it). The
``[t0:t1, a0:a1]`` slab is copied once at construction (the kernels take
contiguous stacks).

Each rank launches K2, K3 or K1 once per apply over its frames and stacks,
on angle ids local to the rank (consecutive over its stacks, the same in
every frame), so K2 writes a compact ``(frames, na_local, p)`` sinogram.
Its rows that hold a real angle (a padded angle of the pack, id ``views``,
writes nothing) go into a zeroed ``(nt, views, p)`` buffer, or, for K3,
come from it; the frame images of K3 and K1 go into a zeroed ``(nt, n_pad,
n_pad)`` buffer. One all_reduce over the whole mesh per apply sums the
buffer: the time ranks' parts are disjoint, the angle ranks' parts add.
"""
from __future__ import annotations

import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from ..sparse.banded_buckets import drive_images
from ..sparse.banded_kernels import (banded_adj_buckets, banded_ata_buckets,
                                     banded_fwd_buckets)
from .sharded_banded import _local_ids
from .sharding import all_reduce, share


class ShardedDynamicBandedOperator(LinearOperator):
    """``DynamicBandedOperator`` with frames split over ``t_axis`` and each
    frame's angles over ``a_axis``. ``stacks``: this rank's non-empty
    slabs ``(W, S, Pm, aidx[, scales])``, each ``(frames, na_local,
    ...)``, ``frames`` its ``(t0, t1)``; ``is_cols``: their drive flags."""

    def __init__(self, stacks, is_cols, frames, shape, nx, p, views, n_groups,
                 nnz, nt, n_pad, mesh, t_axis="time", a_axis="angles",
                 device=DEFAULT):
        self.device = resolve(device)
        self.stacks = tuple(tuple(t.to(self.device) for t in st)
                            for st in stacks)
        self.is_cols = tuple(bool(c) for c in is_cols)
        self.frames = tuple(frames)
        self.shape = tuple(shape)
        self.dtype = torch.float32
        self.nx, self.n_pad, self.det_count = nx, n_pad, p
        self.views, self.n_groups = views, n_groups
        self.nnz, self.nt = nnz, nt
        self.mesh, self.t_axis, self.a_axis = mesh, t_axis, a_axis
        self._bks = tuple((st[0], st[1], st[2], st[4] if len(st) > 4 else None,
                           c) for st, c in zip(self.stacks, self.is_cols))
        nf = self.frames[1] - self.frames[0]
        lengths = [st[0].shape[1] for st in self.stacks]
        self._na_local = sum(lengths)
        self._lids = _local_ids(lengths, self.device, (nf,))
        # the rows of the compact local sinograms (frame-major) that hold a
        # real angle, and their rows in the (nt * views, p) sinogram
        if self.stacks:
            ids = torch.cat([st[3] for st in self.stacks], dim=1).long()
            f, j = torch.nonzero((ids >= 0) & (ids < views), as_tuple=True)
            self._src = f * self._na_local + j
            self._dst = (self.frames[0] + f) * views + ids[f, j]

    @staticmethod
    def _shard(stacks, op, mesh, t_axis, a_axis, device):
        """This rank's frames and its ``[t0:t1, a0:a1]`` slab of each stack
        that it shares: (slabs, drive flags, (t0, t1))."""
        T, A = mesh.shape[t_axis], mesh.shape[a_axis]
        if op.nt % T:
            raise ValueError(
                f"nt={op.nt} must be a multiple of the '{t_axis}' mesh "
                f"axis ({T}); pad the frame list.")
        if mesh.size != T * A:
            raise ValueError(f"the mesh must be ({t_axis}, {a_axis}), got "
                             f"{mesh.shape}")
        t0, t1 = share(op.nt, T, mesh.coord(t_axis))
        out, flags = [], []
        for st, c in stacks:
            a0, a1 = share(st[0].shape[1], A, mesh.coord(a_axis))
            if a1 > a0:
                out.append([t[t0:t1, a0:a1].to(device).contiguous()
                            for t in st])
                flags.append(c)
        return out, flags, (t0, t1)

    @classmethod
    def from_dynamic(cls, op, mesh, t_axis: str = "time",
                     a_axis: str = "angles", device=DEFAULT):
        """Shard a ``sparse.DynamicBandedOperator`` (its two drive
        groups)."""
        device = resolve(device)
        stacks = [(g[:4], g[4]) for g in op._groups()]
        return cls._from(op, stacks, mesh, t_axis, a_axis, device)

    @classmethod
    def _from(cls, op, stacks, mesh, t_axis, a_axis, device):
        slabs, flags, frames = cls._shard(stacks, op, mesh, t_axis, a_axis,
                                          device)
        return cls(slabs, flags, frames, op.shape, op.nx, op.det_count,
                   op.views, op.n_groups, op.nnz, op.nt, op.n_pad, mesh,
                   t_axis, a_axis, device=device)

    @property
    def stored_bytes(self):
        """Bytes of this rank's slabs."""
        return sum(t.numel() * t.element_size() for st in self.stacks
                   for t in st)

    def _images(self, x):
        """This rank's frames of ``x`` as drive images (and transposes)."""
        t0, t1 = self.frames
        return drive_images(x.reshape(self.nt, -1)[t0:t1], self.nx,
                            self.n_pad)

    def matvec(self, x):
        """K2 over this rank's frames and stacks, the rows of its real
        angles written into a zeroed full sinogram, one all_reduce."""
        p = self.det_count
        y = torch.zeros((self.nt * self.views, p), dtype=torch.float32,
                        device=x.device)
        if self._bks:
            X, XT = self._images(x)
            yl = banded_fwd_buckets(X, XT, self._bks, self._lids, p,
                                    self.n_groups)
            y.index_copy_(0, self._dst,
                          yl.reshape(-1, p).index_select(0, self._src))
        return all_reduce(y, self.mesh).reshape(-1).to(x.dtype)

    def rmatvec(self, yv):
        """K3 over this rank's frames and stacks on the rows of its
        angles, one all_reduce of the frame images."""
        p = self.det_count
        img = self._zero_images(yv.device)
        if self._bks:
            t0, t1 = self.frames
            Y = yv.reshape(-1, p).to(torch.float32)
            Yl = torch.zeros(((t1 - t0) * self._na_local, p),
                             dtype=torch.float32, device=yv.device)
            Yl.index_copy_(0, self._src, Y.index_select(0, self._dst))
            img[t0:t1] = banded_adj_buckets(Yl.view(t1 - t0, -1, p),
                                            self._bks, self._lids,
                                            self.n_groups)
        return self._reduced(img).to(yv.dtype)

    def normal_matvec(self, x):
        """Fused AᵀA: K1 over this rank's frames and stacks, one
        all_reduce of the frame images."""
        img = self._zero_images(x.device)
        if self._bks:
            X, XT = self._images(x)
            img[self.frames[0]:self.frames[1]] = banded_ata_buckets(
                X, XT, self._bks, self.n_groups)
        return self._reduced(img).to(x.dtype)

    def _zero_images(self, device):
        return torch.zeros((self.nt, self.n_pad, self.n_pad),
                           dtype=torch.float32, device=device)

    def _reduced(self, img):
        n = self.nx
        return all_reduce(img, self.mesh)[:, :n, :n].reshape(-1)


class ShardedBucketedDynamicBandedOperator(ShardedDynamicBandedOperator):
    """(time x angles)-sharded tap-width-bucketed dynamic pack (float32,
    bfloat16, or int8 with per-(frame, angle) scales): every bucket's
    angles split over the angle axis, all buckets in one launch of each
    kernel per rank and apply."""

    @classmethod
    def from_dynamic(cls, op, mesh, t_axis: str = "time",
                     a_axis: str = "angles", device=DEFAULT):
        """Shard a ``sparse.BucketedDynamicBandedOperator``."""
        device = resolve(device)
        return cls._from(op, list(zip(op.stacks, op.is_cols)), mesh, t_axis,
                         a_axis, device)
