"""Angle-sharded banded projectors over K1-K3.

Counterpart of ``trips_tpu/parallel/sharded_banded.py``. The banded pack's
applies are angle-major: every angle is independent in the forward and
adds into the image in the adjoint, so the ranks of one mesh axis split
each bucket's angles. Rank ``i`` of ``S`` holds the bucket's angles ``[i c,
min((i + 1) c, na))``, ``c = ceil(na / S)``: the real angles of device
``i``'s shard of JAX's stack padded to a multiple of the axis. The port
pads with no zero-weight angle: ranks may hold slabs of unequal length, and
a rank whose share of a bucket is empty drops the bucket, as
``BucketedBandedProjector`` drops empty buckets.

Each rank runs K2 (``matvec``), K3 (``rmatvec``) and K1 (``normal_matvec``)
once per apply over all its buckets (``sparse.banded_kernels``), on angle
ids local to the rank, ``0 .. na_local - 1``: K2 writes only the rows its
ids name into an uninitialized output, so its compact ``(na_local, p)``
sinogram goes into the zeroed full ``y`` with ``index_copy_``, and K3 reads
a compact ``Y`` that ``index_select`` gathered from the full one. Then one
all_reduce over the axis (``parallel.sharding``): of ``y`` in the forward
(where JAX's output stays angle-sharded and needs none), of the
``(n_pad, n_pad)`` image in the adjoint and the fused normal apply (JAX's
one ``psum``). A rank that holds no angle still issues it.

The slabs are sliced on the device the unsharded operator lives on and
only the rank's slab is moved to ``device``: an operator built with
``device="cpu"`` costs a rank only its slab of the card's memory.
"""
from __future__ import annotations

import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from ..sparse.banded_buckets import drive_images
from ..sparse.banded_kernels import (banded_adj_buckets, banded_ata_buckets,
                                     banded_fwd_buckets)
from .sharding import all_reduce, share


def _local_ids(lengths, device, lead=()):
    """Each bucket's angle ids local to the rank: consecutive from 0 over
    the buckets, int32, expanded over ``lead`` (frames)."""
    ids, k = [], 0
    for na in lengths:
        a = torch.arange(k, k + na, dtype=torch.int32, device=device)
        ids.append(a.expand(lead + (na,)).contiguous())
        k += na
    return tuple(ids)


class ShardedBandedProjector(LinearOperator):
    """Banded projector with each bucket's angles split over the mesh axis
    ``axis``. ``stacks``: this rank's non-empty slabs, ``(W, S, Pm)`` or
    ``(W, S, Pm, scales)``; ``aidxs``: their global angle ids; ``is_cols``:
    their drive flags. ``shape`` and the vectors are the whole operator's."""

    # an all_reduce per apply (gloo stages it through the host; NCCL is
    # not checked under capture): the loops over it step eagerly
    capturable = False

    def __init__(self, stacks, aidxs, is_cols, shape, nx, p, n_groups, nnz,
                 n_pad, mesh, axis, device=DEFAULT):
        self.device = resolve(device)
        self.stacks = tuple(tuple(t.to(self.device) for t in st)
                            for st in stacks)
        self.aidxs = tuple(tuple(int(a) for a in ai) for ai in aidxs)
        self.is_cols = tuple(bool(c) for c in is_cols)
        self.shape = tuple(shape)
        self.dtype = torch.float32
        self.nx, self.n_pad, self.det_count = nx, n_pad, p
        self.n_groups = n_groups
        self.nnz = nnz
        self.mesh, self.axis = mesh, axis
        self._bks = tuple((st[0], st[1], st[2], st[3] if len(st) > 3 else None,
                           c) for st, c in zip(self.stacks, self.is_cols))
        self._lids = _local_ids([len(a) for a in self.aidxs], self.device)
        self._gids = torch.tensor([a for ai in self.aidxs for a in ai],
                                  dtype=torch.long, device=self.device)

    @staticmethod
    def _shard(op, mesh, axis, device):
        """This rank's slab of each bucket of ``op`` that it shares:
        (stacks, global angle ids, drive flags)."""
        s, i = mesh.shape[axis], mesh.coord(axis)
        stacks, aidxs, flags = [], [], []
        for st, ai, c in zip(op.stacks, op.aidxs, op.is_cols):
            a0, a1 = share(len(ai), s, i)
            if a1 > a0:
                stacks.append([t[a0:a1].to(device).contiguous() for t in st])
                aidxs.append(ai[a0:a1])
                flags.append(c)
        return stacks, aidxs, flags

    @classmethod
    def from_banded(cls, op, mesh, axis: str = "rows", device=DEFAULT):
        """Shard a flat ``sparse.BandedProjector`` (its two drive groups),
        its predictors stored mod ``n_pad`` as JAX's shards hold them."""
        device = resolve(device)
        stacks, aidxs, flags = cls._shard(op, mesh, axis, device)
        for st in stacks:
            st[2] = torch.remainder(st[2], op.n_pad)
        return cls(stacks, aidxs, flags, op.shape, op.nx, op.det_count,
                   op.n_groups, op.nnz, op.n_pad, mesh, axis, device=device)

    @property
    def stored_bytes(self):
        """Bytes of this rank's slabs."""
        return sum(t.numel() * t.element_size() for st in self.stacks
                   for t in st)

    def matvec(self, x):
        """K2 over this rank's buckets, its rows written into a zeroed
        full ``y``, one all_reduce."""
        y = torch.zeros((self.shape[0] // self.det_count, self.det_count),
                        dtype=torch.float32, device=x.device)
        if self._bks:
            X, XT = drive_images(x, self.nx, self.n_pad)
            y.index_copy_(0, self._gids, banded_fwd_buckets(
                X, XT, self._bks, self._lids, self.det_count,
                self.n_groups))
        return all_reduce(y, self.mesh, self.axis).reshape(-1).to(x.dtype)

    def rmatvec(self, yv):
        """K3 over this rank's buckets on its rows of ``y``, one
        all_reduce of the image."""
        img = torch.zeros((self.n_pad, self.n_pad), dtype=torch.float32,
                          device=yv.device)
        if self._bks:
            Y = yv.reshape(-1, self.det_count).to(torch.float32)
            img = banded_adj_buckets(Y.index_select(0, self._gids),
                                     self._bks, self._lids, self.n_groups)
        return self._image(img).to(yv.dtype)

    def normal_matvec(self, x):
        """Fused AᵀA: K1 over this rank's buckets, one all_reduce of the
        image."""
        img = torch.zeros((self.n_pad, self.n_pad), dtype=torch.float32,
                          device=x.device)
        if self._bks:
            X, XT = drive_images(x, self.nx, self.n_pad)
            img = banded_ata_buckets(X, XT, self._bks, self.n_groups)
        return self._image(img).to(x.dtype)

    def _image(self, img):
        n = self.nx
        return all_reduce(img, self.mesh, self.axis)[:n, :n].reshape(-1)


class ShardedBucketedBandedProjector(ShardedBandedProjector):
    """Angle-sharded tap-width-bucketed pack (float32, bfloat16, or int8
    with per-angle scales): every bucket's angles split over the axis, all
    buckets in one launch of each kernel per rank and apply."""

    @classmethod
    def from_bucketed(cls, op, mesh, axis: str = "angles", device=DEFAULT):
        """Shard a ``sparse.BucketedBandedProjector`` (angle pairs, ``ap``
        other than 1, are refused as JAX refuses them)."""
        if getattr(op, "ap", 1) != 1:
            raise ValueError(
                "sharding supports ap=1 bucketed packs; angle-pair "
                "batching is a single-chip experiment knob")
        device = resolve(device)
        stacks, aidxs, flags = cls._shard(op, mesh, axis, device)
        return cls(stacks, aidxs, flags, op.shape, op.nx, op.det_count,
                   op.n_groups, op.nnz, op.n_pad, mesh, axis, device=device)
