"""Meshes of ranks, the counted collective, and the row-sharded ELL operators.

Counterpart of ``trips_tpu/parallel/sharding.py`` on ``torch.distributed``.
JAX's sharded operators take and return global arrays, logically whole,
so the solvers run unchanged on top. The port gets the same property with
whole vectors on every rank:

- every rank holds ``x`` and ``y`` whole and only its slab of the
  operator;
- every apply ends in exactly one collective, a ``dist.all_reduce(SUM)``
  over the mesh (or the sharded axis): ``matvec`` writes the rank's rows
  into a zeroed full ``y`` and ``rmatvec`` its columns into a zeroed full
  ``x``, and the sum assembles them.

So every solver (``krylov.cgls``, ``cgls_normal``, GKS, the fused solvers)
runs identically on every rank, and the replicas stay bitwise equal: every
element of an all_reduce's result is reduced once and then copied. Where
JAX keeps an output sharded (the forward of the ELL, BSR and banded
operators), the port pays one all_reduce of that output: its forward costs
one collective of the sinogram where JAX's costs none.

``all_reduce`` is the one collective, the one that both NCCL and gloo take
on CUDA tensors (gloo carries two ranks on one card, which NCCL refuses),
and it counts its calls in ``collective_counts``.

``Mesh`` is the port's ``jax.sharding.Mesh``: an array of global ranks with
named axes, the process group of the whole mesh and one per slice of each
axis (built here rather than on ``torch.distributed.device_mesh``, which
picks a backend from the device type). A mesh of one rank made while no
process group is initialized has no group, and its all_reduce is the
identity: every class then runs in one process. Once a group is
initialized a mesh of one rank uses it and issues the all_reduce.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import round_up
from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from ..sparse.ell import _csr_to_ell, _ell_matvec

collective_counts = {"all_reduce": 0}


def reset_collective_counts():
    for k in collective_counts:
        collective_counts[k] = 0


def _live():
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """Global ranks laid out on named axes.

    ``ranks``: an integer array, one dimension per name of ``axis_names``.
    Every rank of the process group builds the mesh, in the same order as
    the others: each process group is made by all of them, also by ranks
    outside it. ``shape``: axis name -> size, as JAX's ``mesh.shape``.
    ``rank``: build the mesh as that rank sees it, with no process group
    (to inspect a rank's partition in one process; an apply on such a mesh
    of more than one rank raises); None: this process's rank.
    """

    def __init__(self, ranks, axis_names, rank=None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-D ranks for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        if len(set(self.ranks.ravel().tolist())) != self.size:
            raise ValueError(f"a rank appears twice in {self.ranks.tolist()}")
        self.live = rank is None and _live()
        self.rank = (rank if rank is not None
                     else dist.get_rank() if self.live else 0)
        self.group = None
        self._axis_groups = dict.fromkeys(self.axis_names)
        if self.live:
            self._make_groups()
        elif rank is None and self.ranks.ravel().tolist() != [0]:
            raise ValueError(f"a mesh of {self.size} ranks needs an "
                             f"initialized process group")
        where = np.argwhere(self.ranks == self.rank)
        self._coords = (dict(zip(self.axis_names, map(int, where[0])))
                        if len(where) else None)

    def _make_groups(self):
        world = dist.get_world_size()
        if self.ranks.max(initial=0) >= world or self.ranks.min() < 0:
            raise ValueError(f"ranks {self.ranks.tolist()} outside a world "
                             f"of {world}")
        members = sorted(self.ranks.ravel().tolist())
        self.group = (dist.group.WORLD if members == list(range(world))
                      else dist.new_group(members))
        for i, name in enumerate(self.axis_names):
            if self.ranks.shape[i] == self.size:
                self._axis_groups[name] = self.group
                continue
            # every slice along the axis, by every rank, in one order
            rows = np.moveaxis(self.ranks, i, -1).reshape(
                -1, self.ranks.shape[i])
            for row in rows.tolist():
                g = dist.new_group(row)
                if self.rank in row:
                    self._axis_groups[name] = g

    def coord(self, axis):
        """This rank's index along ``axis``."""
        if self._coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return self._coords[axis]

    def axis_group(self, axis):
        """The process group of this rank's slice along ``axis``."""
        self.coord(axis)
        return self._axis_groups[axis]


def make_mesh(axis_sizes: dict, ranks=None):
    """Mesh from ``{'time': t, 'rows': r}`` over ``ranks`` (default: the
    first ranks of the process group, or rank 0 alone without one)."""
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    n = int(np.prod(sizes))
    if ranks is None:
        ranks = range(dist.get_world_size() if _live() else 1)
    ranks = list(ranks)
    if len(ranks) < n:
        raise ValueError(f"need {n} ranks, have {len(ranks)}")
    return Mesh(np.array(ranks[:n]).reshape(sizes), names)


def all_reduce(t, mesh, axis=None):
    """Sum ``t`` in place over ``mesh`` (or its slice along ``axis``) and
    return it; the identity on a one-rank mesh without a process group.
    Every call counts, once."""
    if mesh.live:
        group = mesh.group if axis is None else mesh.axis_group(axis)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    elif mesh.size > 1:
        raise RuntimeError(f"a mesh of {mesh.size} ranks built without a "
                           f"process group cannot reduce")
    collective_counts["all_reduce"] += 1
    return t


def share(n, shards, i):
    """Shard ``i``'s range ``[a0, a1)`` of ``n`` items cut in ``shards``
    chunks of ``ceil(n / shards)`` (at least 1): the real items of shard
    ``i`` of JAX's stack padded to a multiple of the axis."""
    c = max(-(-n // shards), 1)
    return min(i * c, n), min((i + 1) * c, n)


def _slab(t, a0, a1, device):
    """Rows ``[a0, a1)`` of ``t``, sliced where ``t`` lives and moved."""
    return t[a0:a1].to(device).contiguous()


class ShardedEllOperator(LinearOperator):
    """Padded-ELL operator whose forward rows and transpose rows (the
    operator's columns) are split over the mesh axis ``axis``; ``shape``
    is the padded ``(m_pad, n_pad)`` (multiples of the axis), as JAX's.
    ``vals``/``cols`` hold this rank's rows ``rows`` of the forward table,
    ``vals_t``/``cols_t`` its rows ``cols_range`` of the transpose."""

    def __init__(self, vals, cols, vals_t, cols_t, rows, cols_range, shape,
                 nnz, mesh, axis):
        self.vals, self.cols = vals, cols
        self.vals_t, self.cols_t = vals_t, cols_t
        self.rows, self.cols_range = rows, cols_range
        self.shape = tuple(shape)
        self.nnz = nnz
        self.mesh, self.axis = mesh, axis
        self.dtype = vals.dtype
        self.device = vals.device

    @classmethod
    def from_ell(cls, op, mesh, axis: str = "rows", device=DEFAULT):
        """Shard a ``sparse.EllOperator``: its tables are sliced where they
        live and this rank's slabs moved to ``device`` (the card unless
        "cpu" is asked for)."""
        device = resolve(device)
        s, i = mesh.shape[axis], mesh.coord(axis)
        m, n = op.shape
        m_pad, n_pad = round_up(m, s), round_up(n, s)
        rows = tuple(min(a, m) for a in share(m_pad, s, i))
        cols = tuple(min(a, n) for a in share(n_pad, s, i))
        return cls(*(_slab(t, *rows, device) for t in (op.vals, op.cols)),
                   *(_slab(t, *cols, device) for t in (op.vals_t, op.cols_t)),
                   rows, cols, (m_pad, n_pad), op.nnz, mesh, axis)

    def _assemble(self, vals, cols, rng, size, v):
        out = v.new_zeros(size, dtype=torch.promote_types(self.dtype,
                                                          v.dtype))
        if rng[1] > rng[0]:
            out[rng[0]:rng[1]] = _ell_matvec(vals, cols, v.reshape(-1))
        return all_reduce(out, self.mesh, self.axis)

    def matvec(self, x):
        return self._assemble(self.vals, self.cols, self.rows,
                              self.shape[0], x)

    def rmatvec(self, y):
        return self._assemble(self.vals_t, self.cols_t, self.cols_range,
                              self.shape[1], y)


def _ell_frames(vals, cols, X):
    """``_ell_matvec`` of each frame: ``(f, m, w)`` tables on ``X (f, n)``
    -> ``(f, m)``."""
    f = X.shape[0]
    g = torch.gather(X, 1, cols.reshape(f, -1).long()).view(vals.shape)
    return (vals * g).sum(-1)


class ShardedDynamicOperator(LinearOperator):
    """Block diagonal over time of per-frame ELL tables on a ('time',
    'rows') mesh: frames over 'time', each frame's rows (and its transpose
    rows) over 'rows'. ``x`` is frame-major ``(nt * n,)``; ``shape`` the true
    ``(nt * m, nt * n)``, ``frame_shape`` the padded ``(m_f, n_f)``. This
    rank holds frames ``frames`` and, of each, forward rows ``rows`` and
    transpose rows ``cols_range``, stacked ``(nt_local, rows, w)``."""

    def __init__(self, vals, cols, vals_t, cols_t, frames, rows, cols_range,
                 shape, frame_shape, nnz, nt, mesh):
        self.vals, self.cols = vals, cols
        self.vals_t, self.cols_t = vals_t, cols_t
        self.frames, self.rows, self.cols_range = frames, rows, cols_range
        self.shape = tuple(shape)
        self.frame_shape = tuple(frame_shape)
        self.nnz = nnz
        self.nt = nt
        self.mesh = mesh
        self.dtype = vals.dtype
        self.device = vals.device

    @classmethod
    def from_blocks(cls, blocks, mesh, device=DEFAULT):
        """``blocks``: the per-frame scipy matrices (one shape). Each frame's
        tables are made on the host and only this rank's part moved to
        ``device``."""
        from scipy import sparse as sp

        device = resolve(device)
        t_sh, r_sh = mesh.shape["time"], mesh.shape["rows"]
        nt = len(blocks)
        if nt % t_sh:
            raise ValueError(f"nt={nt} must divide over time axis {t_sh}")
        Bs = [sp.csr_matrix(b) for b in blocks]
        # per frame: (vals, cols, vals_t, cols_t)
        tabs = [_csr_to_ell(B) + _csr_to_ell(B.T.tocsr()) for B in Bs]
        m0, n0 = Bs[0].shape
        m_f, n_f = round_up(m0, r_sh), round_up(n0, r_sh)
        ti, ri = mesh.coord("time"), mesh.coord("rows")
        frames = share(nt, t_sh, ti)
        rows = tuple(min(a, m0) for a in share(m_f, r_sh, ri))
        cols = tuple(min(a, n0) for a in share(n_f, r_sh, ri))

        def stack(k, rng):
            """Table k of this rank's frames and rows ``rng``, at the
            widest frame's width."""
            width = max(t[k].shape[1] for t in tabs)
            out = np.zeros((frames[1] - frames[0], rng[1] - rng[0], width),
                           tabs[0][k].dtype)
            for j, t in enumerate(range(*frames)):
                a = tabs[t][k][rng[0]:rng[1]]
                out[j, :, :a.shape[1]] = a
            return torch.from_numpy(out).to(device)

        return cls(stack(0, rows), stack(1, rows), stack(2, cols),
                   stack(3, cols), frames, rows, cols, (nt * m0, nt * n0),
                   (m_f, n_f), sum(B.nnz for B in Bs), nt, mesh)

    def _assemble(self, vals, cols, rng, size_out, v, size_in):
        nt = self.nt
        V = v.reshape(nt, size_in)[self.frames[0]:self.frames[1]]
        out = v.new_zeros((nt, size_out),
                          dtype=torch.promote_types(self.dtype, v.dtype))
        if rng[1] > rng[0] and V.shape[0]:
            out[self.frames[0]:self.frames[1], rng[0]:rng[1]] = \
                _ell_frames(vals, cols, V)
        return all_reduce(out, self.mesh).reshape(-1)

    def matvec(self, x):
        m0, n0 = self.shape[0] // self.nt, self.shape[1] // self.nt
        return self._assemble(self.vals, self.cols, self.rows, m0, x, n0)

    def rmatvec(self, y):
        m0, n0 = self.shape[0] // self.nt, self.shape[1] // self.nt
        return self._assemble(self.vals_t, self.cols_t, self.cols_range, n0,
                              y, m0)
