"""Out-of-core dynamic CT: host-resident per-frame packs streamed to the
card with a two-slot pipeline.

Counterpart of ``trips_tpu/parallel/streamed.py``. Every frame's banded
pack stays in host memory, and one frame's slab at a time goes to the
card, the next frame's upload running while the current frame computes:

- at construction each frame's stacks are copied once into one pinned
  (page-locked) host buffer, laid out as a slab: a copy from pageable
  memory with ``non_blocking=True`` would not be asynchronous;
- two device slots, each the size of the largest frame's slab, are
  allocated once; an apply uploads frame t+1 into one (a single
  ``copy_(..., non_blocking=True)`` on a side stream) while frame t's
  kernels run from the other on torch's current stream;
- events in both directions bound the device's share to two slabs
  without a host sync per frame: slot s's "ready" event, recorded on the
  side stream after its upload, is waited on by the compute stream before
  the frame's apply; its "free" event, recorded on the compute stream
  after that apply, is waited on by the side stream before the slot is
  overwritten. (JAX's version gets the same bound by blocking the host on
  each frame's output.)

A frame's apply is the frame operator's own ``matvec``/``rmatvec``/
``normal_matvec`` on a view twin whose buckets are views of the slot, so
``matvec`` launches K2 nt times, ``rmatvec`` K3 nt times and
``normal_matvec`` K1 nt times, each writing its frame's slice of one
output. With ``device="cpu"`` the host frame operators apply in turn, with
no streams. The resident operators (``sparse.dynamic_banded``) stay the
fast path whenever the pack fits the card's memory: a streamed apply moves
the whole pack over the host link.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from ..core.device import DEFAULT, resolve
from ..core.linop import LinearOperator
from ..sparse import banded_kernels as bk

_ALIGN = 256  # byte alignment of each tensor in a slab (TMA needs 16)


def _layout(op):
    """A frame operator's bucket tensors (W, S, Pm[, scales] of each held
    bucket, in order) and their places in its slab: ([(tensor, offset,
    bytes)], slab bytes)."""
    parts, size = [], 0
    for b in op._bks:
        for t in b[:4]:
            if t is not None:
                nbytes = t.numel() * t.element_size()
                parts.append((t, size, nbytes))
                size += -(-nbytes // _ALIGN) * _ALIGN
    return parts, size


class StreamedDynamicBandedOperator(LinearOperator):
    """Block diagonal over time of per-frame operators that live on the host
    and are streamed to ``device`` (the card unless "cpu" is asked for) per
    apply.

    ``frame_ops``: the per-frame ``BandedProjector`` /
    ``BucketedBandedProjector``, built with ``device="cpu"``.
    """

    def __init__(self, frame_ops, device=DEFAULT):
        self.frame_ops = list(frame_ops)
        if not self.frame_ops:
            raise ValueError("frame_ops must contain at least one frame "
                             "operator")
        self.device = resolve(device)
        for op in self.frame_ops:
            if torch.device(op.device).type != "cpu":
                raise ValueError(f"frame operators must live on the host, "
                                 f"got one on {op.device}")
        self.nt = len(self.frame_ops)
        m = sum(op.shape[0] for op in self.frame_ops)
        n = sum(op.shape[1] for op in self.frame_ops)
        self.shape = (m, n)
        self.dtype = torch.float32
        self.nnz = sum(getattr(op, "nnz", 0) for op in self.frame_ops)
        self._row_off = np.cumsum(
            [0] + [op.shape[0] for op in self.frame_ops]).tolist()
        self._col_off = np.cumsum(
            [0] + [op.shape[1] for op in self.frame_ops]).tolist()
        if self.device.type == "cuda":
            self._stage()

    @property
    def stored_bytes(self):
        return sum(getattr(op, "stored_bytes", 0) for op in self.frame_ops)

    @property
    def slab_bytes(self):
        """Bytes of each frame's slab (what an apply uploads per frame)."""
        return [_layout(op)[1] for op in self.frame_ops]

    # -- staging (the card) ------------------------------------------------
    def _stage(self):
        dev = self.device
        self._host, layouts = [], []
        for op in self.frame_ops:
            parts, size = _layout(op)
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError("pinning a frame's host slab failed")
            for t, o, nbytes in parts:
                buf[o:o + nbytes].copy_(
                    t.contiguous().reshape(-1).view(torch.uint8))
            self._host.append(buf)
            layouts.append(parts)
        # Allocator: the slots are allocated once, on the current stream,
        # and never freed while the operator lives; every side-stream
        # upload into one is waited on by the compute stream before its
        # read, so no ``record_stream`` is needed.
        slab = max(b.numel() for b in self._host)
        self._slots = [torch.empty(slab, dtype=torch.uint8, device=dev)
                       for _ in range(2)]
        # the buckets' angle ids are small: resident, one copy per frame
        aidx = [tuple(a.to(dev) for a in op._aidx) for op in self.frame_ops]
        # Per-frame twins: a shallow copy of the host operator with its
        # buckets swapped for views of a slot, one per (slot, frame), made
        # once. Building them through ``BucketedBandedProjector.__init__``
        # would copy the stacks with ``.to()`` and rebuild the angle ids
        # with ``torch.tensor`` every time.
        # Wrapper cache: the wrappers keep checked launch arguments by
        # bucket identity in a FIFO of 64 entries; these 2 nt twins would
        # miss it every apply and evict the resident operators' entries.
        # So each twin's arguments are made here once (``bk.prepare``: the
        # bucket checks and ctypes arguments, off the apply's path) and
        # handed to the wrappers, which then skip their cache.
        self._twins = [[self._twin(s, t, layouts[t], aidx[t])
                        for t in range(self.nt)] for s in range(2)]
        self._side = torch.cuda.Stream(dev)
        self._ready = [torch.cuda.Event() for _ in range(2)]
        self._free = [torch.cuda.Event() for _ in range(2)]

    def _twin(self, s, t, layout, aidx):
        op = self.frame_ops[t]
        slot = self._slots[s]
        views = iter([slot[o:o + nbytes].view(h.dtype).view(h.shape)
                      for h, o, nbytes in layout])
        bks = tuple((next(views), next(views), next(views),
                     next(views) if sc is not None else None, c)
                    for _, _, _, sc, c in op._bks)
        tw = copy.copy(op)
        tw._bks, tw._aidx, tw.device = bks, aidx, self.device
        for attr, name, ids in (("_fwd", "banded_fwd", aidx),
                                ("_adj", "banded_adj", aidx),
                                ("_ata", "banded_ata", None)):
            setattr(tw, attr, functools.partial(
                getattr(bk, name + "_buckets"),
                prepared=bk.prepare(name, slot, bks, ids, op.n_groups)))
        return tw

    def _upload(self, t, s):
        """Enqueue frame t's slab into slot s on the side stream, after the
        frame that slot held was applied."""
        with torch.cuda.stream(self._side):
            self._side.wait_event(self._free[s])
            buf = self._host[t]
            self._slots[s][:buf.numel()].copy_(buf, non_blocking=True)
            self._ready[s].record(self._side)

    def _apply_frame(self, fn, s, t, v):
        """Frame t's apply ``fn`` on its twin in slot s (the compute
        stream)."""
        return getattr(self._twins[s][t], fn)(v)

    # -- applies -----------------------------------------------------------
    def _pipeline(self, fn, v, in_off, out_off):
        out = v.new_empty(out_off[-1])
        if self.device.type == "cpu":
            for t, op in enumerate(self.frame_ops):
                out[out_off[t]:out_off[t + 1]] = getattr(op, fn)(
                    v[in_off[t]:in_off[t + 1]])
            return out
        comp = torch.cuda.current_stream(self.device)
        self._upload(0, 0)
        for t in range(self.nt):
            s = t % 2
            if t + 1 < self.nt:
                self._upload(t + 1, 1 - s)
            comp.wait_event(self._ready[s])
            out[out_off[t]:out_off[t + 1]] = self._apply_frame(
                fn, s, t, v[in_off[t]:in_off[t + 1]])
            self._free[s].record(comp)
        return out

    def matvec(self, x):
        x = torch.as_tensor(x, device=self.device).reshape(-1)
        return self._pipeline("matvec", x, self._col_off, self._row_off)

    def rmatvec(self, y):
        y = torch.as_tensor(y, device=self.device).reshape(-1)
        return self._pipeline("rmatvec", y, self._row_off, self._col_off)

    def normal_matvec(self, x):
        x = torch.as_tensor(x, device=self.device).reshape(-1)
        return self._pipeline("normal_matvec", x, self._col_off,
                              self._col_off)


def cgls_normal_streamed(op, b, x0, n_iter, tol=0.0):
    """CGLS on the normal equations with a streamed operator: the scalar
    recurrences run on the device, the frame loop inside each
    ``normal_matvec`` streams the slabs (the out-of-core mode of
    ``krylov.cgls_normal``: the same update and the same ``(x, k)``
    return, a host-level iteration loop). Two host reads a step (``delta``
    and ``norm(t)``), nothing beside a streamed apply."""
    b = torch.as_tensor(b, device=op.device).reshape(-1)
    x = torch.as_tensor(x0, device=op.device).reshape(-1)
    t = op.rmatvec(b) - op.normal_matvec(x)
    norms_t0 = torch.linalg.norm(t)
    p = t
    gamma = norms_t0**2
    k_done = 0
    # scalar updates mirror krylov.cgls._cgn_step op for op (incl. the
    # nonpositive-delta convergence guard and norm(t)**2 gamma), so the
    # streamed trajectory tracks the resident loop to roundoff
    for _ in range(int(n_iter)):
        q = op.normal_matvec(p)
        delta = torch.dot(p, q)
        if float(delta) <= 0:
            break
        beta = gamma / delta
        x = x + beta * p
        t = t - beta * q
        norm_t = torch.linalg.norm(t)
        gamma_new = norm_t**2
        k_done += 1
        if float(norm_t) <= float(norms_t0) * tol:
            gamma = gamma_new
            break
        p = t + (gamma_new / gamma) * p
        gamma = gamma_new
    return x, k_done
