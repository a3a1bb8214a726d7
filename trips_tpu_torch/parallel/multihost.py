"""Process-group start-up and the pod mesh.

Counterpart of ``trips_tpu/parallel/multihost.py``: every process calls
``init_multihost`` (``torch.distributed`` over a TCP rendezvous at the
coordinator's address), then builds one mesh over all ranks with
``pod_mesh``; the sharded operators of ``parallel/`` work on it unchanged.
The backend is NCCL (the cards) unless the caller asks for another: on the
CPU, or with two ranks on one card (which NCCL refuses), pass ``"gloo"``.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from .sharding import Mesh, _live


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, backend=None, timeout=None):
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, rendezvous at ``coordinator_address`` (``host:port``).
    Does nothing and returns False for one process (None or 1), as JAX's
    does; True once joined. ``backend``: "nccl" unless given;
    ``timeout``: a ``datetime.timedelta`` bound on every collective's
    wait (torch's default if None)."""
    if num_processes in (None, 1):
        return False
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend or "nccl",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return True


def pod_mesh(time_shards=1, rows_shards=None):
    """Mesh ('time', 'rows') over all ranks of the process group (rank 0
    alone without one), 'time' the major axis: consecutive ranks, those of
    one host when ranks are numbered host by host, share a time slice, so
    the rows' sums stay within a host."""
    n = dist.get_world_size() if _live() else 1
    if rows_shards is None:
        rows_shards = n // time_shards
    if time_shards * rows_shards != n:
        raise ValueError(f"{time_shards} x {rows_shards} != {n} ranks")
    return Mesh(np.arange(n).reshape(time_shards, rows_shards),
                ("time", "rows"))
