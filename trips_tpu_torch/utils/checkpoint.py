"""Checkpoint / resume for iterative solvers.

Counterpart of ``trips_tpu/utils/checkpoint.py``, with its ``.npz``
layout: a flat dict of arrays and scalars, a list stored as ``name__i``
entries with its length under ``__len__name``. A file written by either
package loads in the other. Tensors (on any device) are saved as NumPy
arrays.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _array(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path, state: dict):
    """Persist a flat dict of arrays/tensors/scalars/lists of them."""
    flat = {}
    for k, v in state.items():
        if isinstance(v, (list, tuple)):
            flat[f"__len__{k}"] = np.asarray(len(v))
            for i, item in enumerate(v):
                flat[f"{k}__{i}"] = _array(item)
        else:
            flat[k] = _array(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_state(path) -> dict:
    """The dict ``save_state`` wrote, as NumPy arrays."""
    data = np.load(path, allow_pickle=False)
    state = {}
    lists = {}
    for k in data.files:
        if k.startswith("__len__"):
            lists[k[len("__len__"):]] = int(data[k])
    for k in data.files:
        if k.startswith("__len__"):
            continue
        if "__" in k and k.rsplit("__", 1)[0] in lists:
            base, idx = k.rsplit("__", 1)
            state.setdefault(base, [None] * lists[base])[int(idx)] = data[k]
        else:
            state[k] = data[k]
    return state


class CheckpointCallback:
    """Solver callback that saves the state every ``every`` iterations."""

    def __init__(self, path, every=10):
        self.path = path
        self.every = every

    def __call__(self, iteration, **fields):
        if self.every and iteration % self.every == 0:
            arrays = {
                k: v for k, v in fields.items()
                if hasattr(v, "shape") or np.isscalar(v)
            }
            arrays["iteration"] = iteration
            save_state(self.path, arrays)
