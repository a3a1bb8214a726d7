"""Visualization and conversion helpers.

Counterpart of ``trips_tpu/utils/helpers.py`` (API parity with
``trips/utilities/helpers.py``): user-image conversion (:26-50), singular
vector/value plots (:53-120), dynamic reconstruction series plotting
(:123-176), sinogram grids (:178-193). Arrays may be NumPy arrays or torch
tensors on any device (moved to the host as NumPy). PIL and matplotlib
are imported inside the functions that need them.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _np(a):
    """A NumPy array from an array or a tensor (on any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def convert_image_for_trips(path, dataset="mydata", size=(64, 64)):
    """User image -> normalized grayscale .mat with key 'x_true'
    (helpers.py:26-50)."""
    import scipy.io as spio
    from PIL import Image

    img = Image.open(path).convert("L").resize(size)
    X = np.asarray(img, dtype=float)
    X = X / X.max()
    outdir = "./data/image_data"
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, f"{dataset}.mat")
    spio.savemat(out, {"x_true": X})
    return X, out


def plot_singular_vectors(V, nx, ny, num=6, save_path=None):
    """Leading right singular vectors as images (helpers.py:53-98)."""
    import matplotlib.pyplot as plt

    V = _np(V)
    fig, axes = plt.subplots(1, num, figsize=(3 * num, 3))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.imshow(V[:, i].reshape(nx, ny), cmap="inferno")
        ax.set_title(f"v_{i + 1}")
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_singular_values(S, label="singular values", save_path=None):
    """Log-scale spectrum plot (helpers.py:100-120)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.semilogy(_np(S).reshape(-1), "o-", markersize=3)
    ax.set_xlabel("index")
    ax.set_ylabel(label)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_recstructions_series(x, shape, dynamic=True, testproblem="",
                              geome_x=3, geome_y=3, save_imgs=False,
                              save_path="./reconstructions"):
    """Grid of reconstructed frames (helpers.py:123-176)."""
    import matplotlib.pyplot as plt

    nx, ny, nt = shape
    X = _np(x).reshape(nt, nx, ny) if dynamic else _np(x).reshape(1, nx, ny)
    count = min(geome_x * geome_y, X.shape[0])
    fig, axes = plt.subplots(geome_x, geome_y, figsize=(3 * geome_y, 3 * geome_x))
    for i, ax in enumerate(np.asarray(axes).reshape(-1)):
        if i < count:
            ax.imshow(X[i], cmap="inferno")
            ax.set_title(f"t={i}")
        ax.axis("off")
    if save_imgs:
        os.makedirs(save_path, exist_ok=True)
        fig.savefig(os.path.join(save_path, f"series_{testproblem}.png"),
                    bbox_inches="tight")
    return fig


def plot_sinograms(b, p, q, geome_x=2, geome_y=2, save_imgs=False,
                   save_path="./sinograms"):
    """Grid of sinograms (helpers.py:178-193)."""
    import matplotlib.pyplot as plt

    B = _np(b).reshape(-1, p, q)
    fig, axes = plt.subplots(geome_x, geome_y, figsize=(3 * geome_y, 3 * geome_x))
    for i, ax in enumerate(np.asarray(axes).reshape(-1)):
        if i < B.shape[0]:
            ax.imshow(B[i], cmap="inferno", aspect="auto")
        ax.axis("off")
    if save_imgs:
        os.makedirs(save_path, exist_ok=True)
        fig.savefig(os.path.join(save_path, "sinograms.png"), bbox_inches="tight")
    return fig
