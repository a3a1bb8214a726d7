"""The configurations' true images, plain NumPy (the benchmark's copies).

``grains`` is the Voronoi grains phantom of the upstream phantom gallery
(AIRToolsII), as the upstream tomography demo draws it; ``moving_discs``
the frames of the port's synthetic dynamic problem (a disc circling over a
fixed wider disc), which stands in for the Emoji data's block structure.
"""
from __future__ import annotations

import numpy as np


def grains(N, num_grains=None, seed=None):
    """(N, N) grains phantom in [0, 1]."""
    if num_grains is None:
        num_grains = int(round(4 * np.sqrt(N)))
    rng = np.random.default_rng(seed)
    dN = round(N / 10)
    Nbig = N + 2 * dN
    xG = np.ceil(Nbig * rng.random(num_grains))
    yG = np.ceil(Nbig * rng.random(num_grains))
    xx = np.arange(1, Nbig + 1)
    X, Y = np.meshgrid(xx, xx, indexing="xy")
    Xf, Yf = X.flatten(order="F"), Y.flatten(order="F")
    dist = (Xf[:, None] - xG[None, :]) ** 2 + (Yf[:, None] - yG[None, :]) ** 2
    x = np.argmin(dist, axis=1).reshape(Nbig, Nbig) - 1
    x = x[dN:dN + N, dN:dN + N]
    return x / x.max()


def moving_discs(nx, nt):
    """(nt, nx * nx) frames: frame t has a disc of radius nx/6 centred at
    angle 2 pi t / nt on a circle of radius nx/4, over a disc of radius
    nx/3 and value 0.5 at the centre."""
    g = np.arange(nx)
    I, J = np.meshgrid(g, g, indexing="ij")
    frames = []
    for t in range(nt):
        cx = nx / 2 + nx / 4 * np.cos(2 * np.pi * t / nt)
        cy = nx / 2 + nx / 4 * np.sin(2 * np.pi * t / nt)
        img = ((I - cx) ** 2 + (J - cy) ** 2 <= (nx / 6) ** 2).astype(float)
        img += 0.5 * (((I - nx / 2) ** 2 + (J - nx / 2) ** 2) <= (nx / 3) ** 2)
        frames.append(img.reshape(-1))
    return np.stack(frames)
