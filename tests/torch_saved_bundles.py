"""Saved-data bundles for ``demo_saved_data``'s tests, written from a
seed (the reference's ``.mat`` bundles are not in the repository):
``./data/image_data/head.mat`` (``x_true`` n x n, ``b`` 1 x rows) and
``CT200.mat`` (``A`` rows x n^2 sparse, ``phi`` 1 x views, ``s`` 1 x
detectors), the layout ``Tomography.gen_saved_data`` reads. Used by
``tests/test_torch_demos.py``, ``tests/test_torch_demos_jax.py`` and
``demo_reference.py data_twins``."""
import numpy as np
import scipy.io as spio
import scipy.sparse as sp


def write(root, n=8, views=6, dets=12, seed=5):
    """Write the bundles under ``root/data/image_data``; returns (A,
    x_true, b)."""
    rng = np.random.RandomState(seed)
    A = sp.random(views * dets, n * n, density=0.3, format="csc",
                  random_state=rng)
    t = np.linspace(0, 1, n)
    x_true = np.outer(np.sin(np.pi * t), np.cos(0.5 * np.pi * t)) + 0.2
    b = A @ x_true.reshape(-1) + 0.01 * rng.standard_normal(views * dets)
    d = root / "data" / "image_data"
    d.mkdir(parents=True, exist_ok=True)
    spio.savemat(d / "head.mat", {"x_true": x_true, "b": b[None, :]})
    spio.savemat(d / "CT200.mat", {"A": A, "phi": np.zeros((1, views)),
                                   "s": np.zeros((1, dets))})
    return A, x_true, b
