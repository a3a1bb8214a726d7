"""Dynamic (time-resolved) tomography datasets and generators.

Host NumPy/SciPy, copied from ``trips_tpu/problems/dynamic.py``: the same
outputs from the same inputs and seeds. API parity with
``trips/utilities/io.py``:
- ``generate_emoji`` (io.py:97-162): Zenodo 1183532, 33 frames of 128x128,
  per-frame blocks 2170 x 16384, every 3rd angle kept;
- ``generate_crossPhantom`` (io.py:168-229): Zenodo 1341457, 16 frames,
  blocks 700 x 16384;
- ``generate_stempo`` (io.py:343-465): Zenodo 7147139, simulation mode
  builds per-frame parallel-beam (Joseph) projectors on resampled ground
  truth; real mode loads a precomputed sparse matrix.

The loaders read files already present under ``./data/...`` and raise
``FileNotFoundError`` with guidance otherwise; unlike the JAX package's,
they never try to download one. ``generate_synthetic_dynamic`` provides a
self-contained dynamic problem with the same return signature (moving-disc
phantom, rotating per-frame fan-beam geometry, block-diagonal forward map).
``h5py`` is imported only by the loaders that read MATLAB v7.3 files.
"""
from __future__ import annotations

import os

import numpy as np
from scipy import sparse as sp

from ..utils.images import image_to_new_size
from .projector import fan_beam_matrix, parallel_beam_matrix


def _download(url, path):
    if os.path.exists(path):
        return
    raise FileNotFoundError(
        f"dataset file {path} is missing and could not be downloaded "
        f"(this package does not download; the file is at {url}). Place "
        f"the file there manually, or use generate_synthetic_dynamic() for "
        f"an offline dynamic problem.")


def generate_emoji(dataset=30, **kwargs):
    """Emoji dynamic CT (io.py:123-162). Returns
    (A, b, AA, B, nx, ny, nt[, delta])."""
    assert dataset in (30, 60)
    noise_level = kwargs.get("noise_level", 0)
    path = f"./data/emoji_data/DataDynamic_128x{dataset}.mat"
    _download(f"https://zenodo.org/record/1183532/files/DataDynamic_128x{dataset}.mat", path)
    import h5py

    with h5py.File(path, "r") as f:
        A = sp.csc_matrix((f["A"]["data"], f["A"]["ir"], f["A"]["jc"]))
        sinogram = np.array(f["sinogram"]).T
    T = 33
    N = int(np.sqrt(A.shape[1] / T))
    mm, nn = sinogram.shape
    ind = []
    for ii in range(int(nn / 3)):
        ind.extend(np.arange(0, mm) + (3 * ii) * mm)
    m2 = sinogram[:, 0::3]
    A_small = sp.csr_matrix(A)[ind, :]
    b = m2.reshape(-1, 1, order="F").squeeze()
    e = np.random.randn(b.shape[0])
    sig = noise_level * np.linalg.norm(b) / np.linalg.norm(e)
    b = b + sig * e
    delta = np.linalg.norm(sig * e)
    block_m = A_small.shape[0] // T
    AA = [A_small[block_m * i : block_m * (i + 1), N * N * i : N * N * (i + 1)] for i in range(T)]
    B = [b[block_m * i : block_m * (i + 1)] for i in range(T)]
    if noise_level:
        return A_small, b, AA, B, N, N, T, delta
    return A_small, b, AA, B, N, N, T


def generate_crossPhantom(dataset=15, **kwargs):
    """CrossPhantom dynamic CT (io.py:187-229)."""
    assert dataset in (15, 60)
    noise_level = kwargs.get("noise_level", 0)
    path = f"./data/crossphantom_data/DataDynamic_128x{dataset}.mat"
    _download(f"https://zenodo.org/record/1341457/files/DataDynamic_128x{dataset}.mat", path)
    import scipy.io as spio

    f = spio.loadmat(path)
    A = sp.csr_matrix(f["A"])
    sinogram = f["sinogram"]
    T = 16
    N = int(np.sqrt(A.shape[1] / T))
    mm, nn = sinogram.shape
    ind = []
    for ii in range(int(nn / 3)):
        ind.extend(np.arange(0, mm) + (3 * ii) * mm)
    m2 = sinogram[:, ::3]
    A_small = A[ind, :]
    b = m2.reshape(-1, 1, order="F").squeeze()
    e = np.random.randn(b.shape[0])
    sig = noise_level * np.linalg.norm(b) / np.linalg.norm(e)
    b = b + sig * e
    delta = np.linalg.norm(sig * e)
    block_m = A_small.shape[0] // T
    AA = [A_small[block_m * i : block_m * (i + 1), N * N * i : N * N * (i + 1)] for i in range(T)]
    B = [b[block_m * i : block_m * (i + 1)] for i in range(T)]
    if noise_level:
        return A_small, b, AA, B, N, N, T, delta
    return A_small, b, AA, B, N, N, T


def generate_stempo(data_set="simulation", data_thinning=2, views=11,
                    new_shape=(64, 64), **kwargs):
    """STEMPO dynamic CT (io.py:343-465). Simulation mode builds per-frame
    parallel-beam Joseph projectors natively (ASTRA 'linear' replacement)."""
    nt = kwargs.get("nt", 10)
    noise_level = kwargs.get("noise_level", 0)
    if data_set == "simulation":
        path = "./data/stempo_data/stempo_ground_truth_2d_b4.mat"
        _download("https://zenodo.org/record/7147139/files/stempo_ground_truth_2d_b4.mat", path)
        import scipy.io as spio

        truth = spio.loadmat(path)
        image = truth["obj"]
        nx, ny = new_shape
        frames = np.zeros((nx, ny, 360))
        for i in range(360):
            imm = image_to_new_size(image[:, :, i], (nx, ny))
            imm = np.nan_to_num(imm)
            frames[:, :, i] = imm
        anglecount = views - 1
        rowshift, columnsshift = 5, 14
        angle_sets = [
            np.deg2rad(np.linspace(rowshift * t, columnsshift * anglecount + rowshift * t,
                                   num=anglecount + 1))
            for t in range(nt)
        ]
        N = nx
        count = int(360 / nt)
        saveA, B = [], []
        saveb = np.zeros((len(angle_sets[0]) * N, nt))
        savedelta = np.zeros((nt, 1))
        savex_true = np.zeros((nx * ny, nt))
        for i in range(nt):
            A_i = parallel_beam_matrix(N, angle_sets[i], det_count=N, model="linear") / N
            x_true = frames[:, :, count * i] * 1000
            xf = x_true.flatten(order="F")
            savex_true[:, i] = xf
            b_i = A_i @ xf
            e = np.random.normal(0, 1, b_i.shape[0])
            e = e / np.linalg.norm(e) * np.linalg.norm(b_i) * noise_level
            savedelta[i] = np.linalg.norm(e)
            b_m = b_i + e
            saveA.append(sp.csr_matrix(A_i))
            B.append(b_m)
            saveb[:, i] = b_m
        Afull = sp.block_diag(saveA, format="csr")
        b = saveb.flatten(order="F")
        truth_out = savex_true.reshape((nx, ny, nt), order="F").transpose((2, 1, 0))
        return Afull, b, saveA, B, nx, ny, nt, savedelta, truth_out
    elif data_set == "real":
        import h5py

        N = int(2240 / data_thinning)
        nx, ny, nt = N, N, 8
        data_file = f"stempo_seq8x45_2d_b{data_thinning}.mat"
        path = "./data/stempo_data/" + data_file
        _download("https://zenodo.org/record/7147139/files/" + data_file, path)
        with h5py.File(path, "r") as f:
            m = np.array(f["CtData"]["sinogram"]).T
        with h5py.File("./data/stempo_data/A_seqData.mat", "r") as f:
            Adata = np.array(f["A"]["data"])
            Arowind = np.array(f["A"]["ir"])
            Acolind = np.array(f["A"]["jc"])
        n_rows = N * 45
        Aloaded = sp.csc_matrix((Adata, Arowind, Acolind), shape=(n_rows, N * N)).tocsr()
        saveA, B = [], []
        saveb = np.zeros((n_rows, nt))
        savedelta = np.zeros((nt, 1))
        for i in range(nt):
            b_i = m[45 * i : 45 * (i + 1), :].flatten()
            e = np.random.normal(0, 1, b_i.shape[0])
            e = e / np.linalg.norm(e) * np.linalg.norm(b_i) * noise_level
            savedelta[i] = np.linalg.norm(e)
            b_m = b_i + e
            saveA.append(Aloaded)
            B.append(b_m)
            saveb[:, i] = b_m
        Afull = sp.block_diag(saveA, format="csr")
        b = saveb.flatten(order="F")
        return Afull, b, saveA, B, nx, ny, nt, savedelta, None
    raise ValueError(f"unknown data_set {data_set!r}")


def generate_synthetic_dynamic(nx=32, nt=8, views=12, noise_level=0.01,
                               seed=3, return_angles=False):
    """Self-contained dynamic CT problem (offline stand-in for Emoji et al.).

    A moving-disc phantom imaged by a per-frame fan-beam geometry whose
    angles rotate frame to frame (STEMPO-style limited angles). Returns
    (A, b, AA, B, nx, ny, nt, delta, x_true) with x_true (nt*nx*nx,)
    frame-major.
    """
    rng = np.random.default_rng(seed)
    g = np.arange(nx)
    I, J = np.meshgrid(g, g, indexing="ij")
    frames, AA, B = [], [], []
    bs = []
    for t in range(nt):
        cx = nx / 2 + nx / 4 * np.cos(2 * np.pi * t / nt)
        cy = nx / 2 + nx / 4 * np.sin(2 * np.pi * t / nt)
        img = ((I - cx) ** 2 + (J - cy) ** 2 <= (nx / 6) ** 2).astype(float)
        img += 0.5 * (((I - nx / 2) ** 2 + (J - nx / 2) ** 2) <= (nx / 3) ** 2)
        frames.append(img.reshape(-1))
        th0 = np.deg2rad(5 * t)
        angles = th0 + np.linspace(0, np.pi, views, endpoint=False)
        A_t = fan_beam_matrix(nx, angles=angles)
        AA.append(A_t)
        bs.append(A_t @ frames[-1])
    b_true = np.concatenate(bs)
    e = rng.standard_normal(b_true.shape[0])
    sig = noise_level * np.linalg.norm(b_true) / np.linalg.norm(e)
    b = b_true + sig * e
    delta = float(np.linalg.norm(sig * e))
    per_frame_B = np.split(b, nt)
    A = sp.block_diag(AA, format="csr")
    x_true = np.concatenate(frames)
    out = (A, b, AA, per_frame_B, nx, nx, nt, delta, x_true)
    if return_angles:
        # per-frame angle sets (frame-varying geometry) for packing the
        # block system into sparse.DynamicBandedOperator
        angles_list = [np.deg2rad(5 * t)
                       + np.linspace(0, np.pi, views, endpoint=False)
                       for t in range(nt)]
        return out + (angles_list,)
    return out
