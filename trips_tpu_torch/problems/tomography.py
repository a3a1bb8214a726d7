"""Static tomography test problem (fan-beam CT).

Counterpart of ``trips_tpu/problems/tomography.py`` (API parity with
``trips/test_problems/Tomography.py:41-268``): the same geometry
(p = int(sqrt(2)*nx) detectors, theta in [0, pi), source 3*nx, detector nx,
pixel size (so+od)/so), data generated with angles shifted by 1e-8 rad to
avoid the inverse crime, and a solver-facing operator on ``device`` (the
CUDA card unless ``device="cpu"``): the Ta-bucketed banded pack of the
host CSR matrix.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from ..core.device import DEFAULT, resolve
from ..sparse import BucketedBandedProjector
from . import phantoms as phantom
from .projector import fan_beam_matrix


def device_sparse_operator(A_csr, dtype=np.float32, nx=None, angles=None,
                           device=DEFAULT):
    """Pack a host CSR fan/parallel matrix as the bucketed banded operator
    (32 line groups, 4 buckets) on ``device`` (the card unless "cpu" is
    asked for). ``dtype``: float32 (the exact matrix), bfloat16 or "int8".
    Needs the square-grid geometry (``nx`` and ``angles``); other
    geometries have no torch operator yet."""
    if nx is None or angles is None or A_csr.shape[1] != nx * nx:
        raise NotImplementedError(
            "only square grids with known angles have a torch operator "
            "(the bucketed banded pack); pass nx and angles")
    return BucketedBandedProjector.from_scipy_fan(
        A_csr, nx, views=None, angles=np.asarray(angles), n_groups=32,
        dtype=dtype, device=device)


class Tomography:
    def __init__(self, **kwargs):
        self.seed = kwargs.pop("seed", 2022)
        self.device = resolve(kwargs.pop("device", DEFAULT))
        self.nx = None
        self.ny = None
        self.CommitCrime = kwargs.get("CommitCrime", False)

    # -- geometry ---------------------------------------------------------
    def define_proj_id(self, nx, ny, views, **kwargs):
        self.nx, self.ny = nx, ny
        self.p = int(np.sqrt(2) * nx)
        self.q = views
        self.views = views
        self.theta = np.linspace(0, np.pi, views, endpoint=False)
        self.source_origin = 3 * nx
        self.detector_origin = nx
        self.detector_pixel_size = (self.source_origin + self.detector_origin) / self.source_origin

    def define_A(self, nx, ny, views):
        self.define_proj_id(nx, ny, views)
        kw = dict(
            det_count=self.p,
            det_width=self.detector_pixel_size,
            source_origin=self.source_origin,
            origin_det=self.detector_origin,
        )
        self.A = fan_beam_matrix(nx, ny, angles=self.theta, **kw)
        if not self.CommitCrime:
            self.A_mis = fan_beam_matrix(nx, ny, angles=self.theta + 1e-8, **kw)

    def forward_Op(self, nx, ny, views, dtype=None):
        """Returns (OP, A[, A_mis]): the operator on ``self.device``, the
        host CSR, and (when CommitCrime is False) the angle-mismatched CSR
        used for data. ``dtype``: operator storage, float32 by default."""
        self.define_A(nx, ny, views)
        self.OP = device_sparse_operator(
            self.A, dtype=dtype, nx=nx if nx == ny else None,
            angles=self.theta, device=self.device)
        if not self.CommitCrime:
            return self.OP, self.A, self.A_mis
        return self.OP, self.A

    # -- ground truth -----------------------------------------------------
    def gen_true(self, test_problem, **kwargs):
        if self.nx is None or self.ny is None:
            if "nx" in kwargs and "ny" in kwargs:
                self.nx, self.ny = kwargs["nx"], kwargs["ny"]
            else:
                raise TypeError(
                    "The dimension of the image is not specified. Pass nx/ny "
                    "or define the forward operator first."
                )
        N = self.nx
        seed = kwargs.get("phantom_seed", None)
        if test_problem == "grains":
            x = phantom.grains(N, int(round(4 * np.sqrt(N))), seed=seed)
        elif test_problem == "smooth":
            x = phantom.smooth(N)
        elif test_problem == "tectonic":
            x = phantom.tectonic(N)
        elif test_problem == "threephases":
            x = phantom.threephases(N, seed=seed)
        elif test_problem == "ppower":
            x = phantom.ppower(N, seed=seed)
        elif test_problem == "shepp_logan":
            x = phantom.shepp_logan(N)
        elif test_problem in ("SL60", "SL90", "head"):
            raise NotImplementedError(
                f"{test_problem!r} needs the image loaders, which the torch "
                "package does not have yet")
        else:
            raise TypeError(
                "You must enter a valid test problem! Options are: grains, "
                "smooth, tectonic, threephases, ppower, shepp_logan, SL60, "
                "SL90, head."
            )
        self.nx, self.ny = x.shape
        return x.reshape(-1, 1), self.nx, self.ny

    # -- data -------------------------------------------------------------
    def gen_data(self, x, nx, ny, views):
        self.nx, self.ny, self.views = nx, ny, views
        if not self.CommitCrime:
            OP, A, A_mis = self.forward_Op(nx, ny, views)
            b = (A_mis @ np.asarray(x).reshape(-1)).reshape(-1, 1)
        else:
            OP, A = self.forward_Op(nx, ny, views)
            b = (A @ np.asarray(x).reshape(-1)).reshape(-1, 1)
        # reference swaps p/q after data generation (Tomography.py:164-166)
        self.p = self.views
        self.q = int(b.shape[0] / self.views)
        return OP, b, self.p, self.q, A

    def add_noise(self, b_true, opt, noise_level, rng=None):
        """Noise from NumPy's global generator (the reference's semantics:
        seed with ``np.random.seed``), or from ``rng``, a
        ``np.random.Generator``."""
        r = np.random if rng is None else rng
        b_true = np.asarray(b_true).reshape(-1, 1)
        if opt == "Gaussian":
            noise = r.standard_normal(b_true.shape[0]).reshape(-1, 1)
            e = noise_level * np.linalg.norm(b_true) / np.linalg.norm(noise) * noise
            delta = sla.norm(e)
            b_meas = b_true + e
            return b_meas.reshape(self.p, self.q), delta
        if opt == "Poisson":
            b_meas = r.poisson(lam=b_true + 1).astype(float)
            return b_meas.reshape(self.p, self.q), 0
        e = r.laplace(size=(b_true.shape[0], 1))
        sig = noise_level * np.linalg.norm(b_true) / np.linalg.norm(e)
        b_meas = b_true + sig * e
        return b_meas.reshape(self.p, self.q), sla.norm(sig * e)
