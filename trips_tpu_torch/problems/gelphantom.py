"""gelPhantom dynamic cone-beam CT (CIL-equivalent loader).

Counterpart of ``trips_tpu/problems/gelphantom.py``, the same five
functions with the same arguments and returns. The reference
(``trips/utilities/cil_io.py:35-224``) parses the Helsinki gel-phantom
.mat bundle (Zenodo 3696817, one v5 file holding a struct with per-frame
parameter structs and a stacked sinogram array) and builds CIL ``Cone2D``
projection operators. CIL's Cone2D geometry is the planar fan-beam
geometry of ``fan_beam_matrix``, mapped as:

- reconstruction voxel size v = correctedPixelSize / geometricMagnification
  (CIL's ``AcquisitionGeometry.get_ImageGeometry()`` default: the
  reference overrides ``voxel_num`` to 256 but keeps the default voxel
  *size*, cil_io.py:196-198);
- the reference corrects the panel pixel size by 2x
  (``pixelSize = 2*file_info['pixelSize']``, cil_io.py:176);
- angles are sliced with CIL ``Slicer(roi={'angle': (0, 360, step)})``,
  step 20 (cil_io.py:202-204);
- source/detector distances and detector width are expressed in voxel
  units for ``fan_beam_matrix``.

The matrices are host scipy CSR (the C++ builder unless
``TRIPS_TPU_NO_NATIVE=1``); a solver's device operator over the frames is
``BatchedBlockDiagOperator(device_sparse_operator(AA[0], nx=nx,
angles=...), nt)``, one shared geometry. Nothing downloads: the bundle
must exist locally.
"""
from __future__ import annotations

import numpy as np

from .dynamic import _download
from .projector import fan_beam_matrix


def read_frames(path):
    """Parse the gel-phantom bundle (reference cil_io.py:35-91): returns
    dict with 'sinograms' (nt, n_angles, n_det), per-frame-shared geometry
    scalars, and 'angles' in radians."""
    import scipy.io as spio

    mat = spio.loadmat(path, mat_dtype=True, squeeze_me=True,
                       struct_as_record=False)
    key = [k for k in mat if not k.startswith("__")][0]
    rec = mat[key]
    sinograms = np.asarray(rec.sinogram, dtype=float)
    if sinograms.ndim == 2:
        sinograms = sinograms[None]
    p0 = np.atleast_1d(rec.parameters)[0]

    def sc(name):
        return float(np.asarray(getattr(p0, name)).reshape(-1)[0])

    return {
        "sinograms": sinograms,
        "angles": np.asarray(p0.angles, dtype=float).reshape(-1)
        * (np.pi / 180.0),
        "distanceSourceDetector": sc("distanceSourceDetector"),
        "distanceSourceOrigin": sc("distanceSourceOrigin"),
        "distanceOriginDetector": (sc("distanceSourceDetector")
                                   - sc("distanceSourceOrigin")),
        "geometricMagnification": sc("geometricMagnification"),
        "numDetectors": int(sc("numDetectors")),
        "pixelSize": sc("pixelSize"),
        "effectivePixelSize": sc("effectivePixelSize"),
    }


def cil_cone2d_magnification(source_origin, origin_det):
    """CIL's Cone2D magnification: (dist_source_center +
    dist_center_detector) / dist_source_center, computed from the geometry
    positions exactly as ``AcquisitionGeometry`` does (the file's
    ``geometricMagnification`` field agrees for the real bundle, but CIL
    derives it from the configured distances — so do we)."""
    return (source_origin + origin_det) / source_origin


def cil_voxel_size(pixel_size, source_origin, origin_det):
    """CIL ``get_ImageGeometry(resolution=1)``: voxel_size_xy =
    panel.pixel_size / magnification. The reference overrides
    ``voxel_num`` to 256 but keeps this default voxel *size*
    (cil_io.py:196-198)."""
    return pixel_size / cil_cone2d_magnification(source_origin, origin_det)


def gel_operator(info, nx, angle_indices):
    """Native fan-beam (Cone2D-equivalent) matrix for the gel geometry.

    Distances are converted to reconstruction-voxel units with
    v = (2 * pixelSize) / magnification (see module docstring)."""
    pixel_corr = 2.0 * info["pixelSize"]
    so = info["distanceSourceOrigin"]
    od = info["distanceOriginDetector"]
    v = cil_voxel_size(pixel_corr, so, od)
    return fan_beam_matrix(
        nx,
        angles=info["angles"][angle_indices],
        det_count=info["numDetectors"],
        det_width=pixel_corr / v,
        source_origin=so / v,
        origin_det=od / v,
    )


def generate_gelPhantom(nx=256, angle_step=20,
                        data_dir="./data/gelphantom_data"):
    """Load the gel-phantom bundle into per-frame block operators
    (reference cil_io.py:156-224). Returns (A, b, AA, B, nx, nx, nt).

    All frames share one acquisition geometry (the reference builds a
    single A_small and reuses it per frame, cil_io.py:208-218); angles are
    kept at indices range(0, n_angles, angle_step)."""
    from scipy import sparse as sp

    path = f"{data_dir}/GelPhantomData_b4.mat"
    _download(
        "https://zenodo.org/record/3696817/files/GelPhantomData_b4.mat",
        path,
    )
    info = read_frames(path)
    sinos = info["sinograms"]
    nt, n_angles, _ = sinos.shape
    keep = np.arange(0, n_angles, angle_step)
    A_t = sp.csr_matrix(gel_operator(info, nx, keep))
    AA = [A_t] * nt
    B = [sinos[i][keep].reshape(-1) for i in range(nt)]
    A = sp.block_diag(AA, format="csr")
    b = np.concatenate(B)
    return A, b, AA, B, nx, nx, nt
