"""Support modules of the port against trips_tpu on the CPU, and the exact
chord oracle of the fan-beam matrix.

- ``Tomography.gen_true("SL60" | "SL90" | "head")`` and ``gen_saved_data``
  return the JAX package's arrays bit for bit on fixture ``.mat`` files
  each test writes into a ``tmp_path`` (a grey image at the grid's size,
  one to resize, an RGB one; the saved A/b bundles in the layout of
  ``tests/test_dataset_fixtures.py``); nothing downloads. ``plot_rec``
  saves an image under matplotlib's Agg backend.
- The fan-beam matrix against the exact length of each ray's chord
  through each pixel's square (the ray clipped to the square, in float64
  from the builder's own source and detector points), at nx = 32 and 40
  with 12 views. A ray that runs along a grid line (within 1e-9 over its
  path through the image) has a chord of the same length in the two
  squares beside the line, and which one holds it is a convention: such a
  row is held to the chord's total, and each entry to the square it may
  lie in. Every other entry is held to 1e-9. The C++ builder that
  ``trips_tpu`` takes when ``trips_tpu/native/libprojector.so`` loads is
  held to the same oracle (that part skips where the library does not
  load; nothing builds it).
- ``telemetry``: ``Timer`` and ``SolverTrace`` keep JAX's records (the
  clock's readings aside), ``profile`` writes a Chrome trace on the CPU,
  and ``device_busy_ms`` takes the union of a card profile's device
  intervals and refuses a CPU profile and a card profile that recorded
  no device time.
- ``config``: JAX's constants and ``round_up``.
"""
import json
import os

import numpy as np
import pytest
import scipy.io as spio
import torch
from scipy import sparse as sp

import trips_tpu.config as jconfig
import trips_tpu.problems as jp
import trips_tpu.utils.telemetry as jtel
import trips_tpu_torch.config as tconfig
import trips_tpu_torch.problems as tp
import trips_tpu_torch.utils.telemetry as ttel

from torch_threads import one_torch_thread  # noqa: F401

NATIVE = os.path.join(os.path.dirname(jp.__file__), os.pardir, "native",
                      "libprojector.so")
EDGE_TOL, CHORD_ATOL = 1e-9, 1e-9


# ---- Tomography on fixture files ---------------------------------------
@pytest.fixture
def image_data(tmp_path, monkeypatch):
    """./data/image_data with SL60 (16x16, the grid's size), SL90 (20x24,
    resized), head (RGB 18x18, mixed and resized) and the saved A/b
    bundles."""
    rng = np.random.default_rng(4)
    d = tmp_path / "data" / "image_data"
    d.mkdir(parents=True)
    q, p, n = 6, 8, 16
    A = sp.random(p * q, n, density=0.4, format="csc",
                  random_state=np.random.RandomState(6))
    b = rng.random((1, p * q))
    geometry = {"A": A, "phi": np.zeros((1, q)), "s": np.zeros((1, p))}
    for name, shape in (("SL60", (16, 16)), ("SL90", (20, 24)),
                        ("head", (18, 18, 3))):
        spio.savemat(d / f"{name}.mat", {"x_true": rng.random(shape),
                                         "b": b})
    for name in ("CT60", "CT90", "CT200"):
        spio.savemat(d / f"{name}.mat", geometry)
    monkeypatch.chdir(tmp_path)
    return A


@pytest.mark.parametrize("name", ["SL60", "SL90", "head"])
def test_image_phantoms_match_jax(image_data, name):
    xj, nxj, nyj = jp.Tomography().gen_true(name, nx=16, ny=16)
    xt, nxt, nyt = tp.Tomography(device="cpu").gen_true(name, nx=16, ny=16)
    assert (nxt, nyt) == (nxj, nyj) == (16, 16)
    assert xt.dtype == xj.dtype and np.array_equal(xt, xj)
    assert xt.shape == (256, 1) and np.isfinite(xt).all()


@pytest.mark.parametrize("dataset", [60, 90, "head"])
def test_saved_data_matches_jax(image_data, dataset):
    tj, tt = jp.Tomography(), tp.Tomography(device="cpu")
    Aj, xj, bj = tj.gen_saved_data(dataset)
    At, xt, bt = tt.gen_saved_data(dataset)
    assert (sp.csr_matrix(At) != sp.csr_matrix(Aj)).nnz == 0
    assert (sp.csr_matrix(At) != sp.csr_matrix(image_data)).nnz == 0
    assert np.array_equal(xt, xj) and np.array_equal(bt, bj)
    assert bt.shape == (48, 1)
    assert (tt.p, tt.q) == (tj.p, tj.q) == (8, 6)


def test_plot_rec_saves_image(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tomo = tp.Tomography(device="cpu")
    x, nx, ny = tomo.gen_true("shepp_logan", nx=16, ny=16)
    tomo.plot_rec(torch.from_numpy(x), save_imgs=True,
                  save_path=str(tmp_path / "rec"))
    plt.close("all")
    assert (tmp_path / "rec" / "rec.png").stat().st_size > 0


# ---- the exact chord oracle --------------------------------------------
def _rays(nx, views):
    """Every ray of ``fan_beam_matrix(nx, views=views)``, row order: its
    source S and direction D (source to detector cell), as the builder
    makes them."""
    angles = np.linspace(0, np.pi, views, endpoint=False)
    p = int(np.sqrt(2) * nx)
    so, od = 3 * nx, nx
    offs = (np.arange(p) - (p - 1) / 2) * ((so + od) / so)
    S, D = [], []
    for th in angles:
        s = np.array([so * np.sin(th), -so * np.cos(th)])
        d0 = np.array([-od * np.sin(th), od * np.cos(th)])
        u = np.array([np.cos(th), np.sin(th)])
        dets = d0[None, :] + offs[:, None] * u[None, :]
        S.append(np.broadcast_to(s, dets.shape))
        D.append(dets - s)
    return np.concatenate(S), np.concatenate(D)


def _clip(S, D, lo_x, hi_x, lo_y, hi_y):
    """Parameter interval [t0, t1] (within the source-detector segment
    [0, 1]) of each ray inside each box; boxes broadcast against rays."""
    def slab(lo, hi, s, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            a, b = (lo - s) / d, (hi - s) / d
        inside = (s >= lo) & (s <= hi)
        par = d == 0
        return (np.where(par, np.where(inside, -np.inf, np.inf),
                         np.minimum(a, b)),
                np.where(par, np.where(inside, np.inf, -np.inf),
                         np.maximum(a, b)))
    ax, bx = slab(lo_x, hi_x, S[:, :1], D[:, :1])
    ay, by = slab(lo_y, hi_y, S[:, 1:], D[:, 1:])
    return (np.maximum(np.maximum(ax, ay), 0.0),
            np.minimum(np.minimum(bx, by), 1.0))


def chord_oracle(nx, views):
    """(exact chord lengths (rays, nx*nx) with pixel = row*nx + col, row 0
    at the top; the same through each square grown by EDGE_TOL on every
    side; the rays that run along a grid line; each ray's chord through
    the whole image)."""
    S, D = _rays(nx, views)
    norm = np.linalg.norm(D, axis=1)
    j = np.arange(nx)
    x0 = np.tile(-nx / 2 + j, nx)[None, :]          # column j's left edge
    y0 = np.repeat(nx / 2 - j - 1, nx)[None, :]     # row i's bottom edge

    def chords(g):
        t0, t1 = _clip(S, D, x0 - g, x0 + 1 + g, y0 - g, y0 + 1 + g)
        return np.clip(t1 - t0, 0, None) * norm[:, None]

    L, L_near = chords(0.0), chords(EDGE_TOL)
    h = nx / 2
    e0, e1 = _clip(S, D, -h, h, -h, h)
    total = np.clip(e1 - e0, 0, None)[:, 0] * norm
    # along a grid line: both ends of the in-image part within EDGE_TOL of
    # the same line x = k or y = k
    edge = np.zeros(len(S), bool)
    for a in (0, 1):
        ends = S[:, a:a + 1] + np.concatenate([e0, e1], 1) * D[:, a:a + 1]
        k = np.round(ends[:, :1] + h)
        edge |= (np.abs(ends + h - k) <= EDGE_TOL).all(1) & (total > 0)
    return L, L_near, edge, total


def _hold_to_oracle(M, nx, views):
    """-> the rays along a grid line, after holding ``M`` (rays, pixels)
    to the oracle."""
    L, L_near, edge, total = chord_oracle(nx, views)
    off = ~edge
    assert np.abs(M[off] - L[off]).max() <= CHORD_ATOL
    # along a grid line: the chord's total, each entry in a square beside
    # the line, at most that square's share
    assert (np.abs(M[edge].sum(1) - total[edge]) <= CHORD_ATOL).all()
    assert (M[edge] <= L_near[edge] + CHORD_ATOL).all()
    return np.flatnonzero(edge)


@pytest.mark.parametrize("nx", [32, 40])
def test_numpy_builder_matches_chord_oracle(nx, monkeypatch):
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")
    M = tp.fan_beam_matrix(nx, views=12).toarray()
    edge = _hold_to_oracle(M, nx, 12)
    # nx = 32, p = 45: the middle ray of the angles 0 and pi/2 runs along
    # the grid line through the centre (pi/2's within 1e-14); nx = 40, p =
    # 56: no ray does
    p = int(np.sqrt(2) * nx)
    assert edge.tolist() == ([p // 2, 6 * p + p // 2] if p % 2 else [])


def test_native_builder_matches_chord_oracle(monkeypatch):
    """The C++ builder on the same oracle: it agrees with the NumPy one
    except in which square beside the line it puts the pi/2 middle ray's
    chord."""
    if not os.path.exists(NATIVE):
        pytest.skip("trips_tpu/native/libprojector.so is not built")
    monkeypatch.delenv("TRIPS_TPU_NO_NATIVE", raising=False)
    from trips_tpu.native import fan_beam_csr_native

    nx, views = 32, 12
    p, so, od = int(np.sqrt(2) * nx), 3 * nx, nx
    A = fan_beam_csr_native(nx, nx, np.linspace(0, np.pi, views,
                                                endpoint=False),
                            p, (so + od) / so, so, od)
    if A is None:
        pytest.skip("libprojector.so does not load here")
    A.sum_duplicates()
    M = A.toarray()
    edge = _hold_to_oracle(M, nx, views)
    monkeypatch.setenv("TRIPS_TPU_NO_NATIVE", "1")  # the port's NumPy builder
    Mn = tp.fan_beam_matrix(nx, views=views).toarray()
    rows = np.unique(np.nonzero(np.abs(M - Mn) > CHORD_ATOL)[0])
    assert rows.tolist() == [6 * p + p // 2] and set(rows) <= set(edge)


# ---- telemetry, config ---------------------------------------------------
def _fixed_clock(monkeypatch, *mods):
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    for mod in mods:
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))


def test_timer_and_trace_match_jax(monkeypatch, capsys):
    out = {}
    for mod in (jtel, ttel):
        _fixed_clock(monkeypatch, mod)
        timer = mod.Timer()
        for name in ("apply", "apply", "solve"):
            with timer.scope(name):
                pass
        trace = mod.SolverTrace(log_every=2, name="gks")
        for it in range(1, 4):
            trace(it, lam=0.5 / it, relError=1.0 / it)
        out[mod] = (timer.report(), trace.records, trace.summary(),
                    capsys.readouterr().out)
    assert out[ttel] == out[jtel]
    assert out[ttel][0]["apply"]["count"] == 2
    assert out[ttel][3].startswith("[gks] ")


def test_profile_writes_trace_on_cpu(tmp_path):
    with ttel.profile(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones(64).mul_(2).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(ValueError, match="no CUDA device"):
        ttel.device_busy_ms(prof)


def test_device_busy_refuses_an_empty_card_profile():
    """A card profile's busy time is the union of its device events'
    intervals: two overlapping kernels (two streams) count once, and an aten
    op, which the profiler also credits with its kernels' time, and a span's
    annotation on the device's timeline not at all; a card profile with no
    device time raises."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def event(a, b, device_type, annotation=False):
        return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b),
                               device_type=device_type,
                               is_user_annotation=annotation)

    class Profile:
        activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        evts = []

        def events(self):
            return self.evts

    prof = Profile()
    prof.evts = [event(5.0, 5.0, DeviceType.CUDA),
                 event(0.0, 700.0, DeviceType.CPU)]
    with pytest.raises(RuntimeError, match="no device kernel"):
        ttel.device_busy_ms(prof)
    prof.evts = [event(1000.0, 2500.0, DeviceType.CUDA),
                 event(2000.0, 3000.0, DeviceType.CUDA),  # another stream
                 event(4000.0, 5500.0, DeviceType.CUDA),
                 event(900.0, 5600.0, DeviceType.CUDA, annotation=True),
                 event(1000.0, 2500.0, DeviceType.CPU)]  # the op of one
    assert ttel.device_busy_ms(prof) == 3.5


def test_config_matches_jax():
    assert (tconfig.LANE, tconfig.SUBLANE) == (jconfig.LANE, jconfig.SUBLANE)
    for x, m in ((0, 8), (1, 8), (8, 8), (129, 128), (300, 7)):
        assert tconfig.round_up(x, m) == jconfig.round_up(x, m)
    assert tconfig.default_dtype() == torch.get_default_dtype()
    assert tconfig.is_cuda() == torch.cuda.is_available()
