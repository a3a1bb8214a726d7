"""The port's twins of the demos (``trips_tpu_torch/demos/``) on the CPU
at small sizes, against the JAX demos on the same arguments.

Each twin runs through its ``main`` with ``--device cpu``; its relErrors
(float32, as the JAX demos run with x64 off) are held to the JAX demo's
to one unit of the 4 decimals the demos print. Every JAX demo at these
sizes takes 6-25 s on the CPU (JAX's compiles), more than this file's
budget, so the JAX values are constants: the relErrors its ``relerr``
returned, in order, from

    python3 demo_reference.py twins_small

(JAX 0.9.0, x64 off, trips_tpu's C++ matrix builder; ``TWINS_SMALL``
there holds the arguments below), and ``python3 demo_reference.py
data_twins`` for the two data demos (``demo_saved_data`` on the bundles
of ``tests/torch_saved_bundles.py``; without them it prints where to put
them and solves nothing). The fused dynamic twin's resume must
equal its uninterrupted run bit for bit, as the JAX demo asserts. The
dynamic twin's loaders read only files already present: without one
they raise, before any solve. ``tests/test_torch_demos_jax.py`` runs each
twin's own problem and solves against the JAX demo's, live, in float64.
"""
import numpy as np
import pytest

from trips_tpu_torch.demos import (demo_1d_deblurring, demo_2d_deblurring,
                                   demo_dynamic_ct, demo_fused_dynamic,
                                   demo_fused_tpu, demo_saved_data,
                                   demo_tomography, demo_your_data)

import torch_saved_bundles
from torch_threads import one_torch_thread  # noqa: F401

# one unit of the printed 4 decimals; the tomo configuration's 20-step
# float32 Krylov solves on the bfloat16 pack (fused Hybrid LSQR, cgls,
# cgls_normal), 1e-3: two correct float32 CG implementations part by up
# to that much (ROADMAP Queue 3 item 4; here 1.4e-4 to 4.4e-4, the fused
# GKS and MMGKS solves before them 1e-6 to 1.4e-5)
TOL = 1e-4
CG_TOL = {("demo_fused_tpu tomo", k): 1e-3 for k in (4, 5, 6)}

# twin -> (its module, the arguments, the JAX demo's relErrors)
TWINS = {
    "demo_tomography": (
        demo_tomography, ["--n", "16", "--views", "12", "--iters", "8"],
        [0.1990576563065749, 0.1920837336231441, 0.19370682422794303,
         0.17559291968922172]),
    "demo_1d_deblurring": (
        demo_1d_deblurring, ["--n", "120", "--iters", "10"],
        [0.9441402407066513, 0.07578386481724646, 0.24398568399594503,
         0.0821773520115148, 0.07804313868533595, 0.07417797122696357]),
    "demo_2d_deblurring": (
        demo_2d_deblurring, ["--n", "24", "--iters", "8"],
        [0.12001951506578276, 0.12001946501915235, 0.1949797548125655,
         0.2896119472961446, 0.07487119183354071, 0.21531407980629594]),
    "demo_fused_tpu deblur1d": (
        demo_fused_tpu, ["--config", "deblur1d", "--n", "200", "--iters",
                         "8"],
        [0.02506360512274479, 0.03325031648484584, 0.023102963315707527,
         0.02506502303545112, 0.027720378021863532, 0.0279952084243336,
         0.028460495108796915]),
    "demo_fused_tpu tomo": (
        demo_fused_tpu, ["--config", "tomo", "--nx", "24", "--views", "32",
                         "--iters", "4"],
        [0.14663775265216827, 0.12230034917593002, 0.12251363694667816,
         0.12057560682296753, 0.06614407151937485, 0.06643211841583252,
         0.06637731194496155]),
    "demo_fused_dynamic": (
        demo_fused_dynamic, ["--nx", "16", "--nt", "2", "--views", "9",
                             "--n_iter", "7"],
        [0.1985940565947027, 0.18214381248501338, 0.19859452173293815]),
    "demo_dynamic_ct": (
        demo_dynamic_ct, ["--nx", "16", "--nt", "2", "--iters", "4"],
        [0.17849920330922756, 0.17855976368154883, 0.17082920078804906,
         0.1681920933486231, 0.2018009271076798]),
    "demo_your_data": (
        demo_your_data, ["--n", "32", "--iters", "5"],
        [0.21864992604414046]),
}
# demo_saved_data --iters 6 on tests/torch_saved_bundles.py's bundles
SAVED_DATA = (["--iters", "6"], [0.10586174085818384, 0.18795260590546506])


@pytest.mark.parametrize("twin", list(TWINS))
def test_twin_matches_jax_demo(twin, capsys):
    mod, argv, ref = TWINS[twin]
    out = mod.main(argv + ["--device", "cpu"])
    if twin == "demo_fused_dynamic":
        out, same = out
        assert same  # the resumed run bit for bit (the demo asserts it too)
    printed = capsys.readouterr().out
    errs = list(out.values())
    assert len(errs) == len(ref)
    assert all(np.isfinite(errs))
    for k, (name, err, r) in enumerate(zip(out, errs, ref)):
        assert abs(err - r) <= CG_TOL.get((twin, k), TOL), (name, err, r)
        assert f"{err:.4f}" in printed, name


def test_saved_data_twin_matches_jax_demo(tmp_path, monkeypatch, capsys):
    torch_saved_bundles.write(tmp_path)
    monkeypatch.chdir(tmp_path)
    argv, ref = SAVED_DATA
    out = demo_saved_data.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert list(out) == ["GKS (lam=1)", "MMGKS (lam=1e-3)"]
    for (name, err), r in zip(out.items(), ref):
        assert abs(err - r) <= TOL, (name, err, r)
        assert f"{err:.4f}" in printed, name


def test_saved_data_twin_without_bundles(tmp_path, monkeypatch, capsys):
    """Without the bundles under ``./data/image_data`` the twin prints the
    JAX demo's guidance and solves nothing; it fetches nothing."""
    monkeypatch.chdir(tmp_path)
    assert demo_saved_data.main(["--device", "cpu"]) is None
    printed = capsys.readouterr().out
    assert printed.startswith("saved-data bundles unavailable:")
    assert "./data/image_data to run this demo." in printed
    assert not any(tmp_path.rglob("*"))


def test_dynamic_loaders_never_download(tmp_path, monkeypatch):
    """Without its file under ``./data`` a dataset raises, as the JAX
    loader does where it cannot fetch one; nothing is solved."""
    monkeypatch.chdir(tmp_path)
    for name in ("emoji", "crossphantom"):
        with pytest.raises(FileNotFoundError):
            demo_dynamic_ct.main(["--dataset", name, "--device", "cpu"])
    assert not any(tmp_path.rglob("*.mat"))
