"""The port's synthetic AOI (satnerf_tpu_torch/data/synthetic.py) against the
JAX package's recipe (tools/make_synthetic_aoi.py over tests/fixtures.py), at
a small size, with each of its options: the same seed gives the same RPCs
and metadata (1e-9 relative: the same float64 numpy steps on both sides,
the RPC shifts of --rpc_noise too), the same uint8 images with the same
painted transients and their masks (bit for bit), the same key points (pts3d.npy bit for bit, the per-image 2d
coordinates to 1e-9 relative), and the same GT rasters (1e-6 m)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from satnerf_tpu_torch.data import synthetic
from satnerf_tpu_torch.geo.geotiff import read_geotiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "box": (["--size", "14"], dict(size=14)),
    "smooth_shaded_seed3": (
        ["--size", "12", "--terrain", "smooth", "--shading", "--seed", "3",
         "--n_train", "2", "--n_test", "1", "--alt_bounds", "terrain"],
        dict(size=12, terrain="smooth", shading=True, seed=3, n_train=2,
             n_test=1, alt_bounds="terrain")),
    "keypoints": (["--size", "12", "--keypoints", "25", "--seed", "5"],
                  dict(size=12, with_keypoints=True, n_kp=25, seed=5)),
    "keypoints_shaded": (
        ["--size", "10", "--keypoints", "12", "--shading", "--n_train", "2",
         "--n_test", "1"],
        dict(size=10, with_keypoints=True, n_kp=12, shading=True, n_train=2,
             n_test=1)),
    "shaded_sun_ranges": (
        ["--size", "10", "--terrain", "smooth", "--shading", "--sun_el", "15",
         "40", "--sun_az", "100", "200", "--n_train", "2", "--n_test", "1"],
        dict(size=10, terrain="smooth", shading=True, sun_el_range=(15.0, 40.0),
             sun_az_range=(100.0, 200.0), n_train=2, n_test=1)),
    "transients": (
        ["--size", "12", "--transient_frac", "1.0", "--transient_size", "3",
         "--n_transients", "3", "--n_train", "3", "--n_test", "1", "--seed",
         "2"],
        dict(size=12, transient_frac=1.0, transient_size=3, n_transients=3,
             n_train=3, n_test=1, seed=2)),
    "transients_half_default_size_keypoints": (
        ["--size", "12", "--transient_frac", "0.5", "--n_train", "4",
         "--n_test", "1", "--keypoints", "10", "--shading"],
        dict(size=12, transient_frac=0.5, n_train=4, n_test=1,
             with_keypoints=True, n_kp=10, shading=True)),
    "rpc_noise_keypoints": (
        ["--size", "10", "--rpc_noise", "2.5", "--keypoints", "10",
         "--n_train", "2", "--n_test", "1", "--seed", "4"],
        dict(size=10, rpc_noise_px=2.5, with_keypoints=True, n_kp=10,
             n_train=2, n_test=1, seed=4)),
}


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-9, abs=1e-12), path
    else:
        assert a == b, path


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_seed_same_files_as_the_jax_recipe(tmp_path, case):
    argv, kw = CASES[case]
    ref, got = str(tmp_path / "ref"), str(tmp_path / "got")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools", "make_synthetic_aoi.py"), ref,
                    *argv], check=True, cwd=REPO, env=env, timeout=300,
                   stdout=subprocess.DEVNULL)
    data_dir, gt_dir = synthetic.make_synthetic_aoi(got, **kw)
    assert data_dir == os.path.join(got, "data")
    for sub in ("data", "gt"):
        assert sorted(os.listdir(os.path.join(ref, sub))) == sorted(
            os.listdir(os.path.join(got, sub))), sub
    for name in sorted(os.listdir(os.path.join(ref, "data"))):
        a, b = (os.path.join(d, "data", name) for d in (ref, got))
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                _close(json.load(fa), json.load(fb), name)
        elif name.endswith(".tif"):
            ia, ib = read_geotiff(a), read_geotiff(b)
            assert ia.data.dtype == ib.data.dtype == np.uint8
            assert np.array_equal(ia.data, ib.data), name
        elif name == "pts3d.npy" or name.endswith("_TRANSIENT.npy"):
            assert np.array_equal(np.load(a), np.load(b)), name
        elif name.endswith(".npy"):
            np.testing.assert_allclose(np.load(b), np.load(a), atol=1e-7)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name
    da = read_geotiff(os.path.join(ref, "gt", "SYN_000_DSM.tif"))
    db = read_geotiff(os.path.join(got, "gt", "SYN_000_DSM.tif"))
    np.testing.assert_allclose(db.data, da.data, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(
        np.loadtxt(os.path.join(got, "gt", "SYN_000_DSM.txt")),
        np.loadtxt(os.path.join(ref, "gt", "SYN_000_DSM.txt")))
    assert np.array_equal(
        read_geotiff(os.path.join(got, "gt", "SYN_000_CLS.tif")).data,
        read_geotiff(os.path.join(ref, "gt", "SYN_000_CLS.tif")).data)
    has_kp = os.path.exists(os.path.join(got, "data", "pts3d.npy"))
    assert has_kp == kw.get("with_keypoints", False)
    if has_kp:
        with open(os.path.join(got, "data", "SYN_000_000_RGB.json")) as f:
            kp = json.load(f)["keypoints"]
        assert len(kp["2d_coordinates"]) == len(kp["pts3d_indices"]) > 0


def test_rpc_noise_keeps_the_images_of_its_ba_sibling(tmp_path):
    """The same seed with and without --rpc_noise: the same images and key
    points, and RPCs that differ by a shift of the offsets only."""
    kw = dict(size=10, n_train=2, n_test=1, with_keypoints=True, n_kp=10,
              transient_frac=1.0, seed=6)
    clean, _ = synthetic.make_synthetic_aoi(str(tmp_path / "ba"), **kw)
    noisy, _ = synthetic.make_synthetic_aoi(str(tmp_path / "noba"),
                                            rpc_noise_px=2.5, **kw)
    for name in sorted(os.listdir(clean)):
        a, b = os.path.join(clean, name), os.path.join(noisy, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                ja, jb = json.load(fa), json.load(fb)
            ra, rb = ja.pop("rpc"), jb.pop("rpc")
            assert ja == jb, name
            moved = {k for k in ra if ra[k] != rb[k]}
            assert moved == {"col_offset", "row_offset"}, name
            assert all(abs(ra[k] - rb[k]) <= 2.5 for k in moved), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_module_entry_point(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    out = str(tmp_path / "aoi")
    proc = subprocess.run([sys.executable, "-m",
                           "satnerf_tpu_torch.data.synthetic", out, "--size",
                           "8", "--n_train", "2", "--n_test", "1",
                           "--keypoints", "9", "--transient_frac", "1",
                           "--rpc_noise", "1.5"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "synthetic AOI ready" in proc.stdout
    with open(os.path.join(out, "data", "train.txt")) as f:
        assert len(f.read().split()) == 2
    assert os.path.exists(os.path.join(out, "gt", "SYN_000_DSM.tif"))
    assert np.load(os.path.join(out, "data", "pts3d.npy")).shape == (9, 3)
    mask = np.load(os.path.join(out, "data", "SYN_000_001_RGB_TRANSIENT.npy"))
    assert mask.shape == (8, 8) and mask.dtype == bool and mask.any()
