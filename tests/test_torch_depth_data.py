"""The port's depth-supervision dataset (data/satellite_depth.py) against
the JAX package's on the same synthetic AOI with key points: the same rays,
depth targets, weights and image ids (the same float64 numpy steps on both
sides, so the float32 arrays are equal), and the dataset factory's
[color, depth] list."""

import json
import os

import numpy as np
import pytest

from satnerf_tpu.data.satellite_depth import SatelliteDepthScene as JaxDepthScene
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.data import SatelliteDepthScene, load_dataset
from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_aoi")
    data_dir, gt_dir = make_synthetic_aoi(str(root), size=12, with_keypoints=True,
                                          n_kp=30)
    return data_dir, gt_dir


@pytest.mark.parametrize("downscale", [1.0, 2.0])
def test_arrays_equal_the_jax_class(aoi, downscale):
    data_dir, _ = aoi
    ref = JaxDepthScene(data_dir, img_downscale=downscale)
    got = SatelliteDepthScene(data_dir, img_downscale=downscale)
    assert len(got) == len(ref) > 30  # most tie points are seen by 3 images
    for name in ("all_rays", "all_depths", "all_ids", "tie_points"):
        a, b = getattr(ref, name), getattr(got, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert got.all_rays.shape[1] == 11 and got.all_depths.shape[1] == 2
    depth, weight = got.all_depths[:, 0], got.all_depths[:, 1]
    near, far = got.all_rays[:, 6], got.all_rays[:, 7]
    assert ((depth > near) & (depth < far)).all()  # the targets lie on the rays
    assert ((weight > 0) & (weight <= 1)).all()
    assert set(got.all_ids) == {0, 1, 2}


def test_factory_returns_color_and_depth_sets(aoi):
    data_dir, gt_dir = aoi
    cfg = Config(root_dir=data_dir, gt_dir=gt_dir, ds_lambda=1000.0)
    train = load_dataset(cfg, "train")
    assert [type(d).__name__ for d in train] == ["SatelliteScene",
                                                 "SatelliteDepthScene"]
    assert train[0].all_rays.shape[0] == 3 * 12 * 12
    assert len(load_dataset(cfg, "val")) == 1
    assert len(load_dataset(Config(root_dir=data_dir), "train")) == 1


def test_missing_key_point_files_raise(aoi, tmp_path):
    import shutil

    data_dir, _ = aoi
    no_pts = tmp_path / "no_pts"
    shutil.copytree(data_dir, no_pts)
    os.remove(no_pts / "pts3d.npy")
    with pytest.raises(FileNotFoundError, match="pts3d.npy"):
        SatelliteDepthScene(str(no_pts))

    no_kp = tmp_path / "no_kp"
    shutil.copytree(data_dir, no_kp)
    path = no_kp / "SYN_000_001_RGB.json"
    meta = json.loads(path.read_text())
    del meta["keypoints"]
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="keypoints"):
        SatelliteDepthScene(str(no_kp))
