"""The port's copy of the blender dataset (satnerf_tpu_torch/data/blender.py)
against the JAX package's (satnerf_tpu/data/blender.py), array for array, on
the fixture tests/test_blender.py builds: a camera ring around a shaded ball,
RGBA PNGs and transforms jsons. Both are numpy and Pillow only, so the arrays
are held to equality."""

import numpy as np
import pytest

from satnerf_tpu.data import blender as jax_blender
from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.data import BlenderScene, load_dataset
from satnerf_tpu_torch.data import blender as port_blender
from tests.test_blender import build_blender_fixture


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    return build_blender_fixture(str(tmp_path_factory.mktemp("blender_t")))


@pytest.mark.parametrize("perturbation", [(), ("color",), ("color", "occ")],
                         ids=["clean", "color", "color_occ"])
def test_train_split_equals_the_jax_package(blender_root, perturbation):
    kw = dict(split="train", img_wh=(32, 32), perturbation=perturbation)
    ours = BlenderScene(blender_root, **kw)
    ref = jax_blender.BlenderScene(blender_root, **kw)
    assert len(ours) == len(ref) == 3 * 32 * 32
    for name in ("all_rays", "all_rgbs", "all_ids"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # (N, 8): origin, direction, near, far, and no sun direction
    assert ours.all_rays.shape[1] == 8
    np.testing.assert_array_equal(ours.all_rays[:, 6:8],
                                  np.broadcast_to([2.0, 6.0], (len(ours), 2)))
    np.testing.assert_array_equal(ours.K, ref.K)


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_splits_equal_the_jax_package(blender_root, split):
    ours = BlenderScene(blender_root, split=split, img_wh=(32, 32))
    ref = jax_blender.BlenderScene(blender_root, split=split, img_wh=(32, 32))
    assert len(ours) == len(ref) == 2
    assert not hasattr(ours, "all_rays")
    for i in range(len(ours)):
        a, b = ours.load_image(i), ref.load_image(i)
        assert set(a) == set(b) == {"rays", "rgbs", "ts", "src_id", "h", "w"}
        for k in ("rays", "rgbs", "ts"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {i} {k}")
        assert (a["src_id"], a["h"], a["w"]) == (b["src_id"], b["h"], b["w"])


def test_ray_helpers_equal_the_jax_package():
    k = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]])
    dirs = port_blender.pinhole_ray_directions(32, 24, k)
    np.testing.assert_array_equal(
        dirs, jax_blender.pinhole_ray_directions(32, 24, k))
    assert dirs.shape == (32, 24, 3)
    rng = np.random.RandomState(0)
    c2w = rng.randn(3, 4)
    for a, b in zip(port_blender.pinhole_rays(dirs, c2w),
                    jax_blender.pinhole_rays(dirs, c2w)):
        np.testing.assert_array_equal(a, b)


def test_load_dataset_serves_blender_and_refuses_unknown_data(blender_root):
    """`--data blender` no longer raises: one color dataset, never a depth
    dataset (key points exist for satellite scenes only)."""
    for split in ("train", "val"):
        sets = load_dataset(Config(data="blender", root_dir=blender_root,
                                   ds_lambda=1.0), split)
        assert len(sets) == 1 and isinstance(sets[0], BlenderScene)
        assert sets[0].img_wh == (400, 400)  # the reference's default size
    with pytest.raises(ValueError, match="not valid"):
        load_dataset(Config(data="lidar", root_dir=blender_root), "train")
