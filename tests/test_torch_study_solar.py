"""The port's solar-interpolation study
(satnerf_tpu_torch/cli/study_solar_interpolation.py) against the JAX
package's (study_solar_interpolation.py) on one checkpoint the JAX package
wrote: an s-nerf 4 x 32 after two Adam steps, saved as msgpack beside a
shaded toy AOI. Both sweep three suns on the CPU; their sun, albedo and rgb
GeoTIFFs agree within 1e-4 and their summary sheets are the same images.
The port's viridis table (utils/colormap.py, the depth montage's colours)
is held against matplotlib's."""

import glob
import os

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from satnerf_tpu_torch.config import Config
from satnerf_tpu_torch.data.synthetic import make_synthetic_aoi
from satnerf_tpu_torch.geo.geotiff import read_geotiff
from satnerf_tpu_torch.utils.colormap import VIRIDIS, colormap

torch.set_num_threads(1)

RUN, N_INTERP = "shaded_jax", 3


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    import study_solar_interpolation as jax_study
    from satnerf_tpu.train.checkpoints import save_checkpoint
    from satnerf_tpu_torch.cli.study_solar_interpolation import sun_interp
    from tests.test_torch_msgpack_ckpt import jax_trained

    root = tmp_path_factory.mktemp("study_solar")
    data_dir, gt_dir = make_synthetic_aoi(str(root / "aoi"), size=16,
                                          shading=True, terrain="smooth",
                                          sun_el_range=(15.0, 40.0))
    logs, ckpts = str(root / "logs"), str(root / "ckpts")
    Config(exp_name=RUN, root_dir=data_dir, gt_dir=gt_dir, logs_dir=logs,
           ckpts_dir=ckpts, model="s-nerf", fc_layers=4, fc_units=32,
           n_samples=8, precision="float32", device="cpu").dump()
    _, state, _ = jax_trained("s-nerf", 0, fc_layers=4, fc_units=32,
                              n_samples=8)
    save_checkpoint(os.path.join(ckpts, RUN, "epoch=1.ckpt"), state)
    out_j, out_t = str(root / "jax"), str(root / "port")
    jax_study.sun_interp(RUN, logs, out_j, 1, n_interp=N_INTERP)
    sun_interp(RUN, logs, out_t, 1, n_interp=N_INTERP, device="cpu")
    return os.path.join(out_j, RUN), os.path.join(out_t, RUN)


@pytest.mark.parametrize("product", ["sun", "albedo", "rgb"])
def test_sweep_matches_the_jax_study(swept, product):
    out_j, out_t = swept
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(out_j, product, "*.tif")))
    assert len(names) == N_INTERP and all("solar_incidence_angle_" in n
                                          for n in names)
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out_t, product, "*.tif")))
    maps = []
    for name in names:
        a = read_geotiff(os.path.join(out_j, product, name)).data
        b = read_geotiff(os.path.join(out_t, product, name)).data
        np.testing.assert_allclose(b, a, atol=1e-4, err_msg=name)
        maps.append(b)
    if product == "sun":  # the suns differ, and so do the maps
        assert not np.allclose(maps[0], maps[-1], atol=1e-3)
    sheet = {s: np.asarray(Image.open(os.path.join(d, "summary",
                                                   f"{product}.png")))
             for s, d in (("jax", out_j), ("port", out_t))}
    assert np.abs(sheet["port"].astype(int) - sheet["jax"]).max() <= 1


def test_depth_sheet_matches_the_jax_study(swept):
    out_j, out_t = swept
    a, b = (np.asarray(Image.open(os.path.join(d, "summary", "depth_v1.png")))
            for d in swept)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    # depths within 1e-4 may fall on either side of a colour bin
    assert np.mean(np.abs(a.astype(int) - b) > 2) < 0.01


def test_viridis_is_matplotlibs():
    cmap = matplotlib.colormaps["viridis"]
    assert np.array_equal(VIRIDIS, np.asarray(cmap.colors))
    x = np.concatenate([np.linspace(0.0, 1.0, 4097),
                        [1 - 1e-12, 255.5 / 256, -0.2, 1.3, np.nan]])
    np.testing.assert_array_equal(colormap(x), cmap(x)[..., :3])
    img = np.random.RandomState(0).rand(7, 9)
    np.testing.assert_array_equal((colormap(img) * 255).astype(np.uint8),
                                  (cmap(img)[..., :3] * 255).astype(np.uint8))
