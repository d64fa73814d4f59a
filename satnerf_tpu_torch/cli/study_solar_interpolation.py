"""The solar-interpolation study on the PyTorch port (counterpart of
study_solar_interpolation.py, the reference's `sun_interp`): render the
most-nadir view under `n_interp` sun directions interpolated between the
dataset's most- and least-nadir suns, then write hstacked summary PNGs of
sun / albedo / rgb / depth.

  python -m satnerf_tpu_torch.cli.study_solar_interpolation --run_id RUN \
      --logs_dir logs --output_dir out --epoch_number 28 [--n_interp 10] \
      [--checkpoints_dir ckpts] [--root_dir ...] [--img_dir ...] \
      [--gt_dir ...] [--device cuda]

The checkpoint may be the port's or the JAX package's (train/checkpoints.py
reads both). The views render on the cards eval/loader.py's `render_ranks`
gives (opts.json's n_devices, one where the views are too few to repay
starting ranks); rank 0 alone writes and prints. The
depth montage is coloured with the port's own viridis table
(utils/colormap.py): the machine with the card has no matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np
from PIL import Image

from satnerf_tpu_torch.geo.geotiff import read_geotiff
from satnerf_tpu_torch.utils.colormap import colormap


def _crop_center(img):
    h, w = img.shape[:2]
    return img[h // 4: 3 * h // 4, w // 4: 3 * w // 4]


def _read_hwc(paths, crop):
    images = []
    for p in paths:
        img = np.moveaxis(read_geotiff(p).data, 0, -1)
        images.append(_crop_center(img) if crop else img)
    return images


def hstack_sun_tifs(img_paths, crop=True):
    img = np.hstack(_read_hwc(img_paths, crop))[:, :, 0]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def hstack_rgb_tifs(img_paths, crop=True):
    return (np.clip(np.hstack(_read_hwc(img_paths, crop)), 0, 1)
            * 255).astype(np.uint8)


def interpolate_nans(image, method="nearest"):
    """Fill NaNs from the nearest finite neighbours
    (study_solar_interpolation.py:53-68)."""
    from scipy import interpolate

    h, w = image.shape[:2]
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    mask = np.isnan(image.reshape(h, w))
    if not mask.any():
        return image
    vals = interpolate.griddata((xx[~mask], yy[~mask]), image[~mask],
                                (xx[mask], yy[mask]), method=method)
    out = image.copy()
    out[mask] = vals
    return out


def hstack_depth_tifs(img_paths, crop=True, vmin=None, vmax=None):
    images = []
    for img in _read_hwc(img_paths, crop):
        x = interpolate_nans(img[:, :, 0])
        mi = np.min(x) if vmin is None else vmin
        ma = np.max(x) if vmax is None else vmax
        x = (np.clip(x, mi, ma) - mi) / (ma - mi + 1e-8)
        images.append((colormap(x) * 255).astype(np.uint8))
    return np.hstack(images)


def sun_interp(run_id, logs_dir, output_dir, epoch_number,
               checkpoints_dir=None, root_dir=None, img_dir=None, gt_dir=None,
               n_interp: int = 10, device: str = "cuda"):
    from satnerf_tpu_torch.eval.loader import run_on_devices
    from satnerf_tpu_torch.utils.sort import \
        sort_by_increasing_view_incidence_angle

    run_on_devices(_sun_interp, (run_id, logs_dir, output_dir, epoch_number,
                                 checkpoints_dir, root_dir, img_dir, gt_dir,
                                 n_interp, device),
                   logs_dir, run_id, device, root_dir,
                   lambda root: sort_by_increasing_view_incidence_angle(
                       root)[:1] * n_interp)


def _sun_interp(run_id, logs_dir, output_dir, epoch_number, checkpoints_dir,
                root_dir, img_dir, gt_dir, n_interp, device):
    from satnerf_tpu_torch.data.rays import (solar_incidence_angle_deg,
                                             sun_direction)
    from satnerf_tpu_torch.data.satellite import SatelliteScene
    from satnerf_tpu_torch.eval import (predefined_val_ts,
                                        save_nerf_output_to_images)
    from satnerf_tpu_torch.eval.loader import load_run
    from satnerf_tpu_torch.parallel import distributed as D
    from satnerf_tpu_torch.utils.sort import \
        sort_by_increasing_view_incidence_angle

    main = D.is_main()
    cfg, system, params = load_run(run_id, logs_dir, epoch_number,
                                   checkpoints_dir, root_dir, img_dir, gt_dir,
                                   device)

    # solar direction bounds across the dataset
    # (study_solar_interpolation.py:145-165)
    angles, dirs = [], []
    for json_p in glob.glob(os.path.join(cfg.root_dir, "*.json")):
        with open(json_p) as f:
            d = json.load(f)
        el, az = float(d["sun_elevation"]), float(d["sun_azimuth"])
        dirs.append(sun_direction(el, az))
        angles.append(solar_incidence_angle_deg(el, az))
    upper_sun_dir = dirs[int(np.argmin(angles))]
    lower_sun_dir = dirs[int(np.argmax(angles))]

    reference_image = sort_by_increasing_view_incidence_angle(cfg.root_dir)[0]
    dataset = SatelliteScene(cfg.root_dir, cfg.img_dir, split="val",
                             img_downscale=cfg.img_downscale,
                             cache_dir=cfg.cache_dir)
    dataset.records = [dataset._record(reference_image, 0)]
    sample0 = dataset.load_image(0)
    src_id = sample0["src_id"]

    ts = None
    if cfg.model == "sat-nerf":
        with open(os.path.join(cfg.root_dir, "train.txt")) as f:
            train_files = [os.path.join(cfg.root_dir, s)
                           for s in f.read().split("\n") if s.strip()]
        t = (train_files.index(reference_image)
             if reference_image in train_files
             else (predefined_val_ts(src_id) or 0))
        ts = np.full(sample0["rays"].shape[0], t, dtype=np.int32)

    out_dir = os.path.join(output_dir, run_id)
    if main:
        os.makedirs(out_dir, exist_ok=True)

    for i, alpha in enumerate(np.linspace(0, 1, n_interp)):
        sun_d = alpha * upper_sun_dir + (1 - alpha) * lower_sun_dir
        u1 = sun_d / np.linalg.norm(sun_d)
        angle = float(np.degrees(np.arccos(np.clip(u1[2], -1, 1))))

        sample = dict(sample0)
        rays = sample0["rays"].copy()
        rays[:, 8:11] = sun_d.astype(np.float32)
        sample["rays"] = rays
        results = system.render_image(params, rays, ts)
        if not main:
            continue
        save_nerf_output_to_images(dataset, sample, results, out_dir,
                                   epoch_number)
        for p in glob.glob(os.path.join(out_dir,
                                        f"*/*epoch{epoch_number}.tif")):
            shutil.move(p, p.replace(
                ".tif", f"_solar_incidence_angle_{angle:.2f}deg.tif"))
        print(f"solar incidence angle {angle:.2f} completed "
              f"({i + 1} of {n_interp})")

    if not main:
        return
    # summary sheets (study_solar_interpolation.py:219-246)
    summary_dir = os.path.join(out_dir, "summary")
    os.makedirs(summary_dir, exist_ok=True)
    for sub, fn in (("sun", hstack_sun_tifs), ("albedo", hstack_rgb_tifs),
                    ("rgb", hstack_rgb_tifs)):
        paths = sorted(glob.glob(os.path.join(out_dir, f"{sub}/*.tif")))
        if paths:
            Image.fromarray(fn(paths)).save(
                os.path.join(summary_dir, f"{sub}.png"))
    paths = sorted(glob.glob(os.path.join(out_dir, "depth/*.tif")))
    if paths:
        Image.fromarray(hstack_depth_tifs(paths)).save(
            os.path.join(summary_dir, "depth_v1.png"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run_id", required=True)
    ap.add_argument("--logs_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--epoch_number", type=int, required=True)
    ap.add_argument("--checkpoints_dir", default=None)
    ap.add_argument("--root_dir", default=None)
    ap.add_argument("--img_dir", default=None)
    ap.add_argument("--gt_dir", default=None)
    ap.add_argument("--n_interp", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    sun_interp(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
