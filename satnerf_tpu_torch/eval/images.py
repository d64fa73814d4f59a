"""GeoTIFF debug/product dumps of NeRF outputs.

Equivalent of eval_satnerf.py:95-146 (save_nerf_output_to_images) +
train_utils.py:74-93 (save_output_image): rgb / gt_rgb / depth(alt) / dsm /
sun / albedo / beta / sky per-image rasters, each written with the source
image's georeferencing profile.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from satnerf_tpu_torch.geo.geotiff import read_geotiff, write_geotiff


def save_output_image(arr, output_path: str, source_path: Optional[str]) -> None:
    """arr: (D, H, W) channels-first float; profile copied from source_path."""
    arr = np.asarray(arr, np.float32)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    prof = None
    if source_path is not None and os.path.exists(source_path):
        prof = read_geotiff(source_path).profile.copy()
        prof.dtype = "float32"
        prof.count = arr.shape[0]
        prof.height = arr.shape[1]
        prof.width = arr.shape[2]
    write_geotiff(output_path, arr, prof)


def save_nerf_output_to_images(dataset, sample: dict, results: dict,
                               out_dir: str, epoch_number: int) -> None:
    """Write the full product set for one rendered image."""
    rays = np.asarray(sample["rays"])
    rgbs = np.asarray(sample["rgbs"])
    src_id = sample["src_id"]
    src_path = os.path.join(dataset.img_dir, src_id + ".tif")
    if not os.path.exists(src_path):
        src_path = None

    typ = "fine" if "rgb_fine" in results else "coarse"
    h, w = int(sample["h"]), int(sample["w"])

    img = np.moveaxis(np.asarray(results[f"rgb_{typ}"]).reshape(h, w, 3), -1, 0)
    img_gt = np.moveaxis(rgbs.reshape(h, w, 3), -1, 0)
    depth = np.asarray(results[f"depth_{typ}"])

    # depth -> altitude raster
    _, _, alts = dataset.latlonalt_from_prediction(rays, depth)
    save_output_image(alts.reshape(1, h, w),
                      f"{out_dir}/depth/{src_id}_epoch{epoch_number}.tif", src_path)
    # dsm
    dataset.dsm_from_prediction(
        rays, depth, dsm_path=f"{out_dir}/dsm/{src_id}_epoch{epoch_number}.tif"
    )
    # rgb + gt
    save_output_image(img, f"{out_dir}/rgb/{src_id}_epoch{epoch_number}.tif", src_path)
    save_output_image(img_gt, f"{out_dir}/gt_rgb/{src_id}_epoch{epoch_number}.tif",
                      src_path)

    weights = np.asarray(results.get(f"weights_{typ}"))
    if f"sun_{typ}" in results:
        sun = np.asarray(results[f"sun_{typ}"])
        s_v = (weights[..., None] * sun).sum(-2)
        save_output_image(s_v.reshape(1, h, w),
                          f"{out_dir}/sun/{src_id}_epoch{epoch_number}.tif", src_path)
        albedo = np.asarray(results[f"albedo_{typ}"])
        a = (weights[..., None] * albedo).sum(-2)
        save_output_image(np.moveaxis(a.reshape(h, w, 3), -1, 0),
                          f"{out_dir}/albedo/{src_id}_epoch{epoch_number}.tif",
                          src_path)
    if f"beta_{typ}" in results and results[f"beta_{typ}"] is not None:
        beta = np.asarray(results[f"beta_{typ}"])
        b = (weights[..., None] * beta).sum(-2)
        save_output_image(b.reshape(1, h, w),
                          f"{out_dir}/beta/{src_id}_epoch{epoch_number}.tif", src_path)
    if f"sky_{typ}" in results:
        sky = np.asarray(results[f"sky_{typ}"])
        s = (weights[..., None] * sky).sum(-2)
        save_output_image(np.moveaxis(s.reshape(h, w, 3), -1, 0),
                          f"{out_dir}/sky/{src_id}_epoch{epoch_number}.tif", src_path)
