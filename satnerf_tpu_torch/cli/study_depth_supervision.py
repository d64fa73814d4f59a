#!/usr/bin/env python
"""The depth-supervision study on the PyTorch port: study_depth_supervision.py
(the reference's `check_depth_supervision_points`) over the port's own
geo/, data/ and eval/ modules. It visualizes the bundle-adjustment
tie-point depth priors by IDW-interpolating them over each image grid and
rasterizing the result into an 'initial DSM' cropped to the lidar ROI. No
model runs and no device is used.

  python -m satnerf_tpu_torch.cli.study_depth_supervision --run_id RUN \
      --logs_dir logs --output_dir out [--root_dir ...] [--img_dir ...] \
      [--gt_dir ...]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def idw_interpolation(pts2d, z, pts2d_query, N: int = 8):
    """Inverse-distance-weighted interpolation from the N nearest known
    points (reference study_depth_supervision.py:64-103)."""
    from scipy.spatial import cKDTree as KDTree

    tree = KDTree(pts2d)
    nn_distances, nn_indices = tree.query(pts2d_query, k=N)
    if N == 1:
        return z[nn_indices]
    w = 1.0 / np.maximum(nn_distances, 1e-12)
    w /= w.sum(axis=1, keepdims=True)
    z_query = np.sum(w * z[nn_indices], axis=1)
    exact = nn_distances[:, 0] < 1e-10
    z_query[exact] = z[nn_indices[exact, 0]]
    return z_query


def interpolate_sparse_over_grid(height, width, pts2d, values, smooth=20):
    """IDW-interpolate sparse per-keypoint values over the full image grid
    and gaussian-smooth (study_depth_supervision.py:18-37)."""
    from scipy.ndimage import gaussian_filter

    cols, rows = pts2d.T
    valid = (cols < width) & (cols >= 0) & (rows < height) & (rows >= 0)
    pts2d, values = pts2d[valid], values[valid]
    all_cols, all_rows = np.meshgrid(np.arange(width), np.arange(height))
    q = np.vstack([all_cols.ravel(), all_rows.ravel()]).T
    interp = idw_interpolation(pts2d, values, q).reshape(height, width)
    return gaussian_filter(interp, sigma=smooth)


def check_depth_supervision_points(run_id, logs_dir, output_dir,
                                   root_dir=None, img_dir=None, gt_dir=None):
    from satnerf_tpu_torch.data.rays import rays_from_rpc
    from satnerf_tpu_torch.data.satellite import get_file_id
    from satnerf_tpu_torch.data.satellite_depth import SatelliteDepthScene
    from satnerf_tpu_torch.eval.dsm_metrics import _crop_to_roi
    from satnerf_tpu_torch.eval.loader import load_run_config
    from satnerf_tpu_torch.geo.geotiff import write_geotiff
    from satnerf_tpu_torch.geo.rpc import RPCModel, rescale_rpc

    cfg = load_run_config(logs_dir, run_id)
    if gt_dir is not None:
        cfg.gt_dir = gt_dir
    if img_dir is not None:
        cfg.img_dir = img_dir
    if root_dir is not None:
        cfg.root_dir = root_dir
    if cfg.cache_dir is not None and not os.path.isdir(cfg.cache_dir):
        cfg.cache_dir = None

    ds = SatelliteDepthScene(root_dir=cfg.root_dir, img_dir=cfg.img_dir,
                             split="train", cache_dir=cfg.cache_dir,
                             img_downscale=cfg.img_downscale)
    tie_points = ds.tie_points
    out_dir = os.path.join(output_dir, run_id)
    os.makedirs(out_dir, exist_ok=True)
    print("Output dir:", out_dir)

    for t, json_p in enumerate(ds.json_files):
        with open(json_p) as f:
            d = json.load(f)
        img_id = get_file_id(d["img"])
        pts2d = np.array(d["keypoints"]["2d_coordinates"]) / ds.img_downscale
        pts3d = np.array(tie_points[d["keypoints"]["pts3d_indices"], :])
        rpc = rescale_rpc(RPCModel.from_dict(d["rpc"]), 1.0 / ds.img_downscale)

        cols, rows = pts2d.T
        min_alt, max_alt = float(d["min_alt"]), float(d["max_alt"])
        rays = ds.scene.normalize_rays(
            rays_from_rpc(cols, rows, rpc, min_alt, max_alt)
        )
        pts3d_n = ds.scene.normalize_points(pts3d)
        depths = np.linalg.norm(pts3d_n - rays[:, :3], axis=1)

        h = int(int(d["height"]) // ds.img_downscale)
        w = int(int(d["width"]) // ds.img_downscale)
        init_depth = interpolate_sparse_over_grid(h, w, pts2d, depths, smooth=1)

        gcols, grows = np.meshgrid(np.arange(w), np.arange(h))
        grays = ds.scene.normalize_rays(
            rays_from_rpc(gcols.ravel(), grows.ravel(), rpc, min_alt, max_alt)
        )
        out_path = os.path.join(out_dir, f"init_dsm_depth_supervision_{img_id}.tif")
        ds.dsm_from_prediction(grays, init_depth.ravel(), dsm_path=out_path)

        if cfg.gt_dir is not None:
            aoi_id = img_id[:7]
            roi = os.path.join(cfg.gt_dir, aoi_id + "_DSM.txt")
            if os.path.exists(roi):
                meta = np.loadtxt(roi)
                cropped, prof = _crop_to_roi(out_path, meta[0], meta[1],
                                             int(meta[2]), int(meta[2]), meta[3])
                write_geotiff(out_path, cropped[None], prof)
        print(f"done {t + 1} of {len(ds.json_files)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run_id", required=True)
    ap.add_argument("--logs_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--root_dir", default=None)
    ap.add_argument("--img_dir", default=None)
    ap.add_argument("--gt_dir", default=None)
    check_depth_supervision_points(**vars(ap.parse_args()))


if __name__ == "__main__":
    main()
