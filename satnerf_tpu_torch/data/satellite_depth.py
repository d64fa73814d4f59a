"""Depth-supervision dataset: sparse rays through bundle-adjustment keypoints.

Counterpart of satnerf_tpu/data/satellite_depth.py (reference
datasets/satellite_depth.py:20-149). Unlike the reference subclass, which
hardcodes img_downscale=1.0 and drops the caller's cache_dir, this honors the
caller's settings. Numpy only.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from satnerf_tpu_torch.data.rays import rays_from_rpc, sun_direction
from satnerf_tpu_torch.data.satellite import SatelliteScene, read_dict_from_json, get_file_id
from satnerf_tpu_torch.geo.ellipsoid import latlon_from_ecef
from satnerf_tpu_torch.geo.rpc import RPCModel, rescale_rpc


class SatelliteDepthScene(SatelliteScene):
    """Train-split-only dataset of keypoint rays with depth targets.

    `all_rays` (N, 11), `all_depths` (N, 2) [depth, weight], `all_ids` (N,).
    Depth targets are |pts3d_normalized - ray_origin| (satellite_depth.py:84);
    weights are exp(-(e/e_mean)^2) over per-point reprojection-error sums
    (satellite_depth.py:103-129).
    """

    def __init__(self, root_dir: str, img_dir: Optional[str] = None,
                 split: str = "train", img_downscale: float = 1.0,
                 cache_dir: Optional[str] = None, verbose: bool = False):
        # initialize the scene frame + split lists via the parent, but skip
        # its dense per-pixel load by shadowing _load_all with the sparse one
        self._depth_mode = True
        super().__init__(root_dir, img_dir, split="train",
                         img_downscale=img_downscale, cache_dir=cache_dir,
                         verbose=verbose)

    def _load_all(self):
        pts3d_path = os.path.join(self.json_dir, "pts3d.npy")
        if not os.path.exists(pts3d_path):
            raise FileNotFoundError(f"Could not find {pts3d_path}")
        self.tie_points = np.load(pts3d_path)
        kp_weights = self._keypoint_weights(self.json_files, self.tie_points)

        rays_l, depths_l, ids_l = [], [], []
        for t, json_p in enumerate(self.json_files):
            d = read_dict_from_json(json_p)
            img_id = get_file_id(d["img"])
            if "keypoints" not in d:
                raise ValueError(f"No 'keypoints' field was found in {json_p}")

            pts2d = np.array(d["keypoints"]["2d_coordinates"], np.float64)
            pts2d = pts2d / self.img_downscale
            idx3d = np.asarray(d["keypoints"]["pts3d_indices"], np.int64)
            pts3d = self.tie_points[idx3d, :]
            rpc = rescale_rpc(RPCModel.from_dict(d["rpc"]), 1.0 / self.img_downscale)

            cols, rows = pts2d[:, 0], pts2d[:, 1]
            rays = self.scene.normalize_rays(
                rays_from_rpc(cols, rows, rpc, float(d["min_alt"]), float(d["max_alt"]))
            )
            sun_d = sun_direction(float(d["sun_elevation"]), float(d["sun_azimuth"]))
            rays11 = np.hstack(
                [rays, np.broadcast_to(sun_d, (rays.shape[0], 3))]
            ).astype(np.float32)

            pts3d_n = self.scene.normalize_points(pts3d)
            depths = np.linalg.norm(pts3d_n - rays[:, :3], axis=1)
            weights = kp_weights[idx3d]

            rays_l.append(rays11)
            depths_l.append(
                np.stack([depths, weights], axis=-1).astype(np.float32)
            )
            ids_l.append(np.full(rays.shape[0], t, dtype=np.int32))
            if self.verbose:
                print(f"Depth {img_id} loaded ( {t + 1} / {len(self.json_files)} )")

        self.all_depths = np.concatenate(depths_l, 0)
        return (
            np.concatenate(rays_l, 0),
            self.all_depths,  # alias: parent expects an rgbs slot
            np.concatenate(ids_l, 0),
        )

    def _keypoint_weights(self, json_files, tie_points) -> np.ndarray:
        """exp(-(e/e_mean)^2) with e = summed reprojection error of each tie
        point over the cameras observing it (satellite_depth.py:103-129).
        Reprojection uses the full-resolution RPCs like the reference."""
        n_pts = tie_points.shape[0]
        errors = np.zeros((n_pts, len(json_files)), dtype=np.float32)
        for t, json_p in enumerate(json_files):
            d = read_dict_from_json(json_p)
            if "keypoints" not in d:
                raise ValueError(f"No 'keypoints' field was found in {json_p}")
            pts2d = np.array(d["keypoints"]["2d_coordinates"], np.float64)
            idx3d = np.asarray(d["keypoints"]["pts3d_indices"], np.int64)
            pts3d = tie_points[idx3d, :]
            rpc = RPCModel.from_dict(d["rpc"])
            lat, lon, alt = latlon_from_ecef(pts3d[:, 0], pts3d[:, 1], pts3d[:, 2])
            col, row = rpc.projection(lon, lat, alt)
            reproj = np.stack([col, row], axis=-1)
            errors[idx3d, t] = np.linalg.norm(pts2d - reproj, axis=1)
        e = errors.sum(axis=1)
        e_mean = e.mean()
        return np.exp(-((e / e_mean) ** 2))

    def __len__(self):
        return self.all_rays.shape[0]
