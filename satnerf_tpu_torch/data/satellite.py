"""Multi-view satellite dataset: json metadata -> normalized ray/rgb tensors.

Replaces datasets/satellite.py:83-358 with a plain-numpy loader (no torch
Dataset/DataLoader machinery — batching happens on-device, see data/sampler.py).

Metadata layout is byte-compatible with the reference: one json per image with
img / height / width / rpc (rpcm dict) / sun_elevation / sun_azimuth /
min_alt / max_alt [+ keypoints for depth supervision], plus root-level
train.txt / test.txt split files and a scene.loc normalization file.
"""

from __future__ import annotations

import glob
import json
import os
import socket
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from PIL import Image

from satnerf_tpu_torch.data.rays import image_ray_grid, sun_direction
from satnerf_tpu_torch.data.scene import SceneFrame
from satnerf_tpu_torch.geo.ellipsoid import latlon_from_ecef
from satnerf_tpu_torch.geo.geotiff import read_geotiff
from satnerf_tpu_torch.geo.rpc import RPCModel, rescale_rpc
from satnerf_tpu_torch.geo.utm import utm_from_latlon, utm_epsg
from satnerf_tpu_torch.ops.dsm_raster import raster_dsm


def get_file_id(filename: str) -> str:
    return os.path.splitext(os.path.basename(filename))[0]


def read_dict_from_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_rgb_image(img_path: str, downscale: float = 1.0) -> np.ndarray:
    """(h*w, 3) float32 rgb in [0, 1] (datasets/satellite.py:67-80).

    Downscale >1 resizes bicubically to (h//ds, w//ds) like the reference's
    torchvision Resize.
    """
    data = read_geotiff(img_path).data  # (C, H, W)
    img = np.moveaxis(data, 0, -1).astype(np.float32) / 255.0
    h, w = img.shape[:2]
    if downscale > 1:
        nh, nw = int(h // downscale), int(w // downscale)
        pim = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        img = np.asarray(pim.resize((nw, nh), Image.BICUBIC), dtype=np.float32) / 255.0
    return img.reshape(-1, 3)


@dataclass
class ImageRecord:
    json_path: str
    img_id: str
    h: int
    w: int
    t: int  # embedding index


class SatelliteScene:
    """Loads a reference-format satellite dataset root.

    split='train': `all_rays` (N, 11) f32 [o, d, near, far, sun_d],
                   `all_rgbs` (N, 3) f32, `all_ids` (N,) int32.
    split='val'  : per-image loading via `load_image(i)`; item 0 is the first
                   TRAIN image (the reference's overfit probe,
                   datasets/satellite.py:127-133) and must be excluded from
                   val metrics.
    """

    def __init__(self, root_dir: str, img_dir: Optional[str] = None,
                 split: str = "train", img_downscale: float = 1.0,
                 cache_dir: Optional[str] = None, verbose: bool = False):
        self.json_dir = root_dir
        self.img_dir = img_dir if img_dir is not None else root_dir
        self.cache_dir = cache_dir
        self.train = split == "train"
        self.img_downscale = float(img_downscale)
        self.verbose = verbose
        self.white_back = False

        assert os.path.exists(self.json_dir), f"root_dir {root_dir} does not exist"
        assert os.path.exists(self.img_dir), f"img_dir {self.img_dir} does not exist"

        loc_path = os.path.join(self.json_dir, "scene.loc")
        if not os.path.exists(loc_path):
            self._init_scene_frame(loc_path)
        self.scene = SceneFrame.load(loc_path)

        if self.train:
            self.json_files = self._split_files("train.txt")
            self.records = [
                self._record(p, t) for t, p in enumerate(self.json_files)
            ]
            self.n_train = len(self.records)
            self.all_rays, self.all_rgbs, self.all_ids = self._load_all()
        elif split == "eval_train":
            # per-image evaluation over the TRAIN images (the reference's
            # `eval_satnerf --split train`, eval_satnerf.py:246-253): ids are
            # the train ids themselves
            self.json_files = self._split_files("train.txt")
            self.records = [
                self._record(p, t) for t, p in enumerate(self.json_files)
            ]
            self.n_train = len(self.records)
        else:
            test_files = self._split_files("test.txt")
            train_files = self._split_files("train.txt")
            self.n_train = n_train = len(train_files)
            # reference quirk: val ids continue AFTER the train ids, and the
            # train probe image keeps id 0 (datasets/satellite.py:127-133)
            self.json_files = [train_files[0]] + test_files
            ids = [0] + [n_train + i for i in range(len(test_files))]
            self.records = [
                self._record(p, t) for p, t in zip(self.json_files, ids)
            ]

    # ----------------------------------------------------------- internals

    def _split_files(self, name: str):
        with open(os.path.join(self.json_dir, name)) as f:
            names = [s for s in f.read().split("\n") if s.strip()]
        return [os.path.join(self.json_dir, n) for n in names]

    def _record(self, json_path: str, t: int) -> ImageRecord:
        d = read_dict_from_json(json_path)
        h = int(int(d["height"]) // self.img_downscale)
        w = int(int(d["width"]) // self.img_downscale)
        return ImageRecord(json_path, get_file_id(d["img"]), h, w, t)

    def _init_scene_frame(self, loc_path: str) -> None:
        """Fit scene.loc from the near+far points of every image's ray grid
        (datasets/satellite.py:135-158). Subsamples the pixel grid 8x — the
        scene bounding box only needs the hull, not every pixel."""
        all_points = []
        for json_p in sorted(glob.glob(os.path.join(self.json_dir, "*.json"))):
            d = read_dict_from_json(json_p)
            rays = self._image_rays(d, subsample=8)
            near_pts = rays[:, :3]
            far_pts = rays[:, :3] + rays[:, 7:8] * rays[:, 3:6]
            all_points.append(np.vstack([near_pts, far_pts]))
        frame = SceneFrame.from_points(np.vstack(all_points))
        # preserve the per-axis scales in the file like the reference does
        pts = np.vstack(all_points)
        from satnerf_tpu_torch.geo.rpc import scaling_params

        scales = [scaling_params(pts[:, i])[0] for i in range(3)]
        frame.save(loc_path, per_axis_scales=scales)

    def _image_rays(self, d: dict, subsample: int = 1) -> np.ndarray:
        h = int(int(d["height"]) // self.img_downscale)
        w = int(int(d["width"]) // self.img_downscale)
        rpc = rescale_rpc(RPCModel.from_dict(d["rpc"]), 1.0 / self.img_downscale)
        if subsample > 1:
            cols, rows = np.meshgrid(
                np.linspace(0, w - 1, max(2, w // subsample)),
                np.linspace(0, h - 1, max(2, h // subsample)),
            )
            from satnerf_tpu_torch.data.rays import rays_from_rpc

            return rays_from_rpc(cols.ravel(), rows.ravel(), rpc,
                                 float(d["min_alt"]), float(d["max_alt"]))
        return image_ray_grid(rpc, h, w, float(d["min_alt"]), float(d["max_alt"]))

    def _rays_for(self, d: dict, img_id: str) -> np.ndarray:
        """Raw (un-normalized) rays, with an .npy cache playing the role of the
        reference's torch.save cache (datasets/satellite.py:185-196)."""
        if self.cache_dir is not None:
            cache_path = os.path.join(self.cache_dir, f"{img_id}.npy")
            if os.path.exists(cache_path):
                return np.load(cache_path)
        rays = self._image_rays(d)
        if self.cache_dir is not None:
            os.makedirs(self.cache_dir, exist_ok=True)
            # atomic publish: multi-host runs (parallel/distributed.py) have
            # every process racing to build the same cache — write to a
            # host+process-unique tmp file and rename, so a concurrent
            # reader never sees a half-written .npy (PIDs alone can collide
            # across hosts sharing one cache_dir)
            tmp = (f"{cache_path}.{socket.gethostname()}"
                   f".{os.getpid()}.tmp.npy")
            np.save(tmp, rays)  # ends in .npy so np.save appends nothing
            os.replace(tmp, cache_path)
        return rays

    def _load_one(self, json_path: str, t: int):
        d = read_dict_from_json(json_path)
        img_id = get_file_id(d["img"])
        img_p = os.path.join(self.img_dir, d["img"])
        rgbs = load_rgb_image(img_p, self.img_downscale)
        rays = self.scene.normalize_rays(self._rays_for(d, img_id))
        sun_d = sun_direction(float(d["sun_elevation"]), float(d["sun_azimuth"]))
        sun_dirs = np.broadcast_to(sun_d, (rays.shape[0], 3))
        rays11 = np.hstack([rays, sun_dirs]).astype(np.float32)
        ids = np.full(rays.shape[0], t, dtype=np.int32)
        return rays11, rgbs.astype(np.float32), ids

    def _load_all(self):
        rays_l, rgbs_l, ids_l = [], [], []
        for rec in self.records:
            r, c, i = self._load_one(rec.json_path, rec.t)
            rays_l.append(r)
            rgbs_l.append(c)
            ids_l.append(i)
            if self.verbose:
                print(f"Image {rec.img_id} loaded ( {rec.t + 1} / {len(self.records)} )")
        return (
            np.concatenate(rays_l, 0),
            np.concatenate(rgbs_l, 0),
            np.concatenate(ids_l, 0),
        )

    # ------------------------------------------------------------- public

    def __len__(self):
        return self.all_rays.shape[0] if self.train else len(self.records)

    def load_image(self, idx: int) -> dict:
        """Full-image sample for validation/eval: rays, rgbs, ts, src_id, h, w."""
        rec = self.records[idx]
        rays, rgbs, _ = self._load_one(rec.json_path, rec.t)
        return {
            "rays": rays,
            "rgbs": rgbs,
            "ts": np.full(rays.shape[0], rec.t, dtype=np.int32),
            "src_id": rec.img_id,
            "h": rec.h,
            "w": rec.w,
        }

    # ------------------------------------------------- geometry products

    def latlonalt_from_prediction(self, rays: np.ndarray, depth: np.ndarray):
        """Depth map -> (lat, lon, alt) point cloud (satellite.py:246-275).
        rays are the normalized (N, >=8) input rays; float64 throughout."""
        rays = np.asarray(rays, np.float64)
        depth = np.asarray(depth, np.float64).reshape(-1, 1)
        xyz_n = rays[:, 0:3] + rays[:, 3:6] * depth
        xyz = self.scene.denormalize_points(xyz_n)
        return latlon_from_ecef(xyz[:, 0], xyz[:, 1], xyz[:, 2])

    def dsm_from_prediction(self, rays: np.ndarray, depth: np.ndarray,
                            dsm_path: Optional[str] = None,
                            roi_txt: Optional[str] = None) -> np.ndarray:
        """Depth map -> UTM DSM raster (satellite.py:277-338), plyflatten
        semantics (radius=1, uniform weights), 0.5 m default grid."""
        lats, lons, alts = self.latlonalt_from_prediction(rays, depth)
        easts, norths = utm_from_latlon(lats, lons)
        cloud = np.stack([easts, norths, alts], axis=-1)

        if roi_txt is not None:
            meta = np.loadtxt(roi_txt)
            xoff, yoff = meta[0], meta[1]
            xsize = ysize = int(meta[2])
            resolution = meta[3]
            yoff += ysize * resolution  # move origin to the upper edge
        else:
            resolution = 0.5
            xmin, xmax = cloud[:, 0].min(), cloud[:, 0].max()
            ymin, ymax = cloud[:, 1].min(), cloud[:, 1].max()
            xoff = np.floor(xmin / resolution) * resolution
            xsize = int(1 + np.floor((xmax - xoff) / resolution))
            yoff = np.ceil(ymax / resolution) * resolution
            ysize = int(1 - np.floor((ymin - yoff) / resolution))

        dsm = raster_dsm(cloud, xoff, yoff, resolution, xsize, ysize,
                         radius=1, sigma=float("inf"))

        if dsm_path is not None:
            from satnerf_tpu_torch.geo.geotiff import Affine, Profile, write_geotiff

            os.makedirs(os.path.dirname(dsm_path) or ".", exist_ok=True)
            prof = Profile(
                width=dsm.shape[1], height=dsm.shape[0], count=1,
                dtype="float64",
                crs_epsg=utm_epsg(float(lats[0]), float(lons[0])),
                transform=Affine(resolution, 0.0, xoff, 0.0, -resolution, yoff),
                nodata=float("nan"),
            )
            write_geotiff(dsm_path, dsm[:, :, 0][None], prof)
        return dsm
