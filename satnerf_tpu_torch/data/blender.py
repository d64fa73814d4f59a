"""Synthetic Blender (NeRF lego-style) dataset: pinhole cameras, white bg.

The port's own copy of satnerf_tpu/data/blender.py (the reference's
datasets/blender.py:82-209): numpy and Pillow only. The geo-free dataset of
`--data blender`: rays are (N, 8), origin, direction, near, far, with no sun
direction. Supports the NeRF-W-style color/occlusion perturbations used for
transient experiments.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image, ImageDraw


def pinhole_ray_directions(h: int, w: int, K: np.ndarray) -> np.ndarray:
    """(h, w, 3) camera-frame ray dirs, OpenGL convention (blender.py:12-33):
    x right, y up, z backward; no half-pixel centering (matches reference)."""
    j, i = np.meshgrid(np.arange(h, dtype=np.float64),
                       np.arange(w, dtype=np.float64), indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return np.stack(
        [(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1
    )


def pinhole_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-frame (origins, unit dirs), flattened (h*w, 3) each."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def add_perturbation(img: Image.Image, perturbation, seed: int) -> Image.Image:
    """NeRF-W style train-image corruptions (blender.py:61-79)."""
    if "color" in perturbation:
        rng = np.random.RandomState(seed)
        arr = np.array(img) / 255.0
        s = rng.uniform(0.8, 1.2, size=3)
        b = rng.uniform(-0.2, 0.2, size=3)
        arr[..., :3] = np.clip(s * arr[..., :3] + b, 0, 1)
        img = Image.fromarray((255 * arr).astype(np.uint8))
    if "occ" in perturbation:
        draw = ImageDraw.Draw(img)
        rng = np.random.RandomState(seed)
        left = rng.randint(200, 400)
        top = rng.randint(200, 400)
        for i in range(10):
            rng_i = np.random.RandomState(10 * seed + i)
            color = tuple(rng_i.choice(range(256), 3).tolist())
            draw.rectangle(
                ((left + 20 * i, top), (left + 20 * (i + 1), top + 200)),
                fill=color,
            )
    return img


class BlenderScene:
    """split='train': all_rays (N, 8), all_rgbs (N, 3), all_ids (N,).
    split='val'/'test': per-frame loading via load_image(i)."""

    def __init__(self, root_dir: str, split: str = "train", img_wh=(400, 400),
                 perturbation=()):
        self.root_dir = root_dir
        self.split = split
        assert img_wh[0] == img_wh[1], "image width must equal image height!"
        self.img_wh = img_wh
        assert set(perturbation).issubset({"color", "occ"})
        self.perturbation = list(perturbation)
        self.white_back = True

        with open(os.path.join(root_dir, f"transforms_{split.split('_')[-1]}.json")) as f:
            self.meta = json.load(f)

        w, h = img_wh
        focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        focal *= w / 800
        self.K = np.eye(3)
        self.K[0, 0] = self.K[1, 1] = focal
        self.K[0, 2] = w / 2
        self.K[1, 2] = h / 2
        self.near, self.far = 2.0, 6.0
        self.directions = pinhole_ray_directions(h, w, self.K)

        if split == "train":
            rays_l, rgbs_l, ids_l = [], [], []
            for t, frame in enumerate(self.meta["frames"]):
                rays, rgbs = self._frame_data(frame, perturb_seed=t if t != 0 else None)
                rays_l.append(rays)
                rgbs_l.append(rgbs)
                ids_l.append(np.full(rays.shape[0], t, dtype=np.int32))
            self.all_rays = np.concatenate(rays_l, 0)
            self.all_rgbs = np.concatenate(rgbs_l, 0)
            self.all_ids = np.concatenate(ids_l, 0)

    def _frame_data(self, frame, perturb_seed=None):
        c2w = np.array(frame["transform_matrix"], np.float64)[:3, :4]
        img = Image.open(os.path.join(self.root_dir, f"{frame['file_path']}.png"))
        if perturb_seed is not None and self.perturbation:
            img = add_perturbation(img, self.perturbation, perturb_seed)
        img = img.resize(self.img_wh, Image.LANCZOS)
        arr = np.asarray(img, np.float32) / 255.0  # (h, w, 4)
        arr = arr.reshape(-1, arr.shape[-1])
        if arr.shape[-1] == 4:
            rgbs = arr[:, :3] * arr[:, -1:] + (1.0 - arr[:, -1:])  # white bg
        else:
            rgbs = arr[:, :3]
        rays_o, rays_d = pinhole_rays(self.directions, c2w)
        rays = np.hstack(
            [
                rays_o, rays_d,
                np.full((rays_o.shape[0], 1), self.near),
                np.full((rays_o.shape[0], 1), self.far),
            ]
        ).astype(np.float32)
        return rays, rgbs.astype(np.float32)

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return min(8, len(self.meta["frames"]))
        return len(self.meta["frames"])

    def load_image(self, idx: int) -> dict:
        frame = self.meta["frames"][idx]
        rays, rgbs = self._frame_data(frame)
        w, h = self.img_wh
        return {
            "rays": rays,
            "rgbs": rgbs,
            "ts": np.zeros(rays.shape[0], dtype=np.int32),
            "src_id": os.path.basename(frame["file_path"]),
            "h": h,
            "w": w,
        }
