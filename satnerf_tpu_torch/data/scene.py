"""Scene frame: the normalization that maps ECEF coordinates into the unit-ish
cube the networks operate in.

The reference buries this inside SatelliteDataset (center/range at
datasets/satellite.py:108-109, applied at 218-227, inverted at 246-275) even
though the DSM writer needs it too. Here it is a standalone object shared by
the data pipeline and the geometry products (SURVEY.md §1 'notable inversion').
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from satnerf_tpu_torch.geo.rpc import scaling_params


@dataclass
class SceneFrame:
    """ECEF offset/scale: normalized = (ecef - center) / range."""

    center: np.ndarray  # (3,) float64
    range: float

    # ------------------------------------------------------------------- IO

    @classmethod
    def from_points(cls, points: np.ndarray) -> "SceneFrame":
        """Fit from an (N, 3) ECEF cloud: per-axis half-range offsets, one
        shared isotropic scale (max of the three half-ranges), exactly like
        datasets/satellite.py:152-158 + 108-109."""
        sx, ox = scaling_params(points[:, 0])
        sy, oy = scaling_params(points[:, 1])
        sz, oz = scaling_params(points[:, 2])
        return cls(center=np.array([ox, oy, oz], dtype=np.float64),
                   range=float(max(sx, sy, sz)))

    @classmethod
    def load(cls, path: str) -> "SceneFrame":
        """Read a reference-format scene.loc json (X_scale/X_offset/...)."""
        with open(path) as f:
            d = json.load(f)
        center = np.array(
            [float(d["X_offset"]), float(d["Y_offset"]), float(d["Z_offset"])],
            dtype=np.float64,
        )
        rng = float(
            max(float(d["X_scale"]), float(d["Y_scale"]), float(d["Z_scale"]))
        )
        return cls(center=center, range=rng)

    def save(self, path: str, per_axis_scales=None) -> None:
        """Write scene.loc in the reference layout. If per-axis scales are
        known (from from_points) they can be preserved; otherwise the shared
        range is written for all three axes."""
        s = per_axis_scales if per_axis_scales is not None else [self.range] * 3
        d = {
            "X_scale": s[0], "X_offset": float(self.center[0]),
            "Y_scale": s[1], "Y_offset": float(self.center[1]),
            "Z_scale": s[2], "Z_offset": float(self.center[2]),
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(d, f, indent=2)

    # ------------------------------------------------------------ transforms

    def normalize_points(self, xyz: np.ndarray) -> np.ndarray:
        return (xyz - self.center) / self.range

    def denormalize_points(self, xyz_n: np.ndarray) -> np.ndarray:
        return xyz_n * self.range + self.center

    def normalize_rays(self, rays: np.ndarray) -> np.ndarray:
        """rays (N, >=8): origin /3, dir /3, near, far. Origins are shifted and
        scaled; directions are unit and stay untouched; near/far scale
        (datasets/satellite.py:218-227)."""
        out = rays.copy()
        out[:, 0:3] = (rays[:, 0:3] - self.center) / self.range
        out[:, 6:8] = rays[:, 6:8] / self.range
        return out
